"""Steps captured once in CUDA graphs and replayed every tick (the port's
counterpart of ``jax.jit`` on the decode step and on each quantized prefill
chunk length).

:class:`CapturedStep` captures a function that reads and writes only
static device buffers, then replays it; :class:`StepGraphs` holds an
engine's captured steps.  Three things graphs change are kept right here:

- **memory**: the steps share one memory pool (on the card,
  ``torch.cuda.graph_pool_handle()``), so the prefill graphs add no more
  than the largest one's intermediates.  Replays come in any order, which
  is safe because every tensor a later step reads (the cache, ``last_tok``,
  the staging and output buffers) is allocated before any capture: a
  graph's pool memory holds only intermediates that die within its replay;
- **workspaces**: the split kernels' scratch buffers
  (:mod:`repro_torch.kernels.workspace`) are held once for all the steps,
  for as long as they live, so none of them can grow (and free the address
  a graph holds); the caller sizes them before the first capture;
- **launch counters**: the kernel wrappers count a launch where they make
  it, which under a capture happens once and runs nothing.  The capture's
  own counts are taken back out and kept as the step's delta, and every
  replay adds the delta: the counters count launches that ran.

Kernel dispatch (``DispatchCache.warm_callable``) runs at the capture too,
not at a replay, so each capture records, under ``DispatchCache.record()``,
the dispatch triples its step resolved (``CapturedStep.triples``).  A
graph keeps the kernels it was captured with: when a frozen pick is
demoted, the steps whose triples hold it are captured again
(:meth:`StepGraphs.recapture`, in place: the step keeps its replay count),
and if the new picks need larger workspaces every step is
(:meth:`StepGraphs.regrow`).  A graph is a small object with
``capture(fn)`` and ``replay()`` (:class:`CudaGraph` on the card), so the
CPU tests can stand one in.
"""
from __future__ import annotations

import collections
from typing import (Callable, Dict, FrozenSet, Hashable, List, Optional,
                    Sequence, Tuple)

import torch

from ..artifacts.dispatch import DispatchKey, get_default_cache
from ..kernels.flash_attention import flash_attention_h100
from ..kernels.matmul import matmul_h100
from ..kernels.ssd_scan import ssd_scan_h100
from ..kernels.workspace import WORKSPACES

#: The wrappers whose counters a captured step carries: the serve path's.
COUNTED = (matmul_h100, flash_attention_h100, ssd_scan_h100)


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind ``capture(fn)`` / ``replay()``, its
    memory from ``pool`` (a ``torch.cuda.graph_pool_handle()`` the graphs
    of one engine share); the capture runs on the side stream
    ``torch.cuda.graph`` requires."""

    def __init__(self, pool) -> None:
        self._g = torch.cuda.CUDAGraph()
        self._pool = pool

    def capture(self, fn: Callable[[], None]) -> None:
        with torch.cuda.graph(self._g, pool=self._pool):
            fn()

    def replay(self) -> None:
        self._g.replay()


class CapturedStep:
    """``fn`` captured in ``graph``; calling the step replays it.  ``delta``
    holds, per counted wrapper, the launches and launch shapes one replay
    makes, and ``triples`` the dispatch triples (family, machine, sorted
    data items) the capture resolved through the process-wide dispatch
    cache, the one the model's ops consult.  The workspaces must be held
    while it lives (:class:`StepGraphs` holds them)."""

    def __init__(self, fn: Callable[[], None], graph,
                 counted: Sequence[Callable] = COUNTED):
        self.fn = fn
        self.replays = 0
        self._counted = tuple(counted)
        self.graph: Optional[object] = None
        self.triples: FrozenSet[DispatchKey] = frozenset()
        self.capture(graph)

    def capture(self, graph) -> None:
        """Capture ``fn`` into ``graph`` (the step's previous graph, if any,
        must have been released)."""
        before = [(k.launches, collections.Counter(k.shapes))
                  for k in self._counted]
        try:
            with get_default_cache().record() as rec:
                graph.capture(self.fn)
        finally:
            self.delta: List[Tuple[Callable, int, collections.Counter]] = []
            for k, (n, shapes) in zip(self._counted, before):
                self.delta.append((k, k.launches - n, k.shapes - shapes))
                k.launches = n
                k.shapes.clear()
                k.shapes.update(shapes)
        self.triples = frozenset(rec.requests)
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            raise RuntimeError("this captured step was released: no graph "
                               "to replay")
        self.graph.replay()
        self.replays += 1
        for k, n, shapes in self.delta:
            k.launches += n
            k.shapes.update(shapes)

    def release(self) -> None:
        """Drop the graph."""
        self.graph = None


class StepGraphs:
    """An engine's captured steps, keyed by name: each captured in a graph
    from ``make_graph()`` (on the card, one sharing the set's memory pool),
    the workspaces held once for all of them from the first capture until
    :meth:`release`."""

    def __init__(self, make_graph: Callable[[], object]):
        self._make_graph = make_graph
        self.steps: Dict[Hashable, CapturedStep] = {}
        self._held: Optional[List[torch.Tensor]] = None

    def _hold(self) -> None:
        if self._held is None:
            self._held = [t for ws in WORKSPACES for t in ws.hold(self)]

    def capture(self, key: Hashable, fn: Callable[[], None]) -> CapturedStep:
        self._hold()
        try:
            step = CapturedStep(fn, self._make_graph())
        except BaseException:
            self.release()
            raise
        self.steps[key] = step
        return step

    def recapture(self, key: Hashable) -> CapturedStep:
        """Capture step ``key`` again from its own function into a new graph
        (after dropping its old one); its replay count carries on.  A
        failed capture releases every step and raises."""
        step = self.steps[key]
        step.release()
        self._hold()
        try:
            step.capture(self._make_graph())
        except BaseException:
            self.release()
            raise
        return step

    def regrow(self, grow: Callable[[], None]) -> None:
        """Drop every step's graph and the hold on the workspaces, run
        ``grow`` (which may now enlarge them), and hold them again; the
        caller then recaptures every step."""
        for step in self.steps.values():
            step.release()
        for ws in WORKSPACES:
            ws.release(self)
        self._held = None
        grow()
        self._hold()

    def release(self) -> None:
        """Drop every graph and let the workspaces grow again."""
        for step in self.steps.values():
            step.release()
        self.steps = {}
        for ws in WORKSPACES:
            ws.release(self)
        self._held = None
