"""A step captured once in a CUDA graph and replayed every tick (the port's
counterpart of ``jax.jit`` on the decode step).

:class:`CapturedStep` captures a function that reads and writes only
static device buffers, then replays it.  Two things a graph changes are
kept right here:

- **workspaces**: the split kernels' scratch buffers
  (:mod:`repro_torch.kernels.workspace`) are held for as long as the step
  lives, so none of them can grow (and free the address the graph holds);
  the caller sizes them before the capture;
- **launch counters**: the kernel wrappers count a launch where they make
  it, which under a capture happens once and runs nothing.  The capture's
  own counts are taken back out and kept as the step's delta, and every
  replay adds the delta: the counters count launches that ran.

The graph is a small object with ``capture(fn)`` and ``replay()``
(:class:`CudaGraph` on the card), so the CPU tests can stand one in.
"""
from __future__ import annotations

import collections
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels.flash_attention import flash_attention_h100
from ..kernels.matmul import matmul_h100
from ..kernels.ssd_scan import ssd_scan_h100
from ..kernels.workspace import WORKSPACES

#: The wrappers whose counters a captured step carries: the serve path's.
COUNTED = (matmul_h100, flash_attention_h100, ssd_scan_h100)


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind ``capture(fn)`` / ``replay()``; the
    capture runs on the side stream ``torch.cuda.graph`` requires."""

    def __init__(self) -> None:
        self._g = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], None]) -> None:
        with torch.cuda.graph(self._g):
            fn()

    def replay(self) -> None:
        self._g.replay()


class CapturedStep:
    """``fn`` captured in ``graph``; calling the step replays it.  ``delta``
    holds, per counted wrapper, the launches and launch shapes one replay
    makes."""

    def __init__(self, fn: Callable[[], None], graph,
                 counted: Sequence[Callable] = COUNTED):
        self.replays = 0
        before = [(k.launches, collections.Counter(k.shapes))
                  for k in counted]
        self._held: List[torch.Tensor] = [
            t for ws in WORKSPACES for t in ws.hold(self)]
        try:
            graph.capture(fn)
        except BaseException:
            self.release()
            raise
        finally:
            self.delta: List[Tuple[Callable, int, collections.Counter]] = []
            for k, (n, shapes) in zip(counted, before):
                self.delta.append((k, k.launches - n, k.shapes - shapes))
                k.launches = n
                k.shapes.clear()
                k.shapes.update(shapes)
        self.graph: Optional[object] = graph

    def __call__(self) -> None:
        self.graph.replay()
        self.replays += 1
        for k, n, shapes in self.delta:
            k.launches += n
            k.shapes.update(shapes)

    def release(self) -> None:
        """Drop the graph and let the workspaces grow again."""
        for ws in WORKSPACES:
            ws.release(self)
        self._held = []
        self.graph = None
