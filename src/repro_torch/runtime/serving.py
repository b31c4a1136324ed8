"""Paged serving engine of the port: block KV pool + chunked prefill + a
compiled decode tick and compiled prefill chunks + async tick overlap, with
kernel dispatch frozen at start and traced by :mod:`repro_torch.obs`.

The port of ``runtime/serving.py``: a paged KV pool
(:class:`repro_torch.runtime.kv_pool.PagedKVPool` owns the accounting,
:func:`repro_torch.models.init_paged_cache` the device layout), chunked
prefill with quantized chunk lengths, and ``warm_kernels``: the traced warm
set of the serve path resolved through the comprehensive tree and frozen
into the dispatch cache's lock-free lane before the first request, so the
run itself resolves nothing cold.  Scheduling decisions are the JAX
engine's, byte for byte (:mod:`repro_torch.runtime.scheduler`).

Each tick: plan (scheduler) -> dispatch (at most one prefill chunk, then one
decode over the whole pool with per-row block tables) -> commit (the one
host sync: sampled tokens land in request outputs; EOS / ``max_new``
retire).  It serves the ``attn_mlp``, ``attn_moe``, ``ssm`` and ``hybrid``
blocks, every config the JAX engine serves; a slot's SSM state is zeroed
when a sequence is admitted to it, as the JAX ``_reset_slot`` does.  The
decode step routes all ``max_batch`` rows through a MoE layer in row order,
rows not decoding included, as the JAX step does (capacity is per routing
call, so masking them out would change which live tokens it drops).  Such a
row enters with K2's zeros where the JAX step attends it to the garbage
block, so the two engines agree token for token while a decode step's
capacity does not bind over it: always at ``max_batch`` <= 4 (ROADMAP F7).

**Compiled steps** (the JAX engine's ``jax.jit(_decode)`` and
``jax.jit(_prefill)``, one compile a quantized chunk length).  Both steps
read and write static device buffers only, so on ``cuda`` the engine
captures them at construction in CUDA graphs that share one memory pool
(:mod:`repro_torch.runtime.graph`): the decode step, then one prefill graph
for each chunk length the scheduler can return
(:func:`~repro_torch.plans.trace.chunk_lengths`).

- The decode step (:meth:`ServeEngine._decode_body`) reads ``last_tok``,
  the rows' ``cache_index``, ``block_tables`` and ``active`` mask: the step
  itself (:func:`~repro_torch.models.paged_decode_step`, one K1 launch a
  projection, one K2 and one K3 launch a layer), the greedy sample and the
  device-side chain ``last_tok = where(active, sampled, last_tok)``.
- A prefill chunk of length C (:meth:`ServeEngine._prefill_body`) reads the
  first C columns of the token buffer, its ``start``, ``slot`` and block
  table and the flag of the chunk that ends the prompt
  (:func:`~repro_torch.models.paged_prefill_step`: one K1 launch a
  projection, one K2 and one K3 launch a layer, the slot's SSM state row
  chosen on the device), samples the last token on the device and, on the
  final chunk only, sets ``last_tok[slot]`` to it.

Before the captures the engine sizes every split workspace for the serve
path's picks (they cannot grow under a graph) and runs each body once
eagerly on scratch copies of the KV pool, the SSM state and ``last_tok``
(which resolves every kernel entry and shared-memory opt-in before the
capture and writes no live state).  A tick then copies
its inputs in from pinned host staging, replays the graphs it needs and
copies the sampled tokens out to pinned host memory, all on the stream;
nothing else is launched for a step.  The CPU runs the very same bodies
eagerly on the same buffers, so the CPU tests hold their logic; on ``cuda``
no step runs eagerly (``eager_prefills`` counts the eager prefill bodies),
and a chunk length with no graph raises.

**Async tick overlap** (``async_depth``, as the JAX engine has it): a tick
is dispatched without a host sync, and up to ``async_depth - 1`` ticks stay
in flight across :meth:`ServeEngine.step`'s return, so the host plans and
dispatches tick t+1 while the card runs tick t; committing a tick (waiting
on its event and reading its tokens) is the only sync.  Each in-flight tick
owns one of ``async_depth`` host slots: its staged inputs and its sampled
tokens.  A slot is reused ``async_depth`` ticks later, after the tick that
used it was committed, so its staging is never written while a copy out of
it may still be pending, and the graphs' output buffers are copied out
before the next tick's replay overwrites them.  The scheduler's dispatch
guard and ``dead`` marks bound the speculation, as in the JAX engine.

**Tracing**, as the JAX engine is traced: with a flight recorder installed
(:func:`repro_torch.obs.install` / :func:`repro_torch.obs.tracing`) each
:meth:`ServeEngine.step` emits one ``TickSpan`` timed on the engine's clock
with the JAX engine's clock reads, so a counting clock makes the trace
deterministic; the scheduler emits its ``AdmissionDecision`` records and
the dispatch cache its ``DispatchDecision`` records.  Under graphs kernel
dispatch happens at warm-up and capture, not at a replay, so those are
where a ``DispatchDecision`` appears.  :meth:`ServeEngine.registry` is the
metrics registry.

**Prefix sharing** (``prefix_sharing=True``), as in the JAX engine: the
pool indexes full ``page_size``-aligned prompt blocks by chain hash, a
request whose prompt shares a prefix with a live or recently retired
sequence maps the resident blocks and prefills only its tail (its first
chunk starts at a mapped block boundary and reads the mapped blocks
through its table), and a write into a shared block first copies it
(:func:`~repro_torch.models.paged_copy_block`, two eager launches, no host
sync).  It is forced off for ``ssm`` and ``hybrid`` blocks: their state
must see every prompt token.

**Serve plans and the disk tier**: ``warm_kernels`` starts from a serve
plan when one matches (:mod:`repro_torch.plans`: zero cold resolutions),
else warms online; a stale plan warns and falls back, or raises under
``strict_plans``.

**Faults and degradation** (:mod:`repro_torch.runtime.faults`, as the JAX
engine's): every device stage of a tick (a CoW copy, the prefill chunk, the
decode step) runs under :meth:`ServeEngine._guard`.  With ``degrade`` a
recoverable failure demotes the next frozen kernel pick this engine
dispatches down the case discussion's ranking
(``DispatchCache.demote``) and retries the stage once; a second failure
poisons the stage's sequences (preempt-by-recompute).  A graph keeps the
kernels it was captured with, so a demotion synchronises the device (no
commit: ticks in flight stay in flight), sizes the workspaces for the new
picks, and captures again only the steps whose recorded dispatch triples
hold the demoted one (every step, if a workspace must grow).  The warm run
before each capture runs on scratch copies of the KV pool, the SSM state
and ``last_tok``, so a recapture leaves the live state bit for bit.  What
degradation absorbs is host-side: injected faults and a wrapper's format
error at a capture.  A CUDA runtime error (an illegal address, a launch
failure) leaves the context unusable, so it propagates as fatal and is
never demoted, as does a demotion that cannot recapture; the engine never
moves to the CPU.  The ``serve.tick`` slow fault and the
:class:`~repro_torch.runtime.faults.TickWatchdog` read the engine's clock.

**The kernel monitor** (``monitor=True`` with ``warm_kernels``, as in the
JAX engine): :class:`~repro_torch.runtime.monitor.KernelMonitor` probes the
frozen picks at the start of every ``monitor_every``-th tick, timing each
tracked triple's incumbent against a challenger on the engine's device
(``monitor_timer`` overrides the timer), and hot-swaps a pick that
``swap_patience`` windows in a row measure slower by ``swap_threshold``.
A graph keeps the kernel it captured, so after a swap of a triple this
engine dispatches the engine captures again the steps that launch it, as
a demotion does (``recaptures`` / ``recapture_log`` count both).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from ..artifacts.dispatch import DispatchKey, get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..device import DeviceLike, device_error, resolve_device
from ..kernels import flash_attention as fa
from ..kernels import matmul as mm
from ..kernels.ops import FAMILIES
from ..kernels.workspace import Workspace
from ..models import (init_paged_cache, paged_copy_block, paged_decode_step,
                      paged_prefill_step)
from ..models.config import ModelConfig
from ..models.transformer import check_block
from ..obs import ObsRegistry
from ..obs import recorder as obs
from ..obs.events import TickSpan
from ..plans.trace import chunk_lengths, trace_warm_set
from . import faults
from .faults import TickWatchdog
from .graph import CapturedStep, CudaGraph, StepGraphs
from .kv_pool import GARBAGE_BLOCK, PagedKVPool
from .monitor import KernelMonitor
from .scheduler import Request, Scheduler, SeqState, TickPlan
from .steps import freeze_traced, greedy_sample


def warm_kernel_dispatch(cfg: ModelConfig, *,
                         machine: MachineDescription = H100_SXM,
                         max_len: int = 512, max_batch: int = 8,
                         prefill_chunk: int = 32,
                         plan_store: Any = None,
                         strict_plans: bool = False) -> Dict[str, Any]:
    """Pre-resolve the kernel variants the port's serve path will ask for
    and pin them into the process cache's frozen plan, as the JAX function
    does, over the port's trace (:func:`~repro_torch.plans.trace.
    trace_warm_set`, which depends on ``max_batch`` and ``prefill_chunk``):

    - **plan-backed** first: a serve plan for (config, machine) and this
      engine's ``max_len``, ``max_batch`` and ``prefill_chunk``, looked up
      in ``plan_store`` (a :class:`~repro_torch.plans.PlanStore`; ``None``
      for the ``REPRO_ARTIFACT_DIR``-resolved store, ``False`` to skip the
      probe), is fed straight to ``DispatchCache.freeze_resolved``: no tree
      is enumerated and ``stats.cold_builds`` stays 0.  A plan whose
      dispatch-table digests no longer match this host's tables warns
      (``StalePlanWarning``) and falls through, or raises
      ``StalePlanError`` under ``strict_plans``;
    - **online** otherwise: every traced triple resolved through the tiers
      and frozen.  A triple with no feasible leaf raises: the port's model
      would dispatch it.

    Returns ``{label: {"candidate": Candidate, "rank_source": str}}``."""
    from ..plans.loader import warm_from_plan
    cache = get_default_cache()
    if plan_store is not False:
        picks = warm_from_plan(cfg, machine=machine, max_len=max_len,
                               max_batch=max_batch,
                               prefill_chunk=prefill_chunk,
                               store=plan_store or None, cache=cache,
                               strict=strict_plans)
        if picks is not None:
            return picks
    return freeze_traced(trace_warm_set(cfg, max_len=max_len,
                                        max_batch=max_batch,
                                        prefill_chunk=prefill_chunk),
                         machine)


@dataclass
class _InFlight:
    """One dispatched-but-uncommitted tick: the host slot its sampled tokens
    land in, the event after which they are there (None on the CPU), and
    the sequences they belong to.  Committing it is the pipeline's only
    host sync."""

    slot: int = 0
    event: Optional[torch.cuda.Event] = None
    seed_seq: Optional[SeqState] = None
    decode_seqs: List[SeqState] = field(default_factory=list)


class _HostSlot:
    """One in-flight tick's host memory (pinned on ``cuda``): the decode
    and prefill inputs staged for their copy in, and the sampled tokens
    copied out."""

    def __init__(self, batch: int, nblk: int, prefill_words: int,
                 pin: bool):
        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.idx = buf((batch,), torch.int32)
        self.bts = buf((batch, nblk), torch.int32)
        self.active = buf((batch,), torch.bool)
        self.prefill = buf((prefill_words,), torch.int32)
        self.seed = buf((1, 1), torch.int32)
        self.toks = buf((batch, 1), torch.int32)


@dataclass(frozen=True)
class Recapture:
    """One demotion's or swap's recapture: the tick, the triple, whether the
    workspaces had to grow (then every step was captured again), and the
    seconds each recaptured step took (its scratch warm run, capture and
    synchronise)."""

    tick: int
    triple: DispatchKey
    grew: bool
    seconds: Dict[Hashable, float]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *,
                 max_batch: int = 8, max_len: int = 512,
                 page_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32,
                 watermark_blocks: Optional[int] = None,
                 prefix_sharing: bool = False,
                 async_depth: int = 1,
                 warm_kernels: bool = False,
                 plan_store: Any = None,
                 strict_plans: bool = False,
                 monitor: bool = False,
                 monitor_window: int = 8,
                 monitor_every: int = 4,
                 swap_threshold: float = 1.25,
                 swap_patience: int = 2,
                 monitor_timer: Any = None,
                 degrade: bool = False,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 watchdog: bool = True,
                 clock: faults.Clock = faults.default_clock,
                 machine: MachineDescription = H100_SXM,
                 device: DeviceLike = None):
        if cfg.encoder is not None:
            raise ValueError("ServeEngine does not serve encoder-decoder "
                             "configs")
        if async_depth < 1:
            raise ValueError(f"async_depth must be >= 1: {async_depth}")
        check_block(cfg)
        self.device = resolve_device(device)
        pdev = params["embed"]["tok"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.machine = machine
        # graceful degradation: a recoverable failure in a guarded stage
        # demotes a frozen pick and retries once; a second one poisons the
        # stage's sequences.  Off by default, as in the JAX engine
        self.degrade = degrade
        self.deadline_ms = deadline_ms
        self.clock = clock
        self.watchdog: Optional[TickWatchdog] = (TickWatchdog() if watchdog
                                                 else None)
        # an SSM state must see every prompt token: no prompt skipping
        self.prefix_sharing = prefix_sharing and cfg.block not in (
            "ssm", "hybrid")
        self.blocks_per_seq = -(-max_len // page_size)
        if num_blocks is None:
            num_blocks = max_batch * self.blocks_per_seq + 1
        self.kernel_plan = (warm_kernel_dispatch(
            cfg, machine=machine, max_len=max_len, max_batch=max_batch,
            prefill_chunk=prefill_chunk, plan_store=plan_store,
            strict_plans=strict_plans) if warm_kernels else None)
        # the dispatch cache this engine demotes through and the registry
        # reports: captured here, so a test's private default cache keeps
        # its degrade events
        self._cache = get_default_cache()
        self._degrade_rr = 0
        # the adaptive loop over the frozen picks (off by default: a probe
        # runs kernels and waits for them), built only when warm-up froze a
        # plan, its probes on this engine's device
        self.monitor: Optional[KernelMonitor] = None
        if monitor and self.kernel_plan is not None:
            self.monitor = KernelMonitor(
                self._cache, machine=machine, window=monitor_window,
                probe_every=monitor_every, threshold=swap_threshold,
                patience=swap_patience, timer=monitor_timer)
            self.monitor.measure = dataclasses.replace(
                self.monitor.measure, device=self.device.type)
            self.monitor.track_frozen()
        # the triples this engine dispatches: the ones it may demote
        self._warm_ops = trace_warm_set(cfg, max_len=max_len,
                                        max_batch=max_batch,
                                        prefill_chunk=prefill_chunk)
        self._warm_keys = frozenset((op.family, machine.name, op.data)
                                    for op in self._warm_ops)
        self.pool = PagedKVPool(num_blocks, page_size)
        self.sched = Scheduler(self.pool, max_batch=max_batch,
                               max_len=max_len, prefill_chunk=prefill_chunk,
                               watermark_blocks=watermark_blocks,
                               prefix_sharing=self.prefix_sharing,
                               max_queue=max_queue, clock=clock)
        self.cache = init_paged_cache(cfg, num_blocks, page_size, max_batch,
                                      device=self.device)
        self.async_depth = async_depth
        self.chunk_lengths = chunk_lengths(prefill_chunk, max_len)
        # the steps' static buffers: the captured graphs read and write
        # these addresses every tick, and nothing a later step reads is
        # allocated after the first capture
        B, nblk, dev = max_batch, self.blocks_per_seq, self.device
        width = max(self.chunk_lengths)
        self.last_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self._idx = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._bts = torch.full((B, nblk), GARBAGE_BLOCK, dtype=torch.int32,
                               device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._nxt = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        # a chunk's inputs in one int32 buffer, one copy in: its block
        # table, its tokens (a chunk of length C reads the first C), then
        # start, slot and whether the chunk ends the prompt
        self._prefill_in = torch.full((nblk + width + 3,), GARBAGE_BLOCK,
                                      dtype=torch.int32, device=dev)
        self._pbt = self._prefill_in[:nblk].view(1, nblk)
        self._ptoks = self._prefill_in[nblk:nblk + width].view(1, width)
        self._pstart, self._pslot, self._pfinal = (
            self._prefill_in[nblk + width + i:nblk + width + i + 1]
            for i in range(3))
        self._pseed = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        cuda = dev.type == "cuda"
        self._slots = [_HostSlot(B, nblk, self._prefill_in.numel(), pin=cuda)
                       for _ in range(async_depth)]
        self._ticks = 0
        self._inflight: Deque[_InFlight] = collections.deque()
        self._rid = 0
        self._rejected: List[Request] = []
        self._graphs: Optional[StepGraphs] = None
        self.graph: Optional[CapturedStep] = None
        self.prefill_graphs: Dict[int, CapturedStep] = {}
        self.eager_prefills = 0
        self.capture_s = 0.0
        self.capture_times: Dict[Hashable, float] = {}
        # recaptures after demotions: steps captured again, their seconds
        self.recaptures = 0
        self.recapture_s = 0.0
        self.recapture_log: List[Recapture] = []
        if cuda:
            t0 = time.perf_counter()
            pool = torch.cuda.graph_pool_handle()
            self._capture(StepGraphs(lambda: CudaGraph(pool)))
            self.capture_s = time.perf_counter() - t0

    def _workspace_needs(self) -> List[Tuple[Workspace, int]]:
        """What every launch of the serve path needs of the split
        workspaces (the traced warm set at the picks it resolves to now:
        K1's split-K at each projection, E times that at the experts' batched
        launches, K2's splits over the pool at decode's max_batch rows and a
        chunk's one row)."""
        keys = self.blocks_per_seq * self.page_size
        needs: List[Tuple[Workspace, int]] = []
        for op in self._warm_ops:
            data = op.data_dict()
            a = self._cache.best_variant(FAMILIES[op.family], self.machine,
                                         data).assignment
            if op.family == "matmul_h100":
                floats, tiles = mm.workspace_need(
                    data["M"], data["N"], experts=op.experts(self.cfg), **a)
                needs += [(mm.PARTIALS, floats), (mm.TICKETS, tiles)]
            elif op.family == "flash_attention_h100":
                rows = self.max_batch if data["SQ"] == 1 else 1
                needs.append((fa.PARTIALS, fa.workspace_need(
                    rows, data["GROUP"] * data["HK"], data["SQ"], keys,
                    data["HD"], a["kv_chunk"])))
        return needs

    def _reserve_workspaces(self) -> None:
        """Size the split workspaces for every launch the serve path makes,
        before a graph holds them."""
        for ws, n in self._workspace_needs():
            ws.get(self.device, n)

    @contextlib.contextmanager
    def _scratch_state(self):
        """Point the steps' state (the KV pool, the SSM state and
        ``last_tok``) at zeroed scratch copies for the duration: a warm run
        then writes no live state."""
        live = self.cache, self.last_tok
        self.cache = {k: torch.zeros_like(v) for k, v in live[0].items()}
        self.last_tok = torch.zeros_like(live[1])
        try:
            yield
        finally:
            self.cache, self.last_tok = live

    def _warm(self, body) -> None:
        """Run ``body`` once eagerly on scratch state (on the card on a
        side stream, as ``torch.cuda.graph`` wants a capture warmed): it
        resolves every kernel entry and shared-memory opt-in of the step
        before its capture."""
        if self.device.type != "cuda":
            with self._scratch_state():
                body()
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), self._scratch_state():
            body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _capture(self, graphs: StepGraphs) -> None:
        """Size the workspaces, then capture the decode step and one
        prefill step a chunk length into ``graphs``, each after a warm run
        on scratch state; each capture's time (with its warm run) goes
        into ``capture_times``."""
        self._reserve_workspaces()
        self._graphs = graphs
        bodies = [("decode", self._decode_body)] + [
            (C, functools.partial(self._prefill_body, C))
            for C in self.chunk_lengths]
        for key, body in bodies:
            t0 = time.perf_counter()
            self._warm(body)
            graphs.capture(key, body)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.capture_times[key] = time.perf_counter() - t0
        self.graph = graphs.steps["decode"]
        self.prefill_graphs = {C: graphs.steps[C]
                               for C in self.chunk_lengths}

    def _recapture(self, triple: DispatchKey) -> Recapture:
        """After ``triple``'s frozen pick was demoted or swapped:
        synchronise (ticks in flight stay in flight), size the workspaces
        for the new picks and capture again the steps whose recorded
        triples hold ``triple`` — every step if a workspace must grow
        (their graphs are dropped first).  Each capture follows a warm run
        on scratch state, so the live state is left bit for bit.  A
        capture that fails raises (the graphs are released: no step falls
        back)."""
        graphs = self._graphs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        keys = [k for k, s in graphs.steps.items() if triple in s.triples]
        grew = any(n > ws.size(self.device)
                   for ws, n in self._workspace_needs())
        if grew:
            graphs.regrow(self._reserve_workspaces)
            keys = list(graphs.steps)
        seconds: Dict[Hashable, float] = {}
        for key in keys:
            t0 = time.perf_counter()
            step = graphs.steps[key]
            self._warm(step.fn)
            graphs.recapture(key)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds[key] = time.perf_counter() - t0
        rec = Recapture(tick=self.sched.ticks, triple=triple, grew=grew,
                        seconds=seconds)
        self.recaptures += len(seconds)
        self.recapture_s += sum(seconds.values())
        self.recapture_log.append(rec)
        return rec

    def _decode_body(self) -> None:
        """The decode step on the static buffers, the JAX ``_decode``: what
        the graph captures on ``cuda`` and the CPU runs eagerly."""
        logits, _ = paged_decode_step(self.params, self.cfg, self.last_tok,
                                      self.cache, self._idx, self._bts,
                                      active=self._active)
        nxt = greedy_sample(logits)
        self._nxt.copy_(nxt)
        # chain last_tok on the device: decoding rows advance to their
        # sampled token, every other row keeps its value
        self.last_tok.copy_(torch.where(self._active[:, None], nxt,
                                        self.last_tok))

    def _prefill_body(self, C: int) -> None:
        """One prefill chunk of length ``C`` on the static buffers, the JAX
        ``_prefill``: the chunk, its last token sampled into ``_pseed`` and,
        on the chunk that ends the prompt, set into ``last_tok[slot]``; what
        a graph captures for each C on ``cuda`` and the CPU runs eagerly."""
        logits, _ = paged_prefill_step(
            self.params, self.cfg, self._ptoks[:, :C], self.cache,
            self._pstart, self._pbt, self._pslot)
        tok = greedy_sample(logits)
        self._pseed.copy_(tok)
        rows = self._pslot.long()
        keep = self.last_tok.index_select(0, rows)
        self.last_tok.index_copy_(0, rows, torch.where(
            (self._pfinal != 0)[:, None], tok, keep))

    def close(self) -> None:
        """Release the captured graphs (and with them the workspaces, which
        may then grow for another engine)."""
        if self._graphs is not None:
            self._graphs.release()
            self._graphs = None
        self.graph = None
        self.prefill_graphs = {}

    # -- client API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16,
               eos: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Queue a request; returns its rid.  Malformed input raises a
        :class:`~repro_torch.runtime.scheduler.RequestError`; a request shed
        by ``max_queue`` comes back done from a later :meth:`step`."""
        self._rid += 1
        ms = deadline_ms if deadline_ms is not None else self.deadline_ms
        deadline = (self.clock() + ms / 1000.0) if ms is not None else None
        req = Request(self._rid, np.asarray(prompt, np.int32), max_new, eos,
                      deadline=deadline)
        if self.sched.submit(req) is not None:
            self._rejected.append(req)
        return self._rid

    # -- tick execution -------------------------------------------------------
    def step(self) -> List[Request]:
        """One engine tick: plan + dispatch the next tick, then commit the
        oldest in-flight tick(s) down to the pipeline depth.  At
        ``async_depth=1`` the dispatched tick commits at once (synchronous
        engine); at depth ``d`` the newest ``d − 1`` ticks stay in flight
        across the return.  The tick's duration on the engine's clock
        feeds the watchdog and, with tracing on, one ``TickSpan``."""
        faults.set_tick(self.sched.ticks)
        obs.set_tick(self.sched.ticks)
        orec = obs.get_recorder()
        timed = self.watchdog is not None or orec is not None
        t0 = self.clock() if timed else 0.0
        done: List[Request] = []
        if self._rejected:
            done.extend(self._rejected)
            self._rejected.clear()
        if self.monitor is not None:
            self._monitor_tick()
        tick = self.sched.ticks
        plan = self.sched.tick()
        done.extend(plan.cancelled)
        self._dispatch(plan)
        while len(self._inflight) > self.async_depth - 1:
            done.extend(self._commit(self._inflight.popleft()))
        if timed:
            dt = self.clock() - t0
            spec = faults.maybe_fault("serve.tick")
            if spec is not None and spec.kind == "slow":
                dt += spec.arg / 1e6         # injected hang, in microseconds
            if self.watchdog is not None:
                self.watchdog.observe(dt, tick)
            if orec is not None:
                orec.emit(TickSpan(
                    tick=tick, admitted=len(plan.admitted),
                    prefill_tokens=(plan.prefill[2]
                                    if plan.prefill is not None else 0),
                    decode_rows=len(plan.decode),
                    preempted=len(plan.preempted),
                    cancelled=len(plan.cancelled), finished=len(done),
                    duration_us=dt * 1e6))
        return done

    def _monitor_tick(self) -> None:
        """The monitor's tick (one modulo check on a tick without a probe);
        under graphs, each swap of a triple this engine dispatches captures
        again the steps that launch it (every step if a workspace must
        grow), as a demotion does."""
        swapped = len(self.monitor.events)
        self.monitor.on_tick(self.sched.ticks)
        if self._graphs is None:
            return
        for ev in self.monitor.events[swapped:]:
            key = (ev.family, self.machine.name, ev.data)
            if key in self._warm_keys:
                self._recapture(key)

    def _guard(self, site: str, seqs: Tuple[SeqState, ...], fn, *args):
        """Run one guarded tick stage: consult the fault injector, then the
        stage.  With ``degrade`` a recoverable failure demotes the next
        frozen pick (:meth:`_demote_next`) and retries the stage once; a
        second failure poisons ``seqs`` (preempt-by-recompute) and returns
        ``None``.  Without ``degrade``, on a :class:`~repro_torch.runtime.
        faults.FatalFault` or on an error of the CUDA runtime the exception
        propagates, the partial tick kept drainable by :meth:`_dispatch`."""
        try:
            faults.maybe_fault(site)
            return fn(*args)
        except faults.FatalFault:
            raise
        except Exception as e:               # noqa: BLE001 — degrade surface
            if not self.degrade or device_error(e):
                raise
            self._demote_next(e)
            try:
                faults.maybe_fault(site)
                return fn(*args)
            except faults.FatalFault:
                raise
            except Exception as e2:          # noqa: BLE001 — second strike
                if device_error(e2):
                    raise
                for seq in seqs:
                    self.sched.poison(seq)
                return None

    def _demote_next(self, error: Exception) -> None:
        """Fall one frozen pick this engine dispatches down its ranking
        (round-robin over them: a failed batched step names no kernel) and,
        under graphs, capture again the steps that launch it.  A no-op
        without a frozen plan."""
        plan = self._cache.frozen_plan
        keyed = [((f.name, m.name, tuple(sorted(
            (k, int(v)) for k, v in d.items()))), (f, m, d))
            for f, m, d in (plan.triples if plan else ())]
        keyed = [(key, t) for key, t in keyed if key in self._warm_keys]
        if not keyed:
            return
        key, (fam, mach, data) = keyed[self._degrade_rr % len(keyed)]
        self._degrade_rr += 1
        self._cache.demote(fam, mach, data, error=error,
                           tick=self.sched.ticks)
        if self._graphs is not None:
            self._recapture(key)

    def _dispatch(self, plan: TickPlan) -> None:
        """Enqueue one tick plan: the admissions' slot resets, then under
        :meth:`_guard` the CoW copies, at most one prefill chunk and the
        batched decode, each step its inputs' copy in from the tick's host
        slot and a graph replay, then the copies of the sampled tokens to
        the host slot; record it as in flight.  No host sync: positions
        advance speculatively (note_prefill / note_decode, each after its
        stage succeeded), outputs land at commit.  A stage that fails
        twice poisons its sequences and is skipped, so later stages
        re-check ``dead``; the in-flight record is appended even when a
        fatal error aborts the tick, so what was dispatched still
        commits and the engine stays drainable."""
        for seq in plan.admitted:
            self.last_tok[seq.slot] = 0
            if "ssm" in self.cache:
                self.cache["ssm"][:, seq.slot] = 0.0
        # the slot's last user, async_depth ticks ago, has been committed
        rec = _InFlight(slot=self._ticks % self.async_depth)
        self._ticks += 1
        host = self._slots[rec.slot]
        launched = False
        try:
            for (src, dst), owner in zip(plan.cow, plan.cow_owners):
                # copy shared blocks BEFORE this tick writes into them;
                # other owners keep reading the original
                self._guard("serve.cow", (owner,), paged_copy_block,
                            self.cache, src, dst)
            if plan.prefill is not None and not plan.prefill[0].dead:
                seq, start, chunk = plan.prefill
                if self._graphs is not None and \
                        chunk not in self.prefill_graphs:
                    raise RuntimeError(
                        f"no prefill graph for a chunk of {chunk} tokens: "
                        f"the engine captured {self.chunk_lengths}")
                final = start + chunk >= len(seq.target)
                if self._guard("serve.prefill", (seq,), self._prefill_stage,
                               host, seq, start, chunk, final) is not None:
                    launched = True
                    self.sched.note_prefill(seq, chunk)
                    if final:
                        # the final chunk's last-token logits seed decode
                        host.seed.copy_(self._pseed, non_blocking=True)
                        rec.seed_seq = seq
            decoding = [s for s in plan.decode if not s.dead]
            if decoding and self._guard("serve.decode", tuple(decoding),
                                        self._decode_stage, host,
                                        decoding) is not None:
                launched = True
                for seq in decoding:
                    self.sched.note_decode(seq)
                rec.decode_seqs = decoding
        finally:
            if self.device.type == "cuda" and launched:
                # also after a chunk with nothing to read back: the slot's
                # staging is rewritten only once its copy in has run
                rec.event = torch.cuda.Event()
                rec.event.record()
            self._inflight.append(rec)

    def _prefill_stage(self, host: _HostSlot, seq: SeqState, start: int,
                       chunk: int, final: bool) -> bool:
        """Stage one prefill chunk's inputs in the host slot, copy them in
        and replay its length's graph (on the CPU without graphs, run its
        body)."""
        graph = self.prefill_graphs.get(chunk)
        nblk = self.blocks_per_seq
        buf = host.prefill.numpy()
        buf[:nblk] = GARBAGE_BLOCK
        buf[:len(seq.blocks)] = seq.blocks
        buf[nblk:nblk + chunk] = seq.target[start:start + chunk]
        buf[-3:] = (start, seq.slot, final)
        self._prefill_in.copy_(host.prefill, non_blocking=True)
        if graph is not None:
            graph()
        else:
            self._prefill_body(chunk)
            self.eager_prefills += 1
        return True

    def _decode_stage(self, host: _HostSlot,
                      decoding: List[SeqState]) -> bool:
        """Stage the decode rows' inputs in the host slot, copy them in,
        replay the decode graph (on the CPU without graphs, run its body)
        and copy the sampled tokens out to the host slot."""
        bts = host.bts.numpy()
        idx = host.idx.numpy()
        active = host.active.numpy()
        bts.fill(GARBAGE_BLOCK)
        idx.fill(0)
        active.fill(False)
        for seq in decoding:
            bts[seq.slot, :len(seq.blocks)] = seq.blocks
            idx[seq.slot] = seq.pos
            active[seq.slot] = True
        self._bts.copy_(host.bts, non_blocking=True)
        self._idx.copy_(host.idx, non_blocking=True)
        self._active.copy_(host.active, non_blocking=True)
        if self.graph is not None:
            self.graph()
        else:
            self._decode_body()
        host.toks.copy_(self._nxt, non_blocking=True)
        return True

    def _commit(self, rec: _InFlight) -> List[Request]:
        """Commit barrier: wait for one tick's sampled tokens (the
        pipeline's only host sync), append them to request outputs —
        skipping sequences preempted (dead: greedy recompute regenerates
        their tokens) or already finished (EOS found by an earlier commit:
        later speculative tokens are discarded) — then reconcile EOS /
        ``max_new`` and retire."""
        if rec.event is not None:
            rec.event.synchronize()
        host = self._slots[rec.slot]
        seq = rec.seed_seq
        if seq is not None and not seq.dead and not seq.req.done:
            seq.req.out.append(int(host.seed[0, 0]))
        if rec.decode_seqs:
            nxt = host.toks.numpy()
            for seq in rec.decode_seqs:
                if seq.dead or seq.req.done:
                    continue
                seq.req.out.append(int(nxt[seq.slot, 0]))
        return self._retire()

    def _retire(self) -> List[Request]:
        done = []
        for seq in list(self.sched.running()):
            if seq.prefilling:
                continue
            req = seq.req
            if req.eos is not None and req.eos in req.out:
                req.out = req.out[:req.out.index(req.eos) + 1]
                req.done = True
            elif len(req.out) >= req.max_new:
                req.out = req.out[:req.max_new]
                req.done = True
            if req.done:
                done.append(req)
                self.sched.retire(seq)
        return done

    # -- observability --------------------------------------------------------
    def registry(self) -> ObsRegistry:
        """This engine's metrics registry: pool, scheduler, dispatch cache
        and watchdog (and the flight recorder when one is installed) behind
        one ``snapshot()`` / ``render_text()`` / ``summary_line()``."""
        return ObsRegistry.from_engine(self)

    @property
    def degrade_events(self):
        """The dispatch cache's recorded :class:`~repro_torch.artifacts.
        dispatch.DegradeEvent`s (this engine demotes through its captured
        cache)."""
        return self._cache.degrade_events

    def robustness_line(self) -> str:
        s = self.sched.stats
        line = (f"robustness shed={s.shed} cancelled={s.cancelled} "
                f"poisoned={s.poisoned} "
                f"demotions={self._cache.stats.demotions} "
                f"recaptures={self.recaptures}")
        if self.watchdog is not None:
            line += " | " + self.watchdog.stats_line()
        return line

    def run_until_drained(self, max_ticks: int = 1000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_ticks):
            finished.extend(self.step())
            if not self.sched.has_work():
                break
        # drain the pipeline: ticks still in flight when the queue empties
        # carry the final tokens of the last requests
        while self._inflight:
            finished.extend(self._commit(self._inflight.popleft()))
        return finished
