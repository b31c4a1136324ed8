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
retire).  It serves the ``attn_mlp``, ``ssm`` and ``hybrid`` blocks; a
slot's SSM state is zeroed when a sequence is admitted to it, as the JAX
``_reset_slot`` does.

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
eagerly, before any admission; those runs write only the garbage block and
slot 0's SSM state, which its first admission zeroes.  A tick then copies
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

Prefix sharing, the kernel monitor, degradation and serve-plan artifacts
are later slices of the port and are refused by name (the JAX engine turns
prefix sharing off for SSM blocks in any case: their state must see every
prompt token).
"""
from __future__ import annotations

import collections
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Hashable, List, Optional

import numpy as np
import torch

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..device import DeviceLike, resolve_device
from ..kernels import flash_attention as fa
from ..kernels import matmul as mm
from ..kernels.ops import FAMILIES, select
from ..models import (init_paged_cache, paged_copy_block, paged_decode_step,
                      paged_prefill_step)
from ..models.config import ModelConfig
from ..models.transformer import check_block
from ..obs import ObsRegistry
from ..obs import recorder as obs
from ..obs.events import TickSpan
from ..plans.trace import chunk_lengths, trace_warm_set
from .graph import CapturedStep, CudaGraph, StepGraphs
from .kv_pool import GARBAGE_BLOCK, PagedKVPool
from .scheduler import Clock, Request, Scheduler, SeqState, TickPlan
from .steps import greedy_sample


def warm_kernel_dispatch(cfg: ModelConfig, *,
                         machine: MachineDescription = H100_SXM,
                         max_len: int = 512, max_batch: int = 8,
                         prefill_chunk: int = 32) -> Dict[str, Any]:
    """Pre-resolve the kernel variants the port's serve path will ask for
    (the online path of the JAX function; serve-plan artifacts are a later
    slice) and pin them into the process cache's frozen plan.  A triple with
    no feasible leaf raises: the port's model would dispatch it.

    Returns ``{label: {"candidate": Candidate, "rank_source": str}}``."""
    ops = trace_warm_set(cfg, max_len=max_len, max_batch=max_batch,
                         prefill_chunk=prefill_chunk)
    plan = get_default_cache().freeze(
        [(FAMILIES[op.family], machine, op.data_dict()) for op in ops])
    picks: Dict[str, Any] = {}
    for op in ops:
        ent = plan.get(op.family, machine.name, op.data_dict())
        picks[op.label] = {"candidate": ent.candidate,
                           "rank_source": ent.source}
    return picks


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
                 degrade: bool = False,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 clock: Clock = time.monotonic,
                 machine: MachineDescription = H100_SXM,
                 device: DeviceLike = None):
        if async_depth < 1:
            raise ValueError(f"async_depth must be >= 1: {async_depth}")
        refused = [
            (prefix_sharing, "prefix_sharing", "the prefix-sharing slice"),
            (monitor, "monitor", "the adaptive-loop slice (CUDA-event "
             "timer)"),
            (degrade, "degrade", "the fault-tolerance slice"),
            (plan_store is not None or strict_plans, "plan_store",
             "the serve-plan artifact slice"),
        ]
        for on, what, slice_name in refused:
            if on:
                raise NotImplementedError(
                    f"ServeEngine({what}) is not ported yet: it comes with "
                    f"{slice_name} of the port")
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
        self.machine = machine
        self.deadline_ms = deadline_ms
        self.clock = clock
        self.blocks_per_seq = -(-max_len // page_size)
        if num_blocks is None:
            num_blocks = max_batch * self.blocks_per_seq + 1
        self.kernel_plan = (warm_kernel_dispatch(
            cfg, machine=machine, max_len=max_len, max_batch=max_batch,
            prefill_chunk=prefill_chunk) if warm_kernels else None)
        # the dispatch cache the registry reports
        self._cache = get_default_cache()
        self.pool = PagedKVPool(num_blocks, page_size)
        self.sched = Scheduler(self.pool, max_batch=max_batch,
                               max_len=max_len, prefill_chunk=prefill_chunk,
                               watermark_blocks=watermark_blocks,
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
        if cuda:
            t0 = time.perf_counter()
            self._reserve_workspaces(prefill_chunk)
            pool = torch.cuda.graph_pool_handle()
            self._capture(StepGraphs(lambda: CudaGraph(pool)))
            self.capture_s = time.perf_counter() - t0

    def _reserve_workspaces(self, prefill_chunk: int) -> None:
        """Size the split workspaces for every launch the serve path makes
        (the traced warm set at the picks it resolves to: K1's split-K at
        each projection, K2's splits over the pool at decode's max_batch
        rows and a chunk's one row), before a graph holds them."""
        keys = self.blocks_per_seq * self.page_size
        for op in trace_warm_set(self.cfg, max_len=self.max_len,
                                 max_batch=self.max_batch,
                                 prefill_chunk=prefill_chunk):
            data = op.data_dict()
            a = select(op.family, data, self.machine).assignment
            if op.family == "matmul_h100":
                floats, tiles = mm.workspace_need(data["M"], data["N"], **a)
                mm.PARTIALS.get(self.device, floats)
                mm.TICKETS.get(self.device, tiles)
            elif op.family == "flash_attention_h100":
                rows = self.max_batch if data["SQ"] == 1 else 1
                fa.PARTIALS.get(self.device, fa.workspace_need(
                    rows, data["GROUP"] * data["HK"], data["SQ"], keys,
                    data["HD"], a["kv_chunk"]))

    def _capture(self, graphs: StepGraphs) -> None:
        """Capture the decode step, then one prefill step a chunk length,
        into ``graphs``; each capture's time (with its eager run) goes into
        ``capture_times``.  Before each capture the body runs once eagerly
        (on the card on a side stream, as ``torch.cuda.graph`` wants it
        warmed), which resolves every kernel entry and shared-memory
        opt-in.  These runs come before any admission, with every decode
        row inactive and the prefill buffers at slot 0, offset 0 and a
        table of garbage blocks: they write only the garbage block and slot
        0's SSM state, which the first admission to slot 0 zeroes, and
        leave ``last_tok`` as it is."""
        cuda = self.device.type == "cuda"
        self._graphs = graphs
        bodies = [("decode", self._decode_body)] + [
            (C, functools.partial(self._prefill_body, C))
            for C in self.chunk_lengths]
        for key, body in bodies:
            t0 = time.perf_counter()
            if cuda:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    body()
                torch.cuda.current_stream(self.device).wait_stream(side)
            else:
                body()
            graphs.capture(key, body)
            if cuda:
                torch.cuda.synchronize(self.device)
            self.capture_times[key] = time.perf_counter() - t0
        self.graph = graphs.steps["decode"]
        self.prefill_graphs = {C: graphs.steps[C]
                               for C in self.chunk_lengths}

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
        across the return.  With tracing on, one ``TickSpan`` a tick, its
        duration on the engine's clock."""
        obs.set_tick(self.sched.ticks)
        orec = obs.get_recorder()
        t0 = self.clock() if orec is not None else 0.0
        done: List[Request] = []
        if self._rejected:
            done.extend(self._rejected)
            self._rejected.clear()
        tick = self.sched.ticks
        plan = self.sched.tick()
        done.extend(plan.cancelled)
        self._dispatch(plan)
        while len(self._inflight) > self.async_depth - 1:
            done.extend(self._commit(self._inflight.popleft()))
        if orec is not None:
            dt = self.clock() - t0
            orec.emit(TickSpan(
                tick=tick, admitted=len(plan.admitted),
                prefill_tokens=(plan.prefill[2]
                                if plan.prefill is not None else 0),
                decode_rows=len(plan.decode),
                preempted=len(plan.preempted),
                cancelled=len(plan.cancelled), finished=len(done),
                duration_us=dt * 1e6))
        return done

    def _dispatch(self, plan: TickPlan) -> None:
        """Enqueue one tick plan: the admissions' slot resets, the CoW
        copies, at most one prefill chunk and the batched decode, each step
        its inputs' copy in from the tick's host slot and a graph replay,
        then the copies of the sampled tokens to the host slot; record it
        as in flight.  No host sync: positions advance speculatively
        (note_prefill / note_decode), outputs land at commit."""
        for seq in plan.admitted:
            self.last_tok[seq.slot] = 0
            if "ssm" in self.cache:
                self.cache["ssm"][:, seq.slot] = 0.0
        for src, dst in plan.cow:
            paged_copy_block(self.cache, src, dst)
        # the slot's last user, async_depth ticks ago, has been committed
        rec = _InFlight(slot=self._ticks % self.async_depth)
        self._ticks += 1
        host = self._slots[rec.slot]
        launched = False
        if plan.prefill is not None and not plan.prefill[0].dead:
            seq, start, chunk = plan.prefill
            graph = self.prefill_graphs.get(chunk)
            if self._graphs is not None and graph is None:
                raise RuntimeError(
                    f"no prefill graph for a chunk of {chunk} tokens: the "
                    f"engine captured {self.chunk_lengths}")
            self.sched.note_prefill(seq, chunk)
            final = not seq.prefilling
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
            if final:
                # the final chunk's last-token logits seed decode
                host.seed.copy_(self._pseed, non_blocking=True)
                rec.seed_seq = seq
            launched = True
        decoding = [s for s in plan.decode if not s.dead]
        if decoding:
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
            for seq in decoding:
                self.sched.note_decode(seq)
            rec.decode_seqs = decoding
            launched = True
        if self.device.type == "cuda" and launched:
            # also after a chunk with nothing to read back: the slot's
            # staging is rewritten only once its copy in has run
            rec.event = torch.cuda.Event()
            rec.event.record()
        self._inflight.append(rec)

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
        """This engine's metrics registry: pool, scheduler and dispatch
        cache (and the flight recorder when one is installed) behind one
        ``snapshot()`` / ``render_text()`` / ``summary_line()``."""
        return ObsRegistry.from_engine(self)

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
