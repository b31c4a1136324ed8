"""Paged serving engine of the port: block KV pool + chunked prefill +
kernel dispatch frozen at start.

The port of ``runtime/serving.py`` at what the serve launcher's defaults
use: one synchronous tick at a time (``async_depth=1``), a paged KV pool
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
retire).  Prefix sharing, async depth 2, the kernel monitor, degradation,
serve-plan artifacts and tracing are later slices of the port and are
refused by name.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..device import DeviceLike, resolve_device
from ..kernels.ops import FAMILIES
from ..models import (init_paged_cache, paged_copy_block, paged_decode_step,
                      paged_prefill_chunk)
from ..models.config import ModelConfig
from ..plans.trace import trace_warm_set
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
                 trace: bool = False,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 clock: Clock = time.monotonic,
                 machine: MachineDescription = H100_SXM,
                 device: DeviceLike = None):
        refused = [
            (prefix_sharing, "prefix_sharing", "the prefix-sharing slice"),
            (async_depth != 1, f"async_depth={async_depth}",
             "the async-overlap slice"),
            (monitor, "monitor", "the adaptive-loop slice (CUDA-event "
             "timer)"),
            (degrade, "degrade", "the fault-tolerance slice"),
            (plan_store is not None or strict_plans, "plan_store",
             "the serve-plan artifact slice"),
            (trace, "trace", "the observability slice"),
        ]
        for on, what, slice_name in refused:
            if on:
                raise NotImplementedError(
                    f"ServeEngine({what}) is not ported yet: it comes with "
                    f"{slice_name} of the port")
        if cfg.block != "attn_mlp" or cfg.encoder is not None:
            raise NotImplementedError(
                f"block {cfg.block!r} is not ported yet")
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
        self.pool = PagedKVPool(num_blocks, page_size)
        self.sched = Scheduler(self.pool, max_batch=max_batch,
                               max_len=max_len, prefill_chunk=prefill_chunk,
                               watermark_blocks=watermark_blocks,
                               max_queue=max_queue, clock=clock)
        self.cache = init_paged_cache(cfg, num_blocks, page_size, max_batch,
                                      device=self.device)
        self.last_tok = torch.zeros((max_batch, 1), dtype=torch.int32,
                                    device=self.device)
        self._rid = 0
        self._rejected: List[Request] = []

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
    def _block_table(self, seq: SeqState) -> np.ndarray:
        bt = np.full(self.blocks_per_seq, GARBAGE_BLOCK, np.int32)
        bt[:len(seq.blocks)] = seq.blocks
        return bt

    def step(self) -> List[Request]:
        """One engine tick: plan, dispatch, commit."""
        done: List[Request] = []
        if self._rejected:
            done.extend(self._rejected)
            self._rejected.clear()
        plan = self.sched.tick()
        done.extend(plan.cancelled)
        seed, decoding, toks = self._dispatch(plan)
        done.extend(self._commit(seed, decoding, toks))
        return done

    def _dispatch(self, plan: TickPlan):
        for seq in plan.admitted:
            self.last_tok[seq.slot] = 0
        for src, dst in plan.cow:
            paged_copy_block(self.cache, src, dst)
        seed = None
        if plan.prefill is not None and not plan.prefill[0].dead:
            seq, start, chunk = plan.prefill
            logits, self.cache = paged_prefill_chunk(
                self.params, self.cfg, seq.target[None, start:start + chunk],
                self.cache, start, self._block_table(seq)[None], seq.slot)
            self.sched.note_prefill(seq, chunk)
            if not seq.prefilling:
                # final chunk: its last-token logits seed decode
                tok = greedy_sample(logits)
                self.last_tok[seq.slot] = tok[0]
                seed = (seq, tok)
        decoding = [s for s in plan.decode if not s.dead]
        toks = None
        if decoding:
            bts = np.full((self.max_batch, self.blocks_per_seq),
                          GARBAGE_BLOCK, np.int32)
            idx = np.zeros(self.max_batch, np.int32)
            mask = np.zeros(self.max_batch, bool)
            for seq in decoding:
                bts[seq.slot, :len(seq.blocks)] = seq.blocks
                idx[seq.slot] = seq.pos
                mask[seq.slot] = True
            logits, self.cache = paged_decode_step(
                self.params, self.cfg, self.last_tok, self.cache, idx, bts,
                active=mask)
            toks = greedy_sample(logits)
            m = torch.as_tensor(mask, device=self.device)[:, None]
            self.last_tok = torch.where(m, toks, self.last_tok)
            for seq in decoding:
                self.sched.note_decode(seq)
        return seed, decoding, toks

    def _commit(self, seed, decoding: List[SeqState],
                toks: Optional[torch.Tensor]) -> List[Request]:
        """Commit barrier: the tick's one host sync."""
        if seed is not None:
            seq, tok = seed
            if not seq.dead and not seq.req.done:
                seq.req.out.append(int(tok.cpu()[0, 0]))
        if decoding:
            nxt = toks.cpu().numpy()
            for seq in decoding:
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

    def run_until_drained(self, max_ticks: int = 1000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_ticks):
            finished.extend(self.step())
            if not self.sched.has_work():
                break
        return finished
