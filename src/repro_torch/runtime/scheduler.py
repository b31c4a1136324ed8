"""Host-side async serving scheduler: admission, chunked prefill, preemption.

``ServeEngine`` delegates every *decision* to :class:`Scheduler.tick`,
which returns a :class:`TickPlan` of tensor work to perform; the engine
only executes it.  One tick is one engine dispatch:

1. **decode-priority block top-up** — every sequence in decode owns the KV
   block its next token writes into before anything else runs; when the
   pool is exhausted, the *youngest-admitted* running sequence is preempted
   by eviction (its blocks return to the pool, its request re-enters the
   queue front for recompute — generated tokens are kept and re-prefilled
   as part of the prompt).  A write block that is *shared* (refcount > 1:
   prefix-mapped by another sequence or pinned by the prefix index) is
   replaced copy-on-write: a fresh block is allocated, the tick plan
   records a device-side block copy, and only the private copy is written.
2. **admission control** — strict FIFO.  A request is admitted only when a
   decode-batch slot is free AND the pool has head-room for its whole
   prompt plus one decode block plus a watermark of ``watermark_blocks``
   (default ``max_batch``: one block of decode head-room per potential
   decode row).  With ``prefix_sharing`` the pool's prefix index is probed
   first: prompt blocks already resident (from a live or recently-retired
   sequence) are *mapped* instead of recomputed — they join the block
   table at an elevated refcount, prefill starts past them, and head-room
   only has to cover the unmatched tail.  Idle cached blocks count toward
   head-room (the allocator reclaims them LRU on demand).
3. **chunked prefill** — at most one prompt chunk per tick (the oldest
   admitted sequence still prefilling), so prefill work is interleaved
   with decode steps and decode latency stays bounded under prompt
   bursts.  Chunk lengths are quantized (full ``prefill_chunk``-sized
   chunks, then a power-of-two decomposition of the remainder) so the
   compiled chunk-shape set is O(log ``prefill_chunk``) instead of one
   shape per prompt length.  Shared blocks in the chunk's write range are
   CoW-replaced exactly like decode write blocks; as each *full* block of
   the target fills, it is registered in the prefix index for future
   requests to map.

The scheduler plans against **dispatch-time** state: ``note_prefill`` /
``note_decode`` advance ``filled``/``pos`` when work is *dispatched*, not
when it completes, so under async overlap (engine ``async_depth > 1``) the
next tick is planned against positions the in-flight tick is already
writing.  Committed *outputs* (``req.out``) land later, at the engine's
commit barrier; the **dispatch guard** below keeps speculation bounded:
a sequence stops decoding once the outputs it has in flight reach its
``max_new`` budget (EOS is only detectable at commit, so a sequence may
overshoot an EOS by up to the pipeline depth — commit truncates).

Starvation bound: FIFO admission + oldest-first prefill + decode running
every tick give every admitted sequence progress within
:meth:`Scheduler.progress_bound` ticks (tests assert it).  Preemption
resets a sequence's clock — it re-enters at the queue *front* (it is by
construction older than everything still queued, so global FIFO order is
preserved) — and marks the evicted ``SeqState`` **dead** so the engine
discards its uncommitted in-flight tokens (greedy decode regenerates them
deterministically after re-admission).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from ..obs import recorder as obs
from ..obs.events import AdmissionDecision
from .kv_pool import PREFIX_ROOT, PagedKVPool

Clock = Callable[[], float]


class RequestError(ValueError):
    """Structured per-request failure: what was rejected and why.

    Subclasses ``ValueError`` so pre-existing callers (and tests) that
    catch the scheduler's validation errors keep working.  Carries a
    machine-readable ``code`` — ``"too_long"`` / ``"over_capacity"`` /
    ``"empty_prompt"`` / ``"bad_max_new"`` (validation, raised from
    ``submit``), ``"queue_full"`` (load shed, *returned*, never raised) or
    ``"deadline"`` (TTL cancellation, attached to the request at tick
    time) — plus a ``retry_after_ticks`` hint where retrying can help
    (shed/deadline) and ``None`` where it cannot (validation)."""

    def __init__(self, code: str, message: str, *, rid: Optional[int] = None,
                 retry_after_ticks: Optional[int] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.rid = rid
        self.retry_after_ticks = retry_after_ticks

    def __repr__(self) -> str:
        return (f"RequestError({self.code!r}, rid={self.rid}, "
                f"retry_after_ticks={self.retry_after_ticks})")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # (S,) int32
    max_new: int = 16
    eos: Optional[int] = None
    out: List[int] = field(default_factory=list)
    done: bool = False
    #: absolute deadline on the scheduler's clock (None: no TTL).  Expired
    #: requests are cancelled at tick time — queued or running — keeping
    #: whatever output already committed.
    deadline: Optional[float] = None
    #: structured failure when the request ended abnormally (shed,
    #: cancelled, rejected); ``done`` is True whenever this is set.
    error: Optional[RequestError] = None


@dataclass
class SeqState:
    """One admitted sequence: its request plus pool/slot bookkeeping."""

    req: Request
    slot: int
    target: np.ndarray                   # tokens to prefill (prompt [+ out])
    admitted_at: int
    last_progress: int
    blocks: List[int] = field(default_factory=list)
    filled: int = 0                      # prefilled positions (dispatched)
    pos: int = 0                         # cache positions written (dispatched)
    prompt_len: int = 0                  # len(req.prompt) at admission
    chain_hash: int = PREFIX_ROOT        # prefix-index chain over registered
    registered: int = 0                  # full target blocks registered
    dead: bool = False                   # preempted: drop uncommitted tokens

    @property
    def prefilling(self) -> bool:
        return self.filled < len(self.target)

    @property
    def dispatched_out(self) -> int:
        """Output tokens dispatched (committed + in flight): the prefill
        seed token plus one per decode dispatch."""
        if self.prefilling:
            return len(self.target) - self.prompt_len
        return self.pos - self.prompt_len + 1


@dataclass
class SchedStats:
    admissions: int = 0
    preemptions: int = 0
    prefill_chunks: int = 0
    prefill_tokens: int = 0              # token positions actually computed
    decode_ticks: int = 0
    admission_waits: int = 0             # head-of-line blocked on head-room
    shed: int = 0                        # submits refused by the queue bound
    cancelled: int = 0                   # requests expired by their deadline
    poisoned: int = 0                    # sequences preempted after a fault


@dataclass
class TickPlan:
    """The tensor work one engine step must perform, in order.  ``cow``
    copies run first — a shared block must be duplicated device-side
    before this tick's prefill/decode writes into the private copy.
    ``cow_owners[i]`` is the sequence whose table entry ``cow[i]``
    rewrites — fault attribution for the engine's degrade path."""

    admitted: List[SeqState] = field(default_factory=list)
    cow: List[Tuple[int, int]] = field(default_factory=list)  # (src, dst)
    cow_owners: List["SeqState"] = field(default_factory=list)
    prefill: Optional[Tuple[SeqState, int, int]] = None  # (seq, start, len)
    decode: List[SeqState] = field(default_factory=list)
    preempted: List[SeqState] = field(default_factory=list)
    cancelled: List[Request] = field(default_factory=list)


class Scheduler:
    def __init__(self, pool: PagedKVPool, *, max_batch: int, max_len: int,
                 prefill_chunk: int = 32,
                 watermark_blocks: Optional[int] = None,
                 prefix_sharing: bool = False,
                 max_queue: Optional[int] = None,
                 clock: Clock = time.monotonic):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1: {prefill_chunk}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1: {max_queue}")
        self.pool = pool
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.watermark = (max_batch if watermark_blocks is None
                          else watermark_blocks)
        self.max_queue = max_queue
        self.clock = clock
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[SeqState]] = [None] * max_batch
        self.ticks = 0
        self.stats = SchedStats()

    def _emit(self, action: str, rid: int, slot: int = -1) -> None:
        """Trace one scheduling decision; every action maps 1:1 onto its
        :class:`SchedStats` counter (``admit``/``wait``/``shed``/
        ``preempt``/``poison``/``cancel``), so a trace reconstructs the
        stats exactly.  Tick ids come from the recorder's cursor — the
        engine advances it every step, so scheduler and dispatch events
        join on the same tick numbering.  One module-global load when
        tracing is off."""
        rec = obs._recorder
        if rec is not None:
            rec.emit(AdmissionDecision(tick=rec.tick, action=action,
                                       rid=int(rid), slot=int(slot),
                                       queue_depth=len(self.queue)))

    # -- client side ----------------------------------------------------------
    def submit(self, req: Request) -> Optional[RequestError]:
        """Queue a request.

        *Malformed* requests — empty prompt, non-positive generation
        budget, or a prompt + budget that could never fit the serve window
        or the pool — **raise** a :class:`RequestError` (they are caller
        bugs; retrying cannot help).  A well-formed request arriving while
        the queue is at ``max_queue`` is **load-shed**: it is marked done
        with a ``queue_full`` error carrying a retry-after hint (the ticks
        the current queue needs to drain, roughly), and that error is
        *returned* — overload is an operating condition, not an exception."""
        if len(req.prompt) == 0:
            raise RequestError("empty_prompt",
                               f"request {req.rid}: empty prompt",
                               rid=req.rid)
        if req.max_new < 1:
            raise RequestError(
                "bad_max_new",
                f"request {req.rid}: max_new must be >= 1: {req.max_new}",
                rid=req.rid)
        total = len(req.prompt) + req.max_new
        if total > self.max_len:
            raise RequestError(
                "too_long",
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_len {self.max_len}",
                rid=req.rid)
        if self.pool.blocks_for(total) > self.pool.capacity:
            raise RequestError(
                "over_capacity",
                f"request {req.rid}: needs "
                f"{self.pool.blocks_for(total)} blocks, pool capacity is "
                f"{self.pool.capacity}",
                rid=req.rid)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            err = RequestError(
                "queue_full",
                f"request {req.rid}: queue at max_queue={self.max_queue}",
                rid=req.rid,
                retry_after_ticks=self._drain_hint())
            req.error = err
            req.done = True
            self.stats.shed += 1
            self._emit("shed", req.rid)
            return err
        self.queue.append(req)
        return None

    def _drain_hint(self) -> int:
        """Rough ticks until the head of today's queue could admit: one
        chunk-quantized prefill pass per queued prompt ahead of it."""
        per_req = max(1, -(-self.max_len // self.prefill_chunk))
        return max(1, len(self.queue) * per_req // max(1, self.max_batch))

    def running(self) -> List[SeqState]:
        return [s for s in self.slots if s is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def progress_bound(self) -> int:
        """Ticks within which every *admitted, non-preempted* sequence is
        guaranteed progress: decode rows progress every tick; a prefilling
        sequence waits at most for every older sequence's remaining chunks
        (each prompt is at most ``ceil(max_len/prefill_chunk)`` full chunks
        plus the power-of-two tail of its remainder)."""
        chunks_per_seq = (-(-self.max_len // self.prefill_chunk)
                          + max(1, self.prefill_chunk).bit_length())
        return self.max_batch * chunks_per_seq + 1

    # -- the tick -------------------------------------------------------------
    def tick(self) -> TickPlan:
        t = self.ticks
        self.ticks += 1
        plan = TickPlan()

        # 0. deadline sweep: expire TTLs *before* planning work, so a
        # cancelled sequence neither claims blocks nor joins the decode
        # batch this tick.  Running victims keep their committed output
        # (a timeout is a partial answer, not a void one).
        self._expire_deadlines(plan)

        # 1. decode priority: secure a *private* write block for every
        # decode row — allocating the block its next token needs and
        # copy-on-write-replacing it if shared — evicting the youngest
        # running sequence whenever the pool runs dry.  Rows whose
        # dispatched outputs already cover max_new sit out (async overlap
        # must not speculate past the generation budget: the fixed-width
        # block table and the serve window are sized for max_new).
        for seq in sorted((s for s in self.running()
                           if not s.prefilling
                           and s.dispatched_out < s.req.max_new),
                          key=lambda s: (s.admitted_at, s.req.rid)):
            if self.slots[seq.slot] is not seq:
                continue                       # evicted by an older row
            while True:
                if self.pool.blocks_for(seq.pos + 1) > len(seq.blocks):
                    got = self.pool.alloc(1)
                    if got is not None:
                        seq.blocks.extend(got)
                        continue
                else:
                    wb = seq.pos // self.pool.page_size
                    if not self.pool.is_shared(seq.blocks[wb]):
                        break
                    got = self.pool.alloc(1)
                    if got is not None:
                        self._cow(plan, seq, wb, got[0])
                        continue
                victim = self._youngest_running()
                self._preempt(victim)
                self._emit("preempt", victim.req.rid, victim.slot)
                plan.preempted.append(victim)
                if victim is seq:
                    break
        decoding = [s for s in self.running()
                    if not s.prefilling
                    and s.dispatched_out < s.req.max_new]

        # 2. FIFO admission with KV head-room (the long-prompt guard).
        # Head-room is judged against free blocks MINUS what running
        # sequences have claimed but not yet allocated (admitted prompts
        # only take blocks as their chunks prefill) — otherwise a long
        # admitted prompt is invisible to the next admission.  Idle cached
        # prefix blocks count as free-in-waiting (alloc reclaims them),
        # and blocks the prefix index already holds for this prompt don't
        # need head-room at all: the probe maps them instead.
        for slot in range(self.max_batch):
            if not self.queue:
                break
            if self.slots[slot] is not None:
                continue
            req = self.queue[0]
            target = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.out, np.int32)]).astype(np.int32)
            probe: List[int] = []
            if self.prefix_sharing:
                probe, _, _ = self.pool.match_prefix(target, commit=False)
            needed = self.pool.blocks_for(len(target) + 1) - len(probe)
            committed = sum(
                max(0, self.pool.blocks_for(len(s.target) + 1)
                    - len(s.blocks))
                for s in self.running())
            reserve = self.watermark if self.running() else 0
            avail = (self.pool.num_free
                     + max(0, self.pool.num_reclaimable - len(probe)))
            if avail - committed < needed + reserve:
                self.stats.admission_waits += 1
                self._emit("wait", req.rid)
                break                          # strict FIFO: head blocks
            self.queue.popleft()
            seq = SeqState(req=req, slot=slot, target=target,
                           admitted_at=t, last_progress=t,
                           prompt_len=len(req.prompt))
            if self.prefix_sharing:
                blocks, matched, chash = self.pool.match_prefix(target)
                seq.blocks = list(blocks)
                seq.filled = seq.pos = matched
                seq.chain_hash = chash
                seq.registered = matched // self.pool.page_size
            self.slots[slot] = seq
            plan.admitted.append(seq)
            self.stats.admissions += 1
            self._emit("admit", req.rid, slot)

        # 3. one prefill chunk: oldest admitted sequence still prefilling.
        # The chunk's write range must be private: shared blocks in it are
        # CoW-replaced, and the new-block + CoW-copy allocation is
        # all-or-nothing (pool tight: wait for retires).
        for seq in sorted((s for s in self.running() if s.prefilling),
                          key=lambda s: (s.admitted_at, s.req.rid)):
            c = self._chunk_len(len(seq.target) - seq.filled)
            ps = self.pool.page_size
            shared = [i for i in range(seq.filled // ps,
                                       min(-(-(seq.filled + c) // ps),
                                           len(seq.blocks)))
                      if self.pool.is_shared(seq.blocks[i])]
            need = self.pool.blocks_for(seq.filled + c) - len(seq.blocks)
            got = self.pool.alloc(max(0, need) + len(shared))
            if got is None:
                continue                       # pool tight: wait for retires
            for i, dst in zip(shared, got):
                self._cow(plan, seq, i, dst)
            seq.blocks.extend(got[len(shared):])
            plan.prefill = (seq, seq.filled, c)
            break

        plan.decode = decoding
        if decoding:
            self.stats.decode_ticks += 1
        return plan

    # -- engine feedback ------------------------------------------------------
    def note_prefill(self, seq: SeqState, chunk: int) -> None:
        seq.filled += chunk
        seq.pos = seq.filled
        seq.last_progress = self.ticks
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += chunk
        if self.prefix_sharing:
            # register each newly-full block of the target so future
            # prompts sharing this prefix map it instead of recomputing
            ps = self.pool.page_size
            while (seq.registered + 1) * ps <= seq.filled:
                i = seq.registered
                seq.chain_hash = self.pool.register_prefix(
                    seq.chain_hash, seq.target[i * ps:(i + 1) * ps],
                    seq.blocks[i])
                seq.registered += 1

    def note_decode(self, seq: SeqState) -> None:
        seq.pos += 1
        seq.last_progress = self.ticks

    def retire(self, seq: SeqState) -> None:
        """Copy-free retirement: the sequence drops its refcounts and the
        slot frees for the next admission.  Nothing on the device moves;
        blocks the prefix index pinned stay resident (the "recently
        retired" cache) until LRU reclaim, the rest return to the free
        list."""
        if seq.blocks:
            self.pool.free(seq.blocks)
        seq.blocks = []
        self.slots[seq.slot] = None

    # -- robustness -----------------------------------------------------------
    def _expire_deadlines(self, plan: TickPlan) -> None:
        """Cancel every queued or running request whose deadline passed.
        One clock read per tick; requests without deadlines cost one
        attribute test each."""
        if not self.queue and not any(s is not None for s in self.slots):
            return
        now: Optional[float] = None
        for req in list(self.queue):
            if req.deadline is None:
                continue
            now = self.clock() if now is None else now
            if now >= req.deadline:
                self.queue.remove(req)
                self._cancel(req, plan)
        for seq in self.running():
            if seq.req.deadline is None:
                continue
            now = self.clock() if now is None else now
            if now >= seq.req.deadline:
                if seq.blocks:
                    self.pool.free(seq.blocks)
                seq.blocks = []
                seq.dead = True              # drop its uncommitted in-flight
                self.slots[seq.slot] = None
                self._cancel(seq.req, plan)

    def _cancel(self, req: Request, plan: TickPlan) -> None:
        req.error = RequestError("deadline",
                                 f"request {req.rid}: deadline exceeded",
                                 rid=req.rid, retry_after_ticks=1)
        req.done = True
        plan.cancelled.append(req)
        self.stats.cancelled += 1
        self._emit("cancel", req.rid)

    def poison(self, seq: SeqState) -> bool:
        """Reconcile a sequence whose in-flight work faulted: preempt it by
        recompute (the eviction path — committed tokens kept, request
        requeued at the front, state marked dead so the engine drops its
        uncommitted tokens).  Greedy decode regenerates the lost tokens
        deterministically after re-admission, so surviving output is
        token-exact.  Returns False when the sequence already left its slot
        (retired/preempted/cancelled in the meantime) — poisoning is then
        moot."""
        if seq.dead or self.slots[seq.slot] is not seq:
            return False
        self._preempt(seq)
        self.stats.preemptions -= 1          # reattribute: fault, not pressure
        self.stats.poisoned += 1
        self._emit("poison", seq.req.rid, seq.slot)
        return True

    # -- internals ------------------------------------------------------------
    def _cow(self, plan: TickPlan, seq: SeqState, i: int, dst: int) -> None:
        """Replace block-table entry ``i`` with freshly-allocated ``dst``:
        plan the device copy, then drop this sequence's ref on the shared
        source (other owners keep it)."""
        src = seq.blocks[i]
        plan.cow.append((src, dst))
        plan.cow_owners.append(seq)
        seq.blocks[i] = dst
        self.pool.free([src])
        self.pool.stats.cow_copies += 1

    def _chunk_len(self, remaining: int) -> int:
        """Full chunks of ``prefill_chunk``; the tail decomposes into
        powers of two (largest first) to bound the compiled shape set."""
        if remaining >= self.prefill_chunk:
            return self.prefill_chunk
        return 1 << (remaining.bit_length() - 1)

    def _youngest_running(self) -> SeqState:
        return max(self.running(),
                   key=lambda s: (s.admitted_at, s.req.rid))

    def _preempt(self, seq: SeqState) -> None:
        """Evict by recompute: free the blocks, keep the *committed*
        generated tokens, and requeue at the *front* (the victim predates
        everything still queued, so FIFO order is preserved).  The evicted
        ``SeqState`` is marked dead — the engine must drop its uncommitted
        in-flight tokens, which greedy decode regenerates deterministically
        after re-admission — and on re-admission the prompt plus committed
        tokens re-prefill, then decode continues."""
        if seq.blocks:
            self.pool.free(seq.blocks)
        seq.blocks = []
        seq.dead = True
        self.slots[seq.slot] = None
        self.queue.appendleft(seq.req)
        self.stats.preemptions += 1
