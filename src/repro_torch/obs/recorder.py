"""The flight recorder: a bounded, lock-cheap ring of trace events.

A process-wide injector idiom: a module-global recorder consulted by
instrumented sites.  When tracing is
off (the production default) a site costs one module-global load plus an
``is None`` test — no counters, no allocation.  When tracing is on,
emitting appends one record dict to a ``collections.deque(maxlen=...)``:
appends and the aging-out of old records are GIL-atomic, so the hot
paths take no lock (the ring is a single-writer-ish observability
surface, not a concurrency primitive — same stance as ``DispatchStats``'
lock-free ``frozen_hits``).

The frozen ``warm_callable`` lane is *uncounted by default* even while
tracing (its perf contract): ``sample_frozen_every=N`` opts into a
1-in-N sample of that lane, surfaced as ``dispatch_decision`` records
with ``surface="warm_sampled"``.

Export is byte-deterministic: records carry tick indices (never wall
clock — ``TickSpan.duration_us`` comes from the engine's injectable
clock), sequence ids are assigned in emission order, and JSONL encoding
is ``sort_keys=True, separators=(",", ":")`` — same seed + same schedule
means byte-identical output.
"""
from __future__ import annotations

import collections
import contextlib
import json
from typing import Any, Dict, Iterator, List, Optional

from .events import DispatchDecision, event_record


def _jsonable(v: Any) -> Any:
    """Tuples -> lists so exported records equal their json round-trip."""
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    return v


class FlightRecorder:
    """Bounded ring of trace events with monotonic sequence ids.

    ``capacity`` bounds memory: the oldest records age out first and are
    counted in :attr:`dropped` (reported, never silent).  ``emitted`` is
    the lifetime count; ``seq`` ids keep climbing across drops, so a
    truncated trace is detectable from the records alone."""

    def __init__(self, capacity: int = 4096,
                 sample_frozen_every: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        if sample_frozen_every < 0:
            raise ValueError(
                f"sample_frozen_every must be >= 0: {sample_frozen_every}")
        self.capacity = int(capacity)
        #: 0 = the frozen warm lane stays uncounted (default); N>0 =
        #: record every N-th warm_callable hit as a sampled decision.
        self.sample_frozen_every = int(sample_frozen_every)
        self.tick = 0
        self.emitted = 0
        self._ring: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=self.capacity)
        self._warm_calls = 0

    # -- emission (hot-path side) --------------------------------------------
    def emit(self, event: Any) -> None:
        """Append one event (any registered dataclass; see
        :data:`repro_torch.obs.events.EVENT_TYPES`)."""
        rec = event_record(event, self.emitted, self.tick)
        self.emitted += 1
        self._ring.append(rec)

    def sample_warm(self, family_name: str, machine_name: str,
                    items: Any) -> None:
        """1-in-N sampling hook for the frozen ``warm_callable`` lane.
        Callers gate on ``sample_frozen_every > 0`` before calling, so
        the default-sampling trace never touches this counter."""
        self._warm_calls += 1
        if self._warm_calls % self.sample_frozen_every:
            return
        data = tuple(sorted((k, int(v)) for k, v in dict(items).items()))
        self.emit(DispatchDecision(
            tick=self.tick, family=family_name, machine=machine_name,
            data=data, bucket="", leaf=-1, assignment=(),
            source="frozen", surface="warm_sampled", rank=0, demoted=0))

    # -- reading / export -----------------------------------------------------
    @property
    def dropped(self) -> int:
        """Records aged out of the ring (emitted but no longer held)."""
        return self.emitted - len(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def records(self) -> List[Dict[str, Any]]:
        """Snapshot of the buffered records, oldest first, with tuples
        normalized to lists (identical to a JSONL round-trip)."""
        return [{k: _jsonable(v) for k, v in rec.items()}
                for rec in list(self._ring)]

    def export_jsonl(self) -> str:
        """Byte-deterministic JSONL: one record per line, sorted keys,
        minimal separators, trailing newline when non-empty."""
        lines = [json.dumps(rec, sort_keys=True, separators=(",", ":"))
                 for rec in self.records()]
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# The process-wide recorder (None when tracing is off: sites cost one
# module-global load).
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder]) -> None:
    global _recorder
    _recorder = recorder


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def set_tick(tick: int) -> None:
    """Advance the installed recorder's tick cursor (the engine calls
    this at the top of every step; no-op when tracing is off)."""
    if _recorder is not None:
        _recorder.tick = int(tick)


def emit(event: Any) -> None:
    """Emit through the installed recorder; no-op when tracing is off.
    Hot paths inline the global test instead of paying this call."""
    if _recorder is not None:
        _recorder.emit(event)


@contextlib.contextmanager
def tracing(capacity: int = 4096, sample_frozen_every: int = 0
            ) -> Iterator[FlightRecorder]:
    """Install a fresh recorder for the duration of the block
    (tests/CI drills); always restores the previous one on exit."""
    rec = FlightRecorder(capacity=capacity,
                         sample_frozen_every=sample_frozen_every)
    prev = _recorder
    install(rec)
    try:
        yield rec
    finally:
        install(prev)
