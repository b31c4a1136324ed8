"""Seeded, deterministic fault injection + serving-side degradation tools.

The paper's output is a *case discussion*: for every ``(machine, program)``
parameter point, a ranked list of proven-feasible kernel variants — not one
winner.  :mod:`repro_torch.runtime.ft` already treats training failures as data
(injectable ``fault_hook``, retry-from-checkpoint); this module is the
serving-side dual.  It provides the **chaos half** of the fault-tolerant
serving stack — the **degradation half** (falling down the candidate
ranking) lives in :meth:`repro_torch.artifacts.dispatch.DispatchCache.demote` and
the engine's guarded dispatch (:mod:`repro_torch.runtime.serving`).

Pieces:

* :class:`FaultSpec` / :class:`FaultSchedule` — a schedule of
  ``(site, tick, kind)`` faults.  ``FaultSchedule.random(seed, ...)`` draws
  a byte-reproducible schedule with site-appropriate kinds, so every chaos
  drill replays exactly and doubles as a regression test.
* :class:`FaultInjector` — the armed schedule.  Instrumented code calls
  :func:`maybe_fault`/:func:`corrupt_text` at named **injection sites**;
  when no injector is installed these are a single module-global load, so
  production pays (almost) nothing.  Firing is deterministic: a spec fires
  on a call to its site while the injector's tick equals the spec's tick
  (``tick=ANY_TICK`` fires on the next call regardless), FIFO per site,
  each spec exactly once.  The engine advances the tick
  (:func:`set_tick`); outside an engine the tick stays 0.
* Exceptions — :class:`InjectedFault` (recoverable: the degrade path must
  absorb it), :class:`InjectedIOFault` (an ``OSError``: the forgiving
  artifact readers must treat it as a cache miss), and
  :class:`FatalFault` (unrecoverable: must propagate loudly, with the
  engine left drainable).
* :class:`TickWatchdog` — hung/slow-tick detection for the serving loop,
  reusing :class:`repro_torch.runtime.ft.StragglerMonitor`'s rolling-window
  bookkeeping (the serving engine is "host 0" watching itself).

Injection sites instrumented across the stack (kinds each site honors):

======================  =============================  ====================
site                    instrumented in                kinds
======================  =============================  ====================
``pool.alloc``          ``kv_pool.PagedKVPool.alloc``  exhaust, error, fatal
``serve.cow``           ``serving.ServeEngine``        error, fatal
``serve.prefill``       ``serving.ServeEngine``        error, fatal
``serve.decode``        ``serving.ServeEngine``        error, fatal
``serve.tick``          ``serving.ServeEngine``        slow
``artifact.read``       ``artifacts.store``            torn, garble, io
``plan.read``           ``plans.store``                torn, garble, io
``plan.apply``          ``plans.loader``               error
``monitor.probe``       ``runtime.monitor``            error
======================  =============================  ====================

This module is deliberately light (stdlib + numpy + ``runtime.ft``): the
artifact stores import it at module scope, so it must never pull torch or the
engine in.  ``repro_torch.runtime.__init__`` is lazy for the same reason.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import recorder as obs
from ..obs.events import FaultFired
from .ft import StragglerMonitor

#: ``FaultSpec.tick`` wildcard: fire on the next call to the site, whatever
#: the injector's tick is (store/unit tests that never drive an engine).
ANY_TICK = -1

#: Fault kinds with raise semantics (handled inside :func:`maybe_fault`);
#: every other kind is *soft* — returned to the site to interpret.
RAISING_KINDS = ("error", "io", "fatal")

#: Which kinds make sense at which site (``FaultSchedule.random`` draws
#: from these; an unknown site draws "error").
SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "pool.alloc": ("exhaust",),
    "serve.cow": ("error",),
    "serve.prefill": ("error",),
    "serve.decode": ("error",),
    "serve.tick": ("slow",),
    "artifact.read": ("torn", "garble", "io"),
    "plan.read": ("torn", "garble", "io"),
    "plan.apply": ("error",),
    "monitor.probe": ("error",),
}

#: Every instrumented site (the chaos sweep iterates this).
ALL_SITES: Tuple[str, ...] = tuple(SITE_KINDS)


class FaultError(RuntimeError):
    """Base of every injected failure; carries its provenance."""

    def __init__(self, site: str, kind: str, tick: int):
        super().__init__(f"injected {kind} fault at {site} (tick {tick})")
        self.site = site
        self.kind = kind
        self.tick = tick


class InjectedFault(FaultError):
    """A *recoverable* injected failure: the graceful-degradation path
    (demote-and-retry, preemption-by-recompute, forgiving reads) must
    absorb it — an engine dying on one is the bug the drill exists to
    catch."""


class InjectedIOFault(FaultError, OSError):
    """An injected I/O failure.  Subclasses ``OSError`` so the forgiving
    artifact readers (the forgiving-read policy: unreadable == cache miss) swallow it on
    their existing except clauses — the drill proves the policy, it does
    not special-case it."""


class FatalFault(FaultError):
    """An *unrecoverable* injected failure: no handler may swallow it.  It
    must propagate out of the engine loudly, leaving the engine in a
    drainable state (tests call ``run_until_drained`` right after)."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` at injection-site ``site`` on a
    call made while the injector's tick equals ``tick`` (``ANY_TICK`` =
    the site's next call).  ``arg`` parameterizes the kind: byte offset
    for ``torn``/``garble``, added microseconds for ``slow``."""

    site: str
    tick: int
    kind: str = "error"
    arg: int = 0


class FaultSchedule:
    """An ordered, replayable fault list.  Equality and iteration are over
    the specs, so a schedule built from ``random(seed=k)`` is the same
    object-for-object every run — chaos drills double as regressions."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)

    @classmethod
    def random(cls, seed: int, *, sites: Sequence[str] = ALL_SITES,
               max_tick: int = 64, n: int = 4) -> "FaultSchedule":
        """Draw ``n`` faults over ``sites`` x ``[0, max_tick)`` with
        site-appropriate kinds — byte-deterministic in ``seed``."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n):
            site = sites[int(rng.integers(0, len(sites)))]
            kinds = SITE_KINDS.get(site, ("error",))
            specs.append(FaultSpec(
                site=site,
                tick=int(rng.integers(0, max_tick)),
                kind=kinds[int(rng.integers(0, len(kinds)))],
                arg=int(rng.integers(0, 4096))))
        return cls(specs)

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultSchedule)
                and self.specs == other.specs)

    def __repr__(self) -> str:
        return f"FaultSchedule({list(self.specs)!r})"


class FaultInjector:
    """An armed :class:`FaultSchedule`.

    Sites consult it through :func:`maybe_fault`/:func:`corrupt_text`; a
    spec fires when its site is called while ``self.tick`` matches (FIFO
    per site, consumed exactly once).  ``fired`` logs every fired spec in
    order — two runs of the same deterministic workload under the same
    schedule produce identical logs, which the parity tests assert."""

    def __init__(self, schedule: FaultSchedule | Sequence[FaultSpec] = ()):
        if not isinstance(schedule, FaultSchedule):
            schedule = FaultSchedule(schedule)
        self.schedule = schedule
        self._pending: Dict[str, List[FaultSpec]] = {}
        for spec in schedule:
            self._pending.setdefault(spec.site, []).append(spec)
        self.tick = 0
        self.fired: List[FaultSpec] = []

    def pending(self) -> List[FaultSpec]:
        """Specs that have not fired (scheduled ticks the workload never
        reached, or sites it never called)."""
        return [s for site in self._pending for s in self._pending[site]]

    def _pop(self, site: str) -> Optional[FaultSpec]:
        specs = self._pending.get(site)
        if not specs:
            return None
        for i, spec in enumerate(specs):
            if spec.tick == ANY_TICK or spec.tick == self.tick:
                self.fired.append(specs.pop(i))
                if obs._recorder is not None:
                    # every firing joins the provenance stream, stamped
                    # with the *injector's* tick (== the engine tick)
                    obs._recorder.emit(FaultFired(
                        tick=int(self.tick), site=spec.site,
                        kind=spec.kind, arg=int(spec.arg)))
                return spec
        return None

    def fire(self, site: str) -> Optional[FaultSpec]:
        """Pop-and-act for ``site``: raising kinds raise their exception;
        soft kinds (``exhaust``, ``slow``, ``torn``, ``garble``) are
        returned for the site to interpret; no match returns ``None``."""
        spec = self._pop(site)
        if spec is None:
            return None
        if spec.kind == "error":
            raise InjectedFault(site, spec.kind, self.tick)
        if spec.kind == "io":
            raise InjectedIOFault(site, spec.kind, self.tick)
        if spec.kind == "fatal":
            raise FatalFault(site, spec.kind, self.tick)
        return spec


# ---------------------------------------------------------------------------
# The process-wide injector (None in production: sites cost one global load)
# ---------------------------------------------------------------------------

_injector: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> None:
    global _injector
    _injector = injector


def get_injector() -> Optional[FaultInjector]:
    return _injector


def set_tick(tick: int) -> None:
    """Advance the installed injector's tick (the engine calls this at the
    top of every step; no-op when no drill is armed)."""
    if _injector is not None:
        _injector.tick = int(tick)


@contextlib.contextmanager
def inject(schedule: FaultSchedule | Sequence[FaultSpec]
           ) -> Iterator[FaultInjector]:
    """Arm a schedule for the duration of the block (tests/benchmarks/CI
    drills); always disarms on exit, even when the drill raises."""
    injector = FaultInjector(schedule)
    prev = _injector
    install(injector)
    try:
        yield injector
    finally:
        install(prev)


def maybe_fault(site: str) -> Optional[FaultSpec]:
    """The injection-site hook: one module-global load when no drill is
    armed; under a drill, fires at most one matching scheduled fault
    (raising kinds raise; soft kinds are returned for interpretation)."""
    if _injector is None:
        return None
    return _injector.fire(site)


def corrupt_text(site: str, text: str) -> str:
    """Byte-corruption hook for artifact/plan read sites.  ``torn``
    truncates at the spec's byte offset (a mid-write reader); ``garble``
    stamps a NUL over one byte (bit rot; NUL is invalid in JSON anywhere,
    so the read must parse-fail, never half-succeed); raising kinds raise.
    Without a matching spec the text passes through untouched."""
    if _injector is None:
        return text
    spec = _injector.fire(site)
    if spec is None or not text:
        return text
    off = spec.arg % max(1, len(text))
    if spec.kind == "torn":
        return text[:off]
    if spec.kind == "garble":
        return text[:off] + "\x00" + text[off + 1:]
    return text


# ---------------------------------------------------------------------------
# Tick watchdog: StragglerMonitor pointed at the serving loop itself
# ---------------------------------------------------------------------------

@dataclass
class WatchdogStats:
    ticks: int = 0                    # ticks observed
    slow_ticks: int = 0               # ticks flagged over factor x median
    last_slow_tick: int = -1          # tick index of the latest flag
    worst_ratio: float = 0.0          # max observed dt / rolling median


class TickWatchdog:
    """Flags hung/slow engine ticks against their own rolling median.

    Reuses :class:`repro_torch.runtime.ft.StragglerMonitor`'s windowed step-time
    bookkeeping — the serving engine is recorded as host 0 and judged
    against its own history (the cross-host comparison ``stragglers()``
    does is meaningless with one host, so the flagging math lives here).
    A tick is *slow* when its duration exceeds ``factor`` x the rolling
    median of the last ``window`` ticks, once ``min_samples`` ticks have
    been seen; detection is pure and unit-tested with fabricated
    durations."""

    def __init__(self, *, factor: float = 4.0, window: int = 64,
                 min_samples: int = 8):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1.0: {factor}")
        self.monitor = StragglerMonitor(factor=factor, window=window,
                                        min_samples=min_samples)
        self.stats = WatchdogStats()

    def observe(self, seconds: float, tick: Optional[int] = None) -> bool:
        """Record one tick duration; returns True when it flags as slow
        (judged against the history *before* this tick, so one hung tick
        cannot hide itself by dragging the median up)."""
        st = self.stats
        buf = self.monitor._times.get(0, [])
        flagged = False
        if len(buf) >= self.monitor.min_samples:
            med = float(np.median(buf))
            if med > 0.0:
                ratio = float(seconds) / med
                st.worst_ratio = max(st.worst_ratio, ratio)
                flagged = ratio > self.monitor.factor
        self.monitor.record(0, float(seconds))
        if flagged:
            st.slow_ticks += 1
            st.last_slow_tick = tick if tick is not None else st.ticks
        st.ticks += 1
        return flagged

    def stats_line(self) -> str:
        st = self.stats
        return (f"watchdog ticks={st.ticks} slow={st.slow_ticks} "
                f"worst={st.worst_ratio:.1f}x")


# ---------------------------------------------------------------------------
# Injectable clocks (deadline/TTL plumbing shares them)
# ---------------------------------------------------------------------------

#: Default wall clock for deadlines and the watchdog; tests inject fakes.
Clock = Callable[[], float]
default_clock: Clock = time.monotonic
