"""Live kernel monitoring + counter-driven hot-swap (KLARAPTOR at serve
time): the port of ``runtime/monitor.py``, on ``H100_SXM`` by default.

Serve plans freeze kernel picks *offline*; KLARAPTOR (PAPERS.md, arxiv
1911.02373) argues launch parameters are best revisited *at program
runtime*, when measured reality can disagree with the offline model —
traffic mix shifts, a mis-calibrated tuning run, a table built on a
different host.  :class:`KernelMonitor` closes that loop for the frozen
fast lane:

* **probe** — every ``probe_every``-th engine tick, one tracked
  ``(family, machine, data)`` triple (round-robin) gets a cheap probe:
  the frozen incumbent plus one pre-ranked challenger are timed via an
  injectable :data:`repro_torch.tuning.measure.Timer` (the tests supply
  deterministic fakes; the default times device time on the card, and
  waits for its own end event, so a probe tick drains the engine's ticks
  in flight).  Samples land in fixed-size reservoirs — bounded memory, seeded
  RNG, no unbounded history.  Non-probe ticks cost one modulo check, so
  the frozen fast path stays effectively free.
* **decide** — after ``window`` probes of a triple the window closes: if
  the best challenger's median beats the incumbent's median by more than
  ``threshold`` (a ratio, e.g. ``1.25`` = 25% faster) the window
  *disagrees* with the frozen pick.  ``patience`` consecutive disagreeing
  windows — one noisy window never swaps — trigger a hot-swap.
* **swap** — the challenger is first re-proven feasible against the
  comprehensive tree's constraint system (measured speed never overrides
  the constraint model: an infeasible candidate is dropped from the
  challenger pool and counted, never published).  The corrected pick is
  then published through the existing atomic
  :meth:`DispatchCache.freeze_resolved` merge, guarded by the cache's
  unfreeze generation — a concurrent ``unfreeze``/``clear`` wins and the
  swap is counted as blocked, exactly the ``attach_store`` re-freeze
  discipline.  Every swap is recorded as a :class:`SwapEvent` and logged.

Counters (:class:`MonitorStats`) follow the ``PoolStats`` idiom: plain
monotonic ints, cheap to read, surfaced on the serve stats line.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..artifacts.dispatch import CandKey, cand_key  # noqa: F401 — re-export
from ..core.comprehensive import comprehensive_tree
from ..obs import recorder as obs
from ..obs.events import describe_transition
from ..core.constraints import Verdict
from ..core.params import H100_SXM, MachineDescription
from ..core.plan import FamilySpec
from ..core.select import Candidate, rank_candidates
from ..device import device_error
from ..tuning.measure import (MeasureConfig, Timer, default_timer,
                              measure_shape, trimmed_mean_us)
from . import faults

_LOG = logging.getLogger(__name__)


@dataclass
class MonitorStats:
    """Monotonic counters for the adaptive loop (PoolStats-style)."""

    probes: int = 0                   # incumbent+challenger probe pairs run
    samples: int = 0                  # reservoir samples recorded
    probe_failures: int = 0           # timer raised; failure is data
    windows: int = 0                  # decision windows closed
    disagreements: int = 0            # windows where measurement disagreed
    swaps: int = 0                    # hot-swaps published
    swap_blocked_infeasible: int = 0  # challenger failed constraint re-proof
    swap_blocked_gen: int = 0         # publish lost to concurrent unfreeze


@dataclass(frozen=True)
class SwapEvent:
    """One observable hot-swap: what was believed, what was measured."""

    tick: int
    family: str
    data: Tuple[Tuple[str, int], ...]        # sorted items
    old: CandKey
    new: CandKey
    incumbent_us: float
    challenger_us: float
    windows: int                             # disagreeing streak length

    def describe(self) -> str:
        # rendered through the shared obs convention so the swap and
        # degrade logs cannot drift (a test pins this format)
        return describe_transition(
            tick=self.tick, verb="swapped", family=self.family,
            data=self.data,
            old=f"{self.old[1]} ({self.incumbent_us:.1f}us)",
            new=f"{self.new[1]} ({self.challenger_us:.1f}us)",
            cause=f"{self.windows} windows")


class _Reservoir:
    """Fixed-size uniform sample of a candidate's probe timings."""

    __slots__ = ("cap", "seen", "xs")

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self.seen = 0
        self.xs: List[float] = []

    def add(self, us: float, rng: np.random.Generator) -> None:
        self.seen += 1
        if len(self.xs) < self.cap:
            self.xs.append(float(us))
        else:                                 # classic reservoir replacement
            j = int(rng.integers(0, self.seen))
            if j < self.cap:
                self.xs[j] = float(us)

    def median(self) -> Optional[float]:
        return float(np.median(self.xs)) if self.xs else None


@dataclass
class _TripleState:
    """Per tracked (family, data) bookkeeping."""

    family: FamilySpec
    data: Dict[str, int]
    pool: Optional[List[Candidate]] = None   # ranked candidate pool (lazy)
    reservoirs: Dict[CandKey, _Reservoir] = field(default_factory=dict)
    probes_in_window: int = 0
    streak: int = 0                          # consecutive disagreeing windows
    rr: int = 0                              # challenger round-robin cursor


class KernelMonitor:
    """Counter-driven re-tuning over a cache's frozen dispatch plan.

    Drive it with :meth:`on_tick` from the engine loop (or any tick
    source).  ``timer`` defaults to the real kernel timer
    (:func:`repro_torch.tuning.measure.default_timer`: CUDA-graph replays
    between CUDA events on the card) under a deliberately cheap
    :class:`MeasureConfig`; inject a fake for tests.  The monitor only
    republishes the frozen pick: a serving engine whose steps are CUDA
    graphs captures again the steps that launch a swapped triple
    (``ServeEngine.step``).
    """

    def __init__(self, cache=None, *,
                 machine: MachineDescription = H100_SXM,
                 window: int = 8, patience: int = 2,
                 threshold: float = 1.25, probe_every: int = 4,
                 top_k: int = 2, reservoir: int = 32,
                 timer: Optional[Timer] = None,
                 measure: Optional[MeasureConfig] = None,
                 ranker=None,
                 seed: int = 0):
        if window < 1:
            raise ValueError(f"window must be >= 1: {window}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1: {patience}")
        if threshold < 1.0:
            raise ValueError(f"threshold must be >= 1.0: {threshold}")
        if probe_every < 1:
            raise ValueError(f"probe_every must be >= 1: {probe_every}")
        from ..artifacts.dispatch import get_default_cache
        self.cache = cache if cache is not None else get_default_cache()
        self.machine = machine
        self.window = int(window)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.probe_every = int(probe_every)
        self.top_k = int(top_k)
        self.reservoir_cap = int(reservoir)
        self.timer = timer if timer is not None else default_timer
        #: challenger source: (family, machine, data) -> ranked Candidates.
        #: Injectable so the property tests can nominate adversarial
        #: candidates; the feasibility re-proof in :meth:`_swap` holds
        #: regardless of what the ranker proposes.
        self.ranker = ranker if ranker is not None else rank_candidates
        self.measure = measure if measure is not None else MeasureConfig(
            iters=1, warmup=0, trim=0, max_dim=64, seed=seed)
        self.stats = MonitorStats()
        self.events: List[SwapEvent] = []
        self._rng = np.random.default_rng(seed)
        self._triples: Dict[Tuple[str, Tuple[Tuple[str, int], ...]],
                            _TripleState] = {}
        self._rr = 0

    # -- registration ---------------------------------------------------------
    def track(self, family: FamilySpec, data: Mapping[str, int]) -> None:
        """Track one (family, data) triple on this monitor's machine."""
        d = {k: int(v) for k, v in data.items()}
        key = (family.name, tuple(sorted(d.items())))
        self._triples.setdefault(key, _TripleState(family=family, data=d))

    def track_frozen(self, families: Optional[Sequence[str]] = None) -> int:
        """Track every triple in the cache's frozen plan (optionally
        filtered to the named families); returns how many are tracked.
        Benchmarks pass a single-family filter so detection latency is
        deterministic."""
        plan = self.cache.frozen_plan
        if plan is None:
            return 0
        allowed = set(families) if families is not None else None
        for family, machine, data in plan.triples:
            if machine.name != self.machine.name:
                continue
            if allowed is not None and family.name not in allowed:
                continue
            self.track(family, data)
        return len(self._triples)

    # -- the tick hook --------------------------------------------------------
    def on_tick(self, tick: int) -> None:
        """Called once per engine tick; probes on every ``probe_every``-th
        tick, round-robin across tracked triples.  Non-probe ticks return
        after one modulo check."""
        if not self._triples or tick % self.probe_every != 0:
            return
        states = list(self._triples.values())
        st = states[self._rr % len(states)]
        self._rr += 1
        self._probe(st, tick)

    # -- probing --------------------------------------------------------------
    def _incumbent(self, st: _TripleState) -> Optional[Candidate]:
        ent = self.cache.frozen_entry(st.family.name, self.machine.name,
                                      st.data)
        return ent.candidate if ent is not None else None

    def _pool(self, st: _TripleState) -> List[Candidate]:
        """Lazy ranked candidate pool (incumbent's rivals come from here)."""
        if st.pool is None:
            try:
                ranked = self.ranker(st.family, self.machine, st.data)
            except ValueError:
                ranked = []
            st.pool = list(ranked)[:self.top_k + 1]
        return st.pool

    def _sample(self, st: _TripleState, cand: Candidate,
                shape: Mapping[str, int]) -> None:
        try:
            faults.maybe_fault("monitor.probe")
            reps = self.timer(st.family, cand.plan, dict(cand.assignment),
                              dict(shape), self.measure)
            us = trimmed_mean_us(reps, self.measure.trim)
        except faults.FatalFault:
            raise
        except Exception as e:                # noqa: BLE001 — failure is data
            if device_error(e):
                raise                         # the context may be lost
            self.stats.probe_failures += 1
            return
        key = cand_key(cand)
        res = st.reservoirs.get(key)
        if res is None:
            res = st.reservoirs[key] = _Reservoir(self.reservoir_cap)
        res.add(us, self._rng)
        self.stats.samples += 1

    def _probe(self, st: _TripleState, tick: int) -> None:
        incumbent = self._incumbent(st)
        if incumbent is None:
            return                            # not frozen: nothing to guard
        inc_key = cand_key(incumbent)
        rivals = [c for c in self._pool(st) if cand_key(c) != inc_key]
        if not rivals:
            return                            # nothing ranked to challenge
        challenger = rivals[st.rr % len(rivals)]
        st.rr += 1
        shape = measure_shape(
            st.family.name, st.data,
            [incumbent.assignment] + [c.assignment for c in rivals],
            self.measure.max_dim)
        self._sample(st, incumbent, shape)
        self._sample(st, challenger, shape)
        self.stats.probes += 1
        st.probes_in_window += 1
        if st.probes_in_window >= self.window:
            st.probes_in_window = 0
            self._close_window(st, tick, incumbent, rivals)

    # -- deciding -------------------------------------------------------------
    def _close_window(self, st: _TripleState, tick: int,
                      incumbent: Candidate, rivals: List[Candidate]) -> None:
        self.stats.windows += 1
        inc_res = st.reservoirs.get(cand_key(incumbent))
        inc_med = inc_res.median() if inc_res is not None else None
        if inc_med is None:
            st.streak = 0
            return
        best: Optional[Tuple[float, Candidate]] = None
        for c in rivals:
            res = st.reservoirs.get(cand_key(c))
            med = res.median() if res is not None else None
            if med is not None and (best is None or med < best[0]):
                best = (med, c)
        if best is None or best[0] * self.threshold >= inc_med:
            st.streak = 0                     # agreement (or no evidence)
            return
        self.stats.disagreements += 1
        st.streak += 1
        if st.streak >= self.patience:
            self._swap(st, tick, incumbent, best[1], inc_med, best[0])

    # -- swapping -------------------------------------------------------------
    def _infeasible(self, family: FamilySpec, data: Mapping[str, int],
                    cand: Candidate) -> bool:
        """Re-prove the challenger against the constraint tree — measured
        speed never overrides feasibility (same check as the disk tier's
        bucket re-validation)."""
        leaves = comprehensive_tree(family)
        if not 0 <= int(cand.leaf_index) < len(leaves):
            return True
        leaf = leaves[int(cand.leaf_index)]
        full = {**self.machine.bindings(),
                **{k: int(v) for k, v in data.items()},
                **{k: int(v) for k, v in cand.assignment.items()}}
        cs = leaf.constraints.specialize(full)
        if cs.decided:
            return cs.infeasible
        return (leaf.constraints.subs(full).check(samples=64)
                is Verdict.INCONSISTENT)

    def _swap(self, st: _TripleState, tick: int, incumbent: Candidate,
              challenger: Candidate, inc_us: float, ch_us: float) -> None:
        st.streak = 0
        if self._infeasible(st.family, st.data, challenger):
            # drop it from the pool for good: no counter sequence may ever
            # re-nominate a candidate the constraint system disproves
            self.stats.swap_blocked_infeasible += 1
            ck = cand_key(challenger)
            st.pool = [c for c in (st.pool or []) if cand_key(c) != ck]
            return
        # publish-if-unchanged: capture the generation, then merge through
        # the cache's atomic freeze path; a concurrent unfreeze/clear wins
        gen = self.cache.unfreeze_generation
        plan = self.cache.freeze_resolved(
            [(st.family, self.machine, st.data, challenger, "measured")],
            _expect_unfreeze_gen=gen)
        ent = (plan.get(st.family.name, self.machine.name, st.data)
               if plan is not None else None)
        if ent is None or cand_key(ent.candidate) != cand_key(challenger):
            self.stats.swap_blocked_gen += 1
            return
        self.stats.swaps += 1
        event = SwapEvent(tick=tick, family=st.family.name,
                          data=tuple(sorted(st.data.items())),
                          old=cand_key(incumbent), new=cand_key(challenger),
                          incumbent_us=float(inc_us),
                          challenger_us=float(ch_us),
                          windows=self.patience)
        self.events.append(event)
        if obs._recorder is not None:         # join the provenance stream
            obs._recorder.emit(event)
        _LOG.info("kernel hot-swap: %s", event.describe())

    # -- observability --------------------------------------------------------
    def stats_line(self) -> str:
        s = self.stats
        return (f"monitor probes={s.probes} windows={s.windows} "
                f"disagree={s.disagreements} swaps={s.swaps} "
                f"blocked={s.swap_blocked_infeasible + s.swap_blocked_gen}")
