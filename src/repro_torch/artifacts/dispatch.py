"""O(1) runtime dispatch over precompiled case discussions.

``DispatchCache.best_variant`` resolves a (family, machine, data) triple
through a frozen fast lane plus three tiers:

  0. **frozen plan** — an immutable snapshot built by :meth:`DispatchCache.
     freeze` from warm-up triples (``warm_kernel_dispatch`` feeds it), or
     pinned directly from a shipped serve-plan artifact via
     :meth:`DispatchCache.freeze_resolved` (:mod:`repro_torch.plans`).  The
     read path (:meth:`DispatchCache.warm_callable`) is a single GIL-atomic
     plain-dict lookup: no lock, no key re-sorting (canonical keys are
     ``frozenset`` item views; steady-state keys are learned call-site item
     tuples), and each entry carries the **pre-instantiated kernel
     callables** so a warm op call never rebuilds a wrapper.
     Misses fall through to the locked tiers;
  1. **memory LRU** — exact-key memo of resolved :class:`Candidate`s; a
     recurring triple (the serving steady state) costs one dict lookup;
  2. **disk artifact** — a per-machine dispatch table compiled offline
     (:mod:`repro_torch.artifacts.compile`): leaves pre-specialized against the
     machine bindings and candidates pre-ranked per data-shape *bucket*
     (dims rounded up to powers of two).  On a bucket hit the ranked list is
     re-validated against the *exact* data — a constant number of constraint
     substitutions, no enumeration — so an off-grid shape still gets a sound
     answer from the precompiled ranking;
  3. **cold rebuild** — full ``rank_candidates`` over the tree (itself
     loaded from the tree artifact when present, rebuilt in-process when
     not).

Within tier 2, a FORMAT_VERSION-2 table may carry a ``measured_ranks``
section written by a tuner: per bucket, the candidate order observed on
real hardware.  When present
and well-formed it *reorders* the shortlist walk — measured rank beats the
symbolic score — but it can never add candidates; feasibility still comes
from the leaf constraints alone.

Invariants this module maintains (tests enforce them):

- **cache-miss-never-error** — a missing, unreadable, version-mismatched,
  or field-mangled table (including a malformed ``measured_ranks`` or
  ``calibration`` section) degrades to the next tier; no artifact content
  can raise out of ``best_variant``;
- **soundness** — tier 2 never invents feasibility: every candidate it
  returns passes the same leaf-constraint check the cold path applies; if
  the whole precompiled shortlist fails for the exact data, we fall through
  to tier 3;
- **parity without tuning** — a table with no ``measured_ranks`` section
  resolves exactly as the symbolic cold path would (asserted by the
  artifact/tuning test suites);
- **frozen parity** — ``freeze`` snapshots resolutions produced by the very
  tiers above, so with and without a frozen plan every triple resolves to
  the same candidate (asserted by the fast-lane tests).

The port keys a frozen entry's callables, ``warm_callable`` and
``instantiate`` on the device type of the tensors (``"cuda"`` launches the
hand-written kernel, ``"cpu"`` runs its plain version) where the JAX
package keys them on ``interpret``, and binds data through
:func:`repro_torch.core.select.bind` (a data key naming a machine symbol
raises).  With a flight recorder installed (:mod:`repro_torch.obs`) every
resolution through the tiers, every counted frozen-plan hit and every
demotion joins the trace.  Under a captured CUDA graph the model dispatches
at the capture, not at a replay, so a demotion republishes the frozen pick
and the engine recaptures the steps that launch it
(:mod:`repro_torch.runtime.serving`).
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, FrozenSet, Iterable, Iterator, List,
                    Mapping, Optional, Sequence, Tuple)

from ..core.constraints import Verdict
from ..core.params import MachineDescription
from ..core.plan import FamilySpec, Leaf
from ..core.select import Candidate, bind, rank_candidates
from ..obs import recorder as obs
from ..obs.events import DispatchDecision, describe_transition
from . import serde
from .store import ArtifactStore

DispatchKey = Tuple[str, str, Tuple[Tuple[str, int], ...]]
FrozenKey = Tuple[str, str, FrozenSet[Tuple[str, int]]]

#: Identity of a candidate for demotion/comparison purposes: the leaf it
#: came from + its full program-parameter assignment (scores are *model*
#: opinions and excluded).  The runtime monitor re-exports these.
CandKey = Tuple[int, Tuple[Tuple[str, int], ...]]


def cand_key(c: Candidate) -> CandKey:
    return (int(c.leaf_index),
            tuple(sorted((k, int(v)) for k, v in c.assignment.items())))


@dataclass(frozen=True)
class DegradeEvent:
    """One observable fall down the candidate ranking (the failure-path
    mirror of the monitor's ``SwapEvent``): which pick raised, what
    replaced it, and why.  ``exhausted`` flags a full wrap-around — every
    ranked candidate had been demoted, so the ladder reset to the top pick
    rather than leave the triple unresolvable (cache-miss-never-error
    extends to demotion: dispatch always answers)."""

    tick: int
    family: str
    machine: str
    data: Tuple[Tuple[str, int], ...]        # sorted items
    old: CandKey
    new: CandKey
    error: str                               # repr of the triggering failure
    source: str                              # tier that decided the fallback
    exhausted: bool = False

    def describe(self) -> str:
        # rendered through the shared obs convention so the degrade and
        # swap logs cannot drift (a test pins this format)
        tail = " [ladder exhausted; reset]" if self.exhausted else ""
        return describe_transition(
            tick=self.tick, verb="demoted", family=self.family,
            data=self.data, old=str(self.old[1]), new=str(self.new[1]),
            note=self.source, cause=self.error, tail=tail)


def frozen_key(family_name: str, machine_name: str,
               data: Mapping[str, int]) -> FrozenKey:
    """Fast-lane key: hashing a ``frozenset`` skips the LRU key's sort."""
    return (family_name, machine_name,
            frozenset((k, int(v)) for k, v in data.items()))


@dataclass(frozen=True)
class FrozenEntry:
    """One warm-up triple's snapshot: the resolved candidate, the tier that
    decided it, and the memoized kernel callables for each device type
    (identity-stable — built once through the family's instantiation
    cache).  ``"cuda"`` is the hand-written kernel, ``"cpu"`` its plain
    PyTorch version."""

    candidate: Candidate
    source: str                            # "measured" | "symbolic" | "cold"
    fns: Dict[str, Callable]               # device type -> callable


#: Device types a frozen entry pins a callable for.
DEVICES = ("cuda", "cpu")


def _pin_entry(family: FamilySpec, cand: Candidate,
               source: str) -> FrozenEntry:
    """Build one frozen entry: the memoized (identity-stable) kernel
    callables for each device type.  Single-sourced so entries pinned
    online (``freeze``) and from a shipped plan (``freeze_resolved``) can
    never be constructed differently."""
    fns = {dev: family.instantiate(cand.plan, cand.assignment, device=dev,
                                   leaf_index=cand.leaf_index)
           for dev in DEVICES}
    return FrozenEntry(candidate=cand, source=source, fns=fns)


class FrozenDispatchPlan:
    """Immutable (family, machine, shape) -> :class:`FrozenEntry` resolver.

    Once constructed the entry dict is never mutated, so concurrent readers
    need no lock: ``DispatchCache.freeze`` publishes a *new* plan object and
    swaps the reference, which is atomic under the GIL.

    The steady-state lookup (:meth:`DispatchCache.warm_callable`) keys an
    *fns alias table* on ``(family object, machine name, items tuple,
    device type)`` and maps straight to the ready kernel callable: the family
    object hashes by identity, the machine name's string hash is cached,
    and the items tuple is whatever ordering the call site builds — no
    sort, no per-item ``int()`` coercion, no intermediate entry object.
    First contact from a call site goes through the canonical
    order-insensitive :func:`frozen_key` (:meth:`learn_fn`) and memoizes
    the cheap key.  Alias inserts are plain-dict stores (GIL-atomic,
    monotonic, bounded by frozen-triples x call sites x 2); the entry map
    itself stays frozen."""

    __slots__ = ("_entries", "_fns", "triples")

    def __init__(self, entries: Mapping[FrozenKey, FrozenEntry],
                 triples: Tuple[Tuple[FamilySpec, MachineDescription,
                                      Mapping[str, int]], ...] = ()):
        self._entries: Dict[FrozenKey, FrozenEntry] = dict(entries)
        self._fns: Dict[Tuple[Any, str, Tuple[Tuple[str, int], ...], str],
                        Callable] = {}
        #: the (family, machine, data) warm-up set this plan snapshots —
        #: kept so a late store attach can re-freeze the same triples
        #: against the new tables instead of pinning stale answers
        self.triples = tuple(triples)

    def get(self, family_name: str, machine_name: str,
            data: Mapping[str, int]) -> Optional[FrozenEntry]:
        return self._entries.get(frozen_key(family_name, machine_name, data))

    def learn_fn(self, family: FamilySpec, machine_name: str,
                 items: Tuple[Tuple[str, int], ...],
                 device: str) -> Optional[Callable]:
        """Slow half of the fns-alias lookup: canonical resolution + alias
        memoization for this call site's item ordering."""
        ent = self._entries.get(
            frozen_key(family.name, machine_name, dict(items)))
        if ent is None or device not in ent.fns:
            return None
        fn = ent.fns[device]
        self._fns[(family, machine_name, items, device)] = fn
        return fn

    def entries(self) -> Dict[FrozenKey, FrozenEntry]:
        """Copy of the entry map (freeze merges through this)."""
        return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


class DispatchRecord:
    """Ordered, deduplicated log of dispatch requests seen while a
    :meth:`DispatchCache.record` context is active.

    Each request is normalized to ``(family_name, machine_name, sorted data
    items)`` so the same triple reached through ``best_variant`` and through
    an op wrapper's ``warm_callable`` items tuple records identically.
    ``counts`` keeps the raw request multiplicity per triple.  Recording is
    a tracing/observability mode (the plans' tracing drives model steps
    through it): appends are plain GIL-atomic dict/list stores, adequate for
    single-threaded tracing, not a concurrency surface."""

    __slots__ = ("requests", "counts")

    def __init__(self) -> None:
        self.requests: List[Tuple[str, str, Tuple[Tuple[str, int], ...]]] = []
        self.counts: Dict[Tuple[str, str, Tuple[Tuple[str, int], ...]],
                          int] = {}

    def add(self, family_name: str, machine_name: str,
            data: Mapping[str, int]) -> None:
        key = (family_name, machine_name,
               tuple(sorted((k, int(v)) for k, v in data.items())))
        n = self.counts.get(key)
        if n is None:
            self.requests.append(key)
            self.counts[key] = 1
        else:
            self.counts[key] = n + 1

    def triples(self) -> List[Tuple[str, str, Dict[str, int]]]:
        """The recorded warm set, first-request order, one row per triple."""
        return [(f, m, dict(items)) for f, m, items in self.requests]

    def __len__(self) -> int:
        return len(self.requests)


def bucket_key(data: Mapping[str, int]) -> str:
    """Canonical data-shape bucket: each dim rounded up to a power of two."""
    parts = []
    for k in sorted(data):
        v = max(1, int(data[k]))
        parts.append(f"{k}{1 << (v - 1).bit_length()}")
    return "|".join(parts)


@dataclass
class DispatchStats:
    """Per-cache resolution counters.

    ``memory_hits``/``disk_hits``/``cold_builds`` are incremented under the
    cache lock — every locked-tier resolution bumps exactly one of them, so
    their sum equals the number of non-frozen ``best_variant`` calls even
    under concurrency (the regression tests assert this).  ``frozen_hits``
    is bumped on the lock-free ``best_variant``/``frozen_entry`` fast paths
    and is therefore *monotonic but approximate* under extreme contention —
    observability must not cost the hot path a lock.  ``warm_callable``,
    the nanosecond lane, is deliberately uncounted (see its docstring)."""

    memory_hits: int = 0
    disk_hits: int = 0
    cold_builds: int = 0
    measured_hits: int = 0        # disk hits served in measured (tuned) order
    frozen_hits: int = 0          # fast-lane hits (lock-free, approximate)
    demotions: int = 0            # candidates demoted after a runtime failure

    def reset(self) -> None:
        self.memory_hits = self.disk_hits = self.cold_builds = 0
        self.measured_hits = self.frozen_hits = self.demotions = 0

    def as_dict(self) -> Dict[str, int]:
        return {"memory_hits": self.memory_hits, "disk_hits": self.disk_hits,
                "cold_builds": self.cold_builds,
                "measured_hits": self.measured_hits,
                "frozen_hits": self.frozen_hits,
                "demotions": self.demotions}


class DispatchCache:
    """Memory LRU -> disk artifact -> cold rebuild, per paper's load-time split.

    Thread notes: the LRU, memoized tables/trees, and stats are lock-
    protected; concurrent misses on the same uncached triple may duplicate
    the (idempotent) tier-2/3 work, with one winner filling the LRU."""

    def __init__(self, store: Optional[ArtifactStore] = None,
                 maxsize: int = 4096,
                 store_resolver: Optional[
                     Callable[[], Optional[ArtifactStore]]] = None):
        self.store = store
        # re-probed on tier-2/3 entry while no store is attached (an artifact
        # dir that appears after first dispatch must not be ignored forever);
        # deliberately NOT consulted on the frozen/LRU hit paths, which stay
        # syscall-free
        self._store_resolver = store_resolver
        self.maxsize = maxsize
        self.stats = DispatchStats()
        # key -> (candidate, source) where source records which ranking
        # decided the original resolution: "measured" | "symbolic" | "cold"
        self._lru: "OrderedDict[DispatchKey, Tuple[Candidate, str]]" = \
            OrderedDict()
        # key -> the winning candidate's walk rank in the ranking that
        # decided it (provenance for the obs DispatchDecision records;
        # evicted/invalidated in lockstep with the LRU)
        self._ranks: Dict[DispatchKey, int] = {}
        # (family, machine) -> (raw payload, leaves parsed once) or None
        self._tables: Dict[Tuple[str, str],
                           Optional[Tuple[Dict[str, Any],
                                          Dict[int, Leaf]]]] = {}
        self._trees: Dict[str, Optional[List[Leaf]]] = {}
        self._lock = threading.Lock()
        # recording mode (see record()): None except while a trace is active
        self._recorder: Optional[DispatchRecord] = None
        # graceful degradation (see demote()): per-triple candidate keys the
        # runtime proved broken; the tiers skip them until a promotion
        # (frozen publish of a marked candidate) or exhaustion-reset clears
        # the mark
        self._demoted: Dict[DispatchKey, set] = {}
        self.degrade_events: List[DegradeEvent] = []
        # fast lane: swapped atomically by freeze(), read without the lock
        self.frozen_plan: Optional[FrozenDispatchPlan] = None
        # bumped by unfreeze()/clear(); attach_store's re-freeze aborts if
        # it changed, so an explicit drop is never silently resurrected
        self._unfreeze_gen = 0

    # -- public API ----------------------------------------------------------
    def best_variant(self, family: FamilySpec, machine: MachineDescription,
                     data: Mapping[str, int]) -> Candidate:
        return self.best_variant_with_source(family, machine, data)[0]

    def best_variant_with_source(self, family: FamilySpec,
                                 machine: MachineDescription,
                                 data: Mapping[str, int]
                                 ) -> Tuple[Candidate, str]:
        """Resolve, also reporting which ranking decided the candidate:
        ``"measured"`` (tuned table order), ``"symbolic"`` (precompiled
        offline ranking), or ``"cold"`` (tier-3 rebuild).  A memory hit
        returns the source recorded when the triple was first resolved, so
        attribution is race-free under concurrent callers."""
        rec = self._recorder
        if rec is not None:
            rec.add(family.name, machine.name, data)
        frozen = self.frozen_plan                 # snapshot: freeze() swaps whole
        if frozen is not None:
            ent = frozen.get(family.name, machine.name, data)
            if ent is not None:
                self.stats.frozen_hits += 1   # lock-free => approximate
                if obs._recorder is not None:
                    key = (family.name, machine.name,
                           tuple(sorted((k, int(v))
                                        for k, v in data.items())))
                    self._emit_decision(key, ent.candidate, ent.source,
                                        0, 0, surface="frozen")
                return ent.candidate, ent.source
        return self._resolve_tiers(family, machine, data)

    def _resolve_tiers(self, family: FamilySpec,
                       machine: MachineDescription,
                       data: Mapping[str, int]) -> Tuple[Candidate, str]:
        """Tiers 1-3 only (no frozen-plan consult): the shared resolution
        body, called directly by ``freeze`` so a *re*-freeze re-reads the
        (possibly newly attached or re-tuned) tables instead of replaying
        its own previous snapshot."""
        key: DispatchKey = (family.name, machine.name,
                            tuple(sorted((k, int(v)) for k, v in data.items())))
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.stats.memory_hits += 1
                rank = self._ranks.get(key, -1)
                demoted = len(self._demoted.get(key, ()))
                self._emit_decision(key, hit[0], hit[1], rank, demoted)
                return hit
            excluded = frozenset(self._demoted.get(key, ()))

        hit2 = self._from_disk(family, machine, data, exclude=excluded)
        if hit2 is None:
            ranked = rank_candidates(family, machine, data,
                                     leaves=self._tree(family))
            rank = next((i for i, c in enumerate(ranked)
                         if cand_key(c) not in excluded),
                        0)           # ladder exhausted: wrap to the top pick
            cold = ranked[rank]

        with self._lock:
            if hit2 is not None:
                cand, measured, rank = hit2
                source = "measured" if measured else "symbolic"
                self.stats.disk_hits += 1
                if measured:
                    self.stats.measured_hits += 1
            else:
                self.stats.cold_builds += 1
                cand, source = cold, "cold"
            self._lru[key] = (cand, source)
            self._lru.move_to_end(key)
            self._ranks[key] = rank
            while len(self._lru) > self.maxsize:
                old_key, _ = self._lru.popitem(last=False)
                self._ranks.pop(old_key, None)
        self._emit_decision(key, cand, source, rank, len(excluded))
        return cand, source

    def _emit_decision(self, key: DispatchKey, cand: Candidate, source: str,
                       rank: int, demoted: int,
                       surface: str = "resolve") -> None:
        """Trace one resolution as a :class:`DispatchDecision` — the
        decision-provenance record (tree leaf + assignment + bucket +
        deciding ranking + walk rank + demotion marks in effect).  One
        module-global load when tracing is off."""
        rec = obs._recorder
        if rec is None:
            return
        rec.emit(DispatchDecision(
            tick=rec.tick, family=key[0], machine=key[1], data=key[2],
            bucket=bucket_key(dict(key[2])), leaf=int(cand.leaf_index),
            assignment=tuple(sorted((k, int(v))
                             for k, v in cand.assignment.items())),
            source=source, surface=surface, rank=int(rank),
            demoted=int(demoted)))

    # -- graceful degradation ------------------------------------------------
    def demote(self, family: FamilySpec, machine: MachineDescription,
               data: Mapping[str, int], *,
               candidate: Optional[Candidate] = None,
               error: Optional[BaseException] = None,
               tick: int = -1) -> Candidate:
        """A runtime failure disproved the triple's current pick: fall down
        the already-proven ranking to the next feasible variant.

        The failing ``candidate`` (defaulting to the triple's current
        resolution) is marked broken for this triple; the replacement is
        re-resolved through the normal tiers with marked candidates
        skipped — so the fallback order *is* the case discussion's ranking
        (measured beats symbolic beats cold), not a separate policy.  If
        the triple is frozen, the replacement is republished through the
        atomic ``freeze_resolved`` merge so the lock-free lane degrades
        too.  When every ranked candidate has been demoted the ladder
        resets: marks are cleared, the top pick returns, and the event is
        flagged ``exhausted`` — dispatch always answers (the engine's
        retry budget, not the cache, decides when to give up on a
        request).  Marks are cleared early when a candidate is re-promoted
        into the frozen lane (the monitor's measured recovery path).

        Returns the replacement candidate; records a :class:`DegradeEvent`
        in :attr:`degrade_events` and bumps ``stats.demotions``."""
        key: DispatchKey = (family.name, machine.name,
                            tuple(sorted((k, int(v))
                                         for k, v in data.items())))
        if candidate is None:
            ent = self.frozen_entry(family.name, machine.name, data)
            if ent is not None:
                candidate = ent.candidate
            else:
                with self._lock:
                    hit = self._lru.get(key)
                candidate = hit[0] if hit is not None else None
        if candidate is None:                 # never resolved: resolve first
            candidate = self._resolve_tiers(family, machine, data)[0]
        old_key = cand_key(candidate)
        with self._lock:
            self._demoted.setdefault(key, set()).add(old_key)
            self._lru.pop(key, None)          # replacement re-resolves fresh
            self._ranks.pop(key, None)
            self.stats.demotions += 1
        new_cand, source = self._resolve_tiers(family, machine, data)
        exhausted = cand_key(new_cand) in self._demoted.get(key, ())
        if exhausted:                         # full wrap-around: reset ladder
            with self._lock:
                self._demoted.pop(key, None)
        frozen = self.frozen_plan
        if frozen is not None and \
                frozen.get(family.name, machine.name, data) is not None:
            self.freeze_resolved([(family, machine, data, new_cand, source)])
        event = DegradeEvent(
            tick=int(tick), family=family.name, machine=machine.name,
            data=key[2], old=old_key, new=cand_key(new_cand),
            error=repr(error) if error is not None else "",
            source=source, exhausted=exhausted)
        self.degrade_events.append(event)
        if obs._recorder is not None:         # join the provenance stream
            obs._recorder.emit(event)
        return new_cand

    def demoted_keys(self, family_name: str, machine_name: str,
                     data: Mapping[str, int]) -> FrozenSet[CandKey]:
        """The triple's current runtime-broken marks (observability)."""
        key: DispatchKey = (family_name, machine_name,
                            tuple(sorted((k, int(v))
                                         for k, v in data.items())))
        with self._lock:
            return frozenset(self._demoted.get(key, ()))

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._ranks.clear()
            self._tables.clear()
            self._trees.clear()
            self.stats.reset()
            self.frozen_plan = None
            self._demoted.clear()
            self.degrade_events.clear()
            self._unfreeze_gen += 1

    def attach_store(self, store: Optional[ArtifactStore]) -> None:
        """Swap the disk tier, dropping table/tree memos pinned against the
        old store (``get_default_cache`` uses this when an artifact dir
        appears after first dispatch).  The LRU is dropped too: triples
        resolved cold before the store appeared must re-resolve against the
        (possibly tuned) tables, not stay pinned to their cold answer.
        A frozen plan is *re-frozen* over its own warm-up triples for the
        same reason — the serving hot path must not keep replaying
        pre-artifact cold picks (tier parity: the re-freeze resolves
        through the new tables)."""
        with self._lock:
            self.store = store
            self._tables.clear()
            self._trees.clear()
            self._lru.clear()
            self._ranks.clear()
            plan, self.frozen_plan = self.frozen_plan, None
            gen = self._unfreeze_gen
        if plan is not None and plan.triples:
            # re-pin against the new store — unless someone unfreezes while
            # we resolve, in which case their drop wins (no resurrection)
            self.freeze(plan.triples, _expect_unfreeze_gen=gen)

    def __len__(self) -> int:
        return len(self._lru)

    # -- tier 0: frozen dispatch plans ---------------------------------------
    def freeze(self, triples: Iterable[Tuple[FamilySpec, MachineDescription,
                                             Mapping[str, int]]],
               *, _expect_unfreeze_gen: Optional[int] = None
               ) -> Optional[FrozenDispatchPlan]:
        """Snapshot resolutions for ``triples`` into the lock-free fast lane.

        Each triple is resolved through the normal tiers (warming the LRU),
        then pinned — candidate, deciding source, and the memoized kernel
        callables of each device type — into a fresh immutable
        :class:`FrozenDispatchPlan` merged over any previous plan (freezing
        is monotonic until :meth:`unfreeze`/:meth:`clear`).  Publishing is a
        single reference swap, so resolves racing a concurrent ``freeze``
        see either the old or the new plan, never a torn one.

        Parity is structural: a frozen entry replays exactly what the tiers
        resolved at freeze time, and the tiers themselves are deterministic
        for fixed artifacts — so freezing can change the cost of a lookup,
        never its answer.  Resolution deliberately bypasses the existing
        frozen plan (:meth:`_resolve_tiers`): re-freezing a triple re-reads
        the current tables, so warm-up after compiling/tuning artifacts
        refreshes stale cold snapshots instead of re-pinning them."""
        resolved: Dict[FrozenKey, FrozenEntry] = {}
        new_triples: Dict[FrozenKey, Tuple[Any, Any, Mapping[str, int]]] = {}
        for family, machine, data in triples:
            cand, source = self._resolve_tiers(family, machine, data)
            key = frozen_key(family.name, machine.name, data)
            resolved[key] = _pin_entry(family, cand, source)
            new_triples[key] = (family, machine, data)
        return self._publish_frozen(resolved, new_triples,
                                    _expect_unfreeze_gen)

    def freeze_resolved(self, entries: Iterable[
            Tuple[FamilySpec, MachineDescription, Mapping[str, int],
                  Candidate, str]],
            *, _expect_unfreeze_gen: Optional[int] = None
            ) -> Optional[FrozenDispatchPlan]:
        """Pin *externally resolved* triples into the fast lane.

        Each entry carries its own :class:`Candidate` and deciding source, so
        no tier is consulted and no tree is enumerated — this is how a
        shipped serve-plan artifact (:mod:`repro_torch.plans`) starts a process
        with ``stats.cold_builds == 0``.  The kernel callables still come
        from the family's memoized ``instantiate`` (identity-stable), and
        publication merges over any existing plan exactly like
        :meth:`freeze`.  The triples are remembered, so a later
        ``attach_store`` re-freeze re-resolves them through the (new) tiers
        — plan-fed picks are re-pinned against fresh tables, not kept
        authoritative forever."""
        resolved: Dict[FrozenKey, FrozenEntry] = {}
        new_triples: Dict[FrozenKey, Tuple[Any, Any, Mapping[str, int]]] = {}
        for family, machine, data, cand, source in entries:
            key = frozen_key(family.name, machine.name, data)
            resolved[key] = _pin_entry(family, cand, source)
            new_triples[key] = (family, machine, data)
        return self._publish_frozen(resolved, new_triples,
                                    _expect_unfreeze_gen)

    def _publish_frozen(self, resolved: Dict[FrozenKey, FrozenEntry],
                        new_triples: Dict[FrozenKey, Tuple[Any, Any,
                                                           Mapping[str, int]]],
                        expect_unfreeze_gen: Optional[int]
                        ) -> Optional[FrozenDispatchPlan]:
        """Shared merge-and-swap tail of freeze/freeze_resolved."""
        with self._lock:
            if (expect_unfreeze_gen is not None
                    and self._unfreeze_gen != expect_unfreeze_gen):
                return self.frozen_plan       # a concurrent unfreeze won
            old = self.frozen_plan
            merged = old.entries() if old is not None else {}
            merged.update(resolved)
            all_triples = {frozen_key(f.name, m.name, d): (f, m, d)
                           for f, m, d in (old.triples if old is not None
                                           else ())}
            all_triples.update(new_triples)
            plan = FrozenDispatchPlan(merged, tuple(all_triples.values()))
            self.frozen_plan = plan
            # promotion clears demotion: publishing a candidate into the
            # fast lane (the monitor's measured re-promote path) is the
            # evidence it recovered — the locked tiers must agree with the
            # frozen lane, so its runtime-broken mark is dropped
            if self._demoted:
                for fkey, ent in resolved.items():
                    fam, mach, d = new_triples[fkey]
                    dkey: DispatchKey = (
                        fam.name, mach.name,
                        tuple(sorted((k, int(v)) for k, v in d.items())))
                    marks = self._demoted.get(dkey)
                    if marks is not None:
                        marks.discard(cand_key(ent.candidate))
                        if not marks:
                            del self._demoted[dkey]
        return plan

    # -- recording mode (warm-set tracing) -----------------------------------
    @contextlib.contextmanager
    def record(self) -> Iterator[DispatchRecord]:
        """Record every dispatch request while the context is active.

        The counted entry points are ``best_variant``/
        ``best_variant_with_source`` (and everything routed through them,
        e.g. ``core.select.best_variant``) and the ops-layer
        ``warm_callable`` — i.e. exactly the requests a model step issues.
        A captured step records, under this context, the triples its capture
        resolved (:mod:`repro_torch.runtime.graph`).  Contexts do
        not nest usefully (the innermost recorder wins and is restored on
        exit); recording costs the hot path one attribute test when off."""
        rec = DispatchRecord()
        prev, self._recorder = self._recorder, rec
        try:
            yield rec
        finally:
            self._recorder = prev

    @property
    def unfreeze_generation(self) -> int:
        """Current unfreeze generation, for publish-if-unchanged races.

        Capture before resolving a replacement plan off-lock, then pass to
        ``freeze``/``freeze_resolved`` as ``_expect_unfreeze_gen``: if any
        ``unfreeze``/``clear`` landed in between, the publish aborts and the
        explicit drop wins (the ``attach_store`` re-freeze discipline; the
        runtime monitor's hot-swap uses the same guard)."""
        with self._lock:
            return self._unfreeze_gen

    def unfreeze(self) -> None:
        """Drop the frozen plan; the locked tiers keep serving.

        Taken under the lock so a ``freeze`` racing this call cannot
        resurrect dropped entries: freeze's merge-and-publish also holds
        the lock, so it sees either the plan (drop wins afterwards) or
        ``None`` (merge starts empty) — never a torn in-between.  The
        generation bump additionally aborts an in-flight ``attach_store``
        re-freeze, which captured its plan *before* this drop."""
        with self._lock:
            self.frozen_plan = None
            self._unfreeze_gen += 1

    def frozen_entry(self, family_name: str, machine_name: str,
                     data: Mapping[str, int]) -> Optional[FrozenEntry]:
        """Lock-free fast-lane lookup by data mapping: the entry with the
        pre-built callables, or ``None`` when the triple was never frozen
        (callers fall back to the locked tiers)."""
        frozen = self.frozen_plan
        if frozen is None:
            return None
        ent = frozen.get(family_name, machine_name, data)
        if ent is not None:
            self.stats.frozen_hits += 1       # lock-free => approximate
        return ent

    def warm_callable(self, family: FamilySpec,
                      machine: MachineDescription,
                      items: Tuple[Tuple[str, int], ...],
                      device: str = "cuda") -> Callable:
        """The warm op path (``kernels.ops`` wrappers call this per op):
        resolve (family, machine, items) straight to a ready kernel callable.

        Frozen hit: one alias-dict get, no lock, no key sort, no entry
        indirection, no rebuild — this is the hottest function in the
        serving steady state (per-call ns here multiply by tokens x ops x
        requests), which is also why it deliberately does NOT bump
        ``stats.frozen_hits``: the counted observability surfaces are
        ``best_variant*``/``frozen_entry``, and benchmarks time this lane
        directly.  Miss: locked LRU resolve + the family's *memoized*
        ``instantiate`` — still no wrapper rebuilt, identical
        candidate (frozen parity), just a lock and a sorted key dearer.

        ``items`` is the data mapping as an items tuple (any order); the
        first call from a given site teaches the plan its ordering.

        Observability contract: with obs tracing off (or on at the
        default sampling) this lane stays exactly as described above —
        each recorder check is one module-global load + ``is None`` test,
        no counters.  ``FlightRecorder(sample_frozen_every=N)`` opts into
        a 1-in-N sample of this lane (``surface="warm_sampled"``)."""
        rec = self._recorder                  # one load+test when not tracing
        if rec is not None:
            rec.add(family.name, machine.name, dict(items))
        orec = obs._recorder                  # one load+test when not tracing
        if orec is not None and orec.sample_frozen_every:
            orec.sample_warm(family.name, machine.name, items)
        frozen = self.frozen_plan
        if frozen is not None:
            fn = frozen._fns.get((family, machine.name, items, device))
            if fn is not None:
                return fn
            fn = frozen.learn_fn(family, machine.name, items, device)
            if fn is not None:
                return fn
        # straight to tiers 1-3: the frozen plan was just consulted (or is
        # absent), re-probing it inside best_variant would be dead work
        cand = self._resolve_tiers(family, machine, dict(items))[0]
        return family.instantiate(cand.plan, cand.assignment,
                                  device=device,
                                  leaf_index=cand.leaf_index)

    # -- tier 2: precompiled dispatch tables ---------------------------------
    def _try_attach_store(self) -> bool:
        """Late store resolution: ask the resolver (when configured) whether
        an artifact dir has appeared since construction."""
        if self._store_resolver is None:
            return False
        store = self._store_resolver()
        if store is None:
            return False
        self.attach_store(store)
        return True

    def _table(self, family_name: str, machine_name: str
               ) -> Optional[Tuple[Dict[str, Any], Dict[int, Leaf]]]:
        """Load + parse a dispatch table once per (family, machine)."""
        if self.store is None and not self._try_attach_store():
            return None
        tkey = (family_name, machine_name)
        with self._lock:
            if tkey in self._tables:
                return self._tables[tkey]
        parsed = None
        payload = self.store.load_dispatch(family_name, machine_name)
        if payload is not None:
            try:
                parsed = (payload, serde.table_leaves(payload))
            except (serde.ArtifactFormatError, AttributeError, KeyError,
                    TypeError, ValueError):
                parsed = None
        with self._lock:
            self._tables[tkey] = parsed
        return parsed

    @staticmethod
    def _measured_order(table: Dict[str, Any], bucket: str,
                        n_entries: int) -> Optional[List[int]]:
        """Entry order from a tuned table's ``measured_ranks`` section.

        Returns ``None`` (symbolic order) unless the section exists and the
        bucket's ``order`` is a list of unique in-range ints — any malformed
        content degrades to the symbolic ranking, never an error."""
        section = table.get("measured_ranks")
        if not isinstance(section, dict):
            return None
        rec = section.get(bucket)
        if not isinstance(rec, dict):
            return None
        order = rec.get("order")
        if not isinstance(order, list) or not order:
            return None
        try:
            idx = [int(i) for i in order]
        except (TypeError, ValueError):
            return None
        if len(set(idx)) != len(idx) or \
                any(i < 0 or i >= n_entries for i in idx):
            return None
        # entries the tuner never saw keep their symbolic rank at the tail
        seen = set(idx)
        return idx + [i for i in range(n_entries) if i not in seen]

    def _bucket_entries(self, family: FamilySpec,
                        machine: MachineDescription, data: Mapping[str, int]
                        ) -> Optional[Tuple[Dict[str, Any], Dict[int, Leaf],
                                            str, List[Any]]]:
        """Shared tier-2 prologue: load the table, reject stale machine
        bindings, find the data's bucket.  Both the resolution path
        (:meth:`_from_disk`) and the observability path
        (:meth:`rank_source`) go through here so they cannot drift."""
        loaded = self._table(family.name, machine.name)
        if loaded is None:
            return None
        table, leaves = loaded
        if table.get("machine_bindings") != machine.bindings():
            return None                       # stale table for a renamed host
        bucket = bucket_key(data)
        entries = table.get("buckets", {}).get(bucket)
        if not entries:
            return None
        return table, leaves, bucket, entries

    def _from_disk(self, family: FamilySpec, machine: MachineDescription,
                   data: Mapping[str, int],
                   exclude: FrozenSet[CandKey] = frozenset()
                   ) -> Optional[Tuple[Candidate, bool, int]]:
        """Resolve via the precompiled table; ``(candidate, measured,
        rank)`` or ``None``.  ``measured`` flags that a tuned
        (measured-rank) order decided the walk — :class:`DispatchStats`
        reports it; ``rank`` is the winner's position in that walk (0 =
        the bucket's top pick — provenance for the obs decision records).
        ``exclude`` carries runtime-demoted candidate keys
        (:meth:`demote`): the walk skips them like infeasible entries,
        falling down the same ranking; a shortlist that is *entirely*
        excluded returns ``None`` so the cold tier applies its exhaustion
        wrap-around."""
        loaded = self._bucket_entries(family, machine, data)
        if loaded is None:
            return None
        table, leaves, bucket, entries = loaded
        order = self._measured_order(table, bucket, len(entries))
        measured = order is not None
        if order is not None:
            entries = [entries[i] for i in order]
        binding = bind(machine, data)
        for rank, entry in enumerate(entries):  # best first (measured/symbolic)
            try:
                idx = int(entry["leaf_index"])
                asg = {k: int(v) for k, v in entry["assignment"].items()}
                score = float(entry["score"])
            except (AttributeError, KeyError, TypeError, ValueError):
                return None                   # mangled entry => cache miss
            if exclude and (idx, tuple(sorted(asg.items()))) in exclude:
                continue                      # runtime-demoted: next ranked
            leaf = leaves.get(idx)
            if leaf is None:
                return None
            full = {**binding, **asg}
            # fully-bound specialization decides feasibility exactly (and
            # is memoized); only unclassifiable systems pay the exact check
            cs = leaf.constraints.specialize(full)
            if cs.decided:
                infeasible = cs.infeasible
            else:
                infeasible = (leaf.constraints.subs(full).check(samples=64)
                              is Verdict.INCONSISTENT)
            if infeasible:
                continue                      # infeasible for the exact shape
            return (Candidate(leaf_index=idx, plan=leaf.plan,
                              assignment=asg, score=score), measured, rank)
        return None

    def rank_source(self, family: FamilySpec, machine: MachineDescription,
                    data: Mapping[str, int]) -> str:
        """Which ranking would decide this triple at tier 2.

        ``"measured"`` — the loaded table carries a usable measured order
        for the data's bucket; ``"symbolic"`` — a table bucket exists but
        has no (valid) measurement; ``"cold"`` — no table/bucket, tier 3
        would enumerate.  Purely observational (used by serving warm-up
        reports); does not touch the LRU or stats."""
        loaded = self._bucket_entries(family, machine, data)
        if loaded is None:
            return "cold"
        table, _, bucket, entries = loaded
        if self._measured_order(table, bucket, len(entries)) is not None:
            return "measured"
        return "symbolic"

    # -- tier 3 support: disk tree beats in-process rebuild ------------------
    def _tree(self, family: FamilySpec) -> Optional[Sequence[Leaf]]:
        if self.store is None and not self._try_attach_store():
            return None
        with self._lock:
            if family.name in self._trees:
                return self._trees[family.name]
        tree = self.store.load_tree(family.name)
        with self._lock:
            self._trees[family.name] = tree
        return tree


# ---------------------------------------------------------------------------
# Process-wide default cache (what core.select.best_variant routes through).
# ---------------------------------------------------------------------------
_default_cache: Optional[DispatchCache] = None
_default_lock = threading.Lock()


def _resolve_env_store() -> Optional[ArtifactStore]:
    import os
    root = os.environ.get("REPRO_ARTIFACT_DIR", "artifacts")
    return ArtifactStore(root) if os.path.isdir(root) else None


def get_default_cache() -> DispatchCache:
    """The process-wide cache, creating it on first touch.

    The auto-created default carries a store *resolver*: while no store is
    attached, the artifact dir (``REPRO_ARTIFACT_DIR`` or ``./artifacts``)
    is re-probed whenever a resolution reaches tier 2/3 — an artifact dir
    compiled or an env var exported *after* the first dispatch is picked
    up, not silently ignored forever.  A cache installed explicitly via
    :func:`set_default_cache` keeps whatever store the caller chose — tests
    rely on a store-less cache *staying* store-less for isolation.

    Double-checked locking: once a cache is installed, this is a lock-free
    module-global read (GIL-atomic) — it sits on the warm op path, where
    the old per-call lock acquire was measurable."""
    global _default_cache
    cache = _default_cache
    if cache is not None:
        return cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = DispatchCache(store=_resolve_env_store(),
                                           store_resolver=_resolve_env_store)
        return _default_cache


def set_default_cache(cache: Optional[DispatchCache]) -> None:
    """Install (or with ``None`` reset) the process-wide dispatch cache.

    ``None`` re-arms the environment probe: the next ``get_default_cache``
    builds a fresh default that resolves its store from the environment.
    An explicit cache is installed as-is (no resolver is grafted on)."""
    global _default_cache
    with _default_lock:
        _default_cache = cache
