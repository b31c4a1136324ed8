"""O(1) runtime dispatch over the comprehensive case discussion.

``DispatchCache.best_variant`` resolves a (family, machine, data) triple
through a frozen fast lane plus two tiers:

  0. **frozen plan** — an immutable snapshot built by :meth:`DispatchCache.
     freeze` from warm-up triples (``warm_kernel_dispatch`` feeds it).  The
     read path (:meth:`DispatchCache.warm_callable`) is a single GIL-atomic
     plain-dict lookup: no lock, no key re-sorting (canonical keys are
     ``frozenset`` item views; steady-state keys are learned call-site item
     tuples), and each entry carries the **pre-instantiated kernel
     callables**, so a warm op call never rebuilds a wrapper.  Misses fall
     through to the locked tiers;
  1. **memory LRU** — exact-key memo of resolved :class:`Candidate`s; a
     recurring triple (the serving steady state) costs one dict lookup;
  2. **cold rebuild** — full ``rank_candidates`` over the tree.

The disk tier (precompiled per-machine dispatch tables and trees), runtime
demotion and the trace hooks of the JAX package's cache are left to later
slices of the port.

Invariant (tests enforce it): **frozen parity** — ``freeze`` snapshots
resolutions produced by the very tiers above, so with and without a frozen
plan every triple resolves to the same candidate.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, FrozenSet, Iterable, Iterator, List,
                    Mapping, Optional, Tuple)

from ..core.params import MachineDescription
from ..core.plan import FamilySpec
from ..core.select import Candidate, rank_candidates

DispatchKey = Tuple[str, str, Tuple[Tuple[str, int], ...]]
FrozenKey = Tuple[str, str, FrozenSet[Tuple[str, int]]]


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
    cache).  The JAX package keys these on ``interpret``; the port keys them
    on the device type of the tensors: ``"cuda"`` is the hand-written
    kernel, ``"cpu"`` its plain PyTorch version."""

    candidate: Candidate
    source: str                            # "cold" (no disk tier yet)
    fns: Dict[str, Callable]               # device type -> callable


#: Device types a frozen entry pins a callable for.
DEVICES = ("cuda", "cpu")


def _pin_entry(family: FamilySpec, cand: Candidate,
               source: str) -> FrozenEntry:
    fns = {dev: family.instantiate(cand.plan, cand.assignment, device=dev,
                                   leaf_index=cand.leaf_index)
           for dev in DEVICES}
    return FrozenEntry(candidate=cand, source=source, fns=fns)


class FrozenDispatchPlan:
    """Immutable (family, machine, shape) -> :class:`FrozenEntry` resolver.

    Once constructed the entry dict is never mutated, so concurrent readers
    need no lock: ``DispatchCache.freeze`` publishes a *new* plan object and
    swaps the reference, which is atomic under the GIL.  The steady-state
    lookup keys an *fns alias table* on ``(family object, machine name,
    items tuple, device)`` and maps straight to the ready callable; first
    contact from a call site goes through the canonical order-insensitive
    :func:`frozen_key` (:meth:`learn_fn`) and memoizes the cheap key."""

    __slots__ = ("_entries", "_fns", "triples")

    def __init__(self, entries: Mapping[FrozenKey, FrozenEntry],
                 triples: Tuple[Tuple[FamilySpec, MachineDescription,
                                      Mapping[str, int]], ...] = ()):
        self._entries: Dict[FrozenKey, FrozenEntry] = dict(entries)
        self._fns: Dict[Tuple[Any, str, Tuple[Tuple[str, int], ...], str],
                        Callable] = {}
        self.triples = tuple(triples)

    def get(self, family_name: str, machine_name: str,
            data: Mapping[str, int]) -> Optional[FrozenEntry]:
        return self._entries.get(frozen_key(family_name, machine_name, data))

    def learn_fn(self, family: FamilySpec, machine_name: str,
                 items: Tuple[Tuple[str, int], ...],
                 device: str) -> Optional[Callable]:
        ent = self._entries.get(
            frozen_key(family.name, machine_name, dict(items)))
        if ent is None or device not in ent.fns:
            return None
        fn = ent.fns[device]
        self._fns[(family, machine_name, items, device)] = fn
        return fn

    def entries(self) -> Dict[FrozenKey, FrozenEntry]:
        return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


class DispatchRecord:
    """Ordered, deduplicated log of dispatch requests seen while a
    :meth:`DispatchCache.record` context is active; ``counts`` keeps the raw
    request multiplicity per triple."""

    __slots__ = ("requests", "counts")

    def __init__(self) -> None:
        self.requests: List[DispatchKey] = []
        self.counts: Dict[DispatchKey, int] = {}

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
        return [(f, m, dict(items)) for f, m, items in self.requests]

    def __len__(self) -> int:
        return len(self.requests)


@dataclass
class DispatchStats:
    """Per-cache resolution counters.  ``memory_hits``/``cold_builds`` are
    bumped under the lock (their sum is the number of locked resolutions);
    ``frozen_hits`` is bumped lock-free on the counted fast paths and is
    approximate under contention.  ``warm_callable`` is uncounted."""

    memory_hits: int = 0
    cold_builds: int = 0
    frozen_hits: int = 0


class DispatchCache:
    """Frozen lane -> memory LRU -> cold rebuild."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self.stats = DispatchStats()
        self._lru: "OrderedDict[DispatchKey, Tuple[Candidate, str]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self._recorder: Optional[DispatchRecord] = None
        self.frozen_plan: Optional[FrozenDispatchPlan] = None

    # -- public API ----------------------------------------------------------
    def best_variant(self, family: FamilySpec, machine: MachineDescription,
                     data: Mapping[str, int]) -> Candidate:
        return self.best_variant_with_source(family, machine, data)[0]

    def best_variant_with_source(self, family: FamilySpec,
                                 machine: MachineDescription,
                                 data: Mapping[str, int]
                                 ) -> Tuple[Candidate, str]:
        rec = self._recorder
        if rec is not None:
            rec.add(family.name, machine.name, data)
        frozen = self.frozen_plan
        if frozen is not None:
            ent = frozen.get(family.name, machine.name, data)
            if ent is not None:
                self.stats.frozen_hits += 1   # lock-free => approximate
                return ent.candidate, ent.source
        return self._resolve_tiers(family, machine, data)

    def _resolve_tiers(self, family: FamilySpec,
                       machine: MachineDescription,
                       data: Mapping[str, int]) -> Tuple[Candidate, str]:
        key: DispatchKey = (family.name, machine.name,
                            tuple(sorted((k, int(v)) for k, v in data.items())))
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.stats.memory_hits += 1
                return hit
        cand = rank_candidates(family, machine, data)[0]
        with self._lock:
            self.stats.cold_builds += 1
            self._lru[key] = (cand, "cold")
            self._lru.move_to_end(key)
            while len(self._lru) > self.maxsize:
                self._lru.popitem(last=False)
        return cand, "cold"

    def __len__(self) -> int:
        return len(self._lru)

    # -- tier 0: frozen dispatch plans ---------------------------------------
    def freeze(self, triples: Iterable[Tuple[FamilySpec, MachineDescription,
                                             Mapping[str, int]]]
               ) -> FrozenDispatchPlan:
        """Resolve ``triples`` through the tiers and pin them — candidate,
        source and the memoized callables of each device type — into a
        fresh immutable plan merged over the previous one, published by one
        reference swap."""
        resolved: Dict[FrozenKey, FrozenEntry] = {}
        new_triples: Dict[FrozenKey, Tuple[Any, Any, Mapping[str, int]]] = {}
        for family, machine, data in triples:
            cand, source = self._resolve_tiers(family, machine, data)
            key = frozen_key(family.name, machine.name, data)
            resolved[key] = _pin_entry(family, cand, source)
            new_triples[key] = (family, machine, data)
        with self._lock:
            old = self.frozen_plan
            merged = old.entries() if old is not None else {}
            merged.update(resolved)
            all_triples = {frozen_key(f.name, m.name, d): (f, m, d)
                           for f, m, d in (old.triples if old is not None
                                           else ())}
            all_triples.update(new_triples)
            plan = FrozenDispatchPlan(merged, tuple(all_triples.values()))
            self.frozen_plan = plan
        return plan

    # -- recording mode (warm-set tracing) -----------------------------------
    @contextlib.contextmanager
    def record(self) -> Iterator[DispatchRecord]:
        """Record every dispatch request (``best_variant*`` and
        ``warm_callable``) while the context is active."""
        rec = DispatchRecord()
        prev, self._recorder = self._recorder, rec
        try:
            yield rec
        finally:
            self._recorder = prev

    def warm_callable(self, family: FamilySpec,
                      machine: MachineDescription,
                      items: Tuple[Tuple[str, int], ...],
                      device: str = "cuda") -> Callable:
        """The warm op path (``kernels.ops`` wrappers call this per op):
        resolve (family, machine, items) straight to a ready kernel
        callable.  Frozen hit: one alias-dict get, no lock.  Miss: locked
        LRU (or cold) resolve plus the family's memoized ``instantiate``."""
        rec = self._recorder
        if rec is not None:
            rec.add(family.name, machine.name, dict(items))
        frozen = self.frozen_plan
        if frozen is not None:
            fn = frozen._fns.get((family, machine.name, items, device))
            if fn is not None:
                return fn
            fn = frozen.learn_fn(family, machine.name, items, device)
            if fn is not None:
                return fn
        cand = self._resolve_tiers(family, machine, dict(items))[0]
        return family.instantiate(cand.plan, cand.assignment,
                                  device=device,
                                  leaf_index=cand.leaf_index)


# ---------------------------------------------------------------------------
# Process-wide default cache (what core.select.best_variant routes through).
# ---------------------------------------------------------------------------
_default_cache: Optional[DispatchCache] = None
_default_lock = threading.Lock()


def get_default_cache() -> DispatchCache:
    """The process-wide cache, created on first touch (lock-free once set)."""
    global _default_cache
    cache = _default_cache
    if cache is not None:
        return cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = DispatchCache()
        return _default_cache


def set_default_cache(cache: Optional[DispatchCache]) -> None:
    """Install (or with ``None`` reset) the process-wide dispatch cache."""
    global _default_cache
    with _default_lock:
        _default_cache = cache
