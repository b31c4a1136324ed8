"""Instantiation fast lane: memoized kernel builders with stable identity.

The paper's offline/online split resolves the *case discussion* before the
hot loop — but resolving a :class:`~repro_torch.core.select.Candidate` is
only half of a warm op call.  The other half is ``FamilySpec.instantiate``,
which would otherwise build a fresh ``functools.partial`` over the kernel
wrapper on every call: per-call allocation on the serving steady state.

:class:`CachedInstantiationMixin` memoizes it: each kernel family implements
the raw builder as ``_build(plan, assignment, device)`` and inherits an
``instantiate`` that memoizes on

    ``(family, leaf_index, frozen assignment, frozen plan flags, device)``

so repeated resolutions of the same triple return the *same object*.  The
JAX package keys the last slot on ``interpret``; here it is the device type
(``"cuda"``: the hand-written kernel, ``"cpu"``: its plain version).

A family whose program parameter for the grain stays in the domain after
``reduce_granularity`` (K4, K6: it then stands for the source grain that did
not fit, and the kernel runs grain 1) names it in ``phantom_grain``; its
candidates that differ only there are keyed and built once, with the grain
the kernel runs (:func:`grain`).

Thread notes: reads are lock-free (GIL-atomic ``dict.get``); misses take a
per-cache lock, double-check, build once, and publish.  Eviction is
insertion-order (FIFO) at ``maxsize``.  ``hits`` is maintained without the
lock and may undercount under contention; ``misses`` (builder invocations)
is exact.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from ..core.plan import KernelPlan

InstantiationKey = Tuple[str, Optional[int], Tuple[Tuple[str, Any], ...],
                         Tuple[Tuple[str, int], ...], str]


def grain(plan: KernelPlan, s):
    """The grain the kernel runs: ``s`` at the source, 1 once
    reduce_granularity applied.  Over ints, or over polynomials for a
    counter."""
    return s if plan.flags.get("granularity_level", 0) == 0 else 1


def freeze_flags(flags: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    """Canonical hashable form of a plan's flag dict."""
    return tuple(sorted(flags.items()))


def freeze_assignment(assignment: Mapping[str, int]
                      ) -> Tuple[Tuple[str, int], ...]:
    """Canonical hashable form of a program-parameter assignment."""
    return tuple(sorted((k, int(v)) for k, v in assignment.items()))


def instantiation_key(family_name: str, plan: KernelPlan,
                      assignment: Mapping[str, int], device: str,
                      leaf_index: Optional[int] = None) -> InstantiationKey:
    return (family_name, leaf_index, freeze_flags(plan.flags),
            freeze_assignment(assignment), str(device))


class InstantiationCache:
    """Identity-stable memo of built kernel callables (one per family)."""

    def __init__(self, maxsize: int = 512):
        self.maxsize = maxsize
        self.hits = 0                      # approximate (lock-free reads)
        self.misses = 0                    # exact (builder invocations)
        self._fns: Dict[InstantiationKey, Callable] = {}
        self._lock = threading.Lock()

    def get_or_build(self, key: InstantiationKey,
                     builder: Callable[[], Callable]) -> Callable:
        fn = self._fns.get(key)            # lock-free warm path
        if fn is not None:
            self.hits += 1
            return fn
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                self.misses += 1
                fn = builder()
                if len(self._fns) >= self.maxsize:
                    self._fns.pop(next(iter(self._fns)))   # FIFO backstop
                self._fns[key] = fn
        return fn

    def __len__(self) -> int:
        return len(self._fns)


class CachedInstantiationMixin:
    """Gives a kernel family an identity-stable ``instantiate``.

    Families implement ``_build(plan, assignment, device)`` — the raw
    constructor that binds the kernel wrapper (``"cuda"``) or its plain
    version (``"cpu"``) to the assignment — and inherit the memoized public
    entry point."""

    name: str
    phantom_grain: Optional[str] = None

    @property
    def instantiation_cache(self) -> InstantiationCache:
        cache = self.__dict__.get("_inst_cache")
        if cache is None:                  # families are singletons; benign
            cache = self.__dict__.setdefault("_inst_cache",
                                             InstantiationCache())
        return cache

    def instantiate(self, plan: KernelPlan, assignment: Mapping[str, int],
                    device: str = "cuda", *,
                    leaf_index: Optional[int] = None) -> Callable:
        g = self.phantom_grain
        if g is not None:
            assignment = {**assignment, g: grain(plan, assignment[g])}
        key = instantiation_key(self.name, plan, assignment, device,
                                leaf_index)
        return self.instantiation_cache.get_or_build(
            key, lambda: self._build(plan, assignment, device))

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str) -> Callable:
        raise NotImplementedError
