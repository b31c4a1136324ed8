"""Build, load, and apply the port's serve-plan artifacts.

Offline (``python -m repro_torch.launch.plan_artifacts``):

    ``build_serve_plan`` — trace the config's warm set for one engine
    (``max_len``, ``max_batch``, ``prefill_chunk``), resolve every triple
    through the dispatch tiers (ideally against compiled tables), and
    package the resolutions as a :class:`ServePlan`.

Online (``ServeEngine(warm_kernels=True)`` at startup):

    ``warm_from_plan`` — load the artifact for (config, machine), validate
    it against the *current* machine bindings and the engine's trace
    parameters, and feed it straight to ``DispatchCache.freeze_resolved``:
    the fast lane is pinned without touching a single tier, so
    ``stats.cold_builds == 0`` on a plan-backed start.  Any mismatch —
    missing file, format version or kind, machine bindings, ``max_len``,
    ``max_batch`` or ``prefill_chunk``, unknown family, uninstantiable
    candidate — returns ``None`` and the caller falls back to online
    warm-up (cache-miss-never-error).

Staleness: a plan records, per resolved family, the digest of the dispatch
table its picks were resolved against (``table_digests``).  Recompiling or
re-tuning rewrites those tables in place, so a shipped plan can silently
pin a ranking the tables no longer hold.  ``plan_staleness`` compares the
recorded digests against the tables the serving host has;
``warm_from_plan`` treats a mismatch as a *loud* miss — a
:class:`StalePlanWarning` and online warm-up by default, a
:class:`StalePlanError` under ``strict=True`` (the engine's
``strict_plans``).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

from ..artifacts import serde as artifact_serde
from ..artifacts.dispatch import (DispatchCache, _resolve_env_store,
                                  get_default_cache)
from ..artifacts.store import ArtifactStore
from ..core.params import H100_SXM, MachineDescription
from ..models.config import ModelConfig
from .serde import PlanEntry, ServePlan
from .store import PlanStore, resolve_env_store
from .trace import TracedOp, trace_warm_set


class StalePlanWarning(UserWarning):
    """A serve plan's recorded dispatch-table digests no longer match the
    tables on this host (someone recompiled or re-tuned under the plan)."""


class StalePlanError(RuntimeError):
    """Strict-mode refusal to start from a stale serve plan."""


def table_digest(store: Optional[ArtifactStore], family_name: str,
                 machine_name: str) -> str:
    """Canonical digest of the dispatch table for (family, machine) in
    ``store`` — ``""`` when no store / no (readable) table exists."""
    if store is None:
        return ""
    payload = store.load_dispatch(family_name, machine_name)
    return artifact_serde.digest(payload) if payload is not None else ""


def plan_staleness(plan: ServePlan, *,
                   machine: MachineDescription = H100_SXM,
                   store: Optional[ArtifactStore] = None
                   ) -> Dict[str, Tuple[str, str]]:
    """Families whose dispatch table changed since the plan was built:
    ``{family: (recorded_digest, current_digest)}`` ("" = no table on that
    side); empty when the plan is fresh.  ``store`` defaults to the
    environment-resolved artifact root."""
    if store is None:
        store = _resolve_env_store()
    out: Dict[str, Tuple[str, str]] = {}
    for family, recorded in plan.table_digests:
        current = table_digest(store, family, machine.name)
        if current != recorded:
            out[family] = (recorded, current)
    return out


# ---------------------------------------------------------------------------
# Offline: build
# ---------------------------------------------------------------------------

def build_serve_plan(cfg: ModelConfig, *,
                     machine: MachineDescription = H100_SXM,
                     max_len: int = 512, max_batch: int = 8,
                     prefill_chunk: int = 32,
                     cache: Optional[DispatchCache] = None
                     ) -> Tuple[ServePlan, List[TracedOp]]:
    """Trace + resolve one config's warm set for one engine into a
    shippable plan.  Resolution goes through the given cache's tiers, so a
    cache holding compiled tables bakes their ranking in (``rank_source``
    records it), and each family's table digest is recorded for the
    staleness check.  Triples with no feasible leaf are left out of the
    plan and returned (the port's model would dispatch them, so an engine
    warmed from such a plan still raises at that shape)."""
    from ..kernels.ops import FAMILIES
    cache = cache if cache is not None else get_default_cache()
    traced = trace_warm_set(cfg, max_len=max_len, max_batch=max_batch,
                            prefill_chunk=prefill_chunk)
    entries: List[PlanEntry] = []
    dropped: List[TracedOp] = []
    for op in traced:
        try:
            cand, source = cache.best_variant_with_source(
                FAMILIES[op.family], machine, op.data_dict())
        except ValueError:
            dropped.append(op)
            continue
        entries.append(PlanEntry(label=op.label, family=op.family,
                                 data=op.data, sites=op.sites,
                                 candidate=cand, rank_source=source))
    digests = tuple(
        (f, table_digest(cache.store, f, machine.name))
        for f in sorted({e.family for e in entries}))
    plan = ServePlan(config=cfg.name, machine=machine.name,
                     machine_bindings=dict(machine.bindings()),
                     max_len=max_len, max_batch=max_batch,
                     prefill_chunk=prefill_chunk, entries=tuple(entries),
                     table_digests=digests)
    return plan, dropped


# ---------------------------------------------------------------------------
# Online: load + apply
# ---------------------------------------------------------------------------

def load_serve_plan(cfg: ModelConfig, *,
                    machine: MachineDescription = H100_SXM,
                    store: Optional[PlanStore] = None,
                    max_len: Optional[int] = None,
                    max_batch: Optional[int] = None,
                    prefill_chunk: Optional[int] = None
                    ) -> Optional[ServePlan]:
    """Load + validate the plan for (config, machine); ``None`` on any miss:
    another config, other machine bindings, or — when given — another
    ``max_len``, ``max_batch`` or ``prefill_chunk``."""
    store = store if store is not None else resolve_env_store()
    if store is None:
        return None
    plan = store.load_plan(cfg.name, machine.name)
    if plan is None:
        return None
    if plan.config != cfg.name:
        return None
    if plan.machine_bindings != machine.bindings():
        return None
    for want, have in ((max_len, plan.max_len), (max_batch, plan.max_batch),
                       (prefill_chunk, plan.prefill_chunk)):
        if want is not None and have != int(want):
            return None
    return plan


def apply_serve_plan(plan: ServePlan, *,
                     machine: MachineDescription = H100_SXM,
                     cache: Optional[DispatchCache] = None
                     ) -> Optional[Dict[str, Any]]:
    """Pin a loaded plan into the cache's frozen fast lane through
    ``DispatchCache.freeze_resolved`` — no tier consulted, no tree
    enumerated.  Returns the ``{label: {"candidate", "rank_source"}}``
    report online warm-up produces, or ``None`` when the plan names an
    unknown family or a candidate that fails to instantiate; nothing is
    published then."""
    from ..kernels.ops import FAMILIES
    from ..runtime import faults
    cache = cache if cache is not None else get_default_cache()
    resolved = []
    for e in plan.entries:
        family = FAMILIES.get(e.family)
        if family is None:
            return None
        resolved.append((family, machine, e.data_dict(), e.candidate,
                         e.rank_source))
    try:
        # chaos site: an injected apply failure degrades to online warm-up
        # exactly like an uninstantiable candidate would
        faults.maybe_fault("plan.apply")
        cache.freeze_resolved(resolved)
    except faults.FatalFault:
        raise
    except (faults.InjectedFault, AttributeError, KeyError, TypeError,
            ValueError):
        return None
    return {e.label: {"candidate": e.candidate,
                      "rank_source": e.rank_source}
            for e in plan.entries}


def warm_from_plan(cfg: ModelConfig, *,
                   machine: MachineDescription = H100_SXM,
                   max_len: int = 512, max_batch: int = 8,
                   prefill_chunk: int = 32,
                   store: Optional[PlanStore] = None,
                   cache: Optional[DispatchCache] = None,
                   strict: bool = False,
                   dispatch_store: Optional[ArtifactStore] = None
                   ) -> Optional[Dict[str, Any]]:
    """The plan-backed warm-up: load, validate, check staleness, freeze.
    ``None`` on any miss — the caller falls back online.  A stale plan
    (its table digests disagree with the tables in ``dispatch_store``,
    default: the cache's store, else the environment's artifact root)
    warns with :class:`StalePlanWarning` and returns ``None``, or raises
    :class:`StalePlanError` under ``strict``."""
    plan = load_serve_plan(cfg, machine=machine, store=store,
                           max_len=max_len, max_batch=max_batch,
                           prefill_chunk=prefill_chunk)
    if plan is None or not plan.entries:
        return None
    if dispatch_store is None:
        dispatch_store = (cache.store
                          if cache is not None and cache.store is not None
                          else _resolve_env_store())
    stale = plan_staleness(plan, machine=machine, store=dispatch_store)
    if stale:
        detail = ", ".join(
            f"{fam} (plan={rec[:12] or 'none'} "
            f"host={cur[:12] or 'none'})"
            for fam, (rec, cur) in sorted(stale.items()))
        msg = (f"serve plan for {cfg.name}/{machine.name} is STALE: "
               f"dispatch tables changed under it for {detail}; rebuild "
               f"with python -m repro_torch.launch.plan_artifacts")
        if strict:
            raise StalePlanError(msg)
        warnings.warn(msg, StalePlanWarning, stacklevel=2)
        return None
    return apply_serve_plan(plan, machine=machine, cache=cache)
