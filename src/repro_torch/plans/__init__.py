"""Traced warm sets and serve-plan artifacts of the port.

- :mod:`repro_torch.plans.trace`  — the exact (family, data) warm set the
  port's paged serve path dispatches
- :mod:`repro_torch.plans.serde`  — ``PLAN_FORMAT_VERSION``-stamped,
  byte-deterministic payloads of the port's own kind
- :mod:`repro_torch.plans.store`  — ``<root>/plans/<config>/serve-v<V>-
  <machine>.json`` next to the dispatch artifacts (a copy)
- :mod:`repro_torch.plans.loader` — offline ``build_serve_plan``; online
  ``warm_from_plan`` (load, validate, check staleness, freeze)
"""
from .serde import PLAN_FORMAT_VERSION, PLAN_KIND, PlanEntry, ServePlan
from .store import PlanStore, resolve_env_store
from .trace import TracedOp, chunk_lengths, op_label, trace_warm_set
from .loader import (StalePlanError, StalePlanWarning, apply_serve_plan,
                     build_serve_plan, load_serve_plan, plan_staleness,
                     table_digest, warm_from_plan)

__all__ = [
    "PLAN_FORMAT_VERSION", "PLAN_KIND", "PlanEntry", "ServePlan",
    "PlanStore", "resolve_env_store",
    "TracedOp", "chunk_lengths", "op_label", "trace_warm_set",
    "StalePlanError", "StalePlanWarning",
    "apply_serve_plan", "build_serve_plan", "load_serve_plan",
    "plan_staleness", "table_digest", "warm_from_plan",
]
