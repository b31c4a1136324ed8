"""Versioned, byte-deterministic serialization for the port's serve-plan
artifacts.

A *serve plan* is the shippable half of serving warm-up: the traced
``(family, machine, data)`` warm set of one model config together with the
candidate each triple resolved to and the ranking tier that decided it
(``rank_source``).  Built offline by ``python -m
repro_torch.launch.plan_artifacts``, shipped next to the dispatch tables,
and fed straight to ``DispatchCache.freeze_resolved`` at engine start — a
plan-backed process performs zero online tree enumerations.

Each entry embeds the candidate's full :class:`KernelPlan` (via
:mod:`repro_torch.artifacts.serde`), so instantiating the kernel callables
needs neither the tree nor the dispatch table on the serving host.

The port's plan is the JAX package's (its format 3) with two changes:

- the port's trace (:func:`repro_torch.plans.trace.trace_warm_set`)
  depends on ``max_batch`` (the decode step's M) and ``prefill_chunk``
  (the chunk lengths) where the JAX trace depends on ``page_size``, so
  those two join ``max_len`` in the plan's identity: a plan built for one
  engine must read as a miss for another, or it would freeze the wrong
  warm set;
- the payload's ``kind`` names the port (:data:`PLAN_KIND`), so a JAX
  plan is a miss to the port's readers and the port's is a miss to the
  JAX package's.

Format policy (the dispatch artifacts' own): every payload embeds
``PLAN_FORMAT_VERSION``; readers treat a version mismatch, unreadable file,
or mangled payload as a **cache miss** — serving falls back to online
warm-up, never errors.  Bump the version on any schema *or semantic*
change; plans are rebuilt, never migrated.

Version history:
  1 — the traced warm set + resolved candidates + rank_source, the
      engine's ``max_len``, ``max_batch`` and ``prefill_chunk``, and
      ``table_digests`` (per resolved family, the digest of the dispatch
      table the picks were resolved against; "" = no table), which engine
      start checks for staleness (:func:`repro_torch.plans.loader.
      plan_staleness`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

from ..artifacts import serde as artifact_serde
from ..artifacts.serde import ArtifactFormatError
from ..core.select import Candidate

PLAN_FORMAT_VERSION = 1

#: The payload kind of the port's serve plans (the JAX package's is
#: ``"serve_plan"``).
PLAN_KIND = "torch_serve_plan"

_RANK_SOURCES = ("measured", "symbolic", "cold")


@dataclass(frozen=True)
class PlanEntry:
    """One warm-set member: the triple, its resolution, and attribution."""

    label: str
    family: str
    data: Tuple[Tuple[str, int], ...]        # sorted items
    sites: Tuple[str, ...]                   # abstract call sites (trace.py)
    candidate: Candidate
    rank_source: str                         # "measured"|"symbolic"|"cold"

    def data_dict(self) -> Dict[str, int]:
        return dict(self.data)


@dataclass(frozen=True)
class ServePlan:
    """A portable serve-plan artifact of the port (deserialized form)."""

    config: str                              # ModelConfig.name
    machine: str                             # MachineDescription.name
    machine_bindings: Dict[str, int]         # stale-machine guard
    max_len: int                             # the engine's trace parameters
    max_batch: int
    prefill_chunk: int
    entries: Tuple[PlanEntry, ...]
    #: family -> digest of the dispatch table the picks were resolved
    #: against ("" = no table existed at build time); the staleness record
    table_digests: Tuple[Tuple[str, str], ...] = ()

    def digest(self) -> str:
        return artifact_serde.digest(plan_to_obj(self))

    def table_digest_map(self) -> Dict[str, str]:
        return dict(self.table_digests)


# ---------------------------------------------------------------------------
# ServePlan <-> canonical JSON object
# ---------------------------------------------------------------------------

def _candidate_to_obj(c: Candidate) -> Dict[str, Any]:
    return {
        "leaf_index": int(c.leaf_index),
        "plan": artifact_serde.plan_to_obj(c.plan),
        "assignment": {k: int(v) for k, v in sorted(c.assignment.items())},
        "score": float(c.score),
    }


def _obj_to_candidate(obj: Mapping[str, Any]) -> Candidate:
    return Candidate(
        leaf_index=int(obj["leaf_index"]),
        plan=artifact_serde.obj_to_plan(obj["plan"]),
        assignment={str(k): int(v) for k, v in obj["assignment"].items()},
        score=float(obj["score"]),
    )


def entry_to_obj(e: PlanEntry) -> Dict[str, Any]:
    return {
        "label": e.label,
        "family": e.family,
        "data": {k: int(v) for k, v in e.data},
        "sites": list(e.sites),
        "candidate": _candidate_to_obj(e.candidate),
        "rank_source": e.rank_source,
    }


def obj_to_entry(obj: Mapping[str, Any]) -> PlanEntry:
    source = str(obj["rank_source"])
    if source not in _RANK_SOURCES:
        raise ArtifactFormatError(f"unknown rank_source {source!r}")
    return PlanEntry(
        label=str(obj["label"]),
        family=str(obj["family"]),
        data=tuple(sorted((str(k), int(v))
                          for k, v in obj["data"].items())),
        sites=tuple(str(s) for s in obj["sites"]),
        candidate=_obj_to_candidate(obj["candidate"]),
        rank_source=source,
    )


def plan_to_obj(plan: ServePlan) -> Dict[str, Any]:
    """Canonical JSON object; ``artifacts.serde.dumps`` of it is byte-stable
    (sorted keys, int-coerced values, deterministic entry order from the
    tracer)."""
    return {
        "format": PLAN_FORMAT_VERSION,
        "kind": PLAN_KIND,
        "config": plan.config,
        "machine": plan.machine,
        "machine_bindings": {k: int(v)
                             for k, v in plan.machine_bindings.items()},
        "max_len": int(plan.max_len),
        "max_batch": int(plan.max_batch),
        "prefill_chunk": int(plan.prefill_chunk),
        "table_digests": {k: str(v) for k, v in plan.table_digests},
        "entries": [entry_to_obj(e) for e in plan.entries],
    }


def obj_to_plan(obj: Mapping[str, Any]) -> ServePlan:
    """Parse a payload; raises :class:`ArtifactFormatError` (or the usual
    mangled-payload TypeError/KeyError/ValueError family) on anything
    structurally off — loaders catch and treat it as a miss."""
    if obj.get("kind") != PLAN_KIND:
        raise ArtifactFormatError(
            f"not a serve plan of the port: {obj.get('kind')!r}")
    if obj.get("format") != PLAN_FORMAT_VERSION:
        raise ArtifactFormatError(
            f"serve-plan format {obj.get('format')!r} != "
            f"{PLAN_FORMAT_VERSION}")
    return ServePlan(
        config=str(obj["config"]),
        machine=str(obj["machine"]),
        machine_bindings={str(k): int(v)
                          for k, v in obj["machine_bindings"].items()},
        max_len=int(obj["max_len"]),
        max_batch=int(obj["max_batch"]),
        prefill_chunk=int(obj["prefill_chunk"]),
        entries=tuple(obj_to_entry(e) for e in obj["entries"]),
        table_digests=tuple(sorted((str(k), str(v)) for k, v
                                   in obj["table_digests"].items())),
    )


def dumps(plan: ServePlan) -> str:
    """Canonical byte-stable JSON text for a serve plan."""
    return artifact_serde.dumps(plan_to_obj(plan))
