"""Trace event taxonomy, JSONL schema, and the shared transition renderer.

Events are plain frozen dataclasses.  The flight recorder serializes any
dataclass whose type name appears in :data:`EVENT_TYPES` — the monitor's
``SwapEvent`` and the dispatch cache's ``DegradeEvent`` join the stream
without this module importing either (no numpy, no cycles): the mapping
is by class *name*, the fields by ``dataclasses.fields``.

Determinism contract: every field value is an int, float, str, bool, or
a (possibly nested) tuple of those — ``json.dumps(sort_keys=True)`` over
them is byte-stable across runs.  Timestamps are tick indices;
``TickSpan.duration_us`` is the only wall-clock-derived field and it
comes from the engine's *injectable* clock, so CI runs under a counting
clock are byte-identical end to end.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Mapping, Tuple

#: class name -> etype tag carried on every JSONL record.
EVENT_TYPES: Dict[str, str] = {
    "TickSpan": "tick_span",
    "DispatchDecision": "dispatch_decision",
    "SwapEvent": "swap",
    "DegradeEvent": "degrade",
    "FaultFired": "fault_fired",
    "PrefixHit": "prefix_hit",
    "AdmissionDecision": "admission_decision",
}


@dataclass(frozen=True)
class TickSpan:
    """One engine tick's shape: what the plan scheduled, what committed,
    how long the host-side step took (on the engine's injectable clock)."""

    tick: int
    admitted: int
    prefill_tokens: int
    decode_rows: int
    preempted: int
    cancelled: int
    finished: int                 # requests that completed this step
    duration_us: float


@dataclass(frozen=True)
class DispatchDecision:
    """The decision-provenance record: which case-discussion branch one
    non-frozen dispatch took.  ``surface`` is the entry point
    (``resolve`` = locked tiers via ``best_variant*``/``warm_callable``
    miss, ``frozen`` = fast-lane hit, ``warm_sampled`` = 1-in-N sample of
    the uncounted ``warm_callable`` lane); ``rank`` is the candidate's
    position in the ranking that decided it (0 = top pick, -1 = replayed
    from the memory LRU where the walk index was not retained);
    ``demoted`` counts the triple's runtime-broken marks in effect."""

    tick: int
    family: str
    machine: str
    data: Tuple[Tuple[str, int], ...]        # sorted items
    bucket: str
    leaf: int
    assignment: Tuple[Tuple[str, int], ...]  # sorted items
    source: str                              # measured | symbolic | cold | frozen
    surface: str                             # resolve | frozen | warm_sampled
    rank: int
    demoted: int


@dataclass(frozen=True)
class FaultFired:
    """One chaos-schedule spec consumed by an injection site."""

    tick: int
    site: str
    kind: str
    arg: int


@dataclass(frozen=True)
class PrefixHit:
    """One committed prefix-index match: blocks mapped instead of
    recomputed, token positions served from the index."""

    tick: int
    blocks: int
    tokens: int


@dataclass(frozen=True)
class AdmissionDecision:
    """One scheduler decision about a request: ``action`` is ``admit`` |
    ``wait`` (head-of-line blocked on head-room) | ``shed`` (queue bound)
    | ``preempt`` (pool pressure eviction) | ``poison`` (fault
    preemption) | ``cancel`` (deadline)."""

    tick: int
    action: str
    rid: int
    slot: int                     # -1 when the request holds no slot
    queue_depth: int


#: etype -> {field name -> allowed python types}.  ``seq`` and ``etype``
#: are stamped by the recorder on every record.
EVENT_SCHEMA: Dict[str, Dict[str, Tuple[type, ...]]] = {
    "tick_span": {
        "tick": (int,), "admitted": (int,), "prefill_tokens": (int,),
        "decode_rows": (int,), "preempted": (int,), "cancelled": (int,),
        "finished": (int,), "duration_us": (int, float),
    },
    "dispatch_decision": {
        "tick": (int,), "family": (str,), "machine": (str,),
        "data": (list, tuple), "bucket": (str,), "leaf": (int,),
        "assignment": (list, tuple), "source": (str,), "surface": (str,),
        "rank": (int,), "demoted": (int,),
    },
    "swap": {
        "tick": (int,), "family": (str,), "data": (list, tuple),
        "old": (list, tuple), "new": (list, tuple),
        "incumbent_us": (int, float), "challenger_us": (int, float),
        "windows": (int,),
    },
    "degrade": {
        "tick": (int,), "family": (str,), "machine": (str,),
        "data": (list, tuple), "old": (list, tuple), "new": (list, tuple),
        "error": (str,), "source": (str,), "exhausted": (bool,),
    },
    "fault_fired": {
        "tick": (int,), "site": (str,), "kind": (str,), "arg": (int,),
    },
    "prefix_hit": {
        "tick": (int,), "blocks": (int,), "tokens": (int,),
    },
    "admission_decision": {
        "tick": (int,), "action": (str,), "rid": (int,), "slot": (int,),
        "queue_depth": (int,),
    },
}

_ACTIONS = ("admit", "wait", "shed", "preempt", "poison", "cancel")
_SURFACES = ("resolve", "frozen", "warm_sampled")


def event_record(event: Any, seq: int, tick: int) -> Dict[str, Any]:
    """Flatten one event dataclass to a JSONL-ready dict.  ``tick`` is the
    recorder's cursor, used only when the event carries no tick of its
    own; ``seq`` is the recorder-assigned monotonic id."""
    name = type(event).__name__
    etype = EVENT_TYPES.get(name)
    if etype is None:
        raise TypeError(f"not a registered trace event: {name}")
    rec: Dict[str, Any] = {"seq": int(seq), "etype": etype}
    for f in fields(event):
        rec[f.name] = getattr(event, f.name)
    rec.setdefault("tick", int(tick))
    return rec


def validate_record(rec: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` unless ``rec`` is a well-formed trace record:
    known etype, non-negative monotonic-assignable seq, every schema
    field present with an allowed type, no unknown fields."""
    etype = rec.get("etype")
    schema = EVENT_SCHEMA.get(etype)  # type: ignore[arg-type]
    if schema is None:
        raise ValueError(f"unknown etype: {etype!r}")
    if not isinstance(rec.get("seq"), int) or rec["seq"] < 0:
        raise ValueError(f"bad seq: {rec.get('seq')!r}")
    allowed = set(schema) | {"seq", "etype"}
    extra = set(rec) - allowed
    if extra:
        raise ValueError(f"{etype}: unknown fields {sorted(extra)}")
    for name, types in schema.items():
        if name not in rec:
            raise ValueError(f"{etype}: missing field {name!r}")
        v = rec[name]
        if bool in types:
            ok = isinstance(v, bool)
        else:
            ok = isinstance(v, types) and not isinstance(v, bool)
        if not ok:
            raise ValueError(
                f"{etype}.{name}: {type(v).__name__} not in "
                f"{tuple(t.__name__ for t in types)}")
    if etype == "admission_decision" and rec["action"] not in _ACTIONS:
        raise ValueError(f"admission_decision.action: {rec['action']!r}")
    if etype == "dispatch_decision" and rec["surface"] not in _SURFACES:
        raise ValueError(f"dispatch_decision.surface: {rec['surface']!r}")


def describe_transition(*, tick: int, verb: str, family: str,
                        data: Tuple[Tuple[str, int], ...],
                        old: str, new: str, note: str = "",
                        cause: str = "", tail: str = "") -> str:
    """The one event-rendering convention for candidate transitions.

    ``tick N: <verb> family@k=v,... OLD -> NEW (note) after CAUSE<tail>``

    The JAX package's ``SwapEvent.describe`` and ``DegradeEvent.describe``
    delegate here (a test pins the exact format), so the two logs cannot
    drift."""
    dims = ",".join(f"{k}={v}" for k, v in data)
    out = f"tick {tick}: {verb} {family}@{dims} {old} -> {new}"
    if note:
        out += f" ({note})"
    if cause:
        out += f" after {cause}"
    return out + tail
