"""Collective bytes by the ring model, from the record of a rank's step
(the counterpart of ``src/repro/launch/hlo_analysis.py``).

The JAX module parses the partitioned HLO of a compiled step; the port has
no compiler and no HLO, so the collectives come from the record
:func:`repro_torch.distributed.comm.recording` keeps while a rank runs one
step (on the card, on gloo ranks, or on the ``meta`` device over an
abstract mesh): each entry's logical op, call site, result bytes and type,
and group size.  Kept from the JAX module: :data:`DTYPE_BYTES` (keyed by
torch's dtype names), the ring model :func:`op_bytes` and
:class:`CollectiveReport` with ``summary()``.  Left out: the HLO parsing
and the loop multipliers (a Python step calls a collective once a call).

``flat_bytes`` counts each distinct call of the step once (call site, op,
result size and group: what the HLO lists once however often its loop
runs it), ``weighted_bytes`` every call, and ``by_comp`` maps each call
site to the bytes of all its calls.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

from ..distributed.comm import Collective

#: Bytes an element, by torch's dtype name (the HLO names of the JAX
#: module's table: pred = bool, s8 = int8, bf16 = bfloat16, ...).
DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "float16": 2, "bfloat16": 2, "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16, "float8_e4m3fn": 1, "float8_e5m2": 1,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def dtype_bytes(dtype) -> int:
    """Bytes an element of a torch dtype or its name."""
    name = str(dtype).replace("torch.", "")
    return DTYPE_BYTES[name]


def op_bytes(op: str, out_bytes: int, n: int) -> int:
    """Per-device bytes moved, ring-algorithm model (the JAX module's
    ``_op_bytes``); ``out_bytes`` is the result's size on a rank.
      all-reduce       2(n-1)/n * size        (size = out)
      all-gather       (n-1)/n * out          (out is the gathered tensor)
      reduce-scatter   (n-1) * out            (input = n * out shards)
      all-to-all       (n-1)/n * out
      collective-permute  out
    """
    if n <= 1:
        return 0
    if op == "all-reduce":
        return int(2 * (n - 1) / n * out_bytes)
    if op == "all-gather":
        return int((n - 1) / n * out_bytes)
    if op == "reduce-scatter":
        return int((n - 1) * out_bytes)
    if op == "all-to-all":
        return int((n - 1) / n * out_bytes)
    return out_bytes   # collective-permute


@dataclass
class CollectiveReport:
    flat_bytes: int = 0
    weighted_bytes: int = 0
    counts: Dict[str, int] = field(default_factory=dict)
    weighted_counts: Dict[str, float] = field(default_factory=dict)
    by_comp: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> Dict:
        return {"flat_bytes": self.flat_bytes,
                "weighted_bytes": self.weighted_bytes,
                "counts": dict(self.counts),
                "weighted_counts": dict(self.weighted_counts)}


def collective_report(record: Iterable[Collective]) -> CollectiveReport:
    """The report of one step's record (``comm.recording()``'s list)."""
    rep = CollectiveReport()
    seen = set()
    for c in record:
        b = op_bytes(c.op, c.nbytes, c.group)
        if (c.site, c.op, c.nbytes, c.group) not in seen:
            seen.add((c.site, c.op, c.nbytes, c.group))
            rep.flat_bytes += b
            rep.counts[c.op] = rep.counts.get(c.op, 0) + 1
        rep.weighted_bytes += b
        rep.weighted_counts[c.op] = rep.weighted_counts.get(c.op, 0.0) + 1.0
        rep.by_comp[c.site] = rep.by_comp.get(c.site, 0) + b
    return rep


def by_op_bytes(record: Iterable[Collective]) -> Dict[str, int]:
    """Ring-model bytes a rank moves, by logical op, over every call."""
    out: Dict[str, int] = {}
    for c in record:
        out[c.op] = out.get(c.op, 0) + op_bytes(c.op, c.nbytes, c.group)
    return out
