"""KLARAPTOR-style least-squares calibration of the symbolic ranking.

The offline model scores a candidate with the performance-measure rationals
(the occupancy of K1-K3 — paper §3.3) evaluated symbolically; this
module fits, per family, how much each measure actually *costs* on the
measured device.  Following KLARAPTOR's rational-program calibration
(arXiv:1911.02373) the model is multiplicative, hence linear in log space:

    log t  =  c0  +  c_w · log(work)  +  Σ_i c_i · log(1 / v_i)

where ``v_i ∈ (0, 1]`` is performance measure *i* for the candidate and
``work`` is the product of the bucket's data dims.  Ordinary least squares
over every measured sample of the family yields the scale coefficients
``c`` — the per-device "exponents" the symbolic model guessed at.

``calibrate_table`` then rewrites a dispatch table's per-bucket candidate
order: measured candidates sort by measured time; candidates whose
measurement failed (or was skipped) are slotted in by *model-predicted*
time when a fit exists, and keep their symbolic rank otherwise.  The result
lands in two optional FORMAT_VERSION-2 sections:

  ``calibration``     — fit coefficients + residual/agreement diagnostics,
  ``measured_ranks``  — per bucket: the re-ranked entry order + raw times.

Both sections are advisory: dispatch falls back to the symbolic ranking on
any malformed content, and feasibility still comes solely from the
constraint tree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..core.counters import CounterKind
from ..core.plan import FamilySpec, KernelPlan, Leaf
from .measure import MeasuredSample

_EPS = 1e-12                      # floor for measures before taking logs


def _perf_counter_names(family: FamilySpec) -> List[str]:
    return [c.name for c in family.counters()
            if c.kind is CounterKind.PERFORMANCE]


def _measure_values(family: FamilySpec, plan: KernelPlan,
                    values: Mapping[str, int]) -> Optional[List[float]]:
    """Evaluate every performance measure at a full binding; None if any
    symbol stays unbound (sample is then dropped from the fit)."""
    out = []
    for c in family.counters():
        if c.kind is not CounterKind.PERFORMANCE:
            continue
        num, den = c.evaluate(family, plan)
        try:
            n, d = float(num.eval(values)), float(den.eval(values))
        except KeyError:
            return None
        if d <= 0:
            return None
        out.append(min(1.0, max(_EPS, n / d)))
    return out


def _features(measures: Sequence[float], work: float) -> List[float]:
    return ([1.0, math.log(max(work, 1.0))]
            + [math.log(1.0 / m) for m in measures])


@dataclass
class CalibrationFit:
    """Per-family least-squares fit of measured time vs symbolic measures."""

    family: str
    feature_names: List[str]
    coeffs: List[float]
    n_samples: int
    rms_log_residual: float
    top1_agreement: float = float("nan")   # filled by calibrate_table
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_obj(self) -> Dict[str, Any]:
        return {
            "method": "log-lstsq",
            "family": self.family,
            "features": list(self.feature_names),
            "coeffs": [float(c) for c in self.coeffs],
            "n_samples": int(self.n_samples),
            "rms_log_residual": float(self.rms_log_residual),
            "top1_agreement": (None if math.isnan(self.top1_agreement)
                               else float(self.top1_agreement)),
            "meta": dict(self.meta),
        }

    @classmethod
    def from_obj(cls, obj: Mapping[str, Any]) -> "CalibrationFit":
        agree = obj.get("top1_agreement")
        return cls(family=str(obj["family"]),
                   feature_names=[str(f) for f in obj["features"]],
                   coeffs=[float(c) for c in obj["coeffs"]],
                   n_samples=int(obj["n_samples"]),
                   rms_log_residual=float(obj["rms_log_residual"]),
                   top1_agreement=float("nan") if agree is None else agree,
                   meta=dict(obj.get("meta", {})))


def _sample_row(family: FamilySpec, plan: KernelPlan, s: MeasuredSample,
                bindings: Mapping[str, int]) -> Optional[List[float]]:
    values = {**bindings, **s.data, **s.assignment}
    measures = _measure_values(family, plan, values)
    if measures is None:
        return None
    work = float(np.prod([float(v) for v in s.data.values()]))
    return _features(measures, work)


def fit_family(family: FamilySpec, table: Mapping[str, Any],
               samples: Sequence[MeasuredSample],
               meta: Optional[Mapping[str, Any]] = None,
               leaves: Optional[Mapping[int, Leaf]] = None
               ) -> Optional[CalibrationFit]:
    """OLS in log space over all successfully measured samples.

    Returns ``None`` when fewer samples than features survived — the table
    then ships measured ranks without a model (symbolic order covers the
    unmeasured tail).  ``leaves`` lets a caller that already parsed the
    table's leaf section (``serde.table_leaves``) avoid re-parsing it.
    """
    from ..artifacts import serde
    bindings = table.get("machine_bindings", {})
    if leaves is None:
        leaves = serde.table_leaves(table)
    names = (["intercept", "log_work"]
             + [f"log_inv_{n}" for n in _perf_counter_names(family)])
    rows, ys = [], []
    for s in samples:
        if s.us is None or s.us <= 0:
            continue
        leaf = leaves.get(s.leaf_index)
        if leaf is None:
            continue
        row = _sample_row(family, leaf.plan, s, bindings)
        if row is None:
            continue
        rows.append(row)
        ys.append(math.log(s.us))
    if len(rows) < len(names):
        return None
    X = np.asarray(rows, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    coeffs, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ coeffs
    return CalibrationFit(
        family=family.name, feature_names=names,
        coeffs=[float(c) for c in coeffs], n_samples=len(rows),
        rms_log_residual=float(np.sqrt(np.mean(resid ** 2))),
        meta=dict(meta or {}))


def predict_us(fit: CalibrationFit, family: FamilySpec, plan: KernelPlan,
               assignment: Mapping[str, int], data: Mapping[str, int],
               bindings: Mapping[str, int]) -> Optional[float]:
    """Model-predicted microseconds for one candidate (None if unbindable)."""
    values = {**bindings, **data, **assignment}
    measures = _measure_values(family, plan, values)
    if measures is None:
        return None
    work = float(np.prod([float(v) for v in data.values()]))
    x = _features(measures, work)
    if len(x) != len(fit.coeffs):
        return None
    return float(math.exp(float(np.dot(x, fit.coeffs))))


def calibrate_table(family: FamilySpec, table: Mapping[str, Any],
                    samples: Sequence[MeasuredSample],
                    fit: Optional[CalibrationFit] = None,
                    meta: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Return a new dispatch-table payload with ``calibration`` +
    ``measured_ranks`` sections; the symbolic ``buckets`` stay untouched.

    Ranking per bucket is tiered — measurement is authoritative, the model
    only orders the tail: (1) measured entries ascending by measured time,
    (2) unmeasured entries ascending by model-predicted time when ``fit``
    is available, (3) the rest in symbolic order.  A candidate the machine
    was never asked to run can therefore never outrank one it was.
    ``top1_agreement`` records, over buckets with
    at least two measured candidates, how often the model's fastest pick
    matches the measured fastest — the diagnostic that says whether the
    symbolic polynomials (as calibrated) describe this machine at all.
    """
    from ..artifacts import serde
    leaves = serde.table_leaves(table)
    if fit is None:
        fit = fit_family(family, table, samples, meta=meta, leaves=leaves)
    bindings = table.get("machine_bindings", {})
    by_bucket: Dict[str, List[MeasuredSample]] = {}
    for s in samples:
        by_bucket.setdefault(s.bucket, []).append(s)

    measured_ranks: Dict[str, Any] = {}
    agree_hits = agree_total = 0
    for bucket, bucket_samples in sorted(by_bucket.items()):
        entries = table.get("buckets", {}).get(bucket, [])
        us_by_pos: Dict[int, Optional[float]] = {
            s.entry_index: s.us for s in bucket_samples}
        if not any(us is not None for us in us_by_pos.values()):
            # no successful measurement in this bucket: emitting an order
            # would let dispatch report "measured" for what is really the
            # symbolic (or model-only) ranking — leave the bucket untuned
            continue
        keyed: List[Any] = []                 # (tier, time-or-pos, pos)
        pred_by_pos: Dict[int, float] = {}
        for pos, entry in enumerate(entries):
            us = us_by_pos.get(pos)
            if us is not None:
                keyed.append((0, us, pos))    # tier 1: measured
                continue
            if fit is not None:
                leaf = leaves.get(int(entry.get("leaf_index", -1)))
                s0 = bucket_samples[0]
                if leaf is not None:
                    asg = {k: int(v) for k, v in entry["assignment"].items()}
                    p = predict_us(fit, family, leaf.plan, asg, s0.data,
                                   bindings)
                    if p is not None:
                        pred_by_pos[pos] = p
                        keyed.append((1, p, pos))   # tier 2: model-predicted
                        continue
            keyed.append((2, pos, pos))       # tier 3: symbolic order
        keyed.sort(key=lambda k: (k[0], k[1], k[-1]))
        order = [k[-1] for k in keyed]
        measured_ranks[bucket] = {
            "order": order,
            "us": [None if us_by_pos.get(p) is None
                   else round(float(us_by_pos[p]), 3)
                   for p in range(len(entries))],
            "predicted_us": {str(p): round(v, 3)
                             for p, v in sorted(pred_by_pos.items())},
        }
        measured = {p: u for p, u in us_by_pos.items() if u is not None}
        if fit is not None and len(measured) >= 2:
            agree_total += 1
            best_measured = min(measured, key=measured.__getitem__)
            preds = {}
            for pos in measured:
                entry = entries[pos]
                leaf = leaves.get(int(entry["leaf_index"]))
                if leaf is None:
                    continue
                asg = {k: int(v) for k, v in entry["assignment"].items()}
                p = predict_us(fit, family, leaf.plan, asg,
                               bucket_samples[0].data, bindings)
                if p is not None:
                    preds[pos] = p
            if preds and min(preds, key=preds.__getitem__) == best_measured:
                agree_hits += 1

    out = dict(table)
    out["format"] = serde.FORMAT_VERSION
    out["measured_ranks"] = measured_ranks
    if fit is not None:
        if agree_total:
            fit.top1_agreement = agree_hits / agree_total
        out["calibration"] = fit.to_obj()
    return out
