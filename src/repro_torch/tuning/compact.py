"""Greedy "few fit most" variant-set reduction (arXiv:2507.15277).

A tuned dispatch table knows, per data-shape bucket, the measured time of
every top-k candidate.  Shipping one bespoke variant per bucket is the
maximal-coverage answer; "A Few Fit Most" observes that a *handful* of
variants usually stays within a small tolerance of every bucket's best.
``compact_table`` computes that subset:

1. a *variant* is the pair ``(leaf_index, assignment)`` — the thing a build
   actually has to carry (one bound kernel specialization);
2. a variant **covers** a bucket when its measured time there is within
   ``(1 + tolerance)`` of the bucket's best measured time;
3. greedy set cover: repeatedly take the variant covering the most
   still-uncovered buckets (ties: lower total relative regret), until every
   coverable bucket is covered.

The result is recorded as the optional ``compaction`` section (advisory
only — dispatch keeps serving the full ranked list; the section tells a
deployment which kernel binaries it could prune and what that costs).
Buckets with no successful measurement are reported as uncovered rather
than silently dropped.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from .measure import MeasuredSample


def variant_key(leaf_index: int, assignment: Mapping[str, int]) -> str:
    asg = ",".join(f"{k}={int(v)}" for k, v in sorted(assignment.items()))
    return f"leaf{int(leaf_index)}|{asg}"


def compact_table(table: Mapping[str, Any],
                  samples: Sequence[MeasuredSample],
                  tolerance: float = 0.10) -> Dict[str, Any]:
    """Return a new payload with a ``compaction`` section appended.

    ``tolerance`` is relative: a variant covers a bucket when
    ``us <= (1 + tolerance) * best_us`` there.
    """
    # bucket -> {variant -> best measured us for that variant in the bucket}
    times: Dict[str, Dict[str, float]] = {}
    for s in samples:
        if s.us is None or s.us <= 0:
            continue
        v = variant_key(s.leaf_index, s.assignment)
        slot = times.setdefault(s.bucket, {})
        slot[v] = min(s.us, slot.get(v, float("inf")))

    best: Dict[str, float] = {b: min(vs.values()) for b, vs in times.items()}
    covers: Dict[str, Set[str]] = {}          # variant -> buckets it covers
    regret: Dict[str, Dict[str, float]] = {}  # variant -> bucket -> rel. regret
    for b, vs in times.items():
        for v, us in vs.items():
            r = us / best[b] - 1.0
            if r <= tolerance:
                covers.setdefault(v, set()).add(b)
                regret.setdefault(v, {})[b] = r

    selected: List[str] = []
    uncovered: Set[str] = set(times)
    steps: List[Dict[str, Any]] = []
    while uncovered:
        scored: List[Tuple[int, float, str]] = []
        for v, bs in covers.items():
            gain = bs & uncovered
            if gain:
                scored.append((len(gain),
                               sum(regret[v][b] for b in gain), v))
        if not scored:
            break                             # remaining buckets uncoverable
        # most new buckets first; ties broken by lower total regret
        scored.sort(key=lambda t: (-t[0], t[1], t[2]))
        _, _, pick = scored[0]
        newly = sorted(covers[pick] & uncovered)
        uncovered -= covers[pick]
        selected.append(pick)
        steps.append({"variant": pick, "new_buckets": newly})

    # accounting runs over *every* non-empty bucket of the table, so a
    # bucket whose measurements all failed shows up as uncovered instead of
    # silently shrinking the denominator
    all_buckets = sorted({b for b, es in table.get("buckets", {}).items()
                          if es} | set(times))
    all_variants = sorted({v for vs in times.values() for v in vs})
    per_bucket: Dict[str, Any] = {}
    for b in all_buckets:
        options = [(regret[v][b], v) for v in selected
                   if b in covers.get(v, ())]
        if options:
            r, v = min(options)
            per_bucket[b] = {"variant": v, "regret": round(r, 4)}
        else:
            per_bucket[b] = None              # unmeasured or over-tolerance

    out = dict(table)
    out["compaction"] = {
        "tolerance": tolerance,
        "variants": selected,
        "steps": steps,
        "total_variants_measured": len(all_variants),
        "buckets_total": len(all_buckets),
        "buckets_covered": len(times) - len(uncovered),
        "per_bucket": per_bucket,
    }
    return out


def compaction_summary(table: Mapping[str, Any]) -> Optional[str]:
    """One-line human summary of a table's compaction section (or None)."""
    c = table.get("compaction")
    if not isinstance(c, dict):
        return None
    return (f"{c.get('total_variants_measured', '?')} measured variants -> "
            f"{len(c.get('variants', []))} selected; "
            f"{c.get('buckets_covered', 0)}/{c.get('buckets_total', 0)} "
            f"buckets within {c.get('tolerance')} of best")
