"""Measurement-calibrated dispatch of the port (closing the offline loop
on the card).

The case discussion ranks kernel variants with a purely *symbolic*
performance model (paper §4); this package checks that ranking against the
machine it claims to describe, as the JAX package's ``repro.tuning`` does,
following KLARAPTOR (arXiv:1911.02373 — fit the rational performance model
to measured timings per device) and "A Few Fit Most" (arXiv:2507.15277 — a
handful of calibrated variants covers most shapes):

- :mod:`repro_torch.tuning.measure`   — time the top-k pre-ranked candidates
  of a dispatch table per ``(family, machine, bucket)`` on the card (device
  time from CUDA-graph replays between CUDA events; deterministic seeds,
  trimmed mean over repeats), or their plain versions on the CPU;
- :mod:`repro_torch.tuning.calibrate` — least-squares fit of per-family
  scale coefficients for the symbolic performance-measure rationals, then
  re-rank every bucket by measured (or model-predicted) time;
- :mod:`repro_torch.tuning.compact`   — greedy "few fit most" reduction:
  the smallest variant subset whose measured time stays within a tolerance
  of each bucket's best.

``python -m repro_torch.launch.tune_artifacts`` drives measure → calibrate
→ compact and rewrites the port's dispatch tables in place (the optional
``FORMAT_VERSION`` 2 sections).  :mod:`repro_torch.artifacts.dispatch`
prefers the measured order when a bucket carries one and falls back to the
symbolic ranking otherwise — serving behaviour is unchanged for untuned
tables.

Invariants (shared with :mod:`repro_torch.artifacts.serde`):

- tuned tables remain canonical-bytes deterministic: re-serializing a
  reloaded tuned table reproduces it byte for byte;
- measurement can only *reorder* a bucket's candidate list, never add to
  it — feasibility always comes from the constraint tree, so a tuned table
  is exactly as sound as the symbolic one;
- every reader of the new sections degrades to the symbolic ranking on any
  malformed content (cache-miss-never-error).
"""
from .calibrate import CalibrationFit, calibrate_table, fit_family
from .compact import compact_table
from .measure import MeasureConfig, MeasuredSample, measure_table, \
    parse_bucket_key

__all__ = [
    "CalibrationFit", "MeasureConfig", "MeasuredSample", "calibrate_table",
    "compact_table", "fit_family", "measure_table", "parse_bucket_key",
]
