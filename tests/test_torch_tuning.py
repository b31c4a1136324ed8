"""Measurement-calibrated dispatch tables of the port (``repro_torch.tuning``
and the FORMAT_VERSION 2 sections), held as ``tests/test_tuning.py`` holds
the JAX package's, on the port's K1 family (``matmul_h100``) and
``H100_SXM``, and against the JAX package on the same inputs.

Measurements are injected through ``measure_table``'s ``timer`` hook — a
deterministic fake keyed on the assignment — except where the CPU's
:class:`~repro_torch.tuning.measure.DeviceTimer` runs the plain versions as
a smoke of the code path (it gives no card numbers).  The two shapes are
llama3-8b decode projections, (4, 4096, 4096) and (4, 4096, 8192), whose
top-4 symbolic candidates are the same four variants.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.tuning as jtuning
from repro.tuning import calibrate as jcal
from repro.tuning import compact as jcompact
from repro.tuning import measure as jmeasure
from repro_torch.artifacts import (ArtifactStore, DispatchCache, bucket_key,
                                   compile_family, serde)
from repro_torch.artifacts.compile import build_dispatch_table
from repro_torch.artifacts.dispatch import set_default_cache
from repro_torch.core.counters import CounterKind
from repro_torch.core.params import H100_SXM
from repro_torch.core.select import STATS, best_variant
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.jacobi1d import jacobi1d_h100
from repro_torch.kernels.matadd import matadd_h100
from repro_torch.kernels.ops import FAMILIES
from repro_torch.kernels.transpose import transpose_h100
from repro_torch.runtime.graph import COUNTED
from repro_torch.tuning import (MeasureConfig, calibrate_table, compact_table,
                                fit_family, measure_table, parse_bucket_key)
from repro_torch.tuning import calibrate as tcal
from repro_torch.tuning import measure as tmeasure
from repro_torch.tuning.calibrate import predict_us
from repro_torch.tuning.compact import compaction_summary
from repro_torch.tuning.measure import (DeviceTimer, MeasuredSample,
                                        clamp_data, measure_shape,
                                        trimmed_mean_us)

MATMUL = FAMILIES["matmul_h100"]
MM_A = {"M": 4, "N": 4096, "K": 4096}
MM_B = {"M": 4, "N": 4096, "K": 8192}
CFG = MeasureConfig(iters=3, warmup=0, trim=1, max_dim=8192, top_k=4)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _isolate_default_cache():
    set_default_cache(DispatchCache())
    yield
    set_default_cache(None)


def fake_timer(family, plan, assignment, data, cfg):
    """Deterministic stand-in for kernel time: cheaper for narrow ``bn``,
    which *inverts* the symbolic preference at these shapes (the napkin
    ranks bn 128 first and bn 32 fourth) — so a measured-rank win is
    observable."""
    us = 100.0 * assignment["bn"] / 32 + 0.01 * assignment["bk"]
    return [us * 1e-6] * cfg.iters


def _tuned_store(tmp_path, shapes, tolerance=0.10, timer=fake_timer):
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], shapes=shapes)
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)
    samples = measure_table(MATMUL, table, CFG, timer=timer)
    tuned = calibrate_table(MATMUL, table, samples, meta={"fake": True})
    tuned = compact_table(tuned, samples, tolerance=tolerance)
    store.save_dispatch(tuned)
    return store, tuned, samples


# ---------------------------------------------------------------------------
# measure helpers, and their parity with the JAX package's
# ---------------------------------------------------------------------------

def test_parse_bucket_key_inverts_bucket_key():
    assert parse_bucket_key(bucket_key(MM_A)) == MM_A
    assert parse_bucket_key(bucket_key({"SQ": 4096, "HD": 64})) == \
        {"SQ": 4096, "HD": 64}
    with pytest.raises(ValueError):
        parse_bucket_key("nodigits")


def test_clamp_and_trimmed_mean():
    assert clamp_data({"M": 4096, "N": 128}, 256) == {"M": 256, "N": 128}
    # trim=1 drops the 1.0 outlier and the 0.1 minimum
    assert trimmed_mean_us([0.3, 1.0, 0.1, 0.3, 0.3], trim=1) == \
        pytest.approx(0.3e6)


KEYS = ["M4|N4096|K4096", "K16384|M32|N131072", "GROUP4|HD128|HK8|SQ1",
        "HD64|SQ256|STATE128", "N2097154", "nodigits", "M4|N"]
REPEATS = [[0.3, 1.0, 0.1, 0.3, 0.3], [2e-6], [5.0, 1.0], [1.0, 2.0, 3.0],
           [7e-5, 6e-5, 9e-5, 1e-4, 2e-5, 3e-5]]


@pytest.mark.parametrize("key", KEYS)
def test_bucket_parsing_and_clamp_match_the_jax_package(key):
    """``parse_bucket_key`` and ``clamp_data`` agree with the JAX
    package's on one set of keys, errors included."""
    try:
        want = jmeasure.parse_bucket_key(key)
    except ValueError:
        with pytest.raises(ValueError):
            parse_bucket_key(key)
        return
    assert parse_bucket_key(key) == want
    for max_dim in (1, 64, 256, 1 << 20):
        assert clamp_data(want, max_dim) == jmeasure.clamp_data(want,
                                                                max_dim)


@pytest.mark.parametrize("trim", [0, 1, 2])
def test_trimmed_mean_matches_the_jax_package(trim):
    for reps in REPEATS:
        assert trimmed_mean_us(reps, trim) == jmeasure.trimmed_mean_us(
            reps, trim)


def test_measure_failure_is_data_not_error(tmp_path):
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], shapes=[MM_A])
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)

    def exploding(family, plan, assignment, data, cfg):
        raise RuntimeError("kernel blew up")

    samples = measure_table(MATMUL, table, CFG, timer=exploding)
    assert samples and all(s.us is None for s in samples)
    tuned = compact_table(calibrate_table(MATMUL, table, samples), samples)
    # the all-failed bucket is reported as uncovered, not silently dropped
    comp = tuned["compaction"]
    assert comp["buckets_total"] == 1 and comp["buckets_covered"] == 0
    assert comp["per_bucket"] == {bucket_key(MM_A): None}
    # a bucket with zero successful measurements must NOT get an order —
    # otherwise dispatch would report "measured" for the symbolic ranking
    assert tuned["measured_ranks"] == {}
    store.save_dispatch(tuned)                          # still a valid table
    cache = DispatchCache(store=store)
    assert cache.rank_source(MATMUL, H100_SXM, MM_A) == "symbolic"
    cand = cache.best_variant(MATMUL, H100_SXM, MM_A)   # must not raise
    assert cache.stats.measured_hits == 0
    assert cand == best_variant(MATMUL, H100_SXM, MM_A, use_cache=False)


def test_a_cuda_runtime_error_stops_the_sweep(tmp_path):
    """A host-side refusal is a ``us=None`` sample, but an error of the
    CUDA runtime propagates: after it every later sample would fail too,
    and the table would keep its symbolic order in silence."""
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], shapes=[MM_A])
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)
    calls = []

    def timer(family, plan, assignment, data, cfg):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("block format refused")
        raise RuntimeError("CUDA error: unspecified launch failure")

    cfg = MeasureConfig(iters=1, warmup=0, max_dim=256, top_k=3)
    with pytest.raises(RuntimeError, match="CUDA error"):
        measure_table(MATMUL, table, cfg, timer=timer)
    assert len(calls) == 2


def test_a_candidate_that_fails_on_the_device_is_never_run_on_the_cpu(
        tmp_path):
    """``device="cuda"`` without a card: every candidate is a ``us=None``
    sample (the timer raises), and no plain version ran in its place."""
    if torch.cuda.is_available():
        pytest.skip("the card is here: the CUDA timer would run")
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], shapes=[MM_A])
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)
    calls = []
    real = mm.matmul_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    mm.matmul_plain = spy
    try:
        samples = measure_table(MATMUL, table, MeasureConfig(
            iters=1, warmup=0, max_dim=256, top_k=2, device="cuda"),
            timer=DeviceTimer())
    finally:
        mm.matmul_plain = real
    assert len(samples) == 2 and all(s.us is None for s in samples)
    assert calls == []


# ---------------------------------------------------------------------------
# measured shapes: every compared candidate passes its format check
# ---------------------------------------------------------------------------

def _llama_tables():
    """The port's K1, K2 and K3 tables for ``H100_SXM`` over llama3-8b's
    serve signatures at phase 8's engine sizes (decode at 4 rows, 32-token
    prefill chunks) and mamba2-130m's K3 signatures."""
    from repro_torch.configs import get_config
    from repro_torch.plans.trace import trace_warm_set
    ops = (trace_warm_set(get_config("llama3_8b"), max_len=256, max_batch=4,
                          prefill_chunk=32)
           + trace_warm_set(get_config("mamba2_130m"), max_len=1024,
                            max_batch=4, prefill_chunk=256))
    out = {}
    for name in ("matmul_h100", "flash_attention_h100", "ssd_scan_h100"):
        shapes = [op.data_dict() for op in ops if op.family == name]
        out[name] = build_dispatch_table(FAMILIES[name], H100_SXM, shapes)
    return out


def _format_error(name, data, a):
    bf16 = torch.bfloat16
    if name == "matmul_h100":
        return mm.format_error(data["M"], data["N"], data["K"], a["bm"],
                               a["bn"], a["bk"], a["s"], a["kb"],
                               a["stages"], True, bf16)
    if name == "flash_attention_h100":
        return fa.format_error(data["GROUP"] * data["HK"], data["HK"],
                               data["SQ"], tmeasure.FA_KEYS, data["HD"],
                               a["bq"], a["bkv"], a["kv_chunk"], a["stages"],
                               bf16)
    return ssd.format_error(1, data["SQ"], tmeasure.SSD_PAIRS, data["HD"],
                            data["STATE"], min(a["chunk"], data["SQ"]),
                            a["bd"], bf16)


@pytest.mark.parametrize("max_dim", [64, 256, 1 << 30])
@pytest.mark.parametrize("name", ["matmul_h100", "flash_attention_h100",
                                  "ssd_scan_h100"])
def test_every_candidate_passes_its_format_check_at_the_measured_shape(
        name, max_dim):
    """At every decode and prefill bucket of llama3-8b (K1, K2) and
    mamba2-130m (K3), clamped as the monitor (64), a CPU smoke (256) and
    the card (no clamp) measure it, each of the bucket's candidates passes
    its family's format check, every split of K1 gets a ``bk`` tile, and
    layout dims are never clamped."""
    table = _llama_tables()[name]
    assert table["buckets"]
    for bucket, entries in table["buckets"].items():
        asgs = [{k: int(v) for k, v in e["assignment"].items()}
                for e in entries]
        data = measure_shape(name, parse_bucket_key(bucket), asgs, max_dim)
        for k in tmeasure._LAYOUT_DIMS.get(name, ()):
            assert data[k] == parse_bucket_key(bucket)[k]
        for a in asgs:
            assert _format_error(name, data, a) is None, (bucket, a, data)
            if name == "matmul_h100":
                assert all(len(r) for r in mm.split_tiles(
                    data["K"], a["bk"], a["kb"])), (bucket, a, data)


def test_cpu_timer_times_every_candidate_of_a_quick_table(tmp_path):
    """``MeasureConfig(device="cpu")``: the plain versions time every
    candidate of a quick K1 table (a smoke of the code path), the tuned
    table then serves its measured order through ``DispatchCache``."""
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], quick=True)
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)
    (bucket,) = table["buckets"]
    timer = DeviceTimer()
    samples = measure_table(MATMUL, table, MeasureConfig(
        iters=2, warmup=0, trim=0, max_dim=256, device="cpu"), timer=timer)
    assert len(samples) == len(table["buckets"][bucket])
    assert all(s.us is not None and s.us > 0 for s in samples)
    assert all(len(s.repeats) == 2 for s in samples)
    store.save_dispatch(compact_table(calibrate_table(MATMUL, table,
                                                      samples), samples))
    cache = DispatchCache(store=store)
    data = parse_bucket_key(bucket)
    assert cache.rank_source(MATMUL, H100_SXM, data) == "measured"
    cache.best_variant(MATMUL, H100_SXM, data)
    assert cache.stats.measured_hits == 1
    timer.clear()


# ---------------------------------------------------------------------------
# acceptance: measured rank consumed by best_variant
# ---------------------------------------------------------------------------

def test_best_variant_prefers_measured_rank(tmp_path):
    store, tuned, samples = _tuned_store(tmp_path, [MM_A])
    bucket = bucket_key(MM_A)
    # the fake timer must actually disagree with the symbolic order,
    # otherwise this test proves nothing
    order = tuned["measured_ranks"][bucket]["order"]
    assert order[0] != 0
    cache = DispatchCache(store=store)
    STATS.reset()
    cand = cache.best_variant(MATMUL, H100_SXM, MM_A)
    assert STATS.enumerate_calls == 0                 # disk tier, no search
    assert cache.stats.disk_hits == 1
    assert cache.stats.measured_hits == 1
    fastest = min((s for s in samples if s.us is not None),
                  key=lambda s: s.us)
    assert cand.assignment == fastest.assignment
    symbolic = best_variant(MATMUL, H100_SXM, MM_A, use_cache=False)
    assert cand.assignment != symbolic.assignment     # the rank really moved


def test_rank_source_reporting(tmp_path):
    store, _, _ = _tuned_store(tmp_path, [MM_A])
    cache = DispatchCache(store=store)
    assert cache.rank_source(MATMUL, H100_SXM, MM_A) == "measured"
    assert cache.rank_source(MATMUL, H100_SXM,
                             {"M": 64, "N": 64, "K": 64}) == "cold"
    assert DispatchCache().rank_source(MATMUL, H100_SXM, MM_A) == "cold"


def test_parity_with_symbolic_when_untuned(tmp_path):
    """No calibration section => the symbolic dispatch, unchanged."""
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], shapes=[MM_A])
    cache = DispatchCache(store=store)
    assert cache.rank_source(MATMUL, H100_SXM, MM_A) == "symbolic"
    cand = cache.best_variant(MATMUL, H100_SXM, MM_A)
    assert cache.stats.measured_hits == 0
    assert cand == best_variant(MATMUL, H100_SXM, MM_A, use_cache=False)


def test_mangled_measured_ranks_degrade_to_symbolic(tmp_path):
    """Malformed tuning sections are ignored, never raised (cache-miss-
    never-error, applied to the v2 sections)."""
    store, tuned, _ = _tuned_store(tmp_path, [MM_A])
    bucket = bucket_key(MM_A)
    for bad_order in ([99, 98], ["x"], "notalist", [0, 0, 1]):
        mangled = dict(tuned)
        mangled["measured_ranks"] = {bucket: {"order": bad_order}}
        store.save_dispatch(mangled)
        cache = DispatchCache(store=store)
        cand = cache.best_variant(MATMUL, H100_SXM, MM_A)  # must not raise
        assert cache.stats.disk_hits == 1
        assert cache.stats.measured_hits == 0
        assert cand == best_variant(MATMUL, H100_SXM, MM_A, use_cache=False)


# ---------------------------------------------------------------------------
# acceptance: v2 round-trip + v1 cache miss
# ---------------------------------------------------------------------------

def test_tuned_table_roundtrips_byte_deterministically(tmp_path):
    store, tuned, _ = _tuned_store(tmp_path, [MM_A, MM_B])
    assert tuned["format"] == serde.FORMAT_VERSION == 2
    reloaded = store.load_dispatch(MATMUL.name, H100_SXM.name)
    assert serde.dumps(reloaded) == serde.dumps(tuned)
    # and a save -> load -> save cycle is a fixed point (no float drift)
    store.save_dispatch(reloaded)
    again = store.load_dispatch(MATMUL.name, H100_SXM.name)
    assert serde.dumps(again) == serde.dumps(tuned)
    assert "calibration" in again and "measured_ranks" in again


def test_v1_table_is_cache_miss_not_error(tmp_path):
    store, tuned, _ = _tuned_store(tmp_path, [MM_A])
    path = store.dispatch_path(MATMUL.name, H100_SXM.name)
    path.write_text(path.read_text().replace('"format":2', '"format":1', 1))
    assert store.load_dispatch(MATMUL.name, H100_SXM.name) is None
    cache = DispatchCache(store=store)
    STATS.reset()
    cand = cache.best_variant(MATMUL, H100_SXM, MM_A)        # must not raise
    assert cache.stats.cold_builds == 1 and STATS.enumerate_calls == 1
    assert cand == best_variant(MATMUL, H100_SXM, MM_A, use_cache=False)


# ---------------------------------------------------------------------------
# calibration fit + compaction
# ---------------------------------------------------------------------------

def test_calibration_fit_predicts_positive_times(tmp_path):
    store, tuned, samples = _tuned_store(tmp_path, [MM_A, MM_B])
    cal = tuned["calibration"]
    assert cal["n_samples"] == sum(s.us is not None for s in samples)
    assert cal["rms_log_residual"] >= 0
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)
    fit = fit_family(MATMUL, table, samples)
    leaf = serde.obj_to_leaf(
        table["leaves"][str(samples[0].leaf_index)])
    p = predict_us(fit, MATMUL, leaf.plan, samples[0].assignment,
                   samples[0].data, table["machine_bindings"])
    assert p is not None and p > 0


def test_compaction_finds_reduced_covering_set(tmp_path):
    """Acceptance: >= 1 bucket where a reduced variant set stays within
    tolerance.  The fake timer makes one variant fastest everywhere, so the
    greedy cover must collapse every bucket onto a single variant."""
    _, tuned, samples = _tuned_store(tmp_path, [MM_A, MM_B])
    comp = tuned["compaction"]
    assert comp["buckets_total"] == 2
    assert comp["buckets_covered"] == comp["buckets_total"]
    assert len(comp["variants"]) < comp["total_variants_measured"]
    assert len(comp["variants"]) == 1
    covered = [b for b, rec in comp["per_bucket"].items()
               if rec is not None and rec["regret"] <= comp["tolerance"]]
    assert len(covered) >= 1


def test_compaction_respects_tolerance(tmp_path):
    """With zero tolerance every bucket needs its exact argmin variant."""

    def per_bucket_best(family, plan, assignment, data, cfg):
        # fastest variant differs per bucket: bn=32 at K 4096, 256 at 8192
        want = 32 if data["K"] <= 4096 else 256
        us = 10.0 if assignment["bn"] == want else 1000.0 + assignment["bk"]
        return [us * 1e-6] * max(1, cfg.iters)

    _, tuned, _ = _tuned_store(tmp_path, [MM_A, MM_B], tolerance=0.0,
                               timer=per_bucket_best)
    comp = tuned["compaction"]
    assert comp["buckets_covered"] == comp["buckets_total"] == 2
    assert len(comp["variants"]) == 2


def _sample(cls, bucket, pos, asg, us, leaf=0):
    return cls(bucket=bucket, entry_index=pos, leaf_index=leaf,
               assignment=asg, score=1.0, data={"M": 256}, us=us)


TIED = [("M256", 1, {"s": 2}, 101.0), ("M256", 2, {"s": 4}, 108.0),
        ("M512", 1, {"s": 2}, 202.0), ("M512", 2, {"s": 4}, 216.0)]


def test_compaction_tie_break_prefers_lower_regret():
    """Two variants covering the same buckets: the greedy cover must pick
    the one with lower total relative regret."""
    # the per-bucket best (s=1) is left out so s=2 and s=4 both cover both
    # buckets and tie on coverage; only regret can break the tie
    tied = [_sample(MeasuredSample, *t) for t in TIED]
    comp = compact_table({"buckets": {}}, tied, tolerance=0.10)["compaction"]
    assert comp["variants"] == ["leaf0|s=2"]


@pytest.mark.parametrize("tolerance", [0.0, 0.05, 0.10])
def test_compaction_matches_the_jax_package(tolerance):
    """One table and one sample list (failed samples, a bucket with none,
    two leaves) give equal ``compaction`` sections in both packages."""
    rows = TIED + [("M256", 0, {"s": 1}, 100.0), ("M512", 0, {"s": 1}, 200.0),
                   ("M512", 3, {"s": 8}, None), ("M1024", 0, {"s": 1}, None),
                   ("M1024", 1, {"s": 2}, 50.0)]
    table = {"buckets": {"M256": [1], "M512": [1], "M1024": [1],
                         "M2048": [1], "M4096": []}}
    mine = [_sample(MeasuredSample, *r, leaf=i % 2)
            for i, r in enumerate(rows)]
    theirs = [_sample(jmeasure.MeasuredSample, *r, leaf=i % 2)
              for i, r in enumerate(rows)]
    got = compact_table(table, mine, tolerance)["compaction"]
    assert got == jcompact.compact_table(table, theirs,
                                         tolerance)["compaction"]
    assert compaction_summary({"compaction": got}) == \
        jcompact.compaction_summary({"compaction": got})


# ---------------------------------------------------------------------------
# calibration parity: one stand-in family through both packages
# ---------------------------------------------------------------------------

class _Expr:
    def __init__(self, fn):
        self.fn = fn

    def eval(self, values):
        return self.fn(values)


class _Counter:
    """A performance measure of a stand-in family: bn / (bn + N), or
    unbindable (KeyError) for an assignment without ``bn``."""

    def __init__(self, kind, name, scale):
        self.kind, self.name, self.scale = kind, name, scale

    def evaluate(self, family, plan):
        return (_Expr(lambda v: self.scale * v["bn"]),
                _Expr(lambda v: self.scale * v["bn"] + v["N"]))


class _Family:
    """What calibrate reads of a family: its name and counters, each
    package's ``CounterKind`` for its own calibrate."""

    name = "stand_in"

    def __init__(self, kind_enum):
        self._counters = [_Counter(kind_enum.PERFORMANCE, "fill", 1),
                          _Counter(kind_enum.PERFORMANCE, "fill2", 3),
                          _Counter(kind_enum.RESOURCE, "smem", 1)]

    def counters(self):
        return self._counters


def _stand_in_table():
    """A real K1 table (its leaves parse in both packages: the serde is a
    copy) over MM_A and MM_B, with every entry's bn kept and one entry
    made unbindable (its bn dropped)."""
    table = build_dispatch_table(MATMUL, H100_SXM, [MM_A, MM_B])
    bucket = bucket_key(MM_B)
    entries = [dict(e) for e in table["buckets"][bucket]]
    entries[-1] = {**entries[-1], "assignment": {
        k: v for k, v in entries[-1]["assignment"].items() if k != "bn"}}
    table["buckets"] = {**table["buckets"], bucket: entries}
    return table


def _stand_in_samples(cls, table, bucket_us):
    """Samples of both buckets: ``bucket_us`` maps a bucket to the measured
    us of its first entries (None: failed)."""
    out = []
    for bucket, times in bucket_us.items():
        data = parse_bucket_key(bucket)
        for pos, us in enumerate(times):
            e = table["buckets"][bucket][pos]
            out.append(cls(bucket=bucket, entry_index=pos,
                           leaf_index=int(e["leaf_index"]),
                           assignment=dict(e["assignment"]),
                           score=float(e["score"]), data=dict(data), us=us))
    return out


def _both_calibrations(bucket_us):
    from repro.core.counters import CounterKind as JCounterKind
    table = _stand_in_table()
    mine = calibrate_table(_Family(CounterKind), table, _stand_in_samples(
        MeasuredSample, table, bucket_us))
    theirs = jcal.calibrate_table(_Family(JCounterKind), table,
                                  _stand_in_samples(jmeasure.MeasuredSample,
                                                    table, bucket_us))
    return table, mine, theirs


@pytest.mark.parametrize("fitted", [True, False])
def test_calibrate_tiered_order_matches_the_jax_package(fitted):
    """The tiered order — measured entries by time, then model-predicted,
    then symbolic — with measured, failed (predicted or, without a fit,
    symbolic) and unmeasured entries, equal in both packages; the
    unbindable entry always stays symbolic."""
    a, b = bucket_key(MM_A), bucket_key(MM_B)
    bucket_us = ({a: [30.0, None, 10.0, 20.0, 25.0], b: [40.0, 5.0, None]}
                 if fitted else {a: [30.0, None, 10.0], b: [None, 5.0]})
    table, mine, theirs = _both_calibrations(bucket_us)
    assert mine["measured_ranks"] == theirs["measured_ranks"]
    assert ("calibration" in mine) == fitted
    if fitted:
        assert mine["calibration"] == theirs["calibration"]
        order = mine["measured_ranks"][b]["order"]
        n = len(table["buckets"][b])
        assert order[:2] == [1, 0] and order[-1] == n - 1   # unbindable last
        assert mine["measured_ranks"][b]["predicted_us"]
    else:
        order = mine["measured_ranks"][a]["order"]
        assert order[:2] == [2, 0]
        assert order[2:] == [i for i in range(len(table["buckets"][a]))
                             if i not in (0, 2)]              # symbolic tail


def test_fit_lstsq_matches_the_jax_package():
    """The fit's least squares on equal feature rows: equal coefficients
    within 1e-9, equal residual and sample count."""
    from repro.core.counters import CounterKind as JCounterKind
    table = _stand_in_table()
    a, b = bucket_key(MM_A), bucket_key(MM_B)
    rng = np.random.default_rng(3)
    bucket_us = {a: list(rng.uniform(5, 50, len(table["buckets"][a]))),
                 b: list(rng.uniform(5, 50, len(table["buckets"][b]) - 1))}
    mine = fit_family(_Family(CounterKind), table, _stand_in_samples(
        MeasuredSample, table, bucket_us))
    theirs = jcal.fit_family(_Family(JCounterKind), table,
                             _stand_in_samples(jmeasure.MeasuredSample,
                                               table, bucket_us))
    assert mine is not None and mine.n_samples == theirs.n_samples
    assert mine.feature_names == theirs.feature_names
    assert np.allclose(mine.coeffs, theirs.coeffs, rtol=0, atol=1e-9)
    assert math.isclose(mine.rms_log_residual, theirs.rms_log_residual,
                        rel_tol=0, abs_tol=1e-9)


@pytest.mark.parametrize("module", ["tuning/calibrate", "tuning/compact"])
def test_calibrate_and_compact_are_copies_of_the_originals(module):
    """Imports and docstrings aside, the port's calibrate and compact are
    the JAX package's code (as ``test_torch_core.py`` holds its other pure
    copies)."""
    from test_torch_core import _code
    import pathlib
    src = pathlib.Path(SRC).resolve()
    assert _code(src / "repro_torch" / f"{module}.py") == \
        _code(src / "repro" / f"{module}.py")


def test_the_tuning_package_exports_the_jax_names():
    import repro_torch.tuning as ttuning
    assert ttuning.__all__ == jtuning.__all__
    assert {"CalibrationFit", "calibrate_table", "fit_family",
            "predict_us"} <= tcal.__dict__.keys() & jcal.__dict__.keys()


def test_warm_kernel_dispatch_reports_rank_source():
    """Serving warm-up labels every pick with the tier that decided it;
    with no artifact store everything is cold."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime.serving import warm_kernel_dispatch
    picks = warm_kernel_dispatch(get_smoke_config("llama3_8b"), max_len=128,
                                 plan_store=False)
    assert picks
    for info in picks.values():
        assert info["rank_source"] == "cold"
        assert info["candidate"].score >= 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_tune_artifacts_cli_dry_run(tmp_path):
    """``--dry-run`` lists the plan, writes nothing and runs no kernel (the
    default ``--device cuda`` is not even asked for a card)."""
    store = ArtifactStore(tmp_path)
    compile_family(MATMUL, store, machines=[H100_SXM], shapes=[MM_A])
    path = store.dispatch_path(MATMUL.name, H100_SXM.name)
    before = path.read_bytes()
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune_artifacts",
         "--family", "matmul_h100", "--machine", "h100_sxm",
         "--out", str(tmp_path), "--dry-run"],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "[dry-run] matmul_h100/h100_sxm" in proc.stdout
    shape = dict(sorted(MM_A.items()))                 # unclamped on cuda
    assert f"{bucket_key(MM_A)} -> measure at {shape}" in proc.stdout
    assert path.read_bytes() == before
    table = store.load_dispatch(MATMUL.name, H100_SXM.name)
    assert "measured_ranks" not in table


def test_tune_artifacts_dry_run_launches_nothing(tmp_path, capsys):
    """In process: ``--dry-run`` over every family compiles the missing
    tables (``--quick``), lists each bucket and moves no launch counter."""
    from repro_torch.launch import tune_artifacts
    wrappers = COUNTED + (transpose_h100, matadd_h100, jacobi1d_h100)
    before = [w.launches for w in wrappers]
    assert tune_artifacts.main(["--out", str(tmp_path), "--quick",
                                "--dry-run"]) == 0
    out = capsys.readouterr().out
    for name in FAMILIES:
        assert f"[dry-run] {name}/h100_sxm" in out
        table = ArtifactStore(tmp_path).load_dispatch(name, "h100_sxm")
        assert "measured_ranks" not in table
    assert "paper_m2050" not in out                # h100_sxm alone
    assert [w.launches for w in wrappers] == before


def test_tune_artifacts_cpu_smoke_writes_a_measured_table(tmp_path, capsys):
    """``--device cpu``: the plain versions timed, the table rewritten with
    the tuning sections, and the cache serves its measured order."""
    from repro_torch.launch import tune_artifacts
    assert tune_artifacts.main([
        "--family", "matmul_h100", "--out", str(tmp_path), "--quick",
        "--device", "cpu", "--iters", "1", "--top-k", "2"]) == 0
    out = capsys.readouterr().out
    assert "[OK] matmul_h100/h100_sxm: 2/2 candidates measured" in out
    store = ArtifactStore(tmp_path)
    table = store.load_dispatch("matmul_h100", "h100_sxm")
    assert table["measured_ranks"] and "compaction" in table
    (bucket,) = table["buckets"]
    cache = DispatchCache(store=store)
    cache.best_variant(MATMUL, H100_SXM, parse_bucket_key(bucket))
    assert cache.stats.measured_hits == 1


def test_tune_artifacts_warns_beside_k2s_measured_order(tmp_path, capsys):
    """K2 is timed at the napkin's context, not the serve path's: the
    launcher says so beside its line (and not beside K1's)."""
    from repro_torch.launch import tune_artifacts
    assert tune_artifacts.main([
        "--family", "flash_attention_h100", "--family", "matmul_h100",
        "--out", str(tmp_path), "--quick", "--device", "cpu", "--iters",
        "1", "--top-k", "1"]) == 0
    out = capsys.readouterr().out
    assert "[warn] flash_attention_h100/h100_sxm: timed over 4096 keys" in out
    assert "[warn] matmul_h100" not in out
