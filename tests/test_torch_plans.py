"""The port's disk tier and serve plans on the CPU.

As ``tests/test_plans.py`` holds the JAX package's: serve-plan serde is
byte-deterministic; every mismatch of a plan's identity — machine
bindings, ``max_len``, and the port's ``max_batch`` and ``prefill_chunk``
(its trace depends on them) — a format or kind mismatch, or a mangled
payload reads as a miss, never an error; a plan whose table digests went
stale warns and falls back online, and raises under ``strict_plans``; a
plan-backed start freezes every traced triple with zero cold builds and
the online picks.  The port's plans are of their own kind: a JAX plan is a
miss to the port and the port's a miss to the JAX package, both ways.
"""
import json
import warnings

import pytest

import repro.configs as jconfigs
from repro.artifacts import ArtifactStore as JArtifactStore
from repro.artifacts import DispatchCache as JDispatchCache
from repro.artifacts import compile_family as j_compile_family
from repro.core import TPU_V5E
from repro.kernels.ops import FAMILIES as J_FAMILIES
from repro.plans import PlanStore as JPlanStore
from repro.plans import build_serve_plan as j_build_serve_plan
from repro.plans import serde as j_plan_serde
from repro_torch.artifacts import (ArtifactStore, DispatchCache,
                                   compile_family)
from repro_torch.artifacts.dispatch import set_default_cache
from repro_torch.configs import get_smoke_config
from repro_torch.core import select as tselect
from repro_torch.core.params import H100_SXM, PAPER_M2050
from repro_torch.kernels.ops import FAMILIES
from repro_torch.plans import (PLAN_FORMAT_VERSION, PlanStore,
                               StalePlanError, StalePlanWarning,
                               apply_serve_plan, build_serve_plan,
                               load_serve_plan, op_label, plan_staleness,
                               table_digest, trace_warm_set, warm_from_plan)
from repro_torch.plans import serde as plan_serde
from repro_torch.runtime import faults
from repro_torch.runtime.faults import ANY_TICK, FaultSpec
from repro_torch.runtime.serving import warm_kernel_dispatch

SIZES = dict(max_len=48, max_batch=3, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _isolate_default_cache():
    set_default_cache(DispatchCache())
    yield
    set_default_cache(None)
    faults.install(None)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("llama3_8b").scaled(dtype="float32")


def _plan(cfg, **kw):
    return build_serve_plan(cfg, cache=DispatchCache(), **{**SIZES, **kw})


def _compiled_store(root):
    store = ArtifactStore(root)
    compile_family(FAMILIES["matmul_h100"], store, machines=[H100_SXM],
                   shapes=[{"M": 8, "N": 64, "K": 64}])
    return store


def _retune(store):
    """Rewrite the matmul table in place, as a recompile or a tuner does:
    its canonical digest changes."""
    payload = store.load_dispatch("matmul_h100", H100_SXM.name)
    bucket = next(iter(payload["buckets"]))
    payload["buckets"][bucket][0]["score"] = 123.456
    store.save_dispatch(payload)


# ---------------------------------------------------------------------------
# serde + store
# ---------------------------------------------------------------------------

def test_plan_bytes_deterministic_and_round_trip(tmp_path, cfg):
    a, dropped = _plan(cfg)
    b, _ = _plan(cfg)
    assert not dropped
    assert plan_serde.dumps(a) == plan_serde.dumps(b)
    assert a.digest() == b.digest()
    pa = PlanStore(tmp_path / "a").save_plan(a)
    pb = PlanStore(tmp_path / "b").save_plan(b)
    assert pa.read_bytes() == pb.read_bytes()
    assert f"serve-v{PLAN_FORMAT_VERSION}-{H100_SXM.name}" in pa.name
    loaded = PlanStore(tmp_path / "a").load_plan(cfg.name, H100_SXM.name)
    assert loaded == a
    assert (loaded.max_batch, loaded.prefill_chunk) == (3, 8)
    assert [(e.family, e.data) for e in loaded.entries] == [
        (op.family, op.data) for op in trace_warm_set(cfg, **SIZES)]
    for e in loaded.entries:
        assert e.label == op_label(e.family, e.data_dict())
        assert e.rank_source == "cold"


@pytest.mark.parametrize("field,value", [
    ("max_len", 64), ("max_batch", 4), ("prefill_chunk", 16),
    ("machine_bindings", "tampered")])
def test_each_plan_mismatch_is_a_miss(tmp_path, cfg, field, value):
    """A plan built for another engine (or host) must not warm this one:
    the port's trace depends on max_batch and prefill_chunk as on
    max_len."""
    plan, _ = _plan(cfg)
    store = PlanStore(tmp_path)
    store.save_plan(plan)
    assert load_serve_plan(cfg, store=store, **SIZES) is not None
    if field == "machine_bindings":
        tampered = plan_serde.ServePlan(**{
            **plan.__dict__,
            "machine_bindings": {**plan.machine_bindings, "V": 1}})
        store.save_plan(tampered)
        assert load_serve_plan(cfg, store=store, **SIZES) is None
    else:
        assert load_serve_plan(cfg, store=store,
                               **{**SIZES, field: value}) is None
    sizes = {**SIZES, field: value} if field != "machine_bindings" \
        else SIZES
    cache = DispatchCache()
    assert warm_from_plan(cfg, store=store, cache=cache, **sizes) is None
    assert cache.frozen_plan is None


@pytest.mark.parametrize("mangle", ["not-json", "kind", "format",
                                    "entries", "assignment", "rank_source",
                                    "max_batch"])
def test_mangled_plan_payload_is_a_miss(tmp_path, cfg, mangle):
    plan, _ = _plan(cfg)
    store = PlanStore(tmp_path)
    path = store.save_plan(plan)
    if mangle == "not-json":
        path.write_text("{truncated")
    else:
        payload = json.loads(path.read_text())
        if mangle == "kind":
            payload["kind"] = "serve_plan"        # the JAX package's kind
        elif mangle == "format":
            payload["format"] = PLAN_FORMAT_VERSION + 1
        elif mangle == "entries":
            payload["entries"] = "nope"
        elif mangle == "assignment":
            payload["entries"][0]["candidate"]["assignment"] = {"bm": "x"}
        elif mangle == "rank_source":
            payload["entries"][0]["rank_source"] = "vibes"
        elif mangle == "max_batch":
            del payload["max_batch"]
        path.write_text(json.dumps(payload))
    assert store.load_plan(cfg.name, H100_SXM.name) is None
    assert warm_from_plan(cfg, store=store, cache=DispatchCache(),
                          **SIZES) is None


def test_jax_and_port_plans_are_misses_to_each_other(tmp_path, cfg):
    """The same config name and machine name, both packages' plans under
    one root: each reader reads only its own kind, both ways."""
    jcfg = jconfigs.get_smoke_config("llama3_8b")
    assert jcfg.name == cfg.name
    tplan, _ = _plan(cfg, machine=PAPER_M2050)
    jplan, _ = j_build_serve_plan(jcfg, max_len=48, cache=JDispatchCache())
    tstore, jstore = PlanStore(tmp_path), JPlanStore(tmp_path)
    # each payload written where the other package looks for its plan
    tpath = tstore.plan_path(cfg.name, PAPER_M2050.name)
    jpath = jstore.plan_path(jcfg.name, TPU_V5E.name)
    tpath.parent.mkdir(parents=True, exist_ok=True)
    tpath.write_text(j_plan_serde.dumps(jplan))
    jpath.write_text(plan_serde.dumps(tplan))
    assert tstore.load_plan(cfg.name, PAPER_M2050.name) is None
    assert jstore.load_plan(jcfg.name, TPU_V5E.name) is None
    # and in their own places each package reads its own
    tstore.save_plan(tplan)
    jstore.save_plan(jplan)
    assert tstore.load_plan(cfg.name, PAPER_M2050.name) == tplan
    assert jstore.load_plan(jcfg.name, TPU_V5E.name) == jplan


def test_jax_and_port_tables_share_a_root_without_crossing(tmp_path):
    """Dispatch tables of both packages under one root: each cache reads
    only its own families' tables (the port's families have their own
    names), both ways."""
    jstore = JArtifactStore(tmp_path)
    j_compile_family(J_FAMILIES["matmul"], jstore, machines=[TPU_V5E],
                     shapes=[{"M": 512, "N": 512, "K": 512}])
    tstore = _compiled_store(tmp_path)
    tcache = DispatchCache(store=tstore)
    tcache.best_variant(FAMILIES["matmul_h100"], H100_SXM,
                        {"M": 8, "N": 64, "K": 64})
    tcache.best_variant(FAMILIES["matmul_h100"], PAPER_M2050,
                        {"M": 512, "N": 512, "K": 512})
    assert (tcache.stats.disk_hits, tcache.stats.cold_builds) == (1, 1)
    jcache = JDispatchCache(store=JArtifactStore(tmp_path))
    jcache.best_variant(J_FAMILIES["matmul"], TPU_V5E,
                        {"M": 512, "N": 512, "K": 512})
    assert jcache.stats.disk_hits == 1
    assert jstore.load_dispatch("matmul_h100", H100_SXM.name) is not None
    assert tstore.load_dispatch("matmul", H100_SXM.name) is None


def test_unknown_family_or_failed_apply_publishes_nothing(cfg):
    plan, _ = _plan(cfg)
    bad = plan_serde.PlanEntry(
        label="bogus@X1", family="bogus_family", data=(("X", 1),),
        sites=("serve.bogus",), candidate=plan.entries[0].candidate,
        rank_source="cold")
    tampered = plan_serde.ServePlan(**{**plan.__dict__,
                                       "entries": plan.entries + (bad,)})
    cache = DispatchCache()
    assert apply_serve_plan(tampered, cache=cache) is None
    assert cache.frozen_plan is None
    with faults.inject([FaultSpec("plan.apply", ANY_TICK, "error")]):
        assert apply_serve_plan(plan, cache=cache) is None
    assert cache.frozen_plan is None
    assert apply_serve_plan(plan, cache=cache) is not None


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------

def test_stale_digest_warns_by_default_and_refuses_strict(tmp_path, cfg):
    store = _compiled_store(tmp_path)
    plan, _ = build_serve_plan(cfg, cache=DispatchCache(store=store),
                               **SIZES)
    dm = plan.table_digest_map()
    assert dm["matmul_h100"] == table_digest(store, "matmul_h100",
                                             H100_SXM.name) != ""
    assert dm["flash_attention_h100"] == ""       # no table compiled
    assert any(e.rank_source == "symbolic" for e in plan.entries)
    pstore = PlanStore(tmp_path)
    pstore.save_plan(plan)
    for strict in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("error", StalePlanWarning)
            assert warm_from_plan(cfg, store=pstore, strict=strict,
                                  cache=DispatchCache(store=store),
                                  **SIZES) is not None
    _retune(store)
    assert set(plan_staleness(plan, store=store)) == {"matmul_h100"}
    with pytest.warns(StalePlanWarning, match="STALE.*matmul_h100"):
        assert warm_from_plan(cfg, store=pstore,
                              cache=DispatchCache(store=store),
                              **SIZES) is None
    with pytest.raises(StalePlanError, match="plan_artifacts"):
        warm_from_plan(cfg, store=pstore, strict=True,
                       cache=DispatchCache(store=store), **SIZES)
    # the engine's warm-up: the warn path still warms (online), the
    # strict path raises
    warm_cache = DispatchCache(store=store)
    set_default_cache(warm_cache)
    with pytest.warns(StalePlanWarning):
        picks = warm_kernel_dispatch(cfg, plan_store=pstore, **SIZES)
    assert picks and len(warm_cache.frozen_plan) == len(picks)
    set_default_cache(DispatchCache(store=store))
    with pytest.raises(StalePlanError):
        warm_kernel_dispatch(cfg, plan_store=pstore, strict_plans=True,
                             **SIZES)


# ---------------------------------------------------------------------------
# plan-backed start: zero cold builds, the online picks
# ---------------------------------------------------------------------------

def test_plan_backed_freeze_zero_cold_and_parity(tmp_path, cfg):
    plan, _ = _plan(cfg)
    store = PlanStore(tmp_path)
    store.save_plan(plan)
    online = DispatchCache()
    set_default_cache(online)
    online_picks = warm_kernel_dispatch(cfg, plan_store=False, **SIZES)
    assert online.stats.cold_builds > 0
    backed = DispatchCache()
    set_default_cache(backed)
    calls = tselect.STATS.enumerate_calls
    picks = warm_kernel_dispatch(cfg, plan_store=store, **SIZES)
    assert tselect.STATS.enumerate_calls == calls  # no tree enumerated
    assert (backed.stats.cold_builds, backed.stats.disk_hits,
            backed.stats.memory_hits) == (0, 0, 0)
    assert picks.keys() == online_picks.keys()
    for label in picks:
        assert picks[label]["candidate"] == online_picks[label]["candidate"]
    for op in trace_warm_set(cfg, **SIZES):
        a = backed.frozen_entry(op.family, H100_SXM.name, op.data_dict())
        b = online.frozen_entry(op.family, H100_SXM.name, op.data_dict())
        assert a.candidate == b.candidate
        backed.best_variant(FAMILIES[op.family], H100_SXM, op.data_dict())
    assert backed.stats.cold_builds == 0


def test_serve_engine_starts_from_a_plan_and_shares_prefixes(tmp_path, cfg):
    """``ServeEngine(warm_kernels=True, plan_store=...)`` pins every pick
    without a cold build; a shared-prefix workload then serves through the
    plan with none either (CoW and mapped prefills add no shape)."""
    import numpy as np
    from repro_torch.models import init_model
    from repro_torch.runtime import ServeEngine
    plan, _ = _plan(cfg)
    store = PlanStore(tmp_path)
    store.save_plan(plan)
    cache = DispatchCache()
    set_default_cache(cache)
    params = init_model(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, warm_kernels=True, plan_store=store,
                      prefix_sharing=True, async_depth=2, page_size=4,
                      device="cpu", **SIZES)
    assert cache.stats.cold_builds == 0
    assert len(cache.frozen_plan) == len(eng.kernel_plan) == len(
        plan.entries)
    rng = np.random.default_rng(0)
    lead = rng.integers(0, cfg.vocab, 20)
    eng.submit(lead, max_new=4)
    eng.run_until_drained()
    eng.submit(np.concatenate([lead[:16], rng.integers(0, cfg.vocab, 6)]),
               max_new=4)
    eng.run_until_drained()
    assert eng.pool.stats.prefix_hits > 0
    assert cache.stats.cold_builds == 0


# ---------------------------------------------------------------------------
# the two CLIs
# ---------------------------------------------------------------------------

def test_compile_artifacts_cli(tmp_path, capsys):
    from repro_torch.launch import compile_artifacts
    rc = compile_artifacts.main(["--family", "matmul_h100", "--family",
                                 "ssd_scan_h100", "--out", str(tmp_path),
                                 "--quick", "--verify"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count("verify: reloaded == fresh") == 2
    store = ArtifactStore(tmp_path)
    for fam in ("matmul_h100", "ssd_scan_h100"):
        for m in (H100_SXM, PAPER_M2050):
            assert store.load_dispatch(fam, m.name) is not None
    with pytest.raises(SystemExit):
        compile_artifacts.main(["--family", "matmul", "--out",
                                str(tmp_path)])


def test_plan_artifacts_cli_dry_run_build_and_check(tmp_path, capsys):
    from repro_torch.launch import plan_artifacts
    base = ["--config", "llama3_8b", "--smoke", "--max-len", "48",
            "--max-batch", "3", "--prefill-chunk", "8", "--out",
            str(tmp_path)]
    assert plan_artifacts.main(base + ["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "[dry-run]" in out and "traced triples" in out
    assert not (tmp_path / "plans").exists()
    assert plan_artifacts.main(base) == 0
    assert "[OK]" in capsys.readouterr().out
    smoke = get_smoke_config("llama3_8b")
    loaded = PlanStore(tmp_path).load_plan(smoke.name, H100_SXM.name)
    assert loaded is not None and loaded.max_batch == 3
    assert plan_artifacts.main(base + ["--check"]) == 0
    assert "[FRESH]" in capsys.readouterr().out
    # a table appearing where none existed is drift as well
    _compiled_store(tmp_path)
    assert plan_artifacts.main(base + ["--check"]) == 0
    assert "[STALE]" in capsys.readouterr().out
    assert plan_artifacts.main(base + ["--check", "--strict"]) == 1
    assert "stale plan(s)" in capsys.readouterr().err
