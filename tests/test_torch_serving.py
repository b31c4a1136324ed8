"""The port's ServeEngine against the JAX ServeEngine on the CPU.

f32 llama3, mamba2 and hymba smoke configs, the same weights (JAX init ->
numpy -> port), the same prompts; ``prefill_chunk`` below some prompt
lengths and more requests than slots, so chunked prefill, slot reuse (and
with it the SSM state reset) and mid-prefill decode all run.  The greedy
tokens must be equal.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import init_model as j_init
from repro.runtime import ServeEngine as JEngine
from repro_torch.artifacts.dispatch import DispatchCache, set_default_cache
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.runtime import ServeEngine, warm_kernel_dispatch

ENGINE = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8)


@pytest.fixture
def fresh_cache():
    cache = DispatchCache()
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


@pytest.fixture(scope="module")
def weights():
    cfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(11), cfg)
    tcfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(vocab):
    rng = np.random.default_rng(12)
    return [rng.integers(0, vocab, n) for n in (5, 19, 11, 3, 26)]


def test_engine_tokens_equal_jax_engine(weights, fresh_cache):
    cfg, jp, tcfg, tp = weights
    prompts = _prompts(cfg.vocab)
    jeng = JEngine(cfg, jp, **ENGINE)
    jr = [jeng.submit(p, max_new=6) for p in prompts]
    jdone = {r.rid: r.out for r in jeng.run_until_drained()}

    teng = ServeEngine(tcfg, tp, warm_kernels=True, device="cpu", **ENGINE)
    cold = fresh_cache.stats.cold_builds
    tr = [teng.submit(p, max_new=6) for p in prompts]
    tdone = {r.rid: r.out for r in teng.run_until_drained()}
    assert fresh_cache.stats.cold_builds == cold       # warm set exhaustive
    assert teng.sched.stats.prefill_chunks > len(prompts)  # chunked prefill
    assert [tdone[r] for r in tr] == [jdone[r] for r in jr]
    assert all(len(tdone[r]) == 6 for r in tr)


def test_warm_set_freezes_every_dispatched_triple(weights, fresh_cache):
    _, _, tcfg, _ = weights
    picks = warm_kernel_dispatch(tcfg, max_len=48, max_batch=3,
                                 prefill_chunk=8)
    assert len(picks) == len(fresh_cache.frozen_plan)
    assert {p["rank_source"] for p in picks.values()} == {"cold"}


def test_traced_warm_set_holds_what_the_engine_dispatches(weights,
                                                          fresh_cache):
    """Fidelity of the port's trace (ROADMAP F5): every (family, data) the
    engine's model asks the dispatch cache for during a run is in the
    traced warm set."""
    from repro_torch.plans.trace import trace_warm_set
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    with fresh_cache.record() as rec:
        for p in _prompts(tcfg.vocab):
            eng.submit(p, max_new=4)
        eng.run_until_drained()
    traced = {(op.family, op.data) for op in trace_warm_set(
        tcfg, max_len=ENGINE["max_len"], max_batch=ENGINE["max_batch"],
        prefill_chunk=ENGINE["prefill_chunk"])}
    seen = {(f, items) for f, _, items in rec.requests}
    assert {f for f, _ in seen} == {"matmul_h100", "flash_attention_h100"}
    assert seen <= traced, seen - traced


def test_engine_without_warmup_resolves_cold_once_per_shape(weights,
                                                            fresh_cache):
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    for p in _prompts(tcfg.vocab)[:2]:
        eng.submit(p, max_new=3)
    eng.run_until_drained()
    first = fresh_cache.stats.cold_builds
    assert first > 0
    for p in _prompts(tcfg.vocab)[:2]:
        eng.submit(p, max_new=3)
    eng.run_until_drained()
    assert fresh_cache.stats.cold_builds == first      # LRU serves repeats


@pytest.mark.parametrize("kw", [dict(prefix_sharing=True),
                                dict(async_depth=2), dict(monitor=True),
                                dict(degrade=True), dict(plan_store="x"),
                                dict(trace=True)])
def test_later_slices_are_refused_by_name(weights, kw):
    _, _, tcfg, tp = weights
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServeEngine(tcfg, tp, device="cpu", **kw)


def test_engine_needs_cuda_unless_cpu_is_asked(weights):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    _, _, tcfg, tp = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, tp)


def test_queue_bound_and_validation_pass_through(weights):
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", max_queue=1, **ENGINE)
    with pytest.raises(ValueError):
        eng.submit(np.arange(60), max_new=4)          # over max_len
    eng.submit(np.arange(4), max_new=2)
    eng.submit(np.arange(4), max_new=2)               # shed: queue full
    done = eng.run_until_drained()
    codes = sorted(r.error.code if r.error else "ok" for r in done)
    assert codes == ["ok", "queue_full"]


def test_launcher_serves_smoke_on_cpu(monkeypatch, capsys, fresh_cache):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama3-8b", "--device", "cpu", "--requests", "3",
        "--max-new", "2", "--warm-kernels"])
    serve.main()
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out
    assert "cold dispatch builds during the run: 0" in out


# ---------------------------------------------------------------------------
# SSM (mamba2) and hybrid (hymba)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mamba2_130m", "hymba_1p5b"])
def ssm_weights(request):
    cfg = jconfigs.get_smoke_config(request.param).scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(13), cfg)
    tcfg = get_smoke_config(request.param).scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def test_ssm_engine_tokens_equal_jax_engine(ssm_weights, fresh_cache):
    """Five requests through three slots: two slots are reused, so a stale
    SSM state would change the later requests' tokens.  The warmed engine
    resolves nothing cold during the run."""
    cfg, jp, tcfg, tp = ssm_weights
    prompts = _prompts(cfg.vocab)
    jeng = JEngine(cfg, jp, **ENGINE)
    jr = [jeng.submit(p, max_new=6) for p in prompts]
    jdone = {r.rid: r.out for r in jeng.run_until_drained()}

    teng = ServeEngine(tcfg, tp, warm_kernels=True, device="cpu", **ENGINE)
    cold = fresh_cache.stats.cold_builds
    tr = [teng.submit(p, max_new=6) for p in prompts]
    tdone = {r.rid: r.out for r in teng.run_until_drained()}
    assert fresh_cache.stats.cold_builds == cold
    assert teng.sched.stats.prefill_chunks > len(prompts)
    assert [tdone[r] for r in tr] == [jdone[r] for r in jr]
    assert all(len(tdone[r]) == 6 for r in tr)


def test_ssm_traced_warm_set_holds_what_the_engine_dispatches(ssm_weights,
                                                              fresh_cache):
    """The trace covers every (family, data) the SSM and hybrid models ask
    for, the f32 decay projection and the SSD scan included (ROADMAP F5)."""
    from repro_torch.plans.trace import trace_warm_set
    _, _, tcfg, tp = ssm_weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    with fresh_cache.record() as rec:
        for p in _prompts(tcfg.vocab):
            eng.submit(p, max_new=4)
        eng.run_until_drained()
    traced = {(op.family, op.data) for op in trace_warm_set(
        tcfg, max_len=ENGINE["max_len"], max_batch=ENGINE["max_batch"],
        prefill_chunk=ENGINE["prefill_chunk"])}
    seen = {(f, items) for f, _, items in rec.requests}
    want = {"matmul_h100", "ssd_scan_h100"} | (
        {"flash_attention_h100"} if tcfg.block == "hybrid" else set())
    assert {f for f, _ in seen} == want
    assert ("matmul_h100", (("K", tcfg.d_model), ("M", ENGINE["max_batch"]),
                            ("N", tcfg.ssm.heads))) in seen
    assert seen <= traced, seen - traced


def test_admission_zeroes_the_slot_state(ssm_weights):
    """A sequence admitted to a slot starts from a zero SSM state: the same
    prompt gives the same tokens in a slot another sequence used before."""
    _, _, tcfg, tp = ssm_weights
    eng = ServeEngine(tcfg, tp, device="cpu", **dict(ENGINE, max_batch=1))
    prompt = _prompts(tcfg.vocab)[0]
    first = eng.submit(prompt, max_new=4)
    eng.submit(_prompts(tcfg.vocab)[1], max_new=4)
    again = eng.submit(prompt, max_new=4)
    out = {r.rid: r.out for r in eng.run_until_drained()}
    assert out[first] == out[again]
