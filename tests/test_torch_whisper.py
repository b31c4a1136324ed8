"""The port's whisper-large-v3 and non-paged serve steps against the JAX
package on the CPU.

f32 ``SMOKE`` configs (whisper: 2 + 2 layers, d 64, 4 heads, S_enc 32);
weights made by ``repro.models.init_model`` and carried through numpy into
``repro_torch.convert.from_jax_params``; inputs from
``numpy.random.default_rng``.  The port routes every projection through K1,
every attention core through K2's paged entry and every SSD core through K3
(their plain versions on the CPU); the JAX model is einsum math.  Tolerance
``rtol = atol = 1e-4`` (the same f32 math summed in another order), except
where a case says otherwise: a bf16 cache at 2e-2 and the port's
counterparts of ``tests/test_models.py`` at the tolerances of the JAX tests
they follow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.artifacts.dispatch import DispatchCache, set_default_cache
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.plans.trace import trace_steps_warm_set
from repro_torch.runtime import build_serve_steps, warm_steps_dispatch
from test_torch_serving import _refuse_host_reads

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # tests/test_models.py:95-97
WHISPER = "whisper_large_v3"
ARCHS = list(jconfigs.ARCH_IDS)           # all ten, as the JAX tests


def _convert(arch, seed, *, dtype="float32", **replace):
    """(JAX config, JAX params, port config, port params) of the smoke
    config, from one JAX init."""
    cfg = jconfigs.get_smoke_config(arch).scaled(dtype=dtype, **replace)
    tcfg = tconfigs.get_smoke_config(arch).scaled(dtype=dtype, **replace)
    jparams, _ = jm.init_model(jax.random.PRNGKey(seed), cfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _extras(cfg, B, seed):
    """enc_embeds for whisper, patch embeddings for chameleon, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return {"enc_embeds": rng.standard_normal(
            (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "stub":
        return {"patch_embeds": rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)}
    return {}


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def whisper():
    return _convert(WHISPER, 31)


@pytest.fixture(scope="module")
def frames(whisper):
    return _extras(whisper[0], 2, 32)["enc_embeds"]


# ---------------------------------------------------------------------------
# Config and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_whisper_configs_equal_jax_configs(which):
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    j = getattr(jconfigs, get)(WHISPER)
    t = getattr(tconfigs, get)("whisper-large-v3")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert t.encoder.seq_len == (1500 if which == "CONFIG" else 32)


def test_from_jax_params_carries_the_encoder(whisper):
    cfg, jp, tcfg, tp = whisper
    assert len(tp["enc_layers"]) == cfg.encoder.layers == 2
    assert len(tp["layers"]) == cfg.layers
    for i, lp in enumerate(tp["enc_layers"]):
        assert "xattn" not in lp and "lnx" not in lp
        np.testing.assert_array_equal(
            lp["attn"]["wq"].numpy(), _np(jp["enc_layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            lp["mlp"]["wo"].numpy(), _np(jp["enc_layers"]["mlp"]["wo"][i]))
    for i, lp in enumerate(tp["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                lp["xattn"][name].numpy(), _np(jp["layers"]["xattn"][name][i]))
        np.testing.assert_array_equal(lp["lnx"]["scale"].numpy(),
                                      _np(jp["layers"]["lnx"]["scale"][i]))
    np.testing.assert_array_equal(tp["enc_ln_f"]["scale"].numpy(),
                                  _np(jp["enc_ln_f"]["scale"]))


def test_from_jax_params_refuses_a_short_encoder_stack(whisper):
    cfg, jp, tcfg, _ = whisper
    tree = jax.tree.map(np.asarray, jp)
    deeper = dataclasses.replace(
        tcfg, encoder=dataclasses.replace(tcfg.encoder, layers=3))
    with pytest.raises(ValueError, match="enc_layers stacked over"):
        from_jax_params(tree, deeper, device="cpu")


# ---------------------------------------------------------------------------
# Encoder, cross-attention, forward
# ---------------------------------------------------------------------------

def test_encode_matches_jax(whisper, frames):
    cfg, jp, tcfg, tp = whisper
    want = jm.encode(jp, cfg, jnp.asarray(frames))
    got = tm.encode(tp, tcfg, frames)
    assert got.shape == (2, cfg.encoder.seq_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_encode_is_one_attention_launch_a_layer(whisper, frames,
                                                monkeypatch):
    """Every encoder layer's non-causal attention is one launch of K2's
    paged entry over all rows: a pool of one block of S_enc keys a row."""
    _, _, tcfg, tp = whisper
    calls = []
    real = ops.paged_attention

    def spy(q, k, v, tables, lens, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"],
                      lens.tolist(), tables.tolist()))
        return real(q, k, v, tables, lens, **kw)

    monkeypatch.setattr(ops, "paged_attention", spy)
    tm.encode(tp, tcfg, frames)
    S = tcfg.encoder.seq_len
    assert calls == [((2, tcfg.heads, S, tcfg.hd),
                      (2, S, tcfg.kv_heads, tcfg.hd), False, [S, S],
                      [[0], [1]])] * tcfg.encoder.layers


@pytest.mark.parametrize("S", [13, 40])
def test_forward_with_enc_embeds_matches_jax(whisper, frames, S,
                                             monkeypatch):
    """Logits of the decoder over the encoder output; a prompt of 40
    tokens is longer than S_enc = 32, so each cross-attention runs its
    queries in two launches (32 and 8)."""
    cfg, jp, tcfg, tp = whisper
    toks = np.random.default_rng(33).integers(0, cfg.vocab, (2, S))
    sq = []
    real = ops.paged_attention

    def spy(q, k, v, tables, lens, **kw):
        sq.append(q.shape[2])
        return real(q, k, v, tables, lens, **kw)

    monkeypatch.setattr(ops, "paged_attention", spy)
    want, _ = jm.forward(jp, cfg, jnp.asarray(toks, jnp.int32),
                         enc_embeds=jnp.asarray(frames))
    got, aux = tm.forward(tp, tcfg, toks, enc_embeds=frames)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert float(aux) == 0.0
    runs = [32, 8] if S > 32 else [S]
    assert sq == [32] * 2 + ([S] + runs) * 2


def test_forward_without_enc_embeds_raises(whisper):
    _, _, tcfg, tp = whisper
    with pytest.raises(ValueError, match="enc_embeds"):
        tm.forward(tp, tcfg, np.zeros((1, 4), np.int64))


# ---------------------------------------------------------------------------
# The non-paged steps: prefill, decode, against JAX
# ---------------------------------------------------------------------------

def _cache_leaves_close(tc, jc, tol):
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert tc[name].dtype == getattr(torch, str(jc[name].dtype)), name
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   _np(jc[name]), err_msg=name, **tol)


def _steps_against_jax(arch, seed, *, S, max_len, dtype, tol, steps=3,
                       B=2, **replace):
    """Prefill B prompts of S tokens, then ``steps`` greedy decode steps at
    a scalar index, on the port and on JAX from the same weights: the last
    logits and every cache leaf after prefill, the logits of every step."""
    cfg, jp, tcfg, tp = _convert(arch, seed, **replace)
    kw = _extras(cfg, B, seed + 1)
    toks = np.random.default_rng(seed + 2).integers(0, cfg.vocab, (B, S))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jc = jm.init_cache(cfg, B, max_len, dtype=jdt)
    tc = tm.init_cache(tcfg, B, max_len, dtype=dtype, device="cpu")
    jl, jc = jm.prefill(jp, cfg, jnp.asarray(toks, jnp.int32), jc,
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tc2 = tm.prefill(tp, tcfg, toks, tc, **kw)
    assert tc2 is tc                                    # written in place
    np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
    _cache_leaves_close(tc, jc, tol)
    for i in range(steps):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jm.decode_step(jp, cfg, jnp.asarray(nxt), jc,
                                jnp.asarray(S + i, jnp.int32))
        tl, _ = tm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                               torch.tensor(S + i))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
    _cache_leaves_close(tc, jc, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["f32_cache", "bf16_cache"])
def test_whisper_prefill_and_decode_match_jax(dtype, tol):
    """Prefill (with the cross cache ck/cv) and three greedy decode steps;
    with the default bf16 cache at JAX's own 2e-2."""
    _steps_against_jax(WHISPER, 41, S=12, max_len=24, dtype=dtype, tol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_jax(arch):
    """Every arch's non-paged prefill and decode steps against JAX's, f32
    model and cache; MoE dropless, as the JAX prefill/forward test makes
    it (capacity depends on which tokens share a routing group).  hymba's
    20-token prompt fits its window of 32 (a ring of 32 slots)."""
    replace = {}
    cfg = jconfigs.get_smoke_config(arch)
    if cfg.moe is not None:
        replace["moe"] = dataclasses.replace(cfg.moe, capacity_factor=64.0)
    _steps_against_jax(arch, 43, S=20, max_len=40, dtype=torch.float32,
                       tol=TOL, **replace)


def test_ring_prefill_longer_than_window_matches_jax():
    """hymba's ring: a 40-token prompt over a window of 32 keeps its last
    32 tokens (slot t % 32), then six decode steps wrap the ring; the port
    reads the first min(idx + 1, W) slots unmasked, JAX masks by the slots'
    positions: the same softmax, leaves and logits within 1e-4."""
    _steps_against_jax("hymba_1p5b", 45, S=40, max_len=46,
                       dtype=torch.float32, tol=TOL, steps=6, B=1)


def test_full_length_cache_with_window_matches_jax():
    """A cache longer than the window (made by hand: ``init_cache`` makes a
    ring): decode reads the last ``window`` positions, the windowed read at
    length idx + 1."""
    cfg, jp, tcfg, tp = _convert("hymba_1p5b", 47)
    B, S, L_ = 2, 30, 48
    toks = np.random.default_rng(48).integers(0, cfg.vocab, (B, S))
    jc = jm.init_cache(cfg, B, L_, dtype=jnp.float32)
    tc = tm.init_cache(tcfg, B, L_, dtype=torch.float32, device="cpu")
    shape = (cfg.layers, B, L_, cfg.kv_heads, cfg.hd)
    jc = {**jc, "k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {**tc, "k": torch.zeros(shape), "v": torch.zeros(shape)}
    jl, jc = jm.prefill(jp, cfg, jnp.asarray(toks, jnp.int32), jc)
    tl, tc = tm.prefill(tp, tcfg, toks, tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for i in range(5):                      # positions 30..34 cross 32
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jm.decode_step(jp, cfg, jnp.asarray(nxt), jc,
                                jnp.asarray(S + i, jnp.int32))
        tl, tc = tm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    _cache_leaves_close(tc, jc, TOL)


@pytest.mark.parametrize("arch", ["yi_6b", "hymba_1p5b", WHISPER])
def test_ragged_vector_cache_index_matches_jax(arch):
    """Continuous batching: every row decodes at its own offset (a (B,)
    cache index), against JAX's vector-index decode from the same cache."""
    cfg, jp, tcfg, tp = _convert(arch, 49)
    B, S = 3, 10
    kw = _extras(cfg, B, 50)
    toks = np.random.default_rng(51).integers(0, cfg.vocab, (B, S))
    jc = jm.init_cache(cfg, B, 24, dtype=jnp.float32)
    tc = tm.init_cache(tcfg, B, 24, dtype=torch.float32, device="cpu")
    _, jc = jm.prefill(jp, cfg, jnp.asarray(toks, jnp.int32), jc,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tm.prefill(tp, tcfg, toks, tc, **kw)
    idx = np.array([10, 4, 7], np.int32)           # rows at their own offsets
    nxt = np.array([[3], [5], [7]], np.int32)
    for _ in range(2):
        jl, jc = jm.decode_step(jp, cfg, jnp.asarray(nxt), jc,
                                jnp.asarray(idx))
        tl, tc = tm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                torch.from_numpy(idx))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        idx = idx + 1
    _cache_leaves_close(tc, jc, TOL)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_models.py on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Greedy continuation via (prefill -> decode_step) equals the full
    forward over the extended sequence, bf16 smoke config and cache, at the
    JAX test's 2e-2; MoE dropless as there."""
    replace = {}
    cfg0 = jconfigs.get_smoke_config(arch)
    if cfg0.moe is not None:
        replace["moe"] = dataclasses.replace(cfg0.moe, capacity_factor=64.0)
    cfg, _, tcfg, tp = _convert(arch, 1, dtype=cfg0.dtype, **replace)
    B, S = 2, 24
    kw = _extras(cfg, B, 0)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    cache = tm.init_cache(tcfg, B, S + 4, device="cpu")
    last, cache = tm.prefill(tp, tcfg, toks, cache, **kw)
    nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
    ext = np.concatenate([toks, nxt.numpy()], axis=1)
    ref, _ = tm.forward(tp, tcfg, ext, **kw)
    dec, _ = tm.decode_step(tp, tcfg, nxt, cache, torch.tensor(S))
    np.testing.assert_allclose(dec.float().numpy(), ref[:, -1].float().numpy(),
                               **BF16_TOL)


def test_ring_cache_equals_full_cache_decode():
    """hymba's ring cache (window 32, a 40-token prompt) gives the full
    forward's logits at each of six decode steps, at the JAX test's 3e-2."""
    cfg, _, tcfg, tp = _convert("hymba_1p5b", 5, dtype="bfloat16")
    B, S, extra = 1, 40, 6
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, S))
    ring = tm.init_cache(tcfg, B, S + extra, device="cpu")
    assert ring["k"].shape[2] == cfg.window
    last, ring = tm.prefill(tp, tcfg, toks, ring)
    cur = toks
    for i in range(extra):
        nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
        cur = np.concatenate([cur, nxt.numpy()], axis=1)
        full, _ = tm.forward(tp, tcfg, cur)
        last, ring = tm.decode_step(tp, tcfg, nxt, ring, torch.tensor(S + i))
        np.testing.assert_allclose(last.float().numpy(),
                                   full[:, -1].float().numpy(),
                                   rtol=3e-2, atol=3e-2)


def test_vector_cache_index_matches_scalar():
    """Continuous-batching (vector index) decode equals scalar-index decode
    (yi, bf16 smoke, at the JAX test's 1e-4)."""
    cfg, _, tcfg, tp = _convert("yi_6b", 7, dtype="bfloat16")
    B, S = 3, 16
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (B, S))
    c1 = tm.init_cache(tcfg, B, 32, device="cpu")
    c2 = tm.init_cache(tcfg, B, 32, device="cpu")
    last, c1 = tm.prefill(tp, tcfg, toks, c1)
    tm.prefill(tp, tcfg, toks, c2)
    nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
    lg_s, _ = tm.decode_step(tp, tcfg, nxt, c1, torch.tensor(S))
    lg_v, _ = tm.decode_step(tp, tcfg, nxt, c2, torch.full((B,), S))
    np.testing.assert_allclose(lg_v.float().numpy(), lg_s.float().numpy(),
                               **TOL)


# ---------------------------------------------------------------------------
# build_serve_steps, the warm set, host syncs
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_cache():
    cache = DispatchCache()
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


@pytest.mark.parametrize("S", [16, 40])
def test_whisper_warm_set_leaves_no_cold_build(whisper, frames, fresh_cache,
                                               S):
    """After ``warm_steps_dispatch`` at (batch, prompt length, max_len) a
    prefill and three decode steps through ``build_serve_steps`` resolve
    nothing cold, and every triple they ask for is in the traced set (F5):
    the encoder at M = B·S_enc, the cross K/V at B·S_enc rows, the cross
    core at each query run of at most S_enc (40 = 32 + 8)."""
    cfg, _, tcfg, tp = whisper
    B = frames.shape[0]
    picks = warm_steps_dispatch(tcfg, batch=B, prompt_len=S, max_len=48)
    assert {p["rank_source"] for p in picks.values()} == {"cold"}
    cold = fresh_cache.stats.cold_builds
    prefill_step, decode_one = build_serve_steps(tcfg)
    toks = np.random.default_rng(52).integers(0, cfg.vocab, (B, S))
    cache = tm.init_cache(tcfg, B, 48, dtype=torch.float32, device="cpu")
    with fresh_cache.record() as rec:
        last, cache = prefill_step(tp, toks, cache, enc_embeds=frames)
        for i in range(3):
            nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
            last, cache = decode_one(tp, nxt, cache, torch.tensor(S + i))
    assert fresh_cache.stats.cold_builds == cold
    traced = {(op.family, op.data) for op in trace_steps_warm_set(
        tcfg, batch=B, prompt_len=S, max_len=48)}
    seen = {(f, items) for f, _, items in rec.requests}
    assert seen == traced
    S_enc = tcfg.encoder.seq_len
    assert ("matmul_h100", (("K", 64), ("M", B * S_enc), ("N", 64))) in seen
    cores = {dict(d)["SQ"] for f, d in seen if f == "flash_attention_h100"}
    assert cores == {S_enc, S, 1} | ({S_enc, S - S_enc} if S > S_enc
                                     else set())


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_130m", "hymba_1p5b",
                                  "kimi_k2_1t_a32b"])
def test_steps_warm_set_holds_what_the_steps_dispatch(arch, fresh_cache):
    """F5 for the other blocks: the traced set of the non-paged steps is
    exactly what prefill and decode ask the dispatch cache for."""
    _, _, tcfg, tp = _convert(arch, 53)
    B, S = 2, 12
    toks = np.random.default_rng(54).integers(0, tcfg.vocab, (B, S))
    cache = tm.init_cache(tcfg, B, 20, dtype=torch.float32, device="cpu")
    with fresh_cache.record() as rec:
        last, cache = tm.prefill(tp, tcfg, toks, cache)
        nxt = torch.argmax(last, -1).to(torch.int32)[:, None]
        tm.decode_step(tp, tcfg, nxt, cache, torch.tensor(S))
    traced = {(op.family, op.data) for op in trace_steps_warm_set(
        tcfg, batch=B, prompt_len=S, max_len=20)}
    assert {(f, items) for f, _, items in rec.requests} == traced


def test_trace_steps_refuses_a_prompt_past_max_len(whisper):
    with pytest.raises(ValueError, match="prompt length"):
        trace_steps_warm_set(whisper[2], batch=1, prompt_len=49, max_len=48)


def test_decode_step_makes_no_host_sync_or_upload(whisper, frames,
                                                  monkeypatch):
    """Given device tensors, whisper's decode step (self-attention over the
    cache, cross-attention over ck/cv) reads nothing on the host and makes
    no tensor from host data, at a scalar and at a vector index."""
    cfg, _, tcfg, tp = whisper
    B = frames.shape[0]
    toks = np.random.default_rng(55).integers(0, cfg.vocab, (B, 8))
    cache = tm.init_cache(tcfg, B, 16, device="cpu")
    tm.prefill(tp, tcfg, toks, cache, enc_embeds=frames)
    nxt = torch.ones((B, 1), dtype=torch.int32)
    scalar, vector = torch.tensor(8), torch.tensor([8, 9], dtype=torch.int32)
    _refuse_host_reads(monkeypatch)
    a, _ = tm.decode_step(tp, tcfg, nxt, cache, scalar)
    b, _ = tm.decode_step(tp, tcfg, nxt, cache, vector)
    monkeypatch.undo()
    assert a.shape == b.shape == (B, cfg.vocab)


def test_plan_artifacts_leave_whisper_out(capsys):
    """Serve plans are the engine's: the default config list leaves the
    encoder-decoder out, and naming it is refused."""
    from repro_torch.launch import plan_artifacts
    assert plan_artifacts.main(["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "llama3-8b" in out and "whisper" not in out
    with pytest.raises(SystemExit):
        plan_artifacts.main(["--config", WHISPER, "--dry-run"])
    assert "encoder-decoder" in capsys.readouterr().err
