"""The port's models against the JAX models on the CPU, f32 smoke size:
llama3 (``attn_mlp``), mamba2 (``ssm``) and hymba (``hybrid``).

Weights come from ``repro.models.init_model``, pass through numpy into
``repro_torch.convert.from_jax_params``; tokens are drawn with numpy.  The
port routes projections through K1, attention through K2 and the SSD core
through K3 (their plain versions on the CPU); the JAX model is einsum math
(ROADMAP F3).  Tolerance 1e-4: the same f32 math summed in another order
(the SSD scan also in other chunks: the port takes the tree's chunk, the
JAX layer the config's).
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
from repro_torch.convert import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)


def _decode(params, cfg, toks, cache, idx, tables, active=None):
    """The port's decode step on tensors, as the engine's static buffers
    hand them over (the step itself converts nothing from the host)."""
    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype)
    return tm.paged_decode_step(
        params, cfg, t(toks, torch.int32), cache, t(idx, torch.int32),
        t(tables, torch.int32),
        active=None if active is None else t(active, torch.bool))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_llama3_config_equals_jax_config(which):
    j = (jconfigs.get_config("llama3_8b") if which == "CONFIG"
         else jconfigs.get_smoke_config("llama3_8b"))
    t = (tconfigs.get_config("llama3-8b") if which == "CONFIG"
         else tconfigs.get_smoke_config("llama3-8b"))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.hd == j.hd and t.param_count() == j.param_count()


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jparams, _ = jm.init_model(jax.random.PRNGKey(3), cfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    tcfg = tconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    return cfg, jparams, tcfg, tparams


def test_forward_logits_match(model):
    cfg, jp, tcfg, tp = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 13))
    want, _ = jm.forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = tm.forward(tp, tcfg, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_then_decode_match(model):
    cfg, jp, tcfg, tp = model
    ps, nblk = 4, 4
    jc = jm.init_paged_cache(cfg, 9, ps, 2, dtype=jnp.float32)
    tc = tm.init_paged_cache(tcfg, 9, ps, 2, dtype=torch.float32,
                             device="cpu")
    rng = np.random.default_rng(6)
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    prompts = [rng.integers(0, cfg.vocab, 7), rng.integers(0, cfg.vocab, 9)]
    chunks = [(0, 0, 4), (0, 4, 3), (1, 0, 8), (1, 8, 1)]
    for row, start, n in chunks:
        toks = prompts[row][None, start:start + n].astype(np.int32)
        bt = tables[row][None]
        jl, jc = jm.paged_prefill_chunk(jp, cfg, jnp.asarray(toks), jc,
                                        jnp.int32(start), jnp.asarray(bt),
                                        jnp.int32(row))
        tl, tc = tm.paged_prefill_chunk(tp, tcfg, toks, tc, start, bt, row)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    idx = np.array([7, 9], np.int32)
    last = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.paged_decode_step(jp, cfg, jnp.asarray(last), jc,
                                      jnp.asarray(idx), jnp.asarray(tables))
        tl, tc = _decode(tp, tcfg, last, tc, idx, tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        idx = idx + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1p5b"])
def test_paged_decode_on_device_tensors_matches_jax(arch):
    """The f32 model on a bf16 pool (the engine's default layout), decoding
    from device tensors with a row not decoding (length 0: it writes the
    garbage block, reads nothing and keeps its SSM state) against the JAX
    ``paged_decode_step`` with the same ``ssm_mask``; the decoding rows'
    logits and the pools agree."""
    cfg = jconfigs.get_smoke_config(arch).scaled(dtype="float32")
    jparams, _ = jm.init_model(jax.random.PRNGKey(4), cfg)
    tcfg = tconfigs.get_smoke_config(arch).scaled(dtype="float32")
    tp = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                         device="cpu")
    jc = jm.init_paged_cache(cfg, 9, 4, 3)
    tc = tm.init_paged_cache(tcfg, 9, 4, 3, device="cpu")
    assert tc["k"].dtype == torch.bfloat16
    rng = np.random.default_rng(16)
    tables = np.array([[1, 2, 3], [0, 0, 0], [4, 5, 6]], np.int32)
    for row, n in ((0, 6), (2, 9)):
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        _, jc = jm.paged_prefill_chunk(jparams, cfg, jnp.asarray(toks), jc,
                                       jnp.int32(0),
                                       jnp.asarray(tables[row][None]),
                                       jnp.int32(row))
        tm.paged_prefill_chunk(tp, tcfg, toks, tc, 0, tables[row][None], row)
    idx = np.array([6, 0, 9], np.int32)
    active = np.array([True, False, True])
    last = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.paged_decode_step(jparams, cfg, jnp.asarray(last), jc,
                                      jnp.asarray(idx), jnp.asarray(tables),
                                      ssm_mask=jnp.asarray(active))
        tl, tc = _decode(tp, tcfg, last, tc, idx, tables, active)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], **TOL)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        idx = idx + active
    for k in set(tc) & {"k", "v"}:
        np.testing.assert_allclose(tc[k][:, 1:].float().numpy(),
                                   np.asarray(jc[k][:, 1:], np.float32),
                                   **TOL)
    if "ssm" in tc:
        np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                                   **TOL)


def test_decode_skips_rows_not_decoding(model):
    """A row marked inactive writes the garbage block only and reads
    nothing; the active row's logits do not depend on it."""
    _, _, tcfg, tp = model
    tables = np.array([[1, 2], [0, 0]], np.int32)
    idx = np.array([3, 0], np.int32)
    toks = np.array([[5], [7]], np.int32)
    c1 = tm.init_paged_cache(tcfg, 3, 4, 2, dtype=torch.float32, device="cpu")
    c2 = tm.init_paged_cache(tcfg, 3, 4, 2, dtype=torch.float32, device="cpu")
    l1, c1 = _decode(tp, tcfg, toks, c1, idx, tables,
                     active=np.array([True, False]))
    l2, c2 = _decode(tp, tcfg, toks[:1], c2, idx[:1], tables[:1])
    np.testing.assert_allclose(l1[:1].numpy(), l2.numpy(), **TOL)
    torch.testing.assert_close(c1["k"][:, 1:], c2["k"][:, 1:])


def test_attention_core_takes_kv_heads_unbroadcast(model, monkeypatch):
    """K2 gets the config's KV heads as they are (no ``repeat_interleave``
    to the query heads) on the no-cache path (the rows' K/V read as a pool
    of one block a row) and the paged path (the pools' KV heads), one launch
    of the paged entry a layer on each, and the logits still match the JAX
    model's."""
    from repro_torch.kernels import ops
    cfg, jp, tcfg, tp = model
    seen, paged = [], []
    real, real_paged = ops.flash_attention, ops.paged_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[0], k.shape[0], v.shape[0]))
        return real(q, k, v, **kw)

    def spy_paged(q, k, v, tables, lens, **kw):
        paged.append((q.shape[1], k.shape[2], v.shape[2]))
        return real_paged(q, k, v, tables, lens, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    monkeypatch.setattr(ops, "paged_attention", spy_paged)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 9))
    want, _ = jm.forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = tm.forward(tp, tcfg, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tc = tm.init_paged_cache(tcfg, 5, 4, 2, dtype=torch.float32,
                             device="cpu")
    jc = jm.init_paged_cache(cfg, 5, 4, 2, dtype=jnp.float32)
    bt = np.array([[1, 2, 3, 4]], np.int32)
    jl, _ = jm.paged_prefill_chunk(jp, cfg, jnp.asarray(toks[:1, :6]), jc,
                                   jnp.int32(0), jnp.asarray(bt),
                                   jnp.int32(0))
    tl, _ = tm.paged_prefill_chunk(tp, tcfg, toks[:1, :6], tc, 0, bt, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcfg.kv_heads < tcfg.heads
    assert not seen and set(paged) == {(tcfg.heads, tcfg.kv_heads,
                                        tcfg.kv_heads)}
    assert len(paged) == 2 * tcfg.layers


def test_init_model_seeded_and_bf16():
    cfg = tconfigs.get_smoke_config("llama3_8b")
    a = tm.init_model(cfg, seed=1, device="cpu")
    b = tm.init_model(cfg, seed=1, device="cpu")
    assert a["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert a["layers"][0]["ln1"]["scale"].dtype == torch.float32
    assert len(a["layers"]) == cfg.layers
    torch.testing.assert_close(a["embed"]["out"], b["embed"]["out"])


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    cfg = tconfigs.get_smoke_config("llama3_8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_paged_cache(cfg, 3, 4, 1)


# ---------------------------------------------------------------------------
# SSM (mamba2) and hybrid (hymba)
# ---------------------------------------------------------------------------

SSM_ARCHS = ["mamba2_130m", "hymba_1p5b"]


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_configs_equal_jax_configs(arch, which):
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    j = getattr(jconfigs, get)(arch)
    t = getattr(tconfigs, get)(arch.replace("_", "-").replace("1p5", "1.5"))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_model(request):
    cfg = jconfigs.get_smoke_config(request.param).scaled(dtype="float32")
    jparams, _ = jm.init_model(jax.random.PRNGKey(4), cfg)
    tcfg = tconfigs.get_smoke_config(request.param).scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def test_ssm_forward_logits_match(ssm_model):
    cfg, jp, tcfg, tp = ssm_model
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 37))
    want, _ = jm.forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = tm.forward(tp, tcfg, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_decay_projection_stays_f32():
    """``wa`` is f32 in a bf16 model, from JAX weights and from init."""
    cfg = jconfigs.get_smoke_config("mamba2_130m")
    jparams, _ = jm.init_model(jax.random.PRNGKey(5), cfg)
    tcfg = tconfigs.get_smoke_config("mamba2_130m")
    conv = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")
    init = tm.init_model(tcfg, seed=1, device="cpu")
    for p in (conv, init):
        assert p["layers"][0]["ssm"]["wa"].dtype == torch.float32
        assert p["layers"][0]["ssm"]["wx"].dtype == torch.bfloat16
        assert p["layers"][0]["ssm"]["a_bias"].dtype == torch.float32


def _jax_cache_np(c):
    return {k: np.asarray(v) for k, v in c.items()}


def test_ssm_paged_prefill_then_decode_match(ssm_model):
    """Chunked paged prefill of two sequences into slots 0 and 1, then
    decode steps, against the JAX functions: logits, k/v pool and SSM
    state."""
    cfg, jp, tcfg, tp = ssm_model
    ps = 4
    jc = jm.init_paged_cache(cfg, 9, ps, 2, dtype=jnp.float32)
    tc = tm.init_paged_cache(tcfg, 9, ps, 2, dtype=torch.float32,
                             device="cpu")
    assert set(tc) == set(jc)
    rng = np.random.default_rng(8)
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    prompts = [rng.integers(0, cfg.vocab, 7), rng.integers(0, cfg.vocab, 9)]
    for row, start, n in [(0, 0, 4), (1, 0, 8), (0, 4, 3), (1, 8, 1)]:
        toks = prompts[row][None, start:start + n].astype(np.int32)
        bt = tables[row][None]
        jl, jc = jm.paged_prefill_chunk(jp, cfg, jnp.asarray(toks), jc,
                                        jnp.int32(start), jnp.asarray(bt),
                                        jnp.int32(row))
        tl, tc = tm.paged_prefill_chunk(tp, tcfg, toks, tc, start, bt, row)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k, v in _jax_cache_np(jc).items():
        np.testing.assert_allclose(tc[k].numpy(), v, **TOL)
    idx = np.array([7, 9], np.int32)
    last = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.paged_decode_step(jp, cfg, jnp.asarray(last), jc,
                                      jnp.asarray(idx), jnp.asarray(tables))
        tl, tc = _decode(tp, tcfg, last, tc, idx, tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        idx = idx + 1
    for k, v in _jax_cache_np(jc).items():
        np.testing.assert_allclose(tc[k].numpy(), v, **TOL)


def _port_chunked(tcfg, tp, prompt, chunks, ps=8):
    nblk = -(-len(prompt) // ps)
    cache = tm.init_paged_cache(tcfg, nblk + 1, ps, 1, dtype=torch.float32,
                                device="cpu")
    table = np.arange(1, nblk + 1, dtype=np.int32)[None]
    logits, start = None, 0
    for n in chunks:
        logits, cache = tm.paged_prefill_chunk(
            tp, tcfg, np.asarray(prompt)[None, start:start + n], cache,
            start, table, 0)
        start += n
    return logits[0], cache


def test_ssm_chunked_prefill_equals_whole_prompt(ssm_model):
    """Chunks [8, 4, 1] thread the SSM state exactly: the last logits and
    the state equal one whole-prompt chunk's, and the JAX whole-prompt
    prefill's logits (as ``tests/test_chunked_prefill.py`` holds the JAX
    model)."""
    cfg, jp, tcfg, tp = ssm_model
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 13)
    whole, wc = _port_chunked(tcfg, tp, prompt, [13])
    chunked, cc = _port_chunked(tcfg, tp, prompt, [8, 4, 1])
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(cc["ssm"].numpy(), wc["ssm"].numpy(), **TOL)
    want, _ = jm.prefill(jp, cfg, jnp.asarray(prompt[None], jnp.int32),
                         jm.init_cache(cfg, 1, 32, dtype=jnp.float32))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want[0]), **TOL)


def test_ssm_decode_keeps_state_of_rows_not_decoding(ssm_model):
    """A row marked inactive keeps its SSM state bit for bit (the JAX
    ``ssm_mask``); the active row steps as it would alone."""
    _, _, tcfg, tp = ssm_model
    tables = np.array([[1, 2], [3, 4]], np.int32)
    idx = np.array([3, 5], np.int32)
    toks = np.array([[5], [7]], np.int32)
    c = tm.init_paged_cache(tcfg, 5, 4, 2, dtype=torch.float32, device="cpu")
    c["ssm"].copy_(torch.from_numpy(_np_state(c["ssm"].shape)))
    before = c["ssm"].clone()
    alone = {k: v[:, :1].clone() if k == "ssm" else v.clone()
             for k, v in c.items()}
    l1, c = _decode(tp, tcfg, toks, c, idx, tables,
                    active=np.array([True, False]))
    l2, alone = _decode(tp, tcfg, toks[:1], alone, idx[:1], tables[:1])
    assert torch.equal(c["ssm"][:, 1], before[:, 1])
    assert not torch.equal(c["ssm"][:, 0], before[:, 0])
    np.testing.assert_allclose(c["ssm"][:, :1].numpy(),
                               alone["ssm"].numpy(), **TOL)
    np.testing.assert_allclose(l1[:1].numpy(), l2.numpy(), **TOL)


def _np_state(shape):
    return np.random.default_rng(9).standard_normal(shape).astype(np.float32)


def test_ssm_steps_update_the_cache_in_place(ssm_model, monkeypatch):
    """Each layer of a decode step hands its cache slice ``ssm[i, :B]`` to
    K3 as both the state and the output state, with the decoding rows as a
    bool mask on the state's device, and a prefill chunk hands the whole
    ``ssm[i]`` with no mask and its slot as the one int32 state row, on the
    state's device: no step allocates or scatters an SSM state."""
    from repro_torch.kernels import ops
    _, _, tcfg, tp = ssm_model
    calls = []
    real = ops.ssd_scan

    def spy(x, a, b, c, state0=None, **kw):
        calls.append((state0, kw.get("out_state"), kw.get("mask"),
                      kw.get("state_rows")))
        return real(x, a, b, c, state0, **kw)

    monkeypatch.setattr(ops, "ssd_scan", spy)
    c = tm.init_paged_cache(tcfg, 5, 4, 2, dtype=torch.float32, device="cpu")
    ssm = c["ssm"]
    tables = np.array([[1, 2], [3, 4]], np.int32)
    tm.paged_prefill_chunk(tp, tcfg, np.array([[3, 5, 7]]), c, 0,
                           tables[1:], 1)
    assert len(calls) == tcfg.layers
    for i, (st, out, mask, rows) in enumerate(calls):
        assert out is st and mask is None
        assert st.data_ptr() == ssm[i].data_ptr() and st.shape == ssm[i].shape
        assert rows.dtype == torch.int32 and rows.tolist() == [1]
    calls.clear()
    _decode(tp, tcfg, np.array([[5], [7]]), c, np.array([3, 3], np.int32),
            tables, active=np.array([False, True]))
    assert len(calls) == tcfg.layers
    for i, (st, out, mask, rows) in enumerate(calls):
        assert out is st and st.data_ptr() == ssm[i].data_ptr()
        assert mask.dtype == torch.bool and mask.tolist() == [False, True]
        assert rows is None
    assert c["ssm"] is ssm


# ---------------------------------------------------------------------------
# The four dense configs and the attn_moe block (llama4-scout, kimi-k2)
# ---------------------------------------------------------------------------

NEW_ARCHS = ["granite_3_8b", "yi_6b", "qwen1p5_4b", "chameleon_34b",
             "llama4_scout_17b_a16e", "kimi_k2_1t_a32b"]
MOE_ARCHS = ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"]


def _converted(arch, seed):
    """The f32 smoke model in JAX and converted, with qwen's q/k/v biases
    planted non-zero from a numpy seed in the JAX tree (the JAX init makes
    them zero, which would hide a bias applied wrongly)."""
    cfg = jconfigs.get_smoke_config(arch).scaled(dtype="float32")
    jparams, _ = jm.init_model(jax.random.PRNGKey(seed), cfg)
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = jparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape), jnp.float32)
    tcfg = tconfigs.get_smoke_config(arch).scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_equal_jax_configs(arch, which):
    get = "get_config" if which == "CONFIG" else "get_smoke_config"
    j = getattr(jconfigs, get)(arch)
    t = getattr(tconfigs, get)(j.name if which == "CONFIG" else arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_whisper_is_refused_by_name():
    """What stays refused of whisper: ``init_model`` takes it (encoder
    layers, ``enc_ln_f`` and cross-attention in every decoder layer), but
    ``from_jax_params`` refuses its tree under a config without the
    encoder, naming the leaves it does not expect, and a config with one
    whose tree lacks them."""
    cfg = tconfigs.get_smoke_config("whisper-large-v3").scaled(
        dtype="float32")
    params = tm.init_model(cfg, device="cpu")
    assert len(params["enc_layers"]) == cfg.encoder.layers
    assert "enc_ln_f" in params
    assert all({"lnx", "xattn"} <= set(lp) for lp in params["layers"])
    assert not any("xattn" in lp for lp in params["enc_layers"])
    jcfg = jconfigs.get_smoke_config("whisper_large_v3").scaled(
        dtype="float32")
    jparams, _ = jm.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    bare = dataclasses.replace(cfg, encoder=None)
    with pytest.raises(ValueError, match="enc_layers.*no encoder"):
        from_jax_params(tree, bare, device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        from_jax_params({k: v for k, v in tree.items() if k != "enc_ln_f"},
                        cfg, device="cpu")


@pytest.mark.parametrize("arch,patches", [(a, False) for a in NEW_ARCHS]
                         + [("chameleon_34b", True)])
def test_new_forward_logits_and_aux_match(arch, patches):
    """Logits and the summed MoE aux loss against the JAX ``forward`` on
    the f32 smoke model; chameleon also with early-fused patch embeddings
    over the first 5 positions of the first row."""
    cfg, jp, tcfg, tp = _converted(arch, 21)
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab, (2, 13))
    kw = {}
    if patches:
        kw["patch_embeds"] = rng.standard_normal(
            (1, 5, cfg.d_model)).astype(np.float32)
    want, want_aux = jm.forward(
        jp, cfg, jnp.asarray(toks, jnp.int32),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, aux = tm.forward(tp, tcfg, toks, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == (cfg.block == "attn_moe")
    if patches:
        plain, _ = tm.forward(tp, tcfg, toks)
        assert not np.allclose(plain.numpy()[0, :5], got.numpy()[0, :5])
        np.testing.assert_allclose(plain.numpy()[1], got.numpy()[1], **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["qwen1p5_4b"])
def test_moe_paged_prefill_then_decode_match(arch):
    """Chunks of two prompts (a chunk is one routing group: capacity
    binds inside it), then decode steps over both rows, against the JAX
    paged functions: logits and pools."""
    cfg, jp, tcfg, tp = _converted(arch, 23)
    jc = jm.init_paged_cache(cfg, 9, 4, 2, dtype=jnp.float32)
    tc = tm.init_paged_cache(tcfg, 9, 4, 2, dtype=torch.float32,
                             device="cpu")
    rng = np.random.default_rng(24)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    prompts = [rng.integers(0, cfg.vocab, 9), rng.integers(0, cfg.vocab, 12)]
    for row, start, n in [(0, 0, 8), (0, 8, 1), (1, 0, 8), (1, 8, 4)]:
        toks = prompts[row][None, start:start + n].astype(np.int32)
        bt = tables[row][None]
        jl, jc = jm.paged_prefill_chunk(jp, cfg, jnp.asarray(toks), jc,
                                        jnp.int32(start), jnp.asarray(bt),
                                        jnp.int32(row))
        tl, tc = tm.paged_prefill_chunk(tp, tcfg, toks, tc, start, bt, row)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    idx = np.array([9, 12], np.int32)
    last = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.paged_decode_step(jp, cfg, jnp.asarray(last), jc,
                                      jnp.asarray(idx), jnp.asarray(tables))
        tl, tc = _decode(tp, tcfg, last, tc, idx, tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        idx = idx + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_moe_init_model_shapes_and_scales():
    """``init_model`` gives an attn_moe layer ``ln2`` and the ``moe`` dict in
    the JAX layouts, expert stacks scaled by their own fan-in."""
    cfg = tconfigs.get_smoke_config("kimi_k2_1t_a32b")
    p = tm.init_model(cfg, seed=2, device="cpu")["layers"][0]
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert "mlp" not in p and set(p) == {"ln1", "attn", "ln2", "moe"}
    shapes = {k: tuple(v.shape) for k, v in p["moe"].items()}
    assert shapes == {"router": (d, E), "wi": (E, d, f), "wg": (E, d, f),
                      "wo": (E, f, d)}
    assert p["moe"]["wi"].dtype == torch.bfloat16
    for name, fan_in in (("wi", d), ("wo", f)):
        std = p["moe"][name].float().std().item() * fan_in ** 0.5
        assert 0.9 < std < 1.1, (name, std)
