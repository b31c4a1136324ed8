"""The port's llama3 model against the JAX model on the CPU, f32 smoke size.

Weights come from ``repro.models.init_model``, pass through numpy into
``repro_torch.convert.from_jax_params``; tokens are drawn with numpy.  The
port routes projections through K1 and attention through K2 (their plain
versions on the CPU); the JAX model is einsum math (ROADMAP F3).
Tolerance 1e-4: the same f32 math summed in another order.
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
        tl, tc = tm.paged_decode_step(tp, tcfg, last, tc, idx, tables)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        last = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        idx = idx + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_decode_skips_rows_not_decoding(model):
    """A row marked inactive writes the garbage block only and reads
    nothing; the active row's logits do not depend on it."""
    _, _, tcfg, tp = model
    tables = np.array([[1, 2], [0, 0]], np.int32)
    idx = np.array([3, 0], np.int32)
    toks = np.array([[5], [7]], np.int32)
    c1 = tm.init_paged_cache(tcfg, 3, 4, 2, dtype=torch.float32, device="cpu")
    c2 = tm.init_paged_cache(tcfg, 3, 4, 2, dtype=torch.float32, device="cpu")
    l1, c1 = tm.paged_decode_step(tp, tcfg, toks, c1, idx, tables,
                                  active=np.array([True, False]))
    l2, c2 = tm.paged_decode_step(tp, tcfg, toks[:1], c2, idx[:1],
                                  tables[:1])
    np.testing.assert_allclose(l1[:1].numpy(), l2.numpy(), **TOL)
    torch.testing.assert_close(c1["k"][:, 1:], c2["k"][:, 1:])


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
