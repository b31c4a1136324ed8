"""The port's mixture-of-experts layer (``repro_torch.models.moe``) and K1's
batched entry against the JAX package on the CPU.

The same f32 inputs and weights, made from a numpy seed, go through the
JAX ``moe_block`` and the port's: top-1 (llama4-scout's smoke shape) and
top-2 (kimi-k2's), a group where capacity binds (the same assignments
dropped), T not a multiple of the group (zero padding tokens that route),
and a planted routing tie (two experts with the same router column: the
lower index wins, as ``jax.lax.top_k`` has it).  Tolerance 1e-4: the same
f32 math summed in another order (K1's plain version sums k tiles in
order; the JAX layer is einsum).

The layer's backward (the router through ``MatmulFn``, the experts through
``BatchedMatmulFn``: K1's batched entry over K4's batched transposes, in
their plain versions here) against ``jax.vjp`` of the JAX layer, where
capacity binds too; K4's batched entry and the MoE training warm set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.moe as jmoe
import repro_torch.configs as tconfigs
import repro_torch.models.moe as tmoe
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import BatchedMatmulFn
from repro_torch.kernels.matmul import (matmul_batched_plain,
                                        matmul_h100_batched, matmul_plain)
from repro_torch.kernels.matmul_experts import (
    format_error as k1b_format_error, matmul_experts_plain)
from repro_torch.kernels.transpose import (format_error as tr_format_error,
                                           transpose_batched_plain,
                                           transpose_h100_batched,
                                           transpose_plain)

TOL = dict(rtol=1e-4, atol=1e-4)


def _layer(arch, seed, *, tie=None):
    """(JAX config, port config, JAX params, port params) of one MoE layer
    of the f32 smoke config; ``tie`` = (i, j) copies router column i into
    column j."""
    cfg = jconfigs.get_smoke_config(arch).scaled(dtype="float32")
    tcfg = tconfigs.get_smoke_config(arch).scaled(dtype="float32")
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "wi": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if tie is not None:
        p["router"][:, tie[1]] = p["router"][:, tie[0]]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    return cfg, tcfg, jp, tp


def _both(arch, x, seed=0, **kw):
    cfg, tcfg, jp, tp = _layer(arch, seed, tie=kw.pop("tie", None))
    want, want_aux = jmoe.moe_block(jp, jnp.asarray(x), cfg, **kw)
    got, aux = tmoe.moe_block(tp, torch.from_numpy(x), tcfg, **kw)
    return (got.numpy(), float(aux)), (np.asarray(want), float(want_aux)), tp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assignments(tp, x, tcfg, gsz):
    """Per group, how many (token, choice) pairs chose each expert."""
    logits = x.reshape(-1, x.shape[-1]) @ tp["router"].numpy()
    probs = torch.softmax(torch.from_numpy(logits), -1)
    _, idx = tmoe.top_k(probs, tcfg.moe.top_k)
    idx = idx.numpy().reshape(-1, gsz, tcfg.moe.top_k)
    return np.stack([np.bincount(g.ravel(), minlength=tcfg.moe.num_experts)
                     for g in idx])


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"],
                         ids=["top1", "top2"])
def test_moe_block_matches_jax(arch):
    (y, aux), (want, want_aux), _ = _both(arch, _x((2, 7, 64), 1))
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(aux, want_aux, **TOL)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"],
                         ids=["top1", "top2"])
def test_moe_capacity_binds_and_drops_the_same_tokens(arch):
    """32 tokens in one group: capacity(32, E, k, 1.25) is below the
    busiest expert's assignments, so later tokens are dropped; a dropped
    token's output is exactly 0 on both sides."""
    x = _x((1, 32, 64), 2)
    (y, aux), (want, want_aux), tp = _both(arch, x, seed=3)
    tcfg = tconfigs.get_smoke_config(arch)
    m = tcfg.moe
    cap = tmoe.capacity(32, m.num_experts, m.top_k, m.capacity_factor)
    assert _assignments(tp, x, tcfg, 32).max() > cap      # capacity binds
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(aux, want_aux, **TOL)
    if m.top_k == 1:
        dropped = np.abs(want[0]).max(-1) == 0
        assert dropped.any()
        assert np.array_equal(np.abs(y[0]).max(-1) == 0, dropped)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"],
                         ids=["top1", "top2"])
def test_moe_tokens_not_a_multiple_of_the_group(arch):
    """T = 13 in groups of 8: the second group is padded with 3 zero
    tokens, which route (every expert ties at probability 1/E) and count in
    the aux loss but are cut from the output."""
    (y, aux), (want, want_aux), _ = _both(arch, _x((1, 13, 64), 4),
                                          group_size=8)
    assert y.shape == (1, 13, 64)
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(aux, want_aux, **TOL)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"],
                         ids=["top1", "top2"])
def test_moe_routing_tie_takes_the_lower_index(arch):
    """Experts 1 and 3 share a router column, so they tie on every token;
    where they are among the top k the lower index comes first, as in
    ``jax.lax.top_k``, and the outputs agree."""
    x = _x((2, 9, 64), 5)
    (y, aux), (want, want_aux), tp = _both(arch, x, seed=6, tie=(1, 3))
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(aux, want_aux, **TOL)
    k = tconfigs.get_smoke_config(arch).moe.top_k
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, 64))
                          @ tp["router"], -1)
    _, idx = tmoe.top_k(probs, k)
    assert np.array_equal(idx.numpy(), jax_top_k(probs.numpy(), k)[1])
    chose = (idx == 1).any(-1)
    assert chose.any()                                # the tie is live
    if k == 1:
        assert not (idx == 3).any()


def jax_top_k(a, k):
    vals, idx = jax.lax.top_k(jnp.asarray(a), k)
    return np.asarray(vals), np.asarray(idx)


def test_top_k_breaks_ties_by_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    _, idx = tmoe.top_k(probs, 2)
    _, jidx = jax_top_k(probs.numpy(), 2)
    assert idx.tolist() == [[0, 1], [1, 3], [0, 2]] == jidx.tolist()


def test_capacity_and_group_size_equal_the_jax_layer():
    assert tmoe.MOE_GROUP_SIZE == jmoe.MOE_GROUP_SIZE
    for args in [(1, 16, 1, 1.25), (32, 16, 1, 1.25), (4, 384, 8, 1.25),
                 (1024, 384, 8, 1.25), (37, 8, 2, 1.0)]:
        assert tmoe.capacity(*args) == jmoe.capacity(*args)


# ---------------------------------------------------------------------------
# K1's batched entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,N,K,kb", [(4, 4, 96, 64, 1), (3, 5, 40, 200, 4),
                                        (8, 16, 64, 96, 2)])
def test_batched_plain_is_matmul_plain_per_expert(dtype, E, M, N, K, kb):
    g = torch.Generator().manual_seed(E * M + K)
    a = torch.randn((E, M, K), generator=g).to(dtype)
    b = torch.randn((E, K, N), generator=g).to(dtype)
    kw = dict(bm=16, bn=32, bk=32, s=1, kb=kb, stages=2)
    got = matmul_batched_plain(a, b, **kw)
    assert got.dtype == torch.float32 and got.shape == (E, M, N)
    for e in range(E):
        assert torch.equal(got[e], matmul_plain(a[e], b[e], **kw))
    n0 = matmul_h100_batched.launches
    assert torch.equal(matmul_h100_batched(a, b, **kw), got)
    assert matmul_h100_batched.launches == n0     # the CPU launches nothing


def test_ops_matmul_batched_takes_the_per_expert_pick():
    """In f32 ``ops.matmul_batched`` resolves the per-expert key {M, N, K}
    through the frozen lane ``ops.matmul`` uses, and its result is the
    per-expert ``ops.matmul``, f32; in bf16 it resolves K1b's key {E, M,
    N, K} (``matmul_experts_h100``) and returns K1b's plain version, bf16:
    the branch is on the operands' type."""
    from repro_torch.artifacts.dispatch import (DispatchCache,
                                                set_default_cache)
    g = torch.Generator().manual_seed(9)
    a = torch.randn((6, 4, 128), generator=g)
    b = torch.randn((6, 128, 48), generator=g)
    cache = DispatchCache()
    set_default_cache(cache)
    try:
        with cache.record() as rec:
            got = ops.matmul_batched(a, b)
            want = torch.stack([ops.matmul(a[e], b[e]) for e in range(6)])
        with cache.record() as rec16:
            got16 = ops.matmul_batched(a.bfloat16(), b.bfloat16())
    finally:
        set_default_cache(None)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, a @ b, **TOL)
    assert {items for _, _, items in rec.requests} == {
        (("K", 128), ("M", 4), ("N", 48))}
    assert {(f, items) for f, _, items in rec16.requests} == {
        ("matmul_experts_h100", (("E", 6), ("K", 128), ("M", 4), ("N", 48)))}
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, matmul_experts_plain(a.bfloat16(),
                                                   b.bfloat16()))


def test_batched_format_error_counts_experts_times_splits():
    from repro_torch.kernels.matmul import format_error, workspace_need
    args = (4, 2048, 7168, 16, 128, 64, 1, 16, 4, True, torch.bfloat16)
    assert format_error(*args) is None
    assert format_error(*args, experts=384) is None       # 6144 z blocks
    assert "experts" in format_error(*args, experts=4096)
    one = workspace_need(4, 2048, bm=16, bn=128, kb=16)
    assert workspace_need(4, 2048, bm=16, bn=128, kb=16, experts=384) == (
        384 * one[0], 384 * one[1])


def _padded_config(mc):
    """A one-layer ``moe_a2a`` config with E = 300 >= 256 (stored padded
    to 512) at a tiny width, from the config module ``mc`` of either
    package."""
    return mc.ModelConfig(
        name="a2a-padded", layers=1, d_model=16, heads=4, kv_heads=2,
        d_ff=16, vocab=64, block="attn_moe", dtype="float32",
        moe=mc.MoEConfig(num_experts=300, top_k=2, d_ff_expert=16,
                         capacity_factor=2.0),
        perf_flags=("moe_a2a",))


def test_a2a_flag_and_padded_storage_are_accepted():
    """The flag passes ``check_block``; both packages' inits store 512
    experts for E = 300 under it (``a2a_padded_experts``), and E where the
    flag is off or E < 256."""
    import repro.models.config as jmc
    import repro_torch.models.config as tmc
    from repro_torch.models.transformer import check_block, init_train_state
    tcfg, jcfg = _padded_config(tmc), _padded_config(jmc)
    check_block(tcfg)
    assert tmoe.a2a_padded_experts(tcfg) == jmoe.a2a_padded_experts(jcfg) \
        == 512
    assert tmoe.a2a_padded_experts(tcfg.scaled(perf_flags=())) == 300
    kimi = tconfigs.get_smoke_config("kimi_k2_1t_a32b")
    assert tmoe.a2a_padded_experts(kimi.scaled(perf_flags=("moe_a2a",))) \
        == kimi.moe.num_experts                     # E = 8 < 256
    state = init_train_state(tcfg, device="meta")
    assert tuple(state["layers"]["moe"]["wi"].shape) == (1, 512, 16, 16)
    assert tuple(state["layers"]["moe"]["router"].shape) == (1, 16, 300)


def test_convert_and_dense_moe_on_padded_storage_match_jax():
    """A JAX tree with 512 stored experts (``init_model`` under the flag)
    converts as it is; the dense ``moe_block`` and the whole forward run
    the first E of them, as the JAX layer slices them, and agree with
    JAX."""
    import repro.models.config as jmc
    import repro.models as jmodels
    import repro_torch.models.config as tmc
    from repro_torch.models.transformer import forward
    jcfg, tcfg = _padded_config(jmc), _padded_config(tmc)
    jp, _ = jmodels.init_model(jax.random.PRNGKey(0), jcfg)
    assert jp["layers"]["moe"]["wi"].shape == (1, 512, 16, 16)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert tuple(tp["layers"][0]["moe"]["wi"].shape) == (512, 16, 16)
    x = _x((2, 8, 16), 5)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    want, want_aux = jmoe.moe_block(jlayer, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_block(tp["layers"][0]["moe"], torch.from_numpy(x),
                              tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    tokens = np.random.default_rng(6).integers(0, 64, (2, 8)).astype(
        np.int32)
    jl, jaux = jmodels.forward(jp, jcfg, jnp.asarray(tokens))
    tl, taux = forward(tp, tcfg, tokens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_a_stored_expert_count_neither_e_nor_padded_is_refused():
    cfg = tconfigs.get_smoke_config("kimi_k2_1t_a32b")
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    L = cfg.layers
    z = np.zeros
    tree = {"embed": {"tok": z((cfg.vocab, d)), "out": z((d, cfg.vocab))},
            "ln_f": {"scale": z(d)},
            "layers": {"moe": {"router": z((L, d, E)),
                               "wi": z((L, E + 8, d, f)),
                               "wg": z((L, E + 8, d, f)),
                               "wo": z((L, E + 8, f, d))}}}
    for flags in ((), ("moe_a2a",)):
        with pytest.raises(ValueError, match="stored experts"):
            from_jax_params(tree, cfg.scaled(perf_flags=flags), device="cpu")


# ---------------------------------------------------------------------------
# The layer's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"],
                         ids=["top1", "top2"])
@pytest.mark.parametrize("shape,seed", [((2, 7, 64), 1), ((1, 32, 64), 2)],
                         ids=["fits", "capacity_binds"])
def test_moe_block_gradients_match_jax(arch, shape, seed):
    """d(x) and every weight's gradient of sum(y·w) + aux, the port's
    autograd against ``jax.grad`` of the JAX layer, also where capacity
    binds and tokens are dropped (they reach the loss through the router
    alone)."""
    cfg, tcfg, jp, tp = _layer(arch, seed + 1)
    x = _x(shape, seed)
    w = _x(shape, seed + 10)

    def jloss(p, xx):
        y, aux = jmoe.moe_block(p, xx, cfg)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    for v in tp.values():
        v.requires_grad_()
    y, aux = tmoe.moe_block(tp, tx, tcfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jg_x)).max())
    for k, v in tp.items():
        j = np.asarray(jg_p[k])
        np.testing.assert_allclose(v.grad.numpy(), j, rtol=1e-4,
                                   atol=1e-5 * np.abs(j).max(), err_msg=k)
    assert np.abs(tp["wi"].grad.numpy()).max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,N,K", [(4, 4, 96, 64), (3, 5, 40, 200),
                                     (8, 16, 64, 96)])
def test_batched_matmul_fn_gradients(dtype, E, M, N, K):
    """``BatchedMatmulFn``'s dA and dB against autograd of the plain
    version of the route ``ops.matmul_batched`` takes over the same
    operands: in f32 K1's batched entry (``matmul_batched_plain``, f32
    out), in bf16 K1b (``matmul_experts_plain``, bf16 out, its backward
    reading the stored operands transposed); the gradients in the
    operands' type, as the output is."""
    g = torch.Generator().manual_seed(E * M + K)
    a = torch.randn((E, M, K), generator=g).to(dtype)
    b = (torch.randn((E, K, N), generator=g) / K ** 0.5).to(dtype)
    dc = torch.randn((E, M, N), generator=g).to(dtype)
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    c = BatchedMatmulFn.apply(ta, tb)
    assert c.dtype == dtype
    c.backward(dc)
    pa, pb = a.clone().requires_grad_(), b.clone().requires_grad_()
    if dtype == torch.float32:
        want = matmul_batched_plain(pa, pb, bm=16, bn=32, bk=32, s=1, kb=1,
                                    stages=2)
    else:
        want = matmul_experts_plain(pa, pb)
    assert torch.equal(c.detach(), ops.matmul_batched(a, b))
    want.backward(dc)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    for got, exp in ((ta.grad, pa.grad), (tb.grad, pb.grad)):
        assert got.dtype == dtype and got.shape == exp.shape
        torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,N", [(4, 80, 64), (3, 5, 7), (16, 33, 1)])
def test_transpose_batched_plain_is_k4_plain_per_expert(dtype, E, M, N):
    g = torch.Generator().manual_seed(E + M + N)
    a = torch.randn((E, M, N), generator=g).to(dtype)
    kw = dict(bm=16, bn=32, s=8, cached=True)
    got = transpose_batched_plain(a, **kw)
    assert got.shape == (E, N, M) and got.dtype == dtype
    for e in range(E):
        assert torch.equal(got[e], transpose_plain(a[e], **kw))
    n0 = transpose_h100_batched.launches
    assert torch.equal(transpose_h100_batched(a, **kw), got)
    assert transpose_h100_batched.launches == n0   # the CPU launches nothing


def test_transpose_batched_format_error_counts_experts():
    assert tr_format_error(5120, 8192, 16, 32, 8, 2) is None
    assert tr_format_error(7168, 2048, 16, 32, 8, 2, experts=384) is None
    assert tr_format_error(3, 5, 16, 32, 8, 2, experts=65_535) is None
    assert "experts" in tr_format_error(3, 5, 16, 32, 8, 2, experts=65_536)
    assert "experts" in tr_format_error(3, 5, 16, 32, 8, 2, experts=0)
    assert "threads" in tr_format_error(3, 5, 64, 32, 8, 2)
    assert "bn below 32" in tr_format_error(3, 5, 16, 16, 8, 2)
    assert "2- or 4-byte" in tr_format_error(3, 5, 16, 32, 8, 8)
    assert "empty" in tr_format_error(0, 5, 16, 32, 8, 2)


def test_ops_transpose_batched_takes_the_per_expert_pick():
    """``ops.transpose_batched`` resolves the per-expert key {M, N}
    through the frozen lane ``ops.transpose`` uses, bit for bit the
    per-expert ``ops.transpose``."""
    from repro_torch.artifacts.dispatch import (DispatchCache,
                                                set_default_cache)
    a = torch.randn((6, 80, 48), generator=torch.Generator().manual_seed(4))
    cache = DispatchCache()
    set_default_cache(cache)
    try:
        with cache.record() as rec:
            got = ops.transpose_batched(a)
            want = torch.stack([ops.transpose(a[e]) for e in range(6)])
    finally:
        set_default_cache(None)
    assert torch.equal(got, want) and torch.equal(got, a.transpose(1, 2))
    assert {(f, items) for f, _, items in rec.requests} == {
        ("transpose_h100", (("M", 80), ("N", 48)))}


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_moe_train_warm_set_lists_the_expert_backward(arch):
    """At the full config, 1 × 1024 tokens a microbatch: the router's dA
    (T, d, E) and dB (d, E, T) on K1; in bf16 (the config's type) the
    experts' forward, dA and dB on K1b at the products' (E, M, N, K), dA
    reading the stored weight and dB the stored rows transposed, and no
    transpose; in f32 their dA, dB and K4 transposes at the per-expert
    keys, every expert site with ``experts() == E``.  Each pick's format
    is one its C entry point takes, at K = E the router's masked loads
    included."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul import format_error as mm_format_error
    from repro_torch.plans.trace import trace_train_warm_set
    for dtype in ("bfloat16", "float32"):
        cfg = get_config(arch).scaled(layers=1, dtype=dtype)
        m = cfg.moe
        E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
        C = tmoe.capacity(1024, E, m.top_k, m.capacity_factor)
        ops_ = trace_train_warm_set(cfg, global_batch=2, seq=1024,
                                    microbatches=2)
        by_site = {s: op for op in ops_ for s in op.sites}
        up, down = "train.layer.moe.expert_up", "train.layer.moe.expert_down"
        want = {
            "train.layer.moe.router.dA": ("matmul_h100", (1024, d, E)),
            "train.layer.moe.router.dB": ("matmul_h100", (d, E, 1024)),
        }
        if dtype == "bfloat16":
            k1b = "matmul_experts_h100"
            want.update({
                up: (k1b, (E, C, f, d)), down: (k1b, (E, C, d, f)),
                f"{up}.dA": (k1b, (E, C, d, f)),
                f"{up}.dB": (k1b, (E, d, f, C)),
                f"{down}.dA": (k1b, (E, C, f, d)),
                f"{down}.dB": (k1b, (E, f, d, C))})
            assert not [s for s in by_site if s.endswith(("wT", "xT"))
                        and ".moe.expert_" in s]
        else:
            want.update({
                f"{up}.dA": ("matmul_h100", (C, d, f)),
                f"{up}.dB": ("matmul_h100", (d, f, C)),
                f"{down}.dA": ("matmul_h100", (C, f, d)),
                f"{down}.dB": ("matmul_h100", (f, d, C)),
                f"{up}.wT": ("transpose_h100", (d, f)),
                f"{up}.xT": ("transpose_h100", (C, d)),
                f"{down}.wT": ("transpose_h100", (f, d)),
                f"{down}.xT": ("transpose_h100", (C, f))})
        for site, (family, key) in want.items():
            op = by_site[site]
            data = op.data_dict()
            names = {"matmul_h100": ("M", "N", "K"),
                     "matmul_experts_h100": ("E", "M", "N", "K"),
                     "transpose_h100": ("M", "N")}[family]
            assert op.family == family and tuple(data[n] for n in names) \
                == key, site
            a = ops.select(family, data).assignment
            if family == "matmul_experts_h100":
                assert op.experts(cfg) == 1
                lay = dict(ta=site.endswith(".dB"), tb=site.endswith(".dA"))
                assert k1b_format_error(*key, **lay, bm=a["bm"], bn=a["bn"],
                                        stages=a["stages"]) is None, site
                continue
            assert op.experts(cfg) == (E if ".moe.expert_" in site else 1)
            if family == "matmul_h100":
                assert mm_format_error(
                    *key, a["bm"], a["bn"], a["bk"], a["s"], a["kb"],
                    a["stages"], True, getattr(torch, dtype),
                    experts=op.experts(cfg)) is None, site
            else:
                assert tr_format_error(*key, a["bm"], a["bn"], a["s"], 2,
                                       experts=op.experts(cfg)) is None, site
