"""K1b (``matmul_experts_h100``, the experts' batched product on TMA and
``wgmma``) on the CPU: its family's tree and counters, its plain version
against the JAX reference, the f32 route left as it was, the gradient, and
the warm sets and launch walks that dispatch it.

Tolerances: the bf16 plain version sums each expert's product in f32 (one
``torch.bmm``) and rounds once to bf16, as ``repro.kernels.ref.matmul(...,
out_dtype=bfloat16)`` does over the whole sum; the two round the same f32
value but for the order of its sums, so they may differ by one bf16 step
of an element (rtol 2^-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comprehensive import comprehensive_tree
from repro_torch.core.params import H100_SXM
from repro_torch.core.select import enumerate_candidates, rank_candidates
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import BatchedMatmulFn
from repro_torch.kernels.matmul import matmul_batched_plain
from repro_torch.kernels.matmul_experts import (
    FAMILY, MAX_SMEM, format_error, matmul_experts_h100,
    matmul_experts_plain, product_dims, smem_bytes)
from repro_torch.launch import roofline
from repro_torch.plans.trace import trace_train_launches, trace_warm_set

BF16_STEP = 2.0 ** -7


def _operands(E, M, N, K, ta=False, tb=False, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((E, K, M) if ta else (E, M, K))
    b = rng.standard_normal((E, N, K) if tb else (E, K, N)) / np.sqrt(K)
    return (torch.from_numpy(a.astype(np.float32)).to(dtype),
            torch.from_numpy(b.astype(np.float32)).to(dtype))


# ---------------------------------------------------------------------------
# The family: tree, counters, napkin
# ---------------------------------------------------------------------------

def test_tree_builds_within_the_candidate_cap():
    """The comprehensive tree: its four leaves (accept, reduce granularity,
    uncache, both), each with at most 18 candidates, within ``select``'s
    cap of 512 a leaf; every counter of the paper is there."""
    leaves = comprehensive_tree(FAMILY)
    assert {leaf.applied for leaf in leaves} <= {
        (), ("reduce_granularity",), ("uncache",),
        ("uncache", "reduce_granularity")}
    for leaf in leaves:
        size = np.prod([len(d.feasible())
                        for d in leaf.plan.program_params.values()])
        assert size <= 512
    assert [c.name for c in FAMILY.counters()] == [
        "smem_bytes", "threads", "registers", "occupancy"]
    data = {"E": 16, "M": 80, "N": 8192, "K": 5120}
    assert 0 < len(enumerate_candidates(FAMILY, H100_SXM, data)) <= 4 * 512


def test_smem_counter_prunes_the_deepest_ring_of_the_widest_tile():
    """Z_B = stages·(bm·bk + bk·bn)·2 + bm·bn·2 within 227 KB: bm 128 × bn
    256 fits 3 stages (212,992 bytes), not 4 (262,144), so no cached leaf
    offers it; the uncached leaf runs that format on its 2-slot ring, and
    the C entry point's own allocation (1 KB of alignment, the barriers)
    fits every format the cached leaves offer."""
    leaves = comprehensive_tree(FAMILY)
    cands = enumerate_candidates(FAMILY, H100_SXM,
                                 {"E": 16, "M": 80, "N": 8192, "K": 5120})
    cached = {(c.assignment["bm"], c.assignment["bn"], c.assignment["stages"])
              for c in cands if leaves[c.leaf_index].plan.flags["smem_cache"]}
    assert (128, 256, 3) in cached and (128, 256, 4) not in cached
    assert len(cached) == 17
    num, _ = FAMILY.counter_value(leaves[0].plan, "smem_bytes")
    z = num.eval({"bm": 128, "bn": 256, "bk": 64, "stages": 3})
    assert z == 212_992 <= H100_SXM.vmem_bytes
    for bm, bn, st in cached:
        assert smem_bytes(bm, bn, st) <= MAX_SMEM
    assert smem_bytes(128, 256, 4) > MAX_SMEM
    uncached = [c for c in cands
                if not leaves[c.leaf_index].plan.flags["smem_cache"]]
    assert [(c.assignment["bm"], c.assignment["bn"], c.assignment["stages"])
            for c in uncached] == [(128, 256, 4)]


@pytest.mark.parametrize("data,pick", [
    ({"E": 16, "M": 80, "N": 8192, "K": 5120}, (128, 256, 3)),   # forward
    ({"E": 16, "M": 5120, "N": 8192, "K": 80}, (128, 256, 3)),   # dB
    ({"E": 16, "M": 4, "N": 8192, "K": 5120}, (64, 256, 4)),     # decode
])
def test_napkin_picks_at_llama4_scouts_keys(data, pick):
    """The napkin's picks at llama4-scout's expert keys: a training group's
    80 rows in one 128-row tile and the deepest ring that fits, dB's 40
    rows of tiles the widest tile (fewer tiles, each a fixed cost), a
    decode step's 4 rows on one consumer warpgroup."""
    best = rank_candidates(FAMILY, H100_SXM, data)[0]
    a = best.assignment
    assert (a["bm"], a["bn"], a["stages"]) == pick


def test_format_error_mirrors_the_entry_points_checks():
    ok = dict(ta=False, tb=False, bm=128, bn=256, stages=3)
    assert format_error(16, 80, 8192, 5120, **ok) is None
    assert "bf16" in format_error(16, 80, 8192, 5120, **ok,
                                  dtype=torch.float32)
    assert "both" in format_error(4, 8, 8, 8, ta=True, tb=True, bm=64,
                                  bn=64, stages=2)
    assert "A's rows" in format_error(4, 27, 64, 64, **dict(ok, ta=True))
    assert format_error(4, 27, 64, 64, **ok) is None      # ragged M, NN
    assert "B's rows" in format_error(4, 8, 60, 64, **ok)
    assert "C's rows" in format_error(4, 8, 60, 64, **dict(ok, tb=True))
    assert "aligned" in format_error(4, 8, 64, 64, **ok, ptrs=(16, 2, 32))
    assert "232,448" in format_error(4, 8, 64, 64, **dict(ok, stages=4))
    assert "stages" in format_error(4, 8, 64, 64, **dict(ok, stages=1))


# ---------------------------------------------------------------------------
# The plain version and the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,M,N,K", [(3, 27, 136, 72), (4, 80, 64, 200)])
def test_plain_equals_jax_ref_rounded_to_bf16(E, M, N, K):
    """Each expert of the bf16 plain version against JAX's ``ref.matmul``
    of that expert rounded to bf16, within one bf16 step."""
    a, b = _operands(E, M, N, K, seed=E)
    got = matmul_experts_plain(a, b)
    assert got.dtype == torch.bfloat16 and got.shape == (E, M, N)
    for e in range(E):
        want = np.asarray(jref.matmul(
            jnp.asarray(a[e].float().numpy(), jnp.bfloat16),
            jnp.asarray(b[e].float().numpy(), jnp.bfloat16),
            out_dtype=jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_allclose(got[e].float().numpy(), want,
                                   rtol=BF16_STEP, atol=1e-6)


@pytest.mark.parametrize("ta,tb", [(False, True), (True, False)])
def test_transposed_reads_equal_the_explicit_copies_bit_for_bit(ta, tb):
    """``ta`` / ``tb`` read A stored [E, K, M] and B stored [E, N, K]: bit
    for bit the product of the copies transposed explicitly, through the
    wrapper and through ``ops.matmul_batched``; ``product_dims`` names the
    product either way."""
    E, M, N, K = 4, 16, 40, 136
    a, b = _operands(E, M, N, K, ta, tb, seed=3)
    A = a.transpose(1, 2).contiguous() if ta else a
    B = b.transpose(1, 2).contiguous() if tb else b
    want = matmul_experts_plain(A, B)
    assert product_dims(a, b, ta, tb) == (E, M, N, K)
    kw = dict(bm=64, bn=64, stages=2)
    assert torch.equal(matmul_experts_plain(a, b, ta=ta, tb=tb), want)
    assert torch.equal(matmul_experts_h100(a, b, ta, tb, **kw), want)
    assert torch.equal(ops.matmul_batched(a, b, ta=ta, tb=tb), want)
    with pytest.raises(ValueError):
        product_dims(a, b, not ta, tb)


def test_wrapper_counts_nothing_on_the_cpu_and_refuses_f32():
    a, b = _operands(2, 8, 16, 64)
    n0 = matmul_experts_h100.launches
    matmul_experts_h100(a, b, bm=64, bn=64, stages=2)
    assert matmul_experts_h100.launches == n0
    with pytest.raises(TypeError):
        matmul_experts_h100(a.float(), b.float(), bm=64, bn=64, stages=2)
    meta = matmul_experts_plain(a.to("meta"), b.to("meta"), ta=False)
    assert meta.shape == (2, 8, 16) and meta.dtype == torch.bfloat16


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False)])
def test_f32_route_is_bit_for_bit_todays(ta, tb):
    """f32 operands take K1's batched entry at the per-expert pick, f32 out,
    as before: bit for bit its plain version at that pick over the copies
    K4b makes of a transposed operand."""
    E, M, N, K = 3, 5, 40, 200
    a, b = _operands(E, M, N, K, ta, tb, seed=7, dtype=torch.float32)
    A = a.transpose(1, 2).contiguous() if ta else a
    B = b.transpose(1, 2).contiguous() if tb else b
    pick = ops.select("matmul_h100", {"M": M, "N": N, "K": K})
    kw = {n: pick.assignment[n] for n in ("bm", "bn", "bk", "s", "kb",
                                           "stages")}
    kw["cached"] = pick.plan.flags["smem_cache"]
    got = ops.matmul_batched(a, b, ta=ta, tb=tb)
    assert got.dtype == torch.float32
    assert torch.equal(got, matmul_batched_plain(A, B, **kw))


@pytest.mark.parametrize("E,M,N,K", [(4, 8, 24, 64), (2, 27, 64, 136)])
def test_batched_matmul_fn_bf16_matches_autograd_of_plain(E, M, N, K):
    """``BatchedMatmulFn`` in bf16: K1b forward, its dA and dB reading the
    stored operands transposed, against autograd of K1b's plain version
    (bf16 out, gradients bf16), within one bf16 step of the largest
    element."""
    a, b = _operands(E, M, N, K, seed=11)
    dc = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (E, M, N)).astype(np.float32)).bfloat16()
    x, w = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = BatchedMatmulFn.apply(x, w)
    out.backward(dc)
    px, pw = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = matmul_experts_plain(px, pw)
    want.backward(dc)
    assert out.dtype == torch.bfloat16 and torch.equal(out.detach(), want)
    for got, exp in ((x.grad, px.grad), (w.grad, pw.grad)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(
            got.float(), exp.float(), rtol=2 * BF16_STEP,
            atol=2 * BF16_STEP * float(exp.float().abs().max()))


# ---------------------------------------------------------------------------
# Dispatch and counting
# ---------------------------------------------------------------------------

def _per_wrapper(launches):
    out = {}
    for ln in launches:
        out[ln.wrapper] = out.get(ln.wrapper, 0) + ln.launches
    return out


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_launches_of_llama4_smoke_by_type(remat):
    """llama4-smoke's train step: in bf16 three K1b launches an expert
    product (four under remat: the forward twice) and no K4b or K1
    batched entry; in f32 K1's batched entry as many and two K4b copies a
    product, as before."""
    cfg = get_smoke_config("llama4_scout_17b_a16e").scaled(remat=remat)
    fwd = 2 if remat == "full" else 1
    products = 3 * cfg.layers * 2                 # wi, wg, wo; 2 microbatches
    bf16 = _per_wrapper(trace_train_launches(cfg, global_batch=4, seq=32,
                                             microbatches=2))
    assert bf16["matmul_experts_h100"] == (fwd + 2) * products
    assert "transpose_h100_batched" not in bf16
    assert "matmul_h100_batched" not in bf16
    f32 = _per_wrapper(trace_train_launches(cfg.scaled(dtype="float32"),
                                            global_batch=4, seq=32,
                                            microbatches=2))
    assert "matmul_experts_h100" not in f32
    assert f32["matmul_h100_batched"] == (fwd + 2) * products
    assert f32["transpose_h100_batched"] == 2 * products


def test_layouts_reach_the_walked_signatures():
    """The walk's K1b launches carry their layouts into the signature the
    wrapper counts: the forward NN, dA NT, dB TN."""
    cfg = get_smoke_config("llama4_scout_17b_a16e")
    seen = set()
    for ln in trace_train_launches(cfg, global_batch=4, seq=32,
                                   microbatches=2):
        if ln.wrapper != "matmul_experts_h100":
            continue
        pick = ops.select(ln.family, dict(ln.key)).assignment
        sig, _ = roofline.launch_signature(ln, pick)
        layout = {".dA": (False, True), ".dB": (True, False)}.get(
            ln.site[-3:], (False, False))
        assert sig[4:6] == layout and sig[-1] == torch.bfloat16
        seen.add(layout)
    assert len(seen) == 3


def test_roofline_counts_the_output_in_the_operands_type():
    """llama4-scout's dB key, (E, M, N, K) = (16, 5120, 8192, 80): 1.376 GB
    and 0.41 ms at 3.35 TB/s, where K1's batched entry (f32 out) counts
    2.72 GB."""
    sig = (16, 5120, 8192, 80, True, False, 128, 128, 2, torch.bfloat16)
    nbytes, flops, peak = roofline.work("matmul_experts_h100", sig)
    assert nbytes == 16 * (5120 * 80 + 80 * 8192 + 5120 * 8192) * 2
    assert round(nbytes / 1e9, 3) == 1.376
    assert round(1e3 * nbytes / roofline.HBM_BYTES_PER_S, 2) == 0.41
    assert flops == 2.0 * 16 * 5120 * 8192 * 80 and peak == 989e12
    old = roofline.work("matmul_h100_batched", (16, 5120, 8192, 80) + (
        64, 128, 64, 2, 1, 4, True, torch.bfloat16))[0]
    assert round(old / 1e9, 2) == 2.72


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e",
                                  "kimi_k2_1t_a32b"])
def test_serve_warm_set_keys_k1b_on_its_experts(arch):
    """The full bf16 config's serve warm set asks K1b for the experts at
    (E, M, N, K), keyed on all E experts, and the engine sizes no split-K
    workspace for them (``TracedOp.experts`` is 1: the key names E); the
    f32 config asks K1 at the per-expert key, E times its workspace."""
    cfg = get_config(arch)
    ops_ = trace_warm_set(cfg, max_len=256, max_batch=4, prefill_chunk=32)
    k1b = [op for op in ops_ if op.family == "matmul_experts_h100"]
    assert k1b and all(op.data_dict()["E"] == cfg.moe.num_experts
                       and op.experts(cfg) == 1 for op in k1b)
    assert all(".moe.expert_" in s for op in k1b for s in op.sites)
    f32 = cfg.scaled(dtype="float32")
    mm = [op for op in trace_warm_set(f32, max_len=256, max_batch=4,
                                      prefill_chunk=32)
          if any(".moe.expert_" in s for s in op.sites)]
    assert mm and all(op.family == "matmul_h100"
                      and op.experts(f32) == cfg.moe.num_experts
                      for op in mm)
