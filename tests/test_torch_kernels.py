"""K1-K6 of the port against the JAX package, on the CPU.

The same inputs, drawn with numpy from a seed, go through the JAX op (its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
the port's op, which on CPU tensors runs the kernel's plain version under
the leaf the H100 dispatch picks.  The CUDA kernels themselves are checked
on the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import pallas_flash_attention
from repro.kernels.jacobi1d import pallas_jacobi1d
from repro.models.layers import _sdpa as j_sdpa
from repro_torch.core import params as tcore_params
from repro_torch.kernels import jacobi1d as jac_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import transpose as tr_mod
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import (flash_attention_h100,
                                                 flash_attention_h100_paged,
                                                 flash_attention_paged_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.jacobi1d import jacobi1d_h100, jacobi1d_plain
from repro_torch.kernels.matadd import matadd_h100, matadd_plain
from repro_torch.kernels.matmul import matmul_h100, matmul_plain
from repro_torch.kernels.ssd_scan import ssd_scan_h100, ssd_scan_plain
from repro_torch.kernels.transpose import transpose_h100, transpose_plain

SEED = 20260


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(x, dtype):
    """One numpy array as a JAX and a torch array of the same type (both
    round f32 to bf16 to nearest even)."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# K1 matmul_h100
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 512, 384),
                                   (300, 200, 150), (64, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax_pallas(M, K, N, dtype):
    ja, ta = _pair(_np((M, K), SEED), dtype)
    jb, tb = _pair(_np((K, N), SEED + 1), dtype)
    want = np.asarray(jops.matmul(ja, jb, impl="pallas", interpret=True))
    got = ops.matmul(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,K,N", [(3, 128, 128, 128), (2, 300, 200, 150)])
def test_matmul_batched_matches_jax_pallas_per_expert(E, M, K, N, dtype):
    """``ops.matmul_batched`` (its plain versions on the CPU: K1's batched
    entry at the per-expert key in f32, f32 out; K1b at (E, M, N, K) in
    bf16, bf16 out) against the JAX Pallas matmul of each expert, as the
    JAX MoE layer's per-expert einsum is traced."""
    ja, ta = _pair(_np((E, M, K), SEED + 2), dtype)
    jb, tb = _pair(_np((E, K, N), SEED + 3), dtype)
    got = ops.matmul_batched(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (E, M, N)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for e in range(E):
        want = np.asarray(jops.matmul(ja[e], jb[e], impl="pallas",
                                      interpret=True))
        np.testing.assert_allclose(got[e].float().numpy(), want, rtol=tol,
                                   atol=tol * 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bn,bk,s,kb,stages,cached", [
    (96, 200, 130, 16, 32, 32, 1, 1, 2, True),
    (96, 200, 130, 64, 128, 64, 2, 1, 4, True),
    (5, 200, 130, 16, 256, 32, 2, 3, 4, True),    # M < 16, 7 tiles / 3
    (5, 200, 20, 16, 32, 64, 1, 2, 2, True),      # N < bn, 4 tiles / 2
    (96, 1000, 25, 32, 64, 32, 1, 16, 4, True),   # 32 tiles / 16
    (3, 300, 130, 16, 64, 64, 2, 4, 1, False),    # one stage, 5 tiles / 4
    (17, 333, 70, 16, 32, 32, 1, 8, 1, False),    # 11 tiles / 8: 2 empty
    (1, 250, 1, 16, 128, 32, 1, 5, 2, True)])
def test_matmul_every_block_format_same_product(M, K, N, bm, bn, bk, s, kb,
                                                stages, cached, dtype):
    """Every (block format, grain, split, ring) leaf computes the same
    product (paper Def. 2 ii), held against the JAX oracle: ragged M, N and
    K, K no multiple of kb·bk, one stage, f32 and bf16."""
    ja, ta = _pair(_np((M, K), SEED + 2), dtype)
    jb, tb = _pair(_np((K, N), SEED + 3), dtype)
    got = matmul_h100(ta, tb, bm=bm, bn=bn, bk=bk, s=s, kb=kb,
                      stages=stages, cached=cached)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.matmul(ja, jb)),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("K,bk,kb", [(1000, 32, 16), (333, 64, 3),
                                     (64, 32, 8), (4096, 64, 8)])
def test_matmul_plain_sums_splits_in_order(K, bk, kb):
    """The plain version is deterministic (two calls equal bit for bit), sums
    each split's k tiles and then the splits in order 0..kb-1 (an empty
    split adds zero), and that order is within rtol 1e-4 / atol 1e-3 of a
    float64 sum."""
    a = torch.from_numpy(_np((7, K), SEED + 6))
    b = torch.from_numpy(_np((K, 45), SEED + 7) / np.float32(np.sqrt(K)))
    kw = dict(bm=16, bn=64, bk=bk, s=1, kb=kb, stages=2)
    got = matmul_plain(a, b, **kw)
    assert torch.equal(got, matmul_plain(a, b, **kw))
    splits = mm_mod.split_tiles(K, bk, kb)
    assert len(splits) == kb
    assert [t for r in splits for t in r] == list(range(-(-K // bk)))
    want = torch.zeros(7, 45)
    for tiles in splits:
        part = torch.zeros(7, 45)
        for t in tiles:
            part += a[:, t * bk:(t + 1) * bk] @ b[t * bk:(t + 1) * bk]
        want += part
    assert torch.equal(got, want)
    exact = (a.double() @ b.double()).numpy()
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4, atol=1e-3)


def test_matmul_format_error_mirrors_the_entry_point():
    """The C entry point's checks in Python: what it takes and what it
    refuses (the GPU tests hold the two against each other on the card)."""
    ok = dict(M=4, N=4096, K=4096, bm=16, bn=128, bk=64, s=1, kb=8,
              stages=4, cached=True, dtype=torch.bfloat16)
    assert mm_mod.format_error(**ok) is None
    assert mm_mod.format_error(**{**ok, "dtype": torch.float32}) is None
    for bad in (dict(bm=8), dict(bm=24), dict(bn=48), dict(bk=16), dict(s=4),
                dict(stages=3), dict(kb=0), dict(bm=64, bn=256, s=1),
                dict(bn=32, N=32 * 65536), dict(bm=32, bn=256, bk=64, s=2,
                                                dtype=torch.float32),
                dict(dtype=torch.float16)):
        assert mm_mod.format_error(**{**ok, **bad}) is not None, bad
    # an uncached leaf runs one stage, so a ring too deep for V launches
    deep = dict(ok, bm=32, bn=256, bk=64, s=2, stages=4,
                dtype=torch.float32)
    assert mm_mod.format_error(**{**deep, "cached": False}) is None


def test_matmul_oracle_matches_jax_oracle():
    ja, ta = _pair(_np((33, 70), SEED + 4), "bfloat16")
    jb, tb = _pair(_np((70, 45), SEED + 5), "bfloat16")
    np.testing.assert_allclose(ref.matmul(ta, tb).numpy(),
                               np.asarray(jref.matmul(ja, jb)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K2 flash_attention_h100
# ---------------------------------------------------------------------------

def _qkv(h, sq, sk, d, seed):
    q = _pair(_np((h, sq, d), seed), "float32")
    k = _pair(_np((h, sk, d), seed + 1), "float32")
    v = _pair(_np((h, sk, d), seed + 2), "float32")
    return q, k, v


@pytest.mark.parametrize("h,s,d", [(2, 256, 64), (4, 512, 128), (1, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_pallas(h, s, d, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(h, s, s, d, SEED + 10)
    want = jops.flash_attention(jq, jk, jv, causal=causal, impl="pallas",
                                interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_flash_window_matches_jax_pallas():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 512, 512, 64, SEED + 20)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=128,
                                impl="pallas", interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("sq,sk", [(1, 200), (1, 37), (32, 200), (16, 61)])
def test_flash_decode_and_chunk_ragged_causal(sq, sk):
    """Decode (sq 1) and a prefill chunk (sq < sk) over a key count that is
    no multiple of any tile: the serve path's shapes.  The JAX dispatch has
    no TPU leaf at these SQ, so the Pallas kernel is called directly."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, sq, sk, 32, SEED + 30 + sq)
    want = pallas_flash_attention(jq, jk, jv, bq=128, bk=128, causal=True,
                                  interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("sq", [200, 1])
def test_flash_non_causal_ragged_matches_oracle(sq):
    """Non-causal with sk = 200.  Held against ``repro.kernels.ref`` and not
    the Pallas kernel: the Pallas kernel pads K/V to a whole tile and lets
    the padded keys into the softmax when causal=False (ROADMAP F1); the
    port computes the oracle's function."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, sq, 200, 64, SEED + 40)
    want = jref.flash_attention(jq, jk, jv, causal=False)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("bq,bkv,kv_chunk,stages", [
    (16, 32, 4096, 2), (32, 64, 64, 3), (64, 32, 96, 4), (128, 64, 128, 2)])
def test_flash_every_tile_shape_same_result(bq, bkv, kv_chunk, stages):
    """Every launch format, one split and several, gives the oracle's
    attention: the format shapes the launch, the splits are combined."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 40, 130, 16, SEED + 50)
    want = jref.flash_attention(jq, jk, jv, causal=True, window=50)
    got = flash_attention_h100(tq, tk, tv, bq=bq, bkv=bkv,
                               kv_chunk=kv_chunk, stages=stages, causal=True,
                               window=50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def _gqa(h, hk, sq, sk, d, seed):
    """q [h, sq, d] and k, v [hk, sk, d] from numpy; JAX gets K/V broadcast
    to the query heads with ``jnp.repeat`` (query head i reads KV head
    i // (h/hk)), the port takes them as they are."""
    (jq, tq) = _pair(_np((h, sq, d), seed), "float32")
    (jk, tk) = _pair(_np((hk, sk, d), seed + 1), "float32")
    (jv, tv) = _pair(_np((hk, sk, d), seed + 2), "float32")
    jk, jv = jnp.repeat(jk, h // hk, axis=0), jnp.repeat(jv, h // hk, axis=0)
    return (jq, tq), (jk, tk), (jv, tv)


@pytest.mark.parametrize("h,hk,sq,sk,causal,window", [
    (8, 2, 128, 128, True, None), (8, 2, 1, 200, True, None),
    (10, 5, 16, 61, True, None), (8, 4, 32, 300, True, 40),
    (4, 1, 1, 256, True, 128)])
def test_flash_gqa_matches_jax_pallas(h, hk, sq, sk, causal, window):
    """K/V with fewer heads than q through ``ops.flash_attention`` (the
    tree's pick at (SQ, HD, GROUP, HK)) against the Pallas kernel in interpret
    mode on K/V broadcast with ``jnp.repeat``, and against the oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _gqa(h, hk, sq, sk, 32, SEED + 300 + sq)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = pallas_flash_attention(jq, jk, jv, bq=128, bk=128, causal=causal,
                                  window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention(jq, jk, jv, causal,
                                                     window)),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("sq", [200, 1])
def test_flash_gqa_non_causal_ragged_matches_oracle(sq):
    """Non-causal GQA over sk = 200, no multiple of any kv tile (F1): held
    against the oracle, which the Pallas kernel is not there."""
    (jq, tq), (jk, tk), (jv, tv) = _gqa(6, 2, sq, 200, 64, SEED + 310)
    want = jref.flash_attention(jq, jk, jv, causal=False)
    for bkv in (32, 64):
        got = flash_attention_h100(tq, tk, tv, bq=32, bkv=bkv, kv_chunk=4096,
                                   causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("kv_chunk", [32, 64, 128, 192, 4096])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 70)])
def test_flash_split_kv_matches_oracle(kv_chunk, causal, window):
    """Split-KV at several ``kv_chunk`` (one split at 4096): each split's
    (m, l, acc) combined in split order is the oracle's attention, decode
    and prefill chunk alike, a window leaving whole splits unseen."""
    for sq in (1, 37):
        (jq, tq), (jk, tk), (jv, tv) = _gqa(8, 2, sq, 333, 16,
                                            SEED + 320 + sq)
        want = jref.flash_attention(jq, jk, jv, causal, window)
        got = flash_attention_h100(tq, tk, tv, bq=16, bkv=32,
                                   kv_chunk=kv_chunk, causal=causal,
                                   window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)


def test_flash_format_error_mirrors_the_entry_point():
    """The C entry point's checks, in Python: the formats the tree offers
    pass, the others name why they are refused."""
    from repro_torch.kernels.flash_attention import format_error
    ok = dict(bq=16, bkv=64, kv_chunk=512, stages=3, dtype=torch.bfloat16)
    assert format_error(32, 8, 1, 4096, 128, **ok) is None
    for bad, why in [(dict(bq=8), "bq"), (dict(bkv=128), "bkv"),
                     (dict(kv_chunk=96), "kv_chunk"), (dict(stages=1),
                                                       "stages"),
                     (dict(dtype=torch.float16), "f32 or bf16")]:
        assert why in format_error(32, 8, 1, 4096, 128, **{**ok, **bad})
    assert "multiple" in format_error(32, 7, 1, 64, 128, **ok)
    assert "sq <= sk" in format_error(32, 8, 65, 64, 128, **ok)
    assert "232,448" in format_error(32, 8, 32, 64, 128, bq=128, bkv=64,
                                     kv_chunk=512, stages=4,
                                     dtype=torch.float32)


def _paged_case(rows, sq, h, hk, d, lens, *, nblk=6, page=4,
                num_blocks=16, q_dtype="float32", pool="float32", seed=0):
    """q [rows, h, sq, d] and pools [num_blocks, page, hk, d] from numpy,
    each row's table a random draw of blocks 1.. (block 0 the garbage
    block, which tables never name for a position below the length)."""
    rng = np.random.default_rng(SEED + 400 + seed)
    q = _np((rows, h, sq, d), SEED + 401 + seed)
    k = _np((num_blocks, page, hk, d), SEED + 402 + seed)
    v = _np((num_blocks, page, hk, d), SEED + 403 + seed)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:nblk]
                       for _ in range(rows)]).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(q, q_dtype), _pair(k, pool),
                                    _pair(v, pool))
    return (jq, jk, jv), (tq, tk, tv, torch.from_numpy(tables),
                          torch.from_numpy(lens)), tables, lens


def _jax_paged(jq, jk, jv, tables, lens, window):
    """The JAX layer's paged read: gather each row's table view of the pool,
    upcast to q's type, and ``_sdpa`` with the queries at positions len −
    sq .. len − 1 over key positions 0 .. nblk · page − 1."""
    rows, h, sq, d = jq.shape
    hk, page = jk.shape[2], jk.shape[1]
    keys = tables.shape[1] * page
    k_att = jk[tables].reshape(rows, keys, hk, d).astype(jq.dtype)
    v_att = jv[tables].reshape(rows, keys, hk, d).astype(jq.dtype)
    qpos = jnp.asarray(lens)[:, None] - sq + jnp.arange(sq)[None]
    out = j_sdpa(jnp.transpose(jq, (0, 2, 1, 3)), k_att, v_att, causal=True,
                 window=window, q_positions=qpos,
                 k_positions=jnp.arange(keys))
    return np.asarray(jnp.transpose(out, (0, 2, 1, 3)).astype(jnp.float32))


@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1p5b", "qwen1p5_4b"])
@pytest.mark.parametrize("case", ["decode", "chunk"])
@pytest.mark.parametrize("q_dtype,pool", [("float32", "float32"),
                                          ("float32", "bfloat16"),
                                          ("bfloat16", "bfloat16")])
def test_paged_attention_matches_jax_paged_read(arch, case, q_dtype, pool):
    """``ops.paged_attention`` (the pick at (SQ, HD, GROUP, HK), its paged
    plain version on the CPU) against the JAX layer's paged read at the
    smoke configs' groupings (hymba's with its window, qwen's one query
    head a KV head): a decode over 4
    rows of ragged lengths, one of them 0 (a row not decoding: zeros), and
    a prefill chunk; f32 q on an f32 and on a bf16 pool, and bf16."""
    cfg = get_smoke_config(arch)
    h, hk, d = cfg.heads, cfg.kv_heads, cfg.hd
    rows, sq, lens = ((4, 1, [7, 0, 19, 24]) if case == "decode"
                      else (1, 8, [13]))
    (jq, jk, jv), targs, tables, lens = _paged_case(
        rows, sq, h, hk, d, lens, q_dtype=q_dtype, pool=pool)
    got = ops.paged_attention(*targs, causal=True, window=cfg.window)
    assert got.dtype == targs[0].dtype and got.shape == (rows, h, sq, d)
    want = _jax_paged(jq, jk, jv, tables, lens, cfg.window)
    live = lens > 0
    tol = 2e-2 if q_dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy()[live], want[live],
                               rtol=tol, atol=tol)
    assert not got[~torch.from_numpy(live)].any()       # length 0: zeros


@pytest.mark.parametrize("kv_chunk", [32, 64, 4096])
@pytest.mark.parametrize("window", [None, 21])
def test_paged_plain_is_the_dense_plain_per_row(kv_chunk, window):
    """Over a pool of 80 keys (3 splits at kv_chunk 32), each row of the
    paged plain version equals the dense plain version over that row's
    gathered keys with the same kv_chunk: the same splits and tiles in the
    same order, the empty ones past the length carrying no weight; the
    f32 upcast of a bf16 pool is the gather's."""
    lens = [80, 33, 1, 0, 64]
    _, (q, k, v, tables, tl), nt, _ = _paged_case(
        5, 1, 8, 2, 16, lens, nblk=20, num_blocks=24, pool="bfloat16",
        seed=7)
    kw = dict(bq=16, bkv=32, kv_chunk=kv_chunk, causal=True, window=window)
    got = flash_attention_h100_paged(q, k, v, tables, tl, **kw)
    for b, n in enumerate(lens):
        if n == 0:
            assert not got[b].any()
            continue
        kb = k[nt[b]].reshape(-1, 2, 16)[:n].permute(1, 0, 2).float()
        vb = v[nt[b]].reshape(-1, 2, 16)[:n].permute(1, 0, 2).float()
        want = flash_attention_plain(q[b], kb.contiguous(), vb.contiguous(),
                                     **kw)
        torch.testing.assert_close(got[b], want, rtol=1e-6, atol=1e-6)


def test_paged_plain_ignores_what_lies_past_the_length():
    """F1 on the paged read: NaN and huge values written into every pool
    position at or past a row's length (the garbage block, stale blocks)
    change nothing."""
    lens = [9, 0, 17]
    _, (q, k, v, tables, tl), nt, _ = _paged_case(3, 1, 4, 2, 16, lens,
                                                  seed=9)
    kw = dict(bq=16, bkv=32, kv_chunk=4096, causal=True)
    want = flash_attention_paged_plain(q, k, v, tables, tl, **kw)
    k2, v2 = k.clone(), v.clone()
    used = {int(nt[b, p // 4]) for b, n in enumerate(lens) for p in range(n)}
    for blk in set(range(k.shape[0])) - used:
        k2[blk], v2[blk] = float("nan"), 1e30
    got = flash_attention_paged_plain(q, k2, v2, tables, tl, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_paged_format_error_mirrors_the_entry_point():
    """The paged entry's checks: (row, KV head) pairs on the grid's y, and
    K/V of q's type or a bf16 pool."""
    from repro_torch.kernels.flash_attention import format_error
    ok = dict(bq=16, bkv=64, kv_chunk=512, stages=3, dtype=torch.float32)
    assert format_error(32, 8, 1, 4096, 128, **ok, rows=8,
                        kv_dtype=torch.bfloat16) is None
    assert "65,535" in format_error(32, 8, 1, 4096, 128, **ok, rows=9000)
    assert "bf16 pool" in format_error(32, 8, 1, 4096, 128,
                                       **{**ok, "dtype": torch.bfloat16},
                                       kv_dtype=torch.float32)


def test_flash_oracle_matches_jax_oracle():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 5, 19, 8, SEED + 60)
    for causal, window in ((True, None), (False, None), (True, 4)):
        np.testing.assert_allclose(
            ref.flash_attention(tq, tk, tv, causal, window).numpy(),
            np.asarray(jref.flash_attention(jq, jk, jv, causal, window)),
            rtol=1e-5, atol=1e-5)


def test_flash_keeps_bf16():
    tq = torch.from_numpy(_np((2, 4, 16), 1)).to(torch.bfloat16)
    tk = torch.from_numpy(_np((2, 9, 16), 2)).to(torch.bfloat16)
    assert ops.flash_attention(tq, tk, tk).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# K3 ssd_scan_h100
# ---------------------------------------------------------------------------

def _ssd(seq, heads, hd, state, seed):
    """x, a in (0.05, 0.95), b, c as in ``tests/test_kernels.py``, each as a
    (JAX, torch) pair."""
    a = 1.0 / (1.0 + np.exp(-_np((seq, heads), seed + 1))) * 0.9 + 0.05
    return (_pair(_np((seq, heads, hd), seed), "float32"),
            _pair(a.astype(np.float32), "float32"),
            _pair(_np((seq, heads, state), seed + 2), "float32"),
            _pair(_np((seq, heads, state), seed + 3), "float32"))


def _stepwise(x, a, b, c, S):
    """The recurrence one step at a time in f64, from state S."""
    x, a, b, c, S = (np.asarray(t, np.float64) for t in (x, a, b, c, S))
    ys = []
    for t in range(x.shape[0]):
        S = a[t][:, None, None] * S + np.einsum("hs,hd->hsd", b[t], x[t])
        ys.append(np.einsum("hs,hsd->hd", c[t], S))
    return np.stack(ys), S


@pytest.mark.parametrize("seq,heads,hd,state", [
    (256, 2, 32, 16), (512, 4, 64, 32), (128, 1, 64, 64), (200, 3, 32, 16)])
def test_ssd_scan_matches_jax_pallas_and_oracle(seq, heads, hd, state):
    """The JAX test's shapes, plus seq 200, no multiple of any chunk."""
    (jx, tx), (ja, ta), (jb, tb), (jc, tc) = _ssd(seq, heads, hd, state,
                                                  SEED + 70)
    pallas = jops.ssd_scan(jx, ja, jb, jc, impl="pallas", interpret=True)
    oracle = jref.ssd_scan(jx, ja, jb, jc)
    got, _ = ops.ssd_scan(tx, ta, tb, tc)
    assert got.shape == (seq, heads, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-3,
                               atol=2e-3)


def test_ssd_state_in_out_matches_stepwise():
    """A nonzero incoming state, the final state and y against the
    recurrence one step at a time."""
    (_, tx), (_, ta), (_, tb), (_, tc) = _ssd(45, 3, 16, 8, SEED + 80)
    s0 = _np((3, 8, 16), SEED + 84)
    want_y, want_s = _stepwise(tx, ta, tb, tc, s0)
    got_y, got_s = ops.ssd_scan(tx, ta, tb, tc, torch.from_numpy(s0))
    assert got_s.dtype == torch.float32 and got_s.shape == (3, 8, 16)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [1, 77, 199])
def test_ssd_state_threads_a_split_sequence(split):
    """Scanning seq 200 in two calls, the second from the first's final
    state, gives the JAX oracle's y over the whole sequence (what chunked
    prefill relies on)."""
    (jx, tx), (ja, ta), (jb, tb), (jc, tc) = _ssd(200, 2, 32, 16, SEED + 90)
    y1, s1 = ops.ssd_scan(tx[:split], ta[:split], tb[:split], tc[:split])
    y2, _ = ops.ssd_scan(tx[split:], ta[split:], tb[split:], tc[split:], s1)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(),
                               np.asarray(jref.ssd_scan(jx, ja, jb, jc)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("chunk,bd", [(16, 32), (16, 64), (32, 32),
                                      (32, 64), (64, 32), (64, 64),
                                      (128, 32), (128, 64)])
def test_ssd_every_chunk_same_result(chunk, bd):
    """Every (chunk, hd tile) leaf computes the same scan (paper Def. 2
    ii), held against the JAX oracle."""
    (jx, tx), (ja, ta), (jb, tb), (jc, tc) = _ssd(150, 2, 16, 8, SEED + 100)
    got, _ = ssd_scan_h100(tx[None], ta[None], tb[None], tc[None],
                           chunk=chunk, bd=bd)
    np.testing.assert_allclose(got[0].numpy(),
                               np.asarray(jref.ssd_scan(jx, ja, jb, jc)),
                               rtol=2e-3, atol=2e-3)


def test_ssd_shared_bc_equals_per_head_bc():
    """B and C given once per step ([rows, seq, state], shared across heads
    as the model projects them) or per head give the same scan."""
    (_, tx), (_, ta), (_, tb), (_, tc) = _ssd(30, 3, 8, 4, SEED + 110)
    b1, c1 = tb[None, :, 0], tc[None, :, 0]
    shared = ssd_scan_plain(tx[None], ta[None], b1, c1, chunk=16, bd=8)
    per_head = ssd_scan_plain(tx[None], ta[None],
                              b1[:, :, None].expand(1, 30, 3, 4).contiguous(),
                              c1[:, :, None].expand(1, 30, 3, 4).contiguous(),
                              chunk=16, bd=8)
    for got, want in zip(shared, per_head):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seq", [1, 8, 37])
def test_ssd_plain_in_place_and_masked_equals_out_of_place(seq):
    """The plain version updating the state in place with rows 1 and 3 of 4
    masked out: the active rows' y and state equal the out-of-place call's,
    the masked rows keep their state bit for bit and get y = 0 (the
    kernel's contract)."""
    rng = np.random.default_rng(SEED + 140 + seq)
    x = torch.from_numpy(rng.standard_normal((4, seq, 3, 16), np.float32))
    a = torch.from_numpy(rng.uniform(0.05, 0.95, (4, seq, 3)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((4, seq, 8), np.float32))
    c = torch.from_numpy(rng.standard_normal((4, seq, 8), np.float32))
    s0 = torch.from_numpy(rng.standard_normal((4, 3, 8, 16), np.float32))
    want_y, want_s = ssd_scan_h100(x, a, b, c, s0, chunk=16, bd=32)
    mask = torch.tensor([True, False, True, False])
    st = s0.clone()
    y, s1 = ssd_scan_h100(x, a, b, c, st, chunk=16, bd=32, out_state=st,
                          mask=mask)
    assert s1 is st
    assert torch.equal(y[mask], want_y[mask])
    assert torch.equal(st[mask], want_s[mask])
    assert torch.equal(st[~mask], s0[~mask]) and not bool(y[~mask].any())


@pytest.mark.parametrize("seq", [1, 8, 37])
@pytest.mark.parametrize("masked", [False, True])
def test_ssd_plain_state_rows_equal_the_gathered_rows(seq, masked):
    """``state_rows`` maps rows 0-2 of x to rows 4, 0 and 2 of a 5-row
    state: the result equals the call without it on the gathered rows, in
    place, and the state rows no index names (1, 3) stay bit for bit; with
    a mask leaving x row 1 out, its state row (0) also stays and its y is
    0.  The launch keeps the kernel's launch signature checks."""
    from repro_torch.kernels.ssd_scan import format_error
    rng = np.random.default_rng(SEED + 150 + seq)
    x = torch.from_numpy(rng.standard_normal((3, seq, 3, 16), np.float32))
    a = torch.from_numpy(rng.uniform(0.05, 0.95, (3, seq, 3)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((3, seq, 8), np.float32))
    c = torch.from_numpy(rng.standard_normal((3, seq, 8), np.float32))
    pool = torch.from_numpy(rng.standard_normal((5, 3, 8, 16), np.float32))
    rows = torch.tensor([4, 0, 2], dtype=torch.int32)
    mask = torch.tensor([True, False, True]) if masked else None
    gathered = pool[rows.long()].clone()
    want_y, want_s = ssd_scan_h100(x, a, b, c, gathered, chunk=16, bd=32,
                                   out_state=gathered, mask=mask)
    st = pool.clone()
    y, s1 = ssd_scan_h100(x, a, b, c, st, chunk=16, bd=32, out_state=st,
                          mask=mask, state_rows=rows)
    assert s1 is st
    assert torch.equal(y, want_y)
    assert torch.equal(st[rows.long()], want_s)
    assert torch.equal(st[[1, 3]], pool[[1, 3]])
    if masked:
        assert torch.equal(st[0], pool[0]) and not bool(y[1].any())
    with pytest.raises(ValueError, match="state_rows"):
        ssd_scan_h100(x, a, b, c, st, chunk=16, bd=32, state_rows=rows)
    assert format_error(3, seq, 3, 16, 8, min(16, seq), 32, torch.float32,
                        5) is None
    assert format_error(3, seq, 3, 16, 8, min(16, seq), 32, torch.float32,
                        -1) == "negative state rows"
    assert "2^31" in format_error(3, seq, 3, 16, 8, min(16, seq), 32,
                                  torch.float32, 1 << 30)


def _kernel_rounding(x, a, b, c, ck, one_g=False):
    """The tensor-core body's rounding points, emulated in f32 from a zero
    state (``csrc/ssd_scan.cu``): c·bᵀ from the bf16 inputs as they are; G,
    the state S and w⊙b each fed to a bf16 product as a high and a low
    bf16 part (``one_g``: G rounded once, the rounding the body does not
    use); exp(cum_t) applied to rows of the f32 c·S; y rounded to bf16."""
    def hi_lo(v):
        hi = v.bfloat16().float()
        return hi, (v - hi).bfloat16().float()
    seq, heads, hd = x.shape
    xf, bf, cf = x.float(), b.float(), c.float()
    S = torch.zeros((heads, b.shape[-1], hd))
    ys = []
    for t0 in range(0, seq, ck):
        xc = xf[t0:t0 + ck].transpose(0, 1)
        cum = torch.cumsum(torch.log(a[t0:t0 + ck].T), -1)
        n = xc.shape[1]
        tri = torch.ones(n, n, dtype=torch.bool).tril()
        L = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(
            ~tri, -torch.inf))
        G = (cf[t0:t0 + ck] @ bf[t0:t0 + ck].T)[None] * L
        if one_g:
            y = G.bfloat16().float() @ xc
        else:
            gh, gl = hi_lo(G)
            y = gh @ xc + gl @ xc
        sh, sl = hi_lo(S)
        cc = cf[t0:t0 + ck][None]
        y = y + (cc @ sh + cc @ sl) * torch.exp(cum)[..., None]
        ys.append(y)
        wh, wl = hi_lo(bf[t0:t0 + ck][None]
                       * torch.exp(cum[:, -1:] - cum)[..., None])
        S = (torch.exp(cum[:, -1:])[..., None] * S
             + wh.transpose(1, 2) @ xc + wl.transpose(1, 2) @ xc)
    return torch.cat(ys, 1).transpose(0, 1).bfloat16()


def test_ssd_kernel_rounding_points_hold_the_relative_check():
    """At mamba2-130m's widths (24 heads of 64, state 128, a 256-step chunk
    in chunks of 128, the pick): the emulated rounding points stay well
    under ``SSD_REL`` = 2^-6 of the JAX oracle's y, by relative Frobenius
    error, while the planted fault the smoke run plants (one step's decay
    set to 1) goes over it; G rounded once to bf16 would put y elements
    outside the 1e-2 tolerance that the split keeps."""
    ssd_rel = 2.0 ** -6
    seq, heads, hd, state = 256, 24, 64, 128
    rng = np.random.default_rng(SEED + 150)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    x = bf(rng.standard_normal((seq, heads, hd)))
    b = bf(rng.standard_normal((seq, state)))
    c = bf(rng.standard_normal((seq, state)))
    a = torch.from_numpy(rng.uniform(0.05, 0.95, (seq, heads)).astype(
        np.float32))
    per_head = lambda t: t.float()[:, None, :].expand(seq, heads, state)

    def oracle(decay):
        return torch.from_numpy(np.array(jref.ssd_scan(
            jnp.asarray(x.float().numpy()), jnp.asarray(decay.numpy()),
            jnp.asarray(per_head(b).numpy()),
            jnp.asarray(per_head(c).numpy()))))

    want = oracle(a)

    def rel(y):
        return float((y.float() - want).norm() / want.norm())

    got = _kernel_rounding(x, a, b, c, 128)
    assert rel(got) < ssd_rel / 8
    faulty = a.clone()
    faulty[seq // 2] = 1.0
    assert rel(oracle(faulty)) > ssd_rel
    plain, _ = ssd_scan_plain(x[None], a[None], b[None], c[None], chunk=128,
                              bd=32)
    torch.testing.assert_close(got.float(), plain[0].float(), rtol=1e-2,
                               atol=1e-2)
    once = _kernel_rounding(x, a, b, c, 128, one_g=True)
    assert not torch.allclose(once.float(), plain[0].float(), rtol=1e-2,
                              atol=1e-2)


def test_ssd_oracle_matches_jax_oracle():
    (jx, tx), (ja, ta), (jb, tb), (jc, tc) = _ssd(23, 2, 8, 4, SEED + 120)
    np.testing.assert_allclose(ref.ssd_scan(tx, ta, tb, tc).numpy(),
                               np.asarray(jref.ssd_scan(jx, ja, jb, jc)),
                               rtol=1e-5, atol=1e-5)


def test_ssd_keeps_x_type_and_f32_state():
    (_, tx), (_, ta), (_, tb), (_, tc) = _ssd(9, 2, 8, 4, SEED + 130)
    y, s = ops.ssd_scan(tx.bfloat16(), ta, tb.bfloat16(), tc.bfloat16())
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32


# ---------------------------------------------------------------------------
# The paper's case studies: K5 matadd_h100, K4 transpose_h100, K6 jacobi1d_h100
# ---------------------------------------------------------------------------

def _bits(x):
    """The raw bits of a torch or numpy array of 2- or 4-byte elements, as
    numpy integers (bit-exact comparison, bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view({2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy()
    x = np.ascontiguousarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize])


@pytest.mark.parametrize("name", ["matadd", "transpose_f32",
                                  "transpose_bf16", "jacobi"])
def test_case_study_oracle_matches_jax_oracle(name):
    """The three oracles equal the JAX ones bit for bit; the Jacobi oracle
    keeps the JAX order (left sum first, then a true division by 3)."""
    x = _np((37, 53), SEED + 140)
    y = _np((37, 53), SEED + 141)
    if name == "matadd":
        (jx, tx), (jy, ty) = _pair(x, "float32"), _pair(y, "float32")
        got, want = ref.matadd(tx, ty), jref.matadd(jx, jy)
    elif name.startswith("transpose"):
        jx, tx = _pair(x, "bfloat16" if name.endswith("bf16") else "float32")
        got, want = ref.transpose(tx), jref.transpose(jx)
    else:
        jx, tx = _pair(_np((1026,), SEED + 142), "float32")
        got, want = ref.jacobi1d(tx, 5), jref.jacobi1d(jx, 5)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("M,N", [(128, 128), (257, 511), (1024, 256)])
def test_matadd_matches_jax_pallas(M, N):
    """The JAX test's shapes, bit for bit."""
    (ja, ta), (jb, tb) = (_pair(_np((M, N), SEED + 150), "float32"),
                          _pair(_np((M, N), SEED + 151), "float32"))
    want = jops.matadd(ja, jb, impl="pallas", interpret=True)
    got = ops.matadd(ta, tb)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("M,N", [(128, 128), (512, 256), (300, 700)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transpose_matches_jax_pallas(M, N, dtype):
    """The JAX test's shapes and types, bit for bit."""
    ja, ta = _pair(_np((M, N), SEED + 160), dtype)
    want = jops.transpose(ja, impl="pallas", interpret=True)
    got = ops.transpose(ta)
    assert got.shape == (N, M) and got.dtype == ta.dtype
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("n,steps", [(1026, 1), (4098, 4), (32770, 2),
                                     (3, 4), (1026, 0)])
def test_jacobi_matches_jax_pallas(n, steps):
    """The JAX test's (n, steps), plus a single interior point and no step,
    within the JAX test's 1e-5 of the Pallas kernel and equal to the JAX
    oracle.  The JAX dispatch has no TPU leaf at n = 3, so there the Pallas
    kernel is called directly."""
    jx, tx = _pair(_np((n,), SEED + 170 + n), "float32")
    if n == 3:
        want = pallas_jacobi1d(jx, steps, B=128, s=1, interpret=True)
    else:
        want = jops.jacobi1d(jx, steps, impl="pallas", interpret=True)
    got = ops.jacobi1d(tx, steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.jacobi1d(jx, steps)))


@pytest.mark.parametrize("bm,bn,s", [(1, 32, 2), (4, 256, 2), (32, 32, 1),
                                     (8, 128, 1), (2, 1024, 2)])
def test_matadd_every_block_format_same_sum(bm, bn, s):
    (ja, ta), (jb, tb) = (_pair(_np((45, 301), SEED + 180), "float32"),
                          _pair(_np((45, 301), SEED + 181), "float32"))
    got = matadd_h100(ta, tb, bm=bm, bn=bn, s=s)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(np.asarray(jref.matadd(ja, jb))))


@pytest.mark.parametrize("bm,bn,s,cached", [
    (32, 32, 4, True), (8, 128, 1, True), (1, 1024, 8, True),
    (32, 32, 1, False), (4, 64, 2, False)])
def test_transpose_every_block_format_same_result(bm, bn, s, cached):
    ja, ta = _pair(_np((45, 301), SEED + 190), "bfloat16")
    got = transpose_h100(ta, bm=bm, bn=bn, s=s, cached=cached)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(np.asarray(jref.transpose(ja))))


#: K4's picks under H100_SXM at the training paths' transposes (llama3-8b at
#: 4 × 1024 rows a microbatch, whisper-large-v3 at 2 × 64 tokens over 2 ×
#: 1500 frames) and at Table 3's 16384²: (M, N) -> (bm, bn, s).
K4_PICKS = {
    (4096, 4096): (16, 32, 8), (4096, 1024): (32, 32, 8),
    (4096, 14336): (16, 32, 8), (14336, 4096): (16, 32, 8),
    (4096, 128256): (16, 32, 8),
    (1280, 1280): (32, 32, 8), (3000, 1280): (32, 32, 8),
    (1280, 5120): (32, 32, 8), (5120, 1280): (32, 32, 8),
    (3000, 5120): (32, 32, 8), (128, 1280): (16, 32, 4),
    (128, 5120): (16, 32, 8), (1280, 51866): (16, 32, 8),
    (16384, 16384): (16, 32, 8)}


def test_transpose_picks_cover_the_training_signatures():
    """``K4_PICKS`` holds every K4 key the two training warm sets trace."""
    from repro_torch.configs import get_config
    from repro_torch.plans.trace import trace_train_warm_set
    keys = set()
    for name, kw in (("llama3_8b", dict(global_batch=8, seq=1024,
                                        microbatches=2)),
                     ("whisper_large_v3", dict(global_batch=2, seq=64))):
        for op in trace_train_warm_set(get_config(name), **kw):
            if op.family == "transpose_h100":
                d = op.data_dict()
                keys.add((d["M"], d["N"]))
    assert keys == set(K4_PICKS) - {(16384, 16384)}


@pytest.mark.parametrize("M,N", sorted(K4_PICKS))
def test_transpose_picks_at_the_training_signatures(M, N):
    """The refitted napkin's picks, cached at full grain (case 1)."""
    from repro_torch.kernels.instantiate_cache import grain
    cand = ops.select("transpose_h100", {"M": M, "N": N})
    a = cand.assignment
    assert cand.plan.flags["smem_cache"]
    assert (a["bm"], a["bn"], grain(cand.plan, a["s"])) == K4_PICKS[(M, N)]


@pytest.mark.parametrize("M,N", [(4096, 128256), (4096, 4096),
                                 (16384, 16384)])
def test_transpose_napkin_ranks_the_leaves_as_fitted(M, N):
    """At the large signatures the napkin orders the leaves as the card's
    device times did (warm when its constants were set, and again with
    every launch on a cold copy of its input): 16-byte runs before 8-byte
    ones, bm 16 (512 threads) before bm 32 before bn 64 at each, and every
    leaf whose bm writes partial 32-byte sectors after them."""
    leaves = [(16, 32, 8), (32, 32, 8), (16, 64, 8), (16, 32, 4),
              (32, 32, 4), (16, 64, 4), (8, 32, 4), (8, 64, 4),
              (4, 256, 8), (2, 512, 8), (1, 1024, 8)]
    score = {f: float(tr_mod._score({"bm": f[0], "bn": f[1], "M": M,
                                     "N": N, "CORES": 132}, f[2], True))
             for f in leaves}
    assert sorted(leaves[:6], key=lambda f: -score[f]) == leaves[:6]
    assert min(score[f] for f in leaves[:6]) > max(score[f]
                                                    for f in leaves[6:])
    assert sorted(leaves[8:], key=lambda f: -score[f]) == leaves[8:]


@pytest.mark.parametrize("M,bm,want", [(4096, 16, 1.0), (4096, 8, 0.5),
                                       (4096, 1, 1 / 16), (3000, 16, 2 / 3),
                                       (3000, 32, 0.8), (1001, 32, 32 / 47)])
def test_transpose_napkin_sector_fill(M, bm, want):
    """The stores' useful share of the 32-byte sectors they touch: a bf16
    B row segment of 2·bm bytes, B's rows 2·M bytes apart (3000 rows start
    16 bytes into a sector every other row, 1001 rows on any even byte).
    """
    assert tr_mod._sector_fill(M, 2 * bm) == pytest.approx(want)


@pytest.mark.parametrize("B,s,F,cached", [
    (256, 1, 1, True), (32, 8, 2, True), (1024, 2, 32, True),
    (256, 4, 4, True), (64, 1, 1, False), (128, 4, 1, False)])
def test_jacobi_every_block_format_same_result(B, s, F, cached):
    jx, tx = _pair(_np((1000,), SEED + 200), "float32")
    got = jacobi1d_h100(tx, 3, B=B, s=s, F=F, cached=cached)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.jacobi1d(jx, 3)))


@pytest.mark.parametrize("F", jac_mod.FUSE_DOMAIN)
@pytest.mark.parametrize("steps", [0, 1, 3, 4, 5, 17])
def test_jacobi_launch_plan(steps, F):
    """A call of ``steps`` sweeps is ceil(steps / F) launches, each of F
    sweeps but the last, which runs what is left; 0 steps launch none."""
    depths = jac_mod.launch_plan(steps, F)
    assert len(depths) == math.ceil(steps / F) and sum(depths) == steps
    assert all(d == F for d in depths[:-1])
    assert all(1 <= d <= F for d in depths)


@pytest.mark.parametrize("n", [3, 1026, (1 << 21) + 2])
@pytest.mark.parametrize("depth", [1, 4])
def test_jacobi_roofline_counts_one_read_and_one_write(n, depth):
    """A K6 launch of any depth counts x read once and y written once (4·n
    bytes each) and 3 flops (two adds, a division) a point a sweep at the
    f32 rate: the least work of its sweeps."""
    from repro_torch.launch import roofline
    sig = (n, 256, 4, 4, depth, True, torch.float32)
    nbytes, flops, peak = roofline.work("jacobi1d_h100", sig)
    assert (nbytes, flops) == (4 * n + 4 * n, depth * 3.0 * (n - 2))
    assert peak == roofline.PEAK_FLOPS[torch.float32] == 67e12


@pytest.mark.parametrize("n", [(1 << 15) + 2, (1 << 21) + 2])
def test_jacobi_picks_run_the_case_study_call_in_one_launch(n):
    """The napkin's picks at the case-study sizes fuse at least the 4
    sweeps of a call (F >= 4), cached at full grain; every candidate of
    the uncached leaf runs one sweep a launch (F = 1)."""
    from repro_torch.core.select import enumerate_candidates
    cand = ops.select("jacobi1d_h100", {"N": n})
    assert cand.plan.flags["smem_cache"] and cand.assignment["F"] >= 4
    assert len(jac_mod.launch_plan(4, cand.assignment["F"])) == 1
    small = dataclasses.replace(tcore_params.H100_SXM, vmem_bytes=0)
    got = enumerate_candidates(jac_mod.FAMILY, small, {"N": n})
    assert got and all(not c.plan.flags["smem_cache"]
                       and c.assignment["F"] == 1 for c in got)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_jacobi_without_interior_returns_x(n):
    """n < 3 has no interior point: x comes back, as from the oracle."""
    x = torch.from_numpy(_np((n,), SEED + 210))
    got = ops.jacobi1d(x, 3)
    assert torch.equal(got, x) and got is not x
    assert torch.equal(ref.jacobi1d(x, 3), x)


# ---------------------------------------------------------------------------
# Wrappers: plain version only for CPU tensors, kernel or raise otherwise
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    m0, f0 = matmul_h100.launches, flash_attention_h100.launches
    s0 = ssd_scan_h100.launches
    a = torch.ones(4, 8)
    assert torch.equal(matmul_h100(a, a.T.contiguous(), bm=16, bn=32, bk=32,
                                   s=1, kb=2, stages=4),
                       matmul_plain(a, a.T.contiguous(), bm=16, bn=32, bk=32,
                                    s=1, kb=2, stages=4))
    q = torch.ones(1, 2, 8)
    flash_attention_h100(q, q, q, bq=16, bkv=32, kv_chunk=64)
    x = torch.ones(1, 3, 2, 8)
    ssd_scan_h100(x, torch.full((1, 3, 2), 0.5), x[..., :4], x[..., :4],
                  chunk=16, bd=8)
    c0 = (matadd_h100.launches, transpose_h100.launches,
          jacobi1d_h100.launches)
    assert torch.equal(matadd_h100(a, a, bm=1, bn=32, s=2),
                       matadd_plain(a, a, bm=1, bn=32, s=2))
    assert torch.equal(transpose_h100(a, bm=32, bn=32, s=1),
                       transpose_plain(a, bm=32, bn=32, s=1))
    v = torch.arange(10.0)
    assert torch.equal(jacobi1d_h100(v, 2, B=32, s=1),
                       jacobi1d_plain(v, 2, B=32, s=1))
    assert (matmul_h100.launches, flash_attention_h100.launches,
            ssd_scan_h100.launches) == (m0, f0, s0)
    assert (matadd_h100.launches, transpose_h100.launches,
            jacobi1d_h100.launches) == c0


def test_kernel_path_refuses_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    a = torch.ones(4, 8)
    with pytest.raises(ValueError):
        mm_mod._launch(a, a.T, bm=16, bn=32, bk=32, s=1, kb=2, stages=4,
                       cached=True)
    with pytest.raises(ValueError):
        fa_mod._launch(a[None], a[None], a[None], bq=16, bkv=32,
                       kv_chunk=64)
    x = torch.ones(1, 3, 2, 8)
    with pytest.raises(ValueError):
        ssd_mod._launch(x, torch.full((1, 3, 2), 0.5), x[..., :4],
                        x[..., :4], chunk=16, bd=8)
    from repro_torch.kernels import matadd as add_mod
    from repro_torch.kernels import transpose as tr_mod
    with pytest.raises(ValueError):
        add_mod._launch(a, a, bm=1, bn=32, s=2)
    with pytest.raises(ValueError):
        tr_mod._launch(a, bm=32, bn=32, s=1)
    with pytest.raises(ValueError):
        jac_mod._launch(torch.ones(10), 2, B=32, s=1)


# ---------------------------------------------------------------------------
# Training: K2b's plain version, K1's backward, K2b's tree, the warm set
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.autograd import AttentionFn, MatmulFn


def _bwd_case(rows, h, hk, sq, page, d, lens, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return (t(rows, h, sq, d), t(rows, page, hk, d), t(rows, page, hk, d),
            t(rows, h, sq, d), torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("rows,h,hk,sq,page,d,causal,window,lens", [
    (2, 8, 2, 24, 24, 16, True, None, [24, 24]),       # GQA, causal
    (2, 4, 4, 20, 20, 32, False, None, [20, 20]),      # non-causal
    (2, 6, 3, 40, 40, 16, True, 9, [40, 31]),          # window
    (3, 4, 2, 12, 30, 16, True, None, [30, 0, 17]),    # ragged, a 0 row
    (2, 4, 2, 7, 33, 16, False, None, [33, 20]),       # sq < page
])
def test_flash_bwd_plain_matches_autograd_of_k2_plain(rows, h, hk, sq, page,
                                                      d, causal, window,
                                                      lens):
    """K2b's plain version (direct softmax gradients) against autograd of
    K2's paged plain version (online softmax over key tiles and splits),
    f32, ``rtol = atol = 1e-5``: the same function's gradients summed in
    another order.  A row of length 0 gets zero gradients."""
    q, k, v, do, ln = _bwd_case(rows, h, hk, sq, page, d, lens, 11)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    tables = torch.arange(rows, dtype=torch.int32)[:, None]
    o = flash_attention_paged_plain(q, k, v, tables, ln, bq=16, bkv=32,
                                    kv_chunk=64, causal=causal,
                                    window=window)
    o.backward(do)
    got = fab.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o.detach(), do, ln, bq=16, bkv=16,
                                        causal=causal, window=window)
    for g, x in zip(got, (q, k, v)):
        torch.testing.assert_close(g, x.grad, rtol=1e-5, atol=1e-5)
    if 0 in lens:
        r = lens.index(0)
        assert not got[0][r].any() and not got[1][r].any() \
            and not got[2][r].any()


def test_attention_fn_bwd_is_k2b_through_ops():
    """``AttentionFn``: K2's paged entry forward, K2b's backward, through
    the dispatch (plain versions on the CPU)."""
    q, k, v, do, ln = _bwd_case(2, 4, 2, 16, 16, 16, [16, 11], 12)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = AttentionFn.apply(q, k, v, None, ln, True, None)
    o.backward(do)
    want = ops.attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                             do, ln, causal=True)
    for g, x in zip(want, (q, k, v)):
        assert torch.equal(g, x.grad)


def test_attention_fn_bwd_refuses_a_paged_pool():
    q, k, v, _, ln = _bwd_case(2, 4, 2, 8, 8, 16, [8, 8], 13)
    swapped = torch.tensor([[1], [0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="paged pool has no backward"):
        AttentionFn.apply(q, k, v, swapped, ln, True, None)
    AttentionFn.apply(q, k, v, torch.tensor([[0], [1]], dtype=torch.int32),
                      ln, True, None)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_matmul_fn_bwd_matches_autograd_of_matmul_plain(dtype, tol):
    """dA = K1(dC, K4(B)) and dB = K1(K4(A), dC) against autograd of
    ``matmul_plain``.  f32 at 1e-5 of the largest gradient (sums in
    another order); bf16 at 2e-2 of it, since ``MatmulFn`` rounds dC to
    the operands' type first (a bf16 cotangent, as the JAX bf16 einsum's)
    and its gradients to bf16 (2^-8 of an element)."""
    rng = np.random.default_rng(5)
    a0 = torch.from_numpy(rng.standard_normal((48, 80)).astype(np.float32))
    b0 = torch.from_numpy((rng.standard_normal((80, 40)) / 9
                           ).astype(np.float32))
    dc = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    a, b = (x.to(dtype).requires_grad_() for x in (a0, b0))
    MatmulFn.apply(a, b).backward(dc)
    a2, b2 = (x.to(dtype).requires_grad_() for x in (a0, b0))
    matmul_plain(a2, b2, bm=16, bn=32, bk=32, s=1).backward(dc)
    assert a.grad.dtype == b.grad.dtype == dtype
    for got, want in ((a.grad, a2.grad), (b.grad, b2.grad)):
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("data", [
    {"SQ": 24, "HD": 16, "GROUP": 4, "HK": 2},
    {"SQ": 100, "HD": 128, "GROUP": 4, "HK": 8},
    {"SQ": 64, "HD": 64, "GROUP": 1, "HK": 20}])
def test_flash_bwd_every_feasible_leaf_same_gradients(data):
    """Every candidate of K2b's tree at a key passes the entry point's
    checks (``format_error``) and, through ``instantiate(..., "cpu")``,
    gives the plain version's gradients: the tiles shape the launch only."""
    from repro_torch.core.select import enumerate_candidates
    from repro_torch.core.params import H100_SXM
    sq, d, hk = data["SQ"], data["HD"], data["HK"]
    h = data["GROUP"] * hk
    q, k, v, do, ln = _bwd_case(2, h, hk, sq, sq, d, [sq, sq - 3], 14)
    o = torch.from_numpy(np.random.default_rng(15).standard_normal(
        q.shape).astype(np.float32))
    cands = enumerate_candidates(fab.FAMILY, H100_SXM, data)
    assert len(cands) == len(fab.BQ) * len(fab.BKV)
    want = None
    for c in cands:
        a = c.assignment
        assert fab.format_error(2, h, hk, sq, sq, d, a["bq"], a["bkv"],
                                torch.bfloat16) is None
        fn = fab.FAMILY.instantiate(c.plan, a, "cpu",
                                    leaf_index=c.leaf_index)
        got = fn(q, k, v, o, do, ln, causal=True)
        want = want or got
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_flash_bwd_format_error_mirrors_the_entry_point():
    ok = dict(rows=2, h=8, hk=2, sq=64, page=64, d=128, bq=64, bkv=64,
              dtype=torch.bfloat16)
    assert fab.format_error(**ok) is None
    for bad, why in (({"h": 6, "hk": 4}, "multiple"), ({"d": 160}, "d not"),
                     ({"bq": 128}, "bq not"), ({"dtype": torch.float16},
                                               "f32 or bf16"),
                     ({"rows": 70_000}, "65,535"), ({"bkv": 128}, "bkv not"),
                     ({"d": 0}, "d not"), ({"sq": 0}, "empty"),
                     ({"h": 70_000, "hk": 70_000}, "65,535")):
        assert why in fab.format_error(**{**ok, **bad})
    assert fab.smem_bytes(64, 64, 128) <= 232_448
    # a d off the 16-byte grain (the element loads) and f32 are taken
    assert fab.format_error(**{**ok, "d": 100}) is None
    assert fab.format_error(**{**ok, "dtype": torch.float32}) is None


@pytest.mark.parametrize("name,data", [
    ("llama3-8b training", {"SQ": 1024, "HD": 128, "GROUP": 4, "HK": 8}),
    ("whisper encoder", {"SQ": 1500, "HD": 64, "GROUP": 1, "HK": 20})])
def test_flash_bwd_napkin_pick_is_a_feasible_leaf_that_fits(name, data):
    """The napkin's pick at llama3-8b's training key and whisper's encoder
    key is a leaf of the domain that the entry point takes, whose counters
    (shared bytes, threads, registers of the larger body) fit the H100, and
    whose blocks of each kernel fit an SM by shared memory and registers."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    pick = rank_candidates(fab.FAMILY, H100_SXM, data)[0]
    a = pick.assignment
    assert a["bq"] in fab.BQ and a["bkv"] in fab.BKV
    h = data["GROUP"] * data["HK"]
    assert fab.format_error(4, h, data["HK"], data["SQ"], data["SQ"],
                            data["HD"], a["bq"], a["bkv"],
                            torch.bfloat16) is None
    pt = {**a, **data, **H100_SXM.bindings()}
    limits = {"smem_bytes": H100_SXM.vmem_bytes,
              "threads": H100_SXM.threads_per_block,
              "registers": H100_SXM.vreg_budget}
    for counter, limit in limits.items():
        num, den = fab.FAMILY.counter_value(pick.plan, counter)
        assert num.eval(pt) / den.eval(pt) <= limit, (name, counter)
    dt = fab.tile_dim(data["HD"])
    assert fab.tc_smem_bytes(a["bq"], a["bkv"], dt) <= H100_SXM.vmem_bytes
    assert max(fab.TC_REGISTERS[dt]) <= H100_SXM.vreg_budget
    # at both keys the napkin takes the largest tiles, as the card does
    assert (a["bq"], a["bkv"]) == (64, 64)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bwd_smem_counter_is_the_larger_body(hd):
    """At every leaf the ``smem_bytes`` counter equals the shared bytes of
    the larger of K2b's two bodies: the FMA body's, which is at least the
    tensor-core body's largest kernel."""
    plan = fab.FAMILY.initial_plan()
    num, den = fab.FAMILY.counter_value(plan, "smem_bytes")
    for bq, bkv in itertools.product(fab.BQ, fab.BKV):
        pt = {"bq": bq, "bkv": bkv, "HD": hd}
        larger = max(fab.f32_smem_bytes(bq, bkv, hd),
                     fab.tc_smem_bytes(bq, bkv, hd))
        assert num.eval(pt) / den.eval(pt) == larger \
            == fab.smem_bytes(bq, bkv, hd), (bq, bkv)
        assert fab.f32_smem_bytes(bq, bkv, hd) >= \
            fab.tc_smem_bytes(bq, bkv, hd)


def test_flash_bwd_tunes_on_the_cpu(tmp_path, capsys):
    """``tune_artifacts`` over K2b's family (``--device cpu``: the plain
    version timed, a smoke): its table compiles, every candidate measures
    and the table comes back with the tuning sections."""
    from repro_torch.artifacts.store import ArtifactStore
    from repro_torch.launch import tune_artifacts
    assert tune_artifacts.main([
        "--family", "flash_attention_bwd_h100", "--out", str(tmp_path),
        "--quick", "--device", "cpu", "--iters", "1", "--top-k", "2"]) == 0
    assert "[OK] flash_attention_bwd_h100/h100_sxm: 2/2 candidates " \
        "measured" in capsys.readouterr().out
    table = ArtifactStore(tmp_path).load_dispatch("flash_attention_bwd_h100",
                                                  "h100_sxm")
    assert table["measured_ranks"] and "compaction" in table


@pytest.mark.parametrize("arch", ["llama3_8b", "whisper_large_v3",
                                  "llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_train_warm_set_leaves_no_cold_build(arch):
    """After ``warm_train_dispatch`` a train step (microbatches 2) resolves
    nothing cold, and the (family, key) pairs it asks for are exactly the
    traced ones (F5): K1's forward, dA and dB keys, K4's transposes, K2's
    and K2b's keys; for the MoE configs the router's and, through the
    batched entries of K1 and K4, the experts'."""
    from repro_torch.artifacts.dispatch import DispatchCache, set_default_cache
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, constant
    from repro_torch.plans.trace import trace_train_warm_set
    from repro_torch.runtime import build_train_step, warm_train_dispatch
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    cache = DispatchCache()
    set_default_cache(cache)
    try:
        warm_train_dispatch(cfg, global_batch=4, seq=16, microbatches=2)
        cold = cache.stats.cold_builds
        params = init_train_state(cfg, device="cpu")
        opt = adamw(constant(1e-3))
        step = build_train_step(cfg, opt, microbatches=2)
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)),
                 "labels": rng.integers(0, cfg.vocab, (4, 16))}
        if cfg.encoder is not None:
            batch["enc_embeds"] = rng.standard_normal(
                (4, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
        with cache.record() as rec:
            step(params, opt.init(params), batch, 0)
        assert cache.stats.cold_builds == cold
        traced = {(op.family, op.data) for op in trace_train_warm_set(
            cfg, global_batch=4, seq=16, microbatches=2)}
        seen = {(f, items) for f, _, items in rec.requests}
        assert seen == traced
        families = {f for f, _ in seen}
        assert families == {"matmul_h100", "transpose_h100",
                            "flash_attention_h100",
                            "flash_attention_bwd_h100"}
    finally:
        set_default_cache(None)
