"""K1-K6 of the port against the JAX package, on the CPU.

The same inputs, drawn with numpy from a seed, go through the JAX op (its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
the port's op, which on CPU tensors runs the kernel's plain version under
the leaf the H100 dispatch picks.  The CUDA kernels themselves are checked
on the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import pallas_flash_attention
from repro.kernels.jacobi1d import pallas_jacobi1d
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_h100
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


@pytest.mark.parametrize("bm,bn,bk,s,cached", [
    (1, 32, 16, 1, True), (4, 64, 32, 2, True), (8, 32, 64, 4, False),
    (16, 64, 128, 16, True), (64, 256, 16, 1, False)])
def test_matmul_every_block_format_same_product(bm, bn, bk, s, cached):
    """Every (block format, grain, caching) leaf computes the same product
    (paper Def. 2 ii), held against the JAX oracle."""
    ja, ta = _pair(_np((96, 200), SEED + 2), "float32")
    jb, tb = _pair(_np((200, 130), SEED + 3), "float32")
    got = matmul_h100(ta, tb, bm=bm, bn=bn, bk=bk, s=s, cached=cached)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.matmul(ja, jb)),
                               rtol=1e-4, atol=1e-3)


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


@pytest.mark.parametrize("bq,bkv", [(1, 32), (8, 64), (32, 128), (2, 256)])
def test_flash_every_tile_shape_same_result(bq, bkv):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 40, 130, 16, SEED + 50)
    want = jref.flash_attention(jq, jk, jv, causal=True, window=50)
    got = flash_attention_h100(tq, tk, tv, bq=bq, bkv=bkv, causal=True,
                               window=50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


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


@pytest.mark.parametrize("chunk,bd", [(1, 8), (16, 16), (32, 64), (64, 8),
                                      (128, 32), (256, 16)])
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


@pytest.mark.parametrize("B,s,cached", [
    (256, 1, True), (32, 8, True), (1024, 2, True), (64, 1, False),
    (128, 4, False)])
def test_jacobi_every_block_format_same_result(B, s, cached):
    jx, tx = _pair(_np((1000,), SEED + 200), "float32")
    got = jacobi1d_h100(tx, 3, B=B, s=s, cached=cached)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.jacobi1d(jx, 3)))


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
    assert torch.equal(matmul_h100(a, a.T.contiguous(), bm=4, bn=32, bk=16,
                                   s=1),
                       matmul_plain(a, a.T.contiguous(), bm=4, bn=32, bk=16,
                                    s=1))
    q = torch.ones(1, 2, 8)
    flash_attention_h100(q, q, q, bq=1, bkv=32)
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
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    a = torch.ones(4, 8)
    with pytest.raises(ValueError):
        mm_mod._launch(a, a.T, bm=4, bn=32, bk=16, s=1, cached=True)
    with pytest.raises(ValueError):
        fa_mod._launch(a[None], a[None], a[None], bq=1, bkv=32)
    x = torch.ones(1, 3, 2, 8)
    with pytest.raises(ValueError):
        ssd_mod._launch(x, torch.full((1, 3, 2), 0.5), x[..., :4],
                        x[..., :4], chunk=16, bd=8)
    from repro_torch.kernels import jacobi1d as jac_mod
    from repro_torch.kernels import matadd as add_mod
    from repro_torch.kernels import transpose as tr_mod
    with pytest.raises(ValueError):
        add_mod._launch(a, a, bm=1, bn=32, s=2)
    with pytest.raises(ValueError):
        tr_mod._launch(a, bm=32, bn=32, s=1)
    with pytest.raises(ValueError):
        jac_mod._launch(torch.ones(10), 2, B=32, s=1)
