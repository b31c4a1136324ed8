"""K1 and K2 of the port against the JAX package, on the CPU.

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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_h100
from repro_torch.kernels.matmul import matmul_h100, matmul_plain

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
# Wrappers: plain version only for CPU tensors, kernel or raise otherwise
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    m0, f0 = matmul_h100.launches, flash_attention_h100.launches
    a = torch.ones(4, 8)
    assert torch.equal(matmul_h100(a, a.T.contiguous(), bm=4, bn=32, bk=16,
                                   s=1),
                       matmul_plain(a, a.T.contiguous(), bm=4, bn=32, bk=16,
                                    s=1))
    q = torch.ones(1, 2, 8)
    flash_attention_h100(q, q, q, bq=1, bkv=32)
    assert (matmul_h100.launches, flash_attention_h100.launches) == (m0, f0)


def test_kernel_path_refuses_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import matmul as mm_mod
    a = torch.ones(4, 8)
    with pytest.raises(ValueError):
        mm_mod._launch(a, a.T, bm=4, bn=32, bk=16, s=1, cached=True)
    with pytest.raises(ValueError):
        fa_mod._launch(a[None], a[None], a[None], bq=1, bkv=32)
