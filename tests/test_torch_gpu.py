"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``: they carry the ``gpu`` marker
and skip where there is no card.  The file imports nothing of JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances, kernel against plain version on the same inputs:

- f32 and bf16 matmul: rtol 1e-4 / atol 8e-4.  A bf16 product is exact in
  f32, so both types differ only by the order of the f32 sums (the plain
  version sums each k tile with cuBLAS, TF32 off; the kernel sums in order).
- f32 attention: 1e-4, the same online softmax with ``expf`` against
  ``torch.exp`` and another summation order.
- bf16 attention: 1e-2, one bf16 rounding step (2^-7) of the output, which
  both versions compute in f32 and round once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention_h100,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul import matmul_h100, matmul_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(shape, seed, dev, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.gpu
def test_gpu_kernels_build(cuda):
    assert build.build_all() >= 0
    assert set(build.SOURCES) <= set(build._LIBS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,bn,bk,s,cached", [
    (8, 64, 32, 2, True), (8, 64, 32, 2, False), (1, 256, 64, 1, True),
    (4, 32, 16, 16, True), (32, 32, 128, 4, True), (16, 64, 64, 8, False)])
def test_gpu_matmul_kernel_matches_plain(cuda, dtype, bm, bn, bk, s, cached):
    a = _t((37, 300), 7, cuda, dtype)
    b = _t((300, 333), 8, cuda, dtype)
    n0 = matmul_h100.launches
    got = matmul_h100(a, b, bm=bm, bn=bn, bk=bk, s=s, cached=cached)
    torch.cuda.synchronize()
    assert matmul_h100.launches == n0 + 1
    want = matmul_plain(a, b, bm=bm, bn=bn, bk=bk, s=s)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("sq,sk,bq,bkv,causal,window", [
    (9, 70, 4, 32, True, None), (9, 70, 4, 32, False, None),
    (9, 70, 4, 32, True, 16), (1, 200, 1, 64, True, None),
    (3, 61, 8, 128, True, None), (32, 200, 8, 64, False, None)])
def test_gpu_flash_kernel_matches_plain(cuda, dtype, tol, sq, sk, bq, bkv,
                                        causal, window):
    q = _t((4, sq, 128), 9, cuda, dtype)
    k = _t((4, sk, 128), 10, cuda, dtype)
    v = _t((4, sk, 128), 11, cuda, dtype)
    n0 = flash_attention_h100.launches
    got = flash_attention_h100(q, k, v, bq=bq, bkv=bkv, causal=causal,
                               window=window)
    torch.cuda.synchronize()
    assert flash_attention_h100.launches == n0 + 1 and got.dtype == dtype
    want = flash_attention_plain(q, k, v, bq=bq, bkv=bkv, causal=causal,
                                 window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_gpu_wrappers_raise_instead_of_falling_back(cuda):
    a = _t((8, 16), 1, cuda)
    with pytest.raises(ValueError):                     # not contiguous
        matmul_h100(a.T, a, bm=4, bn=32, bk=16, s=1)
    with pytest.raises(TypeError):                      # mixed types
        matmul_h100(a, a.T.contiguous().half(), bm=4, bn=32, bk=16, s=1)
    q = _t((2, 4, 256), 2, cuda)                        # head dim > 128
    with pytest.raises(ValueError):
        flash_attention_h100(q, q, q, bq=1, bkv=32)
