"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``: they carry the ``gpu`` marker
and skip where there is no card.  The file imports nothing of JAX, so it
runs on a machine that has only PyTorch (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Tolerances, kernel against plain version on the same inputs:

- f32 and bf16 matmul: rtol 1e-4 / atol 8e-4.  A bf16 product is exact in
  f32, so both types differ only by the order of the f32 sums (the plain
  version sums each k tile with cuBLAS, TF32 off; the kernel sums in order).
- f32 attention: 1e-4, the same online softmax with ``expf`` against
  ``torch.exp`` and another summation order.
- bf16 attention: 1e-2, one bf16 rounding step (2^-7) of the output, which
  both versions compute in f32 and round once.
- SSD scan: 1e-3 on the f32 state and on an f32 y (the same chunk math
  summed in another order, ``expf``/``logf`` against ``torch.exp``/``log``,
  over sums of up to ``chunk`` terms of O(1)); 1e-2 on a bf16 y, one bf16
  step, as for attention.
- matadd and transpose: bit for bit (``torch.equal``).  A transpose moves
  raw bits; a sum is one f32 add rounded once to the element type on both
  sides.
- Jacobi: bit for bit.  Both add the left pair first and divide by 3 as
  IEEE says (the kernel is built without fast math; the plain version
  divides by a tensor, not by a Python scalar).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (flash_attention_h100,
                                                 flash_attention_plain)
from repro_torch.kernels.instantiate_cache import grain
from repro_torch.kernels.jacobi1d import jacobi1d_h100, jacobi1d_plain
from repro_torch.kernels.matadd import matadd_h100, matadd_plain
from repro_torch.kernels.matmul import matmul_h100, matmul_plain
from repro_torch.kernels.ssd_scan import ssd_scan_h100, ssd_scan_plain
from repro_torch.kernels.transpose import transpose_h100, transpose_plain


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


def _ssd_inputs(rows, seq, heads, hd, state, dev, dtype, shared=True):
    rng = np.random.default_rng(rows * 1000 + seq)
    x = _t((rows, seq, heads, hd), rng.integers(1 << 30), dev, dtype)
    a = torch.sigmoid(_t((rows, seq, heads), 3, dev)) * 0.9 + 0.05
    bc_shape = (rows, seq, state) if shared else (rows, seq, heads, state)
    b = _t(bc_shape, 4, dev, dtype)
    c = _t(bc_shape, 5, dev, dtype)
    s0 = _t((rows, heads, state, hd), 6, dev)
    return x, a, b, c, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rows,seq,heads,hd,state,chunk,bd,with_state", [
    (4, 1, 24, 64, 128, 64, 16, True),        # mamba decode step
    (1, 256, 24, 64, 128, 64, 16, True),      # mamba prefill chunk
    (1, 200, 25, 64, 16, 128, 16, False),     # hymba, seq no chunk multiple
    (2, 37, 3, 20, 8, 16, 8, True),           # ragged hd tile
    (1, 77, 2, 64, 128, 128, 32, False),      # largest chunk V allows
    (3, 5, 4, 16, 8, 32, 64, True)])          # tile wider than hd
def test_gpu_ssd_kernel_matches_plain(cuda, dtype, tol, rows, seq, heads, hd,
                                      state, chunk, bd, with_state):
    x, a, b, c, s0 = _ssd_inputs(rows, seq, heads, hd, state, cuda, dtype)
    s0 = s0 if with_state else None
    n0 = ssd_scan_h100.launches
    y, s1 = ssd_scan_h100(x, a, b, c, s0, chunk=chunk, bd=bd)
    torch.cuda.synchronize()
    assert ssd_scan_h100.launches == n0 + 1 and y.dtype == dtype
    wy, ws = ssd_scan_plain(x, a, b, c, s0, chunk=chunk, bd=bd)
    torch.testing.assert_close(s1, ws, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_gpu_ssd_kernel_per_head_bc_equals_shared(cuda):
    x, a, b, c, s0 = _ssd_inputs(2, 40, 3, 32, 16, cuda, torch.float32)
    heads = x.shape[2]
    y1, s1 = ssd_scan_h100(x, a, b, c, s0, chunk=16, bd=16)
    full = [t[:, :, None, :].expand(-1, -1, heads, -1).contiguous()
            for t in (b, c)]
    y2, s2 = ssd_scan_h100(x, a, *full, s0, chunk=16, bd=16)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,bm,bn,s", [
    (1024, 1024, 1, 256, 2), (300, 700, 1, 256, 2), (300, 700, 32, 32, 1),
    (37, 1000, 8, 128, 1), (513, 65, 2, 512, 2),
    (1, 1 << 25, 1, 256, 2)])                  # 65,536 column blocks
def test_gpu_matadd_kernel_matches_plain(cuda, dtype, M, N, bm, bn, s):
    a, b = _t((M, N), 12, cuda, dtype), _t((M, N), 13, cuda, dtype)
    n0 = matadd_h100.launches
    got = matadd_h100(a, b, bm=bm, bn=bn, s=s)
    torch.cuda.synchronize()
    assert matadd_h100.launches == n0 + 1 and got.dtype == dtype
    assert torch.equal(got, matadd_plain(a, b, bm=bm, bn=bn, s=s))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,bm,bn,s,cached", [
    (1024, 1024, 32, 32, 1, True), (300, 700, 32, 32, 4, True),
    (300, 700, 8, 128, 2, True), (300, 700, 1, 1024, 8, True),
    (300, 700, 32, 32, 1, False), (77, 1000, 4, 64, 2, False),
    (3, (1 << 22) + 5, 8, 32, 1, True), (4, 1 << 22, 8, 32, 1, False)])
def test_gpu_transpose_kernel_matches_plain(cuda, dtype, M, N, bm, bn, s,
                                            cached):
    a = _t((M, N), 14, cuda, dtype)
    n0 = transpose_h100.launches
    got = transpose_h100(a, bm=bm, bn=bn, s=s, cached=cached)
    torch.cuda.synchronize()
    assert transpose_h100.launches == n0 + 1 and got.shape == (N, M)
    assert torch.equal(got, transpose_plain(a, bm=bm, bn=bn, s=s))


@pytest.mark.gpu
@pytest.mark.parametrize("op,shape", [("matadd", (1, 1 << 25)),
                                      ("transpose", (4, 1 << 25))])
def test_gpu_ops_launch_past_65535_column_blocks(cuda, op, shape):
    """A thin operand whose pick has more than 65,535 column blocks (the
    cap of a grid's y count) launches through ``ops``: the entry point
    then launches once for each 65,535 column blocks."""
    M, N = shape
    cand = ops.select(f"{op}_h100", {"M": M, "N": N})
    a = cand.assignment
    assert -(-N // (a["bn"] * grain(cand.plan, a["s"]))) > 65535
    x = _t(shape, 16, cuda)
    if op == "matadd":
        got, want = ops.matadd(x, x.flip(1)), x + x.flip(1)
    else:
        got, want = ops.transpose(x), x.t().contiguous()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,steps,B,s,cached", [
    (32770, 4, 256, 1, True), (1026, 3, 128, 4, True), (3, 2, 32, 1, True),
    (1000, 5, 1024, 8, True), (1026, 3, 64, 1, False),
    (32770, 2, 128, 2, False), (1026, 0, 256, 1, True)])
def test_gpu_jacobi_kernel_matches_plain(cuda, n, steps, B, s, cached):
    x = _t((n,), 15, cuda)
    n0 = jacobi1d_h100.launches
    got = jacobi1d_h100(x, steps, B=B, s=s, cached=cached)
    torch.cuda.synchronize()
    assert jacobi1d_h100.launches == n0 + steps
    want = jacobi1d_plain(x, steps, B=B, s=s, cached=cached)
    assert torch.equal(got, want)


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
    x, a, b, c, _ = _ssd_inputs(1, 300, 2, 16, 8, cuda, torch.float32)
    with pytest.raises(TypeError):                      # bf16 decay
        ssd_scan_h100(x, a.bfloat16(), b, c, chunk=16, bd=16)
    with pytest.raises(RuntimeError):                   # 256² scores > V
        ssd_scan_h100(x, a, b, c, chunk=256, bd=16)
    m = _t((8, 64), 3, cuda)
    with pytest.raises(TypeError):                      # mixed types
        matadd_h100(m, m.bfloat16(), bm=1, bn=32, s=2)
    with pytest.raises(ValueError):                     # not contiguous
        matadd_h100(m.T, m.T, bm=1, bn=32, s=2)
    with pytest.raises(TypeError):                      # 8-byte elements
        transpose_h100(m.double(), bm=32, bn=32, s=1)
    with pytest.raises(RuntimeError):                   # 2048 threads > T
        transpose_h100(m, bm=32, bn=64, s=1)
    with pytest.raises(TypeError):                      # f32 only
        jacobi1d_h100(m[0].bfloat16(), 2, B=32, s=1)
    with pytest.raises(ValueError):                     # not a vector
        jacobi1d_h100(m, 2, B=32, s=1)
