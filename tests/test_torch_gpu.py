"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``: they carry the ``gpu`` marker
and skip where there is no card.  The file imports nothing of JAX, so it
runs on a machine that has only PyTorch (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Tolerances, kernel against plain version on the same inputs:

- f32 and bf16 matmul: rtol 1e-4 / atol 8e-4.  A bf16 product is exact in
  f32, so both types differ only by the order of the f32 sums inside a k
  tile (the plain version sums each tile with cuBLAS, TF32 off; the kernel
  on the tensor cores or in FMA); both add the tiles of a split, then the
  splits, in the same order.
- f32 attention: 1e-4, the same online softmax and split combine with
  ``expf`` against ``torch.exp`` and another summation order; the paged
  entry the same, with a bf16 pool upcast alike on both sides.
- bf16 attention: 1e-2, one bf16 rounding step (2^-7) of the output, which
  both versions compute in f32 and round once, and the kernel's P rounded
  to bf16 for the tensor cores (2^-9 relative, averaged over the keys).
- SSD scan: 1e-3 on the f32 state and on an f32 y (the same recurrence,
  chunk math or step by step, summed in another order, ``expf``/``logf``
  against ``torch.exp``/``log``, over sums of up to ``chunk`` terms of
  O(1)); 1e-2 on a bf16 y, one bf16 step, as for attention.  The bf16
  chunk body feeds G, S and w⊙b to the tensor cores as a high and a low
  bf16 part (~16 bits), so it also holds y within 2^-6 by relative
  Frobenius error.
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
                                                 flash_attention_h100_paged,
                                                 flash_attention_paged_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.instantiate_cache import grain
from repro_torch.kernels.jacobi1d import jacobi1d_h100, jacobi1d_plain
from repro_torch.kernels.jacobi1d import launch as jac_launch
from repro_torch.kernels.jacobi1d import launch_plan
from repro_torch.kernels.matadd import matadd_h100, matadd_plain
from repro_torch.kernels.matmul import (matmul_batched_plain, matmul_h100,
                                        matmul_h100_batched, matmul_plain)
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


#: (bm, bn, bk, s) formats the K1 tests cycle through: both grains, both
#: depths, 64 to 1024 threads a block.
MM_FORMATS = [(16, 32, 32, 1), (16, 128, 64, 2), (32, 64, 32, 2),
              (64, 128, 64, 2), (16, 256, 32, 1), (48, 64, 64, 1)]


def _mm_inputs(M, K, N, dev, dtype, seed=7):
    return _t((M, K), seed, dev, dtype), _t((K, N), seed + 1, dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 17, 256])
@pytest.mark.parametrize("N", [25, 333, 32001])
def test_gpu_matmul_kernel_matches_plain(cuda, dtype, M, N):
    """Every split (kb 1, 3, 16: K = 300 is 10 tiles of 32 or 5 of 64, so
    kb 16 leaves empty splits) and ring depth (stages 1, 2, 4) at ragged M
    and N; N = 25 and 32001 take the masked load of B."""
    a, b = _mm_inputs(M, 300, N, cuda, dtype)
    for i, (kb, stages) in enumerate([(kb, st) for kb in (1, 3, 16)
                                      for st in (1, 2, 4)]):
        bm, bn, bk, s = MM_FORMATS[(i + M + N) % len(MM_FORMATS)]
        kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages)
        n0 = matmul_h100.launches
        got = matmul_h100(a, b, **kw)
        torch.cuda.synchronize()
        assert matmul_h100.launches == n0 + 1
        torch.testing.assert_close(got, matmul_plain(a, b, **kw), rtol=1e-4,
                                   atol=8e-4, msg=str(kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_matmul_misaligned_operands(cuda, dtype):
    """Operands whose storage starts 2 or 4 bytes past a 16-byte boundary,
    and K no multiple of 8, take the masked loads and agree."""
    M, K, N = 5, 203, 96
    a0 = _t((M * K + 1,), 3, cuda, dtype)[1:].view(M, K)
    b0 = _t((K * N + 1,), 4, cuda, dtype)[1:].view(K, N)
    assert a0.data_ptr() % 16 and b0.data_ptr() % 16
    kw = dict(bm=16, bn=64, bk=32, s=2, kb=3, stages=4)
    torch.testing.assert_close(matmul_h100(a0, b0, **kw),
                               matmul_plain(a0, b0, **kw), rtol=1e-4,
                               atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_matmul_two_launches_bit_identical(cuda, dtype):
    """The split-K combine sums the partials in split order, never with
    float atomics: two launches give the same bits."""
    a, b = _mm_inputs(4, 4096, 4096, cuda, dtype)
    kw = dict(bm=16, bn=128, bk=32, s=1, kb=16, stages=4)
    first = matmul_h100(a, b, **kw)
    for _ in range(3):
        assert torch.equal(first, matmul_h100(a, b, **kw))


@pytest.mark.gpu
def test_gpu_matmul_workspace_grows_and_tickets_reset(cuda):
    """A large split, a small one and the large one again: the workspace
    grows on demand, every result agrees, and each launch leaves every
    ticket at 0."""
    from repro_torch.kernels import matmul as mm_mod
    for M, N, K, kb in [(32, 4096, 1024, 16), (3, 40, 200, 2),
                        (256, 2048, 512, 8), (32, 4096, 1024, 16)]:
        a, b = _mm_inputs(M, K, N, cuda, torch.bfloat16)
        kw = dict(bm=32, bn=64, bk=32, s=1, kb=kb, stages=2)
        got = matmul_h100(a, b, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, matmul_plain(a, b, **kw), rtol=1e-4,
                                   atol=8e-4)
        part = mm_mod.PARTIALS.bufs[a.device]
        tickets = mm_mod.TICKETS.bufs[a.device]
        assert part.numel() >= kb * M * N
        assert int(tickets.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,N,K", [(4, 4, 96, 300), (16, 5, 333, 200),
                                     (3, 17, 64, 1000)])
def test_gpu_matmul_batched_matches_plain(cuda, dtype, E, M, N, K):
    """The batched entry (E products, one launch) against its plain version
    at every split and ring depth, each expert bit for bit the 2-D launch
    of the same format on that expert's operands (the same body on offset
    pointers); the tickets are left at 0."""
    from repro_torch.kernels import matmul as mm_mod
    a = _t((E, M, K), 11, cuda, dtype)
    b = _t((E, K, N), 12, cuda, dtype)
    for i, (kb, stages) in enumerate([(kb, st) for kb in (1, 3, 16)
                                      for st in (1, 2, 4)]):
        bm, bn, bk, s = MM_FORMATS[(i + M + N) % len(MM_FORMATS)]
        kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages)
        n0, m0 = matmul_h100_batched.launches, matmul_h100.launches
        got = matmul_h100_batched(a, b, **kw)
        torch.cuda.synchronize()
        assert matmul_h100_batched.launches == n0 + 1
        assert matmul_h100.launches == m0
        torch.testing.assert_close(got, matmul_batched_plain(a, b, **kw),
                                   rtol=1e-4, atol=8e-4, msg=str(kw))
        for e in (0, E - 1):
            assert torch.equal(got[e], matmul_h100(a[e].contiguous(),
                                                   b[e].contiguous(), **kw))
        if kb > 1:
            assert int(mm_mod.TICKETS.bufs[a.device].abs().sum()) == 0


@pytest.mark.gpu
def test_gpu_matmul_batched_refuses_too_many_blocks_on_z(cuda):
    """E x kb blocks ride the grid's z, at most 65,535; the wrapper raises
    past it, as ``format_error(experts=E)`` says."""
    from repro_torch.kernels.matmul import format_error
    a = _t((4097, 1, 32), 13, cuda, torch.bfloat16)
    b = _t((4097, 32, 32), 14, cuda, torch.bfloat16)
    kw = dict(bm=16, bn=32, bk=32, s=1, kb=16, stages=2)
    assert format_error(1, 32, 32, **kw, cached=True, dtype=torch.bfloat16,
                        experts=4097) is not None
    with pytest.raises(Exception):
        matmul_h100_batched(a, b, **kw)
    kw["kb"] = 1
    torch.testing.assert_close(matmul_h100_batched(a, b, **kw),
                               matmul_batched_plain(a, b, **kw), rtol=1e-4,
                               atol=8e-4)


@pytest.mark.gpu
def test_gpu_matmul_invalid_format_raises(cuda):
    """The entry point refuses what it does not take, as ``format_error``
    says it will; the wrapper raises."""
    from repro_torch.kernels.matmul import format_error
    a, b = _mm_inputs(4, 64, 64, cuda, torch.bfloat16)
    good = dict(bm=16, bn=32, bk=32, s=1, kb=2, stages=2)
    assert format_error(4, 64, 64, **good, cached=True,
                        dtype=torch.bfloat16) is None
    matmul_h100(a, b, **good)
    for bad in (dict(bm=8), dict(bn=48), dict(bk=16), dict(s=4),
                dict(stages=3), dict(kb=0), dict(bm=64, bn=256)):
        kw = {**good, **bad}
        assert format_error(4, 64, 64, **kw, cached=True,
                            dtype=torch.bfloat16) is not None
        with pytest.raises(RuntimeError):
            matmul_h100(a, b, **kw)


#: (h, hk, sq, sk, bq, bkv, kv_chunk, stages, causal, window): one KV head
#: a query head and GQA at the llama (32/8) and hymba (25/5) groupings;
#: decode, prefill chunks and sk no multiple of bkv; non-causal; windows;
#: one split and several (the combine), ring depths 2-4.
FA_CASES = [
    (4, 4, 9, 70, 16, 32, 4096, 2, True, None),
    (4, 4, 9, 70, 16, 32, 4096, 3, False, None),
    (4, 4, 9, 70, 16, 32, 4096, 4, True, 16),
    (4, 4, 1, 200, 16, 64, 4096, 2, True, None),
    (4, 4, 3, 61, 128, 64, 4096, 2, True, None),
    (4, 4, 32, 200, 64, 64, 4096, 2, False, None),
    (32, 8, 1, 77, 16, 64, 512, 3, True, None),        # llama decode
    (32, 8, 32, 96, 128, 32, 512, 4, True, None),      # llama prefill chunk
    (25, 5, 1, 300, 16, 64, 64, 3, True, 128),         # hymba decode, split
    (25, 5, 32, 300, 64, 64, 128, 2, True, 128),       # hymba chunk, split
    (8, 2, 17, 1000, 32, 32, 256, 4, False, None),     # split, non-causal
    (8, 1, 5, 333, 16, 64, 128, 2, True, 40)]          # split, window


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("h,hk,sq,sk,bq,bkv,kv_chunk,stages,causal,window",
                         FA_CASES)
def test_gpu_flash_kernel_matches_plain(cuda, dtype, tol, h, hk, sq, sk, bq,
                                        bkv, kv_chunk, stages, causal,
                                        window):
    d = 64 if h == 25 else 128
    q = _t((h, sq, d), 9, cuda, dtype)
    k = _t((hk, sk, d), 10, cuda, dtype)
    v = _t((hk, sk, d), 11, cuda, dtype)
    kw = dict(bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
              causal=causal, window=window)
    n0 = flash_attention_h100.launches
    got = flash_attention_h100(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_h100.launches == n0 + 1 and got.dtype == dtype
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 80, 128])
def test_gpu_flash_misaligned_and_narrow_heads(cuda, dtype, d):
    """q, k, v one element past a 16-byte boundary take the masked element
    loads; d = 16 and 80 run in the 64- and 128-wide tiles with the columns
    past d zero."""
    h, hk, sq, sk = 6, 2, 7, 150
    q = _t((h * sq * d + 1,), 1, cuda, dtype)[1:].view(h, sq, d)
    k = _t((hk * sk * d + 1,), 2, cuda, dtype)[1:].view(hk, sk, d)
    v = _t((hk * sk * d + 1,), 3, cuda, dtype)[1:].view(hk, sk, d)
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for kv_chunk in (64, 4096):
        kw = dict(bq=32, bkv=32, kv_chunk=kv_chunk, stages=3, causal=True)
        torch.testing.assert_close(
            flash_attention_h100(q, k, v, **kw).float(),
            flash_attention_plain(q, k, v, **kw).float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,bq,window", [(1, 16, None), (256, 64, None),
                                          (1, 16, 1024)])
def test_gpu_flash_split_kv_two_launches_bit_identical(cuda, sq, bq, window):
    """A long cache (sk 4096) over 16 splits at the llama3-8b decode and a
    256-row prefill chunk, and a windowed decode: within tolerance of the
    plain version, and two launches give the same bits (the combine sums
    the splits in order, never with float atomics)."""
    h, hk, sk, d = 32, 8, 4096, 128
    q = _t((h, sq, d), 20, cuda, torch.bfloat16)
    k = _t((hk, sk, d), 21, cuda, torch.bfloat16)
    v = _t((hk, sk, d), 22, cuda, torch.bfloat16)
    kw = dict(bq=bq, bkv=64, kv_chunk=256, stages=3, causal=True,
              window=window)
    first = flash_attention_h100(q, k, v, **kw)
    torch.testing.assert_close(first.float(),
                               flash_attention_plain(q, k, v, **kw).float(),
                               rtol=1e-2, atol=1e-2)
    for _ in range(2):
        assert torch.equal(first, flash_attention_h100(q, k, v, **kw))


@pytest.mark.gpu
def test_gpu_flash_invalid_format_raises(cuda):
    """The entry point refuses what it does not take, as ``format_error``
    says it will; the wrapper raises."""
    from repro_torch.kernels.flash_attention import format_error
    q = _t((4, 2, 64), 1, cuda, torch.bfloat16)
    k = _t((2, 40, 64), 2, cuda, torch.bfloat16)
    good = dict(bq=16, bkv=32, kv_chunk=32, stages=2)
    assert format_error(4, 2, 2, 40, 64, **good,
                        dtype=torch.bfloat16) is None
    flash_attention_h100(q, k, k, **good)
    for bad in (dict(bq=8), dict(bkv=128), dict(kv_chunk=48),
                dict(stages=1), dict(stages=5)):
        kw = {**good, **bad}
        assert format_error(4, 2, 2, 40, 64, **kw,
                            dtype=torch.bfloat16) is not None
        with pytest.raises(RuntimeError):
            flash_attention_h100(q, k, k, **kw)


#: The paged entry at chip_smoke's phase-4 groupings: (h, hk, d, window,
#: rows, sq, lens, nblk, page, bq, bkv, kv_chunk): llama3-8b (32/8) and
#: hymba-1.5b (25/5, window 1024) decode over 4 rows of ragged lengths,
#: one of them 0, and a prefill chunk; pools of 256 and 4096 keys, one
#: split and several; qwen1.5-4b's one query head a KV head (20/20) and
#: llama4-scout's group of 5 at head dim 128 (40/8).
FA_PAGED_CASES = [
    (32, 8, 128, None, 4, 1, [77, 0, 200, 256], 16, 16, 16, 64, 4096),
    (32, 8, 128, None, 4, 1, [77, 0, 3000, 4096], 256, 16, 16, 64, 256),
    (25, 5, 64, 1024, 4, 1, [77, 0, 1500, 4096], 256, 16, 16, 64, 512),
    (32, 8, 128, None, 1, 32, [96], 16, 16, 128, 32, 4096),
    (32, 8, 128, None, 1, 256, [3000], 256, 16, 64, 64, 1024),
    (25, 5, 64, 1024, 1, 32, [1900], 256, 16, 64, 64, 512),
    (20, 20, 128, None, 4, 1, [77, 0, 200, 256], 16, 16, 16, 64, 4096),
    (40, 8, 128, None, 4, 1, [77, 0, 3000, 4096], 256, 16, 16, 64, 256),
    (40, 8, 128, None, 1, 32, [96], 16, 16, 64, 32, 4096)]


def _paged_inputs(h, hk, d, rows, sq, lens, nblk, page, dev, q_dtype, seed=0):
    num_blocks = rows * nblk + 1
    rng = np.random.default_rng(seed)
    q = _t((rows, h, sq, d), seed + 1, dev, q_dtype)
    k = _t((num_blocks, page, hk, d), seed + 2, dev, torch.bfloat16)
    v = _t((num_blocks, page, hk, d), seed + 3, dev, torch.bfloat16)
    tables = torch.from_numpy(rng.permutation(np.arange(1, num_blocks))
                              .reshape(rows, nblk).astype(np.int32)).to(dev)
    return q, k, v, tables, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,tol", [(torch.float32, 1e-4),
                                         (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize(
    "h,hk,d,window,rows,sq,lens,nblk,page,bq,bkv,kv_chunk", FA_PAGED_CASES)
def test_gpu_flash_paged_kernel_matches_plain(cuda, q_dtype, tol, h, hk, d,
                                              window, rows, sq, lens, nblk,
                                              page, bq, bkv, kv_chunk):
    """The paged entry on a bf16 pool (f32 q upcasts it) against its plain
    version: one launch for every row, a row of length 0 all zeros, and
    over more than one split three launches bit for bit."""
    q, k, v, tables, tl = _paged_inputs(h, hk, d, rows, sq, lens, nblk, page,
                                        cuda, q_dtype)
    kw = dict(bq=bq, bkv=bkv, kv_chunk=kv_chunk, causal=True, window=window,
              stages=3 if q_dtype == torch.bfloat16 else 2)   # f32 smem
    n0 = flash_attention_h100.launches
    got = flash_attention_h100_paged(q, k, v, tables, tl, **kw)
    torch.cuda.synchronize()
    assert flash_attention_h100.launches == n0 + 1 and got.dtype == q_dtype
    want = flash_attention_paged_plain(q, k, v, tables, tl, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for b, n in enumerate(lens):
        if n == 0:
            assert not got[b].any()
    if nblk * page > kv_chunk:
        for _ in range(2):
            assert torch.equal(got, flash_attention_h100_paged(
                q, k, v, tables, tl, **kw))


def _engine(arch, dev, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.runtime import ServeEngine
    cfg = get_smoke_config(arch)
    params = init_model(cfg, seed=5, device=dev)
    return cfg, ServeEngine(cfg, params, device=dev, max_batch=3, max_len=48,
                            page_size=8, prefill_chunk=8, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_130m", "hymba_1p5b",
                                  "kimi_k2_1t_a32b"])
def test_gpu_graph_replay_equals_the_eager_step(cuda, arch):
    """The captured decode tick against the same step run eagerly on the
    card: two engines on the same weights serve five requests through three
    slots (rows join and leave), one replaying its graph, the other with
    its graph dropped running the captured function itself.  Tokens, SSM
    states and every pool block but the garbage block (where rows not
    decoding all write) are equal bit for bit; one replay a decode tick."""
    cfg, graphed = _engine(arch, cuda)
    _, eager = _engine(arch, cuda)
    eager.close()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 19, 11, 3, 26)]
    outs = []
    for eng in (graphed, eager):
        rids = [eng.submit(p, max_new=6) for p in prompts]
        done = {r.rid: r.out for r in eng.run_until_drained()}
        outs.append([done[r] for r in rids])
    assert outs[0] == outs[1] and all(len(o) == 6 for o in outs[0])
    assert graphed.graph.replays == graphed.sched.stats.decode_ticks
    for key in graphed.cache:
        a, b = graphed.cache[key], eager.cache[key]
        if key in ("k", "v"):
            a, b = a[:, 1:], b[:, 1:]
        assert torch.equal(a, b), key
    graphed.close()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_130m", "hymba_1p5b"])
def test_gpu_prefill_graphs_out_of_capture_order_give_eager_tokens(cuda,
                                                                   arch):
    """The prefill graphs share one memory pool and are captured longest
    chunk first; prompts of 3, 5, 13 and 2 tokens replay them 2, 1, 4, 1,
    8, 4, 1, 2.  The tokens, SSM states and pool blocks equal an engine
    that runs every step eagerly, bit for bit; every chunk is one replay
    and none runs eagerly."""
    cfg, graphed = _engine(arch, cuda)
    _, eager = _engine(arch, cuda)
    eager.close()
    order = []

    class Logged:
        def __init__(self, key, step):
            self.key, self.step = key, step

        def __call__(self):
            order.append(self.key)
            self.step()

    capture_order = list(graphed.prefill_graphs)
    graphed.prefill_graphs = {C: Logged(C, g)
                              for C, g in graphed.prefill_graphs.items()}
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (3, 5, 13, 2)]
    outs = []
    for eng in (graphed, eager):
        rids = [eng.submit(p, max_new=5) for p in prompts]
        done = {r.rid: r.out for r in eng.run_until_drained()}
        outs.append([done[r] for r in rids])
    assert capture_order == [8, 4, 2, 1]
    assert order[:len(capture_order)] != capture_order
    assert sorted(set(order)) == [1, 2, 4, 8]
    assert outs[0] == outs[1] and all(len(o) == 5 for o in outs[0])
    assert graphed.eager_prefills == 0
    assert len(order) == graphed.sched.stats.prefill_chunks
    assert eager.eager_prefills == eager.sched.stats.prefill_chunks
    for key in graphed.cache:
        a, b = graphed.cache[key], eager.cache[key]
        if key in ("k", "v"):
            a, b = a[:, 1:], b[:, 1:]
        assert torch.equal(a, b), key
    graphed.close()


@pytest.mark.gpu
def test_gpu_chunk_length_without_a_graph_raises(cuda):
    """On the card a prefill chunk never falls back to an eager step."""
    _, eng = _engine("mamba2_130m", cuda)
    del eng.prefill_graphs[2]
    eng.submit(np.arange(2), max_new=1)
    with pytest.raises(RuntimeError, match="no prefill graph"):
        eng.run_until_drained()
    assert eng.eager_prefills == 0
    eng.close()


@pytest.mark.gpu
def test_gpu_workspace_cannot_grow_under_a_graph(cuda):
    """Once an engine has captured its decode tick, a launch that would need
    a larger split workspace raises; closing the engine lets it grow.  The
    engine reserves under ``cuda``, a launch asks under ``cuda:0``: one
    buffer."""
    from repro_torch.kernels import matmul as mm_mod
    _, eng = _engine("llama3_8b", cuda)
    have = mm_mod.PARTIALS.get(cuda, 0).numel()
    assert mm_mod.PARTIALS.get(torch.device("cuda", 0), 0).numel() == have
    M = -(-have // (16 * 4096)) + 1
    a, b = _mm_inputs(M, 256, 4096, cuda, torch.bfloat16)
    kw = dict(bm=16, bn=64, bk=32, s=1, kb=16, stages=2)
    with pytest.raises(RuntimeError, match="size it before the capture"):
        matmul_h100(a, b, **kw)
    eng.close()
    torch.testing.assert_close(matmul_h100(a, b, **kw), matmul_plain(a, b,
                                                                     **kw),
                               rtol=1e-4, atol=8e-4)


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
    (4, 1, 24, 64, 128, 64, 32, True),        # mamba decode step
    (1, 256, 24, 64, 128, 64, 64, True),      # mamba prefill chunk
    (1, 200, 25, 64, 16, 128, 32, False),     # hymba, seq no chunk multiple
    (2, 37, 3, 20, 8, 16, 32, True),          # ragged hd tile, state 8
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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,state,bd", [(24, 128, 32), (24, 128, 64),
                                            (25, 16, 32), (25, 16, 64)])
@pytest.mark.parametrize("seq", [1, 5, 8])
def test_gpu_ssd_step_in_place_keeps_masked_rows(cuda, dtype, tol, heads,
                                                 state, bd, seq):
    """The step body at mamba2-130m's and hymba-1.5b's decode shapes (seq
    1) and over 5 and 8 steps, run in place on the state with rows 1 and
    2 of 4 masked out: masked rows keep their state bit for bit and get
    y = 0; the others equal the plain version."""
    x, a, b, c, s0 = _ssd_inputs(4, seq, heads, 64, state, cuda, dtype)
    mask = torch.tensor([True, False, False, True], device=cuda)
    s = s0.clone()
    y, s1 = ssd_scan_h100(x, a, b, c, s, chunk=16, bd=bd, out_state=s,
                          mask=mask)
    torch.cuda.synchronize()
    assert s1 is s
    wy, ws = ssd_scan_plain(x, a, b, c, s0, chunk=16, bd=bd)
    assert torch.equal(s[1:3], s0[1:3])
    assert not bool(y[1:3].any())
    torch.testing.assert_close(s[mask], ws[mask], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(y[mask].float(), wy[mask].float(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("seq", [256, 200, 37])
@pytest.mark.parametrize("chunk,bd", [(64, 64), (128, 32), (16, 32)])
def test_gpu_ssd_tensor_core_body_in_place(cuda, seq, chunk, bd):
    """The bf16 chunk body on the tensor cores at mamba2-130m's widths
    (24 heads of 64, state 128), in place: within the elementwise
    tolerances and within 2^-6 of the plain version's y by relative
    Frobenius error."""
    x, a, b, c, s0 = _ssd_inputs(1, seq, 24, 64, 128, cuda, torch.bfloat16)
    s = s0.clone()
    y, s1 = ssd_scan_h100(x, a, b, c, s, chunk=chunk, bd=bd, out_state=s)
    torch.cuda.synchronize()
    wy, ws = ssd_scan_plain(x, a, b, c, s0, chunk=chunk, bd=bd)
    torch.testing.assert_close(s, ws, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(y.float(), wy.float(), rtol=1e-2, atol=1e-2)
    rel = float((y.float() - wy.float()).norm() / wy.float().norm())
    assert rel < 2.0 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("heads,state", [(24, 128), (25, 16)])
@pytest.mark.parametrize("seq", [1, 5, 64, 200])
def test_gpu_ssd_state_rows_match_plain(cuda, dtype, tol, heads, state, seq):
    """``state_rows`` picks rows 4, 0 and 2 of a 5-row state for the 3 rows
    of x, with x row 1 masked out, in place: the step body (seq 1, 5), the
    bf16 tensor-core body and the f32 FMA body (64, 200) equal the plain
    version; the masked row's state and the rows no index names stay bit
    for bit, and the masked row's y is 0."""
    x, a, b, c, _ = _ssd_inputs(3, seq, heads, 64, state, cuda, dtype)
    pool = _t((5, heads, state, 64), 9, cuda)
    rows = torch.tensor([4, 0, 2], dtype=torch.int32, device=cuda)
    mask = torch.tensor([True, False, True], device=cuda)
    kw = dict(chunk=64, bd=32, mask=mask, state_rows=rows)
    st = pool.clone()
    n0 = ssd_scan_h100.launches
    y, s1 = ssd_scan_h100(x, a, b, c, st, out_state=st, **kw)
    torch.cuda.synchronize()
    assert s1 is st and ssd_scan_h100.launches == n0 + 1
    ws = pool.clone()
    wy, _ = ssd_scan_plain(x, a, b, c, ws, out_state=ws, **kw)
    for r in (0, 1, 3):
        assert torch.equal(st[r], pool[r]), r
    assert not bool(y[1].any())
    torch.testing.assert_close(st, ws, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_gpu_ssd_wrapper_resolves_its_entry_once(cuda, monkeypatch):
    """The C entry point is looked up once a process, not once a launch."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    calls = []
    real = build.entry
    monkeypatch.setattr(build, "entry",
                        lambda *args: calls.append(args) or real(*args))
    ssd_mod._entry.cache_clear()
    x, a, b, c, s0 = _ssd_inputs(4, 1, 24, 64, 128, cuda, torch.bfloat16)
    for _ in range(3):
        ssd_scan_h100(x, a, b, c, s0, chunk=16, bd=32, out_state=s0)
    torch.cuda.synchronize()
    assert len(calls) == 1


@pytest.mark.gpu
def test_gpu_ssd_kernel_per_head_bc_equals_shared(cuda):
    x, a, b, c, s0 = _ssd_inputs(2, 40, 3, 32, 16, cuda, torch.float32)
    heads = x.shape[2]
    y1, s1 = ssd_scan_h100(x, a, b, c, s0, chunk=16, bd=32)
    full = [t[:, :, None, :].expand(-1, -1, heads, -1).contiguous()
            for t in (b, c)]
    y2, s2 = ssd_scan_h100(x, a, *full, s0, chunk=16, bd=32)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,bm,bn,s", [
    (1024, 1024, 1, 256, 2), (300, 700, 1, 256, 2), (300, 700, 32, 32, 1),
    (37, 1000, 8, 128, 1), (513, 65, 2, 512, 2),
    (1, 1 << 25, 1, 256, 2),
    (1, 1 << 25, 1, 32, 1),                    # > 65,535 column blocks
    (1 << 17, 8, 1, 32, 1),                    # > 65,535 row blocks
    (5, 1001, 4, 64, 2)])                      # no whole 16-byte rows
def test_gpu_matadd_kernel_matches_plain(cuda, dtype, M, N, bm, bn, s):
    """Bit for bit.  Rows of 700 bf16, 65 or 1001 elements are no multiple
    of 16 bytes and take the masked scalar path, the others the 16-byte
    vectors; (1, 2^25) at bn 32, s 1 has 262,144 (f32) or 131,072 (bf16)
    column blocks (the grid's x), (2^17, 8) at bm 1 131,072 row blocks,
    launched a 65,535 at a time."""
    a, b = _t((M, N), 12, cuda, dtype), _t((M, N), 13, cuda, dtype)
    n0 = matadd_h100.launches
    got = matadd_h100(a, b, bm=bm, bn=bn, s=s)
    torch.cuda.synchronize()
    assert matadd_h100.launches == n0 + 1 and got.dtype == dtype
    assert torch.equal(got, matadd_plain(a, b, bm=bm, bn=bn, s=s))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["a", "b", "c", "all"])
def test_gpu_matadd_misaligned_bases(cuda, dtype, which):
    """An operand or the output one element into its buffer breaks 16-byte
    alignment: the masked scalar path, bit for bit."""
    M, N = 64, 1024
    def view(seed, shift):
        return _t((M * N + 1,), seed, cuda, dtype)[shift:shift + M * N
                                                    ].view(M, N)
    a = view(12, 1 if which in ("a", "all") else 0)
    b = view(13, 1 if which in ("b", "all") else 0)
    kw = dict(bm=4, bn=64, s=2)
    if which in ("c", "all"):
        from repro_torch.kernels import matadd as add_mod
        out = torch.empty(M * N + 1, dtype=dtype, device=cuda)[1:].view(M, N)
        err = add_mod._entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M,
                               N, 4, 64, 2, add_mod._ELEM[dtype],
                               torch.cuda.current_stream().cuda_stream)
        assert err == 0
        got = out
    else:
        got = matadd_h100(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, matadd_plain(a, b, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,bm,bn,s,cached", [
    (1024, 1024, 32, 32, 1, True), (300, 700, 32, 32, 4, True),
    (300, 700, 8, 128, 2, True), (300, 700, 1, 1024, 8, True),
    (300, 700, 32, 32, 1, False), (77, 1000, 4, 64, 2, False),
    (3, (1 << 22) + 5, 8, 32, 1, True), (4, 1 << 22, 8, 32, 1, False),
    # llama3-8b's weight signatures of the training path, at their picks
    (4096, 4096, 16, 32, 8, True), (4096, 1024, 32, 32, 8, True),
    (4096, 14336, 16, 32, 8, True), (14336, 4096, 16, 32, 8, True),
    (4096, 128256, 16, 32, 8, True), (4096, 4096, 32, 32, 8, True),
    # rows whose bytes are no multiple of 16: narrower loads or stores
    (64, 4097, 32, 32, 8, True), (1001, 1001, 16, 64, 4, True),
    (33, 4097, 32, 32, 8, False), (1280, 51866, 32, 32, 8, True),
    # a single row or column
    (1, 4096, 32, 32, 8, True), (4096, 1, 32, 32, 8, True),
    (1, 1, 1, 32, 1, True), (1, 1, 32, 32, 8, False),
    # every bm of the domain, at 16-byte and at narrower accesses
    (1000, 4096, 1, 1024, 8, True), (1000, 4096, 2, 512, 4, True),
    (1000, 4096, 4, 256, 2, True), (1000, 4096, 8, 128, 8, True),
    (1000, 4096, 16, 64, 1, True), (1000, 4096, 32, 32, 8, True),
    (300, 700, 2, 256, 8, True), (300, 700, 4, 32, 8, True),
    (300, 700, 16, 32, 8, True)])
def test_gpu_transpose_kernel_matches_plain(cuda, dtype, M, N, bm, bn, s,
                                            cached):
    a = _t((M, N), 14, cuda, dtype)
    _poison_next(a.numel() * a.element_size(), cuda)
    n0 = transpose_h100.launches
    got = transpose_h100(a, bm=bm, bn=bn, s=s, cached=cached)
    torch.cuda.synchronize()
    assert transpose_h100.launches == n0 + 1 and got.shape == (N, M)
    assert torch.equal(got, transpose_plain(a, bm=bm, bn=bn, s=s))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,N,bm,bn,s,cached", [
    # llama4-scout's expert keys, cut in E: 16-byte accesses
    (2, 80, 5120, 16, 32, 8, True), (2, 5120, 80, 32, 32, 8, True),
    # an expert's stride of 70 bytes at bf16 (140 at f32): M·N odd, so
    # expert 1 starts off every boundary wider than an element
    (3, 5, 7, 32, 32, 8, True), (3, 5, 7, 4, 64, 2, False),
    # rows of no multiple of 16 bytes, a single row, column or element
    (4, 33, 4097, 32, 32, 8, True), (5, 1, 4096, 32, 32, 8, True),
    (5, 4096, 1, 16, 64, 4, True), (7, 1, 1, 1, 32, 1, True)])
def test_gpu_transpose_batched_matches_plain(cuda, dtype, E, M, N, bm, bn,
                                             s, cached):
    """K4's batched entry: one launch, bit for bit its plain version, and
    each expert bit for bit the 2-D launch of the same format on that
    expert's matrix; the 2-D counter does not move."""
    from repro_torch.kernels.transpose import (transpose_batched_plain,
                                               transpose_h100_batched)
    a = _t((E, M, N), 15, cuda, dtype)
    kw = dict(bm=bm, bn=bn, s=s, cached=cached)
    _poison_next(a.numel() * a.element_size(), cuda)
    n0, t0 = transpose_h100_batched.launches, transpose_h100.launches
    got = transpose_h100_batched(a, **kw)
    torch.cuda.synchronize()
    assert transpose_h100_batched.launches == n0 + 1
    assert transpose_h100.launches == t0 and got.shape == (E, N, M)
    assert torch.equal(got, transpose_batched_plain(a, **kw))
    for e in (0, E - 1):
        assert torch.equal(got[e], transpose_h100(a[e].contiguous(), **kw))


@pytest.mark.gpu
def test_gpu_transpose_batched_refuses_too_many_experts(cuda):
    from repro_torch.kernels.transpose import (format_error,
                                               transpose_h100_batched)
    a = torch.zeros((65_536, 1, 2), dtype=torch.bfloat16, device=cuda)
    assert format_error(1, 2, 32, 32, 8, 2, experts=65_536) is not None
    with pytest.raises(Exception):
        transpose_h100_batched(a, bm=32, bn=32, s=8)


def _poison_next(nbytes, dev):
    """Frees a block of ``nbytes`` all-ones bytes, which PyTorch's caching
    allocator hands to the next allocation of that size: an element the
    kernel leaves unwritten then shows as a NaN pattern, not as what an
    earlier launch left there."""
    torch.full((nbytes,), 255, dtype=torch.uint8, device=dev)


def _bit_view(x):
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def _random_bits(shape, seed, dev, dtype):
    """Random bit patterns of ``dtype`` (NaNs with payloads among them),
    with a −0.0 and two NaN payloads planted."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
    info = torch.iinfo(ints)
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(info.min, info.max, shape, generator=g,
                      dtype=torch.int64).to(ints)
    neg0, nan1, nan2 = ((-0x8000, 0x7FC1, -0x5B) if dtype == torch.bfloat16
                        else (-0x80000000, 0x7FC00001, -0x7FFEDD))
    x.view(-1)[:3] = torch.tensor([neg0, nan1, nan2], dtype=ints)
    return x.to(dev).view(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,bn,s,cached", [
    (32, 32, 8, True), (16, 32, 8, True), (2, 128, 4, True),
    (32, 32, 1, False)])
def test_gpu_transpose_moves_raw_bits(cuda, dtype, bm, bn, s, cached):
    """NaN payloads, −0.0 and every other bit pattern come through as they
    are: compared as integers, since NaN != NaN."""
    a = _random_bits((517, 1040), 21, cuda, dtype)
    assert torch.isnan(a).any() and (_bit_view(a) == _bit_view(
        torch.tensor(-0.0, dtype=dtype, device=cuda))).any()
    _poison_next(a.numel() * a.element_size(), cuda)
    got = transpose_h100(a, bm=bm, bn=bn, s=s, cached=cached)
    torch.cuda.synchronize()
    assert torch.equal(_bit_view(got), _bit_view(a).t().contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["buffer", "row_slice"])
def test_gpu_transpose_misaligned_base(cuda, dtype, how):
    """A contiguous operand whose storage starts off the 16-byte boundary
    (one element into its buffer, or rows 1.. of an odd-width matrix)
    takes narrower loads and agrees bit for bit."""
    if how == "buffer":
        a = _t((300 * 4096 + 1,), 22, cuda, dtype)[1:].view(300, 4096)
    else:
        a = _t((301, 1001), 22, cuda, dtype)[1:]
    assert a.is_contiguous() and a.data_ptr() % 16
    for bm, bn, s, cached in ((32, 32, 8, True), (8, 64, 4, True),
                              (32, 32, 8, False)):
        _poison_next(a.numel() * a.element_size(), cuda)
        got = transpose_h100(a, bm=bm, bn=bn, s=s, cached=cached)
        torch.cuda.synchronize()
        assert torch.equal(got, transpose_plain(a, bm=bm, bn=bn, s=s))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_transpose_in_a_cuda_graph(cuda, dtype):
    """A launch captured in a CUDA graph and replayed on new contents of
    its input gives their transpose bit for bit; the counter moves at the
    capture, not at the replays."""
    a = _t((4096, 1024), 24, cuda, dtype)
    kw = dict(bm=32, bn=32, s=8)
    transpose_h100(a, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    n0 = transpose_h100.launches
    with torch.cuda.graph(g):
        out = transpose_h100(a, **kw)
    assert transpose_h100.launches == n0 + 1
    for seed in (25, 26):
        a.copy_(_random_bits(tuple(a.shape), seed, cuda, dtype))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bit_view(out), _bit_view(a).t().contiguous())
    assert transpose_h100.launches == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("op,shape", [("matadd", (1 << 22, 8)),
                                      ("transpose", (4, 1 << 25))])
def test_gpu_ops_launch_past_65535_column_blocks(cuda, op, shape):
    """A thin operand whose pick has more than 65,535 blocks on the grid's
    y (its cap) launches through ``ops``: the entry point then launches
    once for each 65,535 of them.  Transpose counts column blocks on y;
    matadd counts row blocks there (its column blocks are on x, whose cap
    is 2^31 - 1), so its thin operand is a tall one."""
    M, N = shape
    cand = ops.select(f"{op}_h100", {"M": M, "N": N})
    a = cand.assignment
    if op == "matadd":
        assert -(-M // a["bm"]) > 65535
    else:
        assert -(-N // (a["bn"] * grain(cand.plan, a["s"]))) > 65535
    x = _t(shape, 16, cuda)
    if op == "matadd":
        got, want = ops.matadd(x, x.flip(1)), x + x.flip(1)
    else:
        got, want = ops.transpose(x), x.t().contiguous()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


#: (n, steps, B, s, F, cached, shift): the case-study picks, vectors of one
#: or two interior points (shorter than a window), steps no multiple of F,
#: x ``shift`` elements past a 16-byte boundary (every window start
#: unaligned, y's stores apart from x's slots), a halo wider than the block
#: (B = 32, F = 32), every F of the domain, the uncached leaf, no step.
JACOBI_CASES = [
    (32770, 4, 256, 1, 16, True, 0), ((1 << 21) + 2, 4, 1024, 8, 32, True, 0),
    ((1 << 21) + 2, 37, 1024, 8, 32, True, 1), (3, 5, 32, 1, 4, True, 0),
    (4, 3, 32, 1, 2, True, 1), (4, 1, 256, 1, 1, True, 0),
    (1026, 17, 128, 4, 4, True, 1), (1026, 7, 64, 1, 8, True, 2),
    (1026, 3, 128, 4, 1, True, 3), (1000, 5, 1024, 8, 1, True, 0),
    (32770, 40, 32, 1, 32, True, 1), (1026, 3, 64, 1, 1, False, 0),
    (32770, 2, 128, 2, 1, False, 1), (1026, 0, 256, 1, 4, True, 0),
] + [(32770, 37, 256, 2, F, True, 3) for F in (1, 2, 4, 8, 16, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,steps,B,s,F,cached,shift", JACOBI_CASES)
def test_gpu_jacobi_kernel_matches_plain(cuda, n, steps, B, s, F, cached,
                                         shift):
    x = _t((n + shift,), 15, cuda)[shift:]
    n0 = jacobi1d_h100.launches
    got = jacobi1d_h100(x, steps, B=B, s=s, F=F, cached=cached)
    torch.cuda.synchronize()
    assert jacobi1d_h100.launches == n0 + len(launch_plan(steps, F)) == \
        n0 + -(-steps // F)
    want = jacobi1d_plain(x, steps, B=B, s=s, F=F, cached=cached)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("steps,F", [(1, 1), (3, 1), (1, 32), (2, 32),
                                     (3, 4), (33, 32)])
def test_gpu_jacobi_leaves_x_and_copies_only_the_ends(cuda, steps, F):
    """The first launch reads x itself and every launch writes its buffer's
    two fixed ends: x is untouched, the result is a new tensor whose ends
    are x's, and it equals the plain version bit for bit."""
    x = _t((2 ** 21 + 2,), 17, cuda)
    before = x.clone()
    got = jacobi1d_h100(x, steps, B=1024, s=8, F=F)
    torch.cuda.synchronize()
    assert torch.equal(x, before) and got.data_ptr() != x.data_ptr()
    assert torch.equal(got[[0, -1]], x[[0, -1]])
    assert torch.equal(got, jacobi1d_plain(x, steps, B=1024, s=8, F=F))


@pytest.mark.gpu
def test_gpu_wrappers_raise_instead_of_falling_back(cuda):
    a = _t((8, 16), 1, cuda)
    with pytest.raises(ValueError):                     # not contiguous
        matmul_h100(a.T, a, bm=16, bn=32, bk=32, s=1)
    with pytest.raises(TypeError):                      # mixed types
        matmul_h100(a, a.T.contiguous().half(), bm=16, bn=32, bk=32, s=1)
    q = _t((2, 4, 256), 2, cuda)                        # head dim > 128
    with pytest.raises(ValueError):
        flash_attention_h100(q, q, q, bq=16, bkv=32, kv_chunk=64)
    q = _t((3, 4, 64), 2, cuda)                         # 3 heads over 2
    with pytest.raises(ValueError):
        flash_attention_h100(q, q[:2], q[:2], bq=16, bkv=32, kv_chunk=64)
    x, a, b, c, _ = _ssd_inputs(1, 300, 2, 16, 8, cuda, torch.float32)
    with pytest.raises(TypeError):                      # bf16 decay
        ssd_scan_h100(x, a.bfloat16(), b, c, chunk=16, bd=16)
    with pytest.raises(RuntimeError):                   # chunk past 128
        ssd_scan_h100(x, a, b, c, chunk=256, bd=32)
    with pytest.raises(RuntimeError):                   # bd not 32 or 64
        ssd_scan_h100(x, a, b, c, chunk=16, bd=16)
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
    with pytest.raises(ValueError):                     # uncached, F > 1
        jacobi1d_h100(m[0], 2, B=32, s=1, F=4, cached=False)
    with pytest.raises(RuntimeError):                   # depth past F
        jac_launch(m[0], torch.empty_like(m[0]), B=32, s=1, F=2, depth=3)


# ---------------------------------------------------------------------------
# The engine options on the card: degrade with recapture, prefix sharing,
# serve plans
# ---------------------------------------------------------------------------

def _to(node, dev):
    """A parameter tree (dicts, lists, tensors) copied to ``dev``."""
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    return node.to(dev)


def _f32_engine(arch, dev, seed=5, **kw):
    """An f32 smoke engine on ``dev`` with weights made on the CPU (the
    same weights on either device)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.runtime import ServeEngine
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = _to(init_model(cfg, seed=seed, device="cpu"), dev)
    for k, v in dict(max_batch=3, max_len=64, page_size=4,
                     prefill_chunk=8).items():
        kw.setdefault(k, v)
    return cfg, ServeEngine(cfg, params, device=dev, **kw)


def _serve_all(eng, prompts, max_new=5):
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    done = {r.rid: r.out for r in eng.run_until_drained()}
    return [done[r] for r in rids]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_130m"])
def test_gpu_mid_serve_demotion_recaptures_only_the_affected_steps(cuda,
                                                                   arch):
    """A ``serve.decode`` fault mid-serve under ``degrade`` demotes a
    frozen pick on the card; the engine captures again only the steps
    whose recorded triples hold it, the KV pool, SSM state and
    ``last_tok`` stay bit for bit across the recapture, and the f32 tokens
    equal the CPU engine's."""
    from repro_torch.artifacts.dispatch import (DispatchCache,
                                                set_default_cache)
    from repro_torch.runtime import faults
    from repro_torch.runtime.faults import FaultSpec
    set_default_cache(DispatchCache())
    try:
        cfg, cpu = _f32_engine(arch, "cpu", warm_kernels=True)
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (13, 7, 21)]
        want = _serve_all(cpu, prompts)
        set_default_cache(DispatchCache())
        _, eng = _f32_engine(arch, cuda, warm_kernels=True, degrade=True)
        triples = {k: s.triples for k, s in eng._graphs.steps.items()}
        snaps = []
        real = eng._recapture

        def watched(triple):
            torch.cuda.synchronize()
            before = ({k: v.clone() for k, v in eng.cache.items()},
                      eng.last_tok.clone())
            rec = real(triple)
            snaps.append((before, ({k: v.clone() for k, v in
                                    eng.cache.items()},
                                   eng.last_tok.clone())))
            return rec
        eng._recapture = watched
        with faults.inject([FaultSpec("serve.decode", 6, "error")]) as inj:
            got = _serve_all(eng, prompts)
        assert len(inj.fired) == 1 and len(eng.degrade_events) == 1
        (rec,) = eng.recapture_log
        assert list(rec.seconds) == [k for k, t in triples.items()
                                     if rec.triple in t] or rec.grew
        assert 0 < len(rec.seconds) and eng.recapture_s > 0
        (before, after), = snaps
        for k in before[0]:
            assert torch.equal(before[0][k], after[0][k]), k
        assert torch.equal(before[1], after[1])
        assert got == want
        eng.close()
    finally:
        set_default_cache(None)
        faults.install(None)


@pytest.mark.gpu
def test_gpu_prefix_shared_run_equals_cpu_and_sharing_off(cuda):
    """A shared-prefix f32 llama smoke run on the card (mapped blocks read
    through the tables, CoW copies on the device) gives the CPU run's
    tokens and the sharing-off run's."""
    rng = np.random.default_rng(0)
    cfg, _ = _f32_engine("llama3_8b", "cpu")
    lead = rng.integers(0, cfg.vocab, 24).astype(np.int32)
    prompts = [lead] + [np.concatenate([lead[:22], rng.integers(
        0, cfg.vocab, 6)]).astype(np.int32) for _ in range(3)]
    outs = []
    for dev, share in (("cpu", True), (cuda, True), (cuda, False)):
        _, eng = _f32_engine("llama3_8b", dev, prefix_sharing=share,
                             max_batch=4)
        first = _serve_all(eng, prompts[:1])
        outs.append(first + _serve_all(eng, prompts[1:]))
        if share:
            assert eng.pool.stats.prefix_hits > 0
            assert eng.pool.stats.cow_copies >= 3
        if dev != "cpu":
            assert eng.eager_prefills == 0
            eng.close()
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.gpu
def test_gpu_plan_backed_start_makes_no_cold_build(cuda, tmp_path):
    """An engine on the card started from a serve plan resolves nothing
    cold, before or while serving, and gives the online engine's tokens."""
    from repro_torch.artifacts.dispatch import (DispatchCache,
                                                set_default_cache)
    from repro_torch.configs import get_smoke_config
    from repro_torch.plans import PlanStore, build_serve_plan
    cfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    sizes = dict(max_len=64, max_batch=3, prefill_chunk=8)
    plan, dropped = build_serve_plan(cfg, cache=DispatchCache(), **sizes)
    assert not dropped
    store = PlanStore(tmp_path)
    store.save_plan(plan)
    try:
        set_default_cache(DispatchCache())
        _, online = _f32_engine("llama3_8b", cuda, warm_kernels=True,
                                plan_store=False)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 17)]
        want = _serve_all(online, prompts)
        online.close()
        cache = DispatchCache()
        set_default_cache(cache)
        _, eng = _f32_engine("llama3_8b", cuda, warm_kernels=True,
                             plan_store=store)
        assert cache.stats.cold_builds == 0
        assert _serve_all(eng, prompts) == want
        assert cache.stats.cold_builds == 0
        eng.close()
    finally:
        set_default_cache(None)


# ---------------------------------------------------------------------------
# Tuning and the kernel monitor on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_timer_agrees_with_a_graph_replay_at_a_decode_signature(cuda):
    """The tuning timer reads device time: at K1 (4, 4096, 4096) (a llama
    decode projection) its per-launch time is within 10 % of 20 launches
    over cold weight copies replayed from one CUDA graph, and the launch
    counters count the launches that ran (its warm launch and each
    replay's ten), not the capture's."""
    import math
    from repro_torch.tuning.measure import (L2_FLUSH_BYTES, DeviceTimer,
                                            MeasureConfig, trimmed_mean_us)
    fam = ops.FAMILIES["matmul_h100"]
    data = {"M": 4, "N": 4096, "K": 4096}
    cand = ops.select("matmul_h100", data)
    cfg = MeasureConfig(iters=5, warmup=1, trim=1, device="cuda")
    before = matmul_h100.launches
    timer = DeviceTimer()
    got = trimmed_mean_us(timer(fam, cand.plan, cand.assignment, data, cfg),
                          cfg.trim)
    timer.clear()
    assert matmul_h100.launches - before == 1 + 10 * (1 + 5)
    fn = fam.instantiate(cand.plan, cand.assignment, "cuda")
    a = _t((4, 4096), 1, cuda, torch.bfloat16)
    b = _t((4096, 4096), 2, cuda, torch.bfloat16)
    bs = [b] + [b.clone() for _ in range(
        math.ceil(L2_FLUSH_BYTES / (b.numel() * 2)) - 1)]
    fn(a, b)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(20):
            fn(a, bs[i % len(bs)])
    g.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) * 1e3 / 20)
    want = sorted(per)[2]
    assert abs(got - want) <= 0.1 * want, (got, want)


class _SlowPick:
    """A deterministic timer: the assignments in ``slow`` measure 8 ms,
    every other 4 ms."""

    def __init__(self):
        self.slow = set()

    def __call__(self, family, plan, assignment, data, cfg):
        key = tuple(sorted((k, int(v)) for k, v in assignment.items()))
        return [8e-3 if key in self.slow else 4e-3] * max(1, cfg.iters)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2])
def test_gpu_forced_swap_recaptures_and_keeps_the_f32_tokens(cuda, depth):
    """One K1 triple's frozen incumbent skewed slow: the monitor swaps it
    at its first probe, the engine captures again exactly the steps whose
    recorded triples hold it (every step if a workspace grew), and the
    f32 smoke tokens equal the CPU engine's."""
    from repro_torch.artifacts.dispatch import (DispatchCache,
                                                set_default_cache)
    from repro_torch.core.params import H100_SXM
    from repro_torch.runtime import KernelMonitor, cand_key
    set_default_cache(DispatchCache())
    try:
        cfg, cpu = _f32_engine("llama3_8b", "cpu", warm_kernels=True)
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (13, 7, 21)]
        want = _serve_all(cpu, prompts)
        cache = DispatchCache()
        set_default_cache(cache)
        timer = _SlowPick()
        _, eng = _f32_engine("llama3_8b", cuda, warm_kernels=True,
                             monitor=True, monitor_timer=timer,
                             async_depth=depth)
        op = next(o for o in eng._warm_ops if o.family == "matmul_h100")
        mon = KernelMonitor(cache, machine=H100_SXM, window=1, patience=1,
                            probe_every=1, top_k=2, timer=timer)
        mon.track(ops.FAMILIES["matmul_h100"], op.data_dict())
        inc = cache.frozen_entry("matmul_h100", "h100_sxm", op.data_dict())
        timer.slow.add(cand_key(inc.candidate)[1])
        eng.monitor = mon
        triples = {k: s.triples for k, s in eng._graphs.steps.items()}
        got = _serve_all(eng, prompts)
        (ev,) = mon.events
        (rec,) = eng.recapture_log
        triple = ("matmul_h100", "h100_sxm", op.data)
        assert ev.tick == 0 and rec.triple == triple
        assert list(rec.seconds) == ([k for k, t in triples.items()
                                      if triple in t] if not rec.grew
                                     else list(triples))
        now = cache.frozen_entry("matmul_h100", "h100_sxm", op.data_dict())
        assert cand_key(now.candidate) == ev.new != ev.old
        assert got == want
        eng.close()
    finally:
        set_default_cache(None)


@pytest.mark.gpu
def test_gpu_launcher_tunes_a_quick_table(cuda, tmp_path):
    """``python -m repro_torch.launch.tune_artifacts`` on the card: one
    quick K1 table measured, rewritten with its tuning sections, and served
    from its measured order."""
    from repro_torch.artifacts import ArtifactStore, DispatchCache
    from repro_torch.core.params import H100_SXM
    from repro_torch.launch import tune_artifacts
    from repro_torch.tuning import parse_bucket_key
    assert tune_artifacts.main(["--family", "matmul_h100", "--out",
                                str(tmp_path), "--quick", "--iters", "3",
                                "--top-k", "4"]) == 0
    store = ArtifactStore(tmp_path)
    table = store.load_dispatch("matmul_h100", "h100_sxm")
    (bucket,) = table["buckets"]
    rec = table["measured_ranks"][bucket]
    assert all(us is not None and us > 0 for us in rec["us"][:4])
    assert table["calibration"]["meta"]["card"] == \
        torch.cuda.get_device_name(0)
    cache = DispatchCache(store=store)
    data = parse_bucket_key(bucket)
    fam = ops.FAMILIES["matmul_h100"]
    assert cache.rank_source(fam, H100_SXM, data) == "measured"
    cache.best_variant(fam, H100_SXM, data)
    assert cache.stats.measured_hits > 0


# ---------------------------------------------------------------------------
# whisper and the non-paged serve steps on the card
# ---------------------------------------------------------------------------

def _steps_tokens(cfg, params, device, toks, extra, graph=False):
    """Greedy tokens of the non-paged steps (prefill, then 5 decode steps
    at a (B,) index), the decode steps eager or replayed from one CUDA
    graph."""
    from repro_torch.models import init_cache
    from repro_torch.runtime import build_serve_steps, greedy_sample
    from repro_torch.runtime.graph import CudaGraph, StepGraphs
    B, S = toks.shape
    prefill_step, decode_one = build_serve_steps(cfg)
    cache = init_cache(cfg, B, S + 8, device=device)
    last, _ = prefill_step(params, toks, cache,
                           **{k: v.to(device) for k, v in extra.items()})
    tok = greedy_sample(last)
    idx = torch.full((B,), S, dtype=torch.int32, device=device)

    def body():
        logits, _ = decode_one(params, tok, cache, idx)
        tok.copy_(greedy_sample(logits))
        idx.add_(1)

    out = [tok.clone()]
    step = body
    graphs = None
    if graph:
        graphs = StepGraphs(lambda: CudaGraph(torch.cuda.graph_pool_handle()))
        step = graphs.capture("decode", body)
    for _ in range(5):
        step()
        out.append(tok.clone())
    if graphs is not None:
        assert step.replays == 5
        graphs.release()
    return torch.cat(out, 1).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper_large_v3", "hymba_1p5b"])
def test_gpu_non_paged_steps_equal_cpu(cuda, arch):
    """The f32 smoke config through the non-paged steps on the card, the
    decode steps eager and replayed from a CUDA graph, gives the CPU plain
    versions' tokens (whisper: encoder, cross cache; hymba: its ring of 32
    wrapped by a 30-token prompt)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = init_model(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 30))
    extra = {}
    if cfg.encoder is not None:
        extra["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
    want = _steps_tokens(cfg, params, "cpu", toks, extra)
    gp = _to(params, cuda)
    assert _steps_tokens(cfg, gp, cuda, toks, extra) == want
    assert _steps_tokens(cfg, gp, cuda, toks, extra, graph=True) == want


@pytest.mark.gpu
def test_gpu_cross_attention_longer_than_its_context(cuda):
    """40 queries over whisper's 32-frame smoke context run in two launches
    of the paged entry (32 and 8) and match the CPU plain versions."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import forward, init_model
    cfg = get_smoke_config("whisper_large_v3").scaled(dtype="float32")
    params = init_model(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 40))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
    want, _ = forward(params, cfg, toks, enc_embeds=frames)
    n0 = flash_attention_h100.launches
    got, _ = forward(_to(params, cuda), cfg, toks,
                     enc_embeds=frames.to(cuda))
    torch.cuda.synchronize()
    # encoder 2 layers, decoder 2 layers of self (1) and cross (2) launches
    assert flash_attention_h100.launches == n0 + 2 + 2 * 3
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Training: K2b, K1's backward, the train step (card against CPU)
# ---------------------------------------------------------------------------

def _bwd_inputs(rows, h, hk, sq, page, d, lens, dev, dtype, seed=21):
    from repro_torch.kernels.flash_attention import flash_attention_paged_plain
    q = _t((rows, h, sq, d), seed, dev, dtype)
    k = _t((rows, page, hk, d), seed + 1, dev, dtype)
    v = _t((rows, page, hk, d), seed + 2, dev, dtype)
    do = _t((rows, h, sq, d), seed + 3, dev, dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    o = flash_attention_paged_plain(q, k, v, tables, ln, bq=16, bkv=64,
                                    kv_chunk=4096, causal=True)
    return q, k, v, o, do, ln


#: K2b's cases on the card (rows, h, hk, sq, page, d, causal, window,
#: lens, bq, bkv): three of its first kernel's, then every leaf of the
#: domain at a d 128 GQA signature (group 4) and at a d 64 one, a d that is
#: not a multiple of 8 (element loads), a window, ragged lengths with a row
#: of length 0, and sq < page without a causal mask.
_BWD_CASES = [
    (2, 8, 2, 100, 100, 128, True, None, [100, 77], 64, 64),
    (3, 4, 4, 20, 70, 64, False, None, [70, 0, 45], 32, 32),
    (2, 6, 3, 64, 64, 16, True, 16, [64, 64], 16, 16),
    *[(2, 8, 2, 96, 96, 128, True, None, [96, 61], bq, bkv)
      for bq in (16, 32, 64) for bkv in (16, 32, 64)],
    *[(2, 4, 4, 80, 80, 64, False, None, [80, 80], bq, bkv)
      for bq in (16, 32, 64) for bkv in (16, 32, 64)],
    (2, 8, 2, 50, 50, 100, True, None, [50, 33], 32, 16),
    (2, 8, 2, 90, 90, 128, True, 24, [90, 90], 32, 32),
    (4, 8, 2, 64, 64, 128, True, None, [64, 30, 0, 9], 64, 16),
    (2, 4, 2, 24, 100, 64, False, None, [100, 77], 16, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,h,hk,sq,page,d,causal,window,lens,bq,bkv",
                         _BWD_CASES)
def test_gpu_flash_bwd_kernel_matches_plain(cuda, dtype, tol, rows, h, hk,
                                            sq, page, d, causal, window,
                                            lens, bq, bkv):
    """K2b against its plain version on the same inputs: f32 (the FMA
    body) at 1e-4 of the largest gradient (sums in another order, ``expf``
    against ``torch.exp``), bf16 (the tensor-core body) at 2e-2 of it (both
    sum in f32 from the same bf16 inputs and round each gradient once,
    2^-8 of an element; the kernel also rounds P and dS to bf16 before
    their products).  Two launches give the same bits (no atomics), and a
    row of length 0 gets zeros."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_h100, flash_attention_bwd_plain, launches_a_call)
    q, k, v, _, do, ln = _bwd_inputs(rows, h, hk, sq, page, d, lens, cuda,
                                     dtype)
    o = _t((rows, h, sq, d), 40, cuda, dtype)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
    n0 = flash_attention_bwd_h100.launches
    got = flash_attention_bwd_h100(q, k, v, o, do, ln, **kw)
    again = flash_attention_bwd_h100(q, k, v, o, do, ln, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_h100.launches == n0 + 2 * launches_a_call(
        dtype)
    want = flash_attention_bwd_plain(q, k, v, o, do, ln, **kw)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        w = w.float()
        torch.testing.assert_close(g.float(), w, rtol=tol,
                                   atol=tol * float(w.abs().max()))
    if 0 in lens:
        r = lens.index(0)
        assert not any(x[r].any() for x in got)


@pytest.mark.gpu
def test_gpu_attention_fn_bf16_bwd_is_k2b_through_ops(cuda):
    """``AttentionFn`` in bf16 on the card: its backward gives the bits of
    K2b's tensor-core body called through ``ops.attention_bwd`` on the
    saved forward output, in three launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.autograd import AttentionFn
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_h100
    q, k, v, _, do, ln = _bwd_inputs(2, 8, 2, 64, 64, 128, [64, 41], cuda,
                                     torch.bfloat16)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = AttentionFn.apply(q, k, v, None, ln, True, None)
    n0 = flash_attention_bwd_h100.launches
    o.backward(do)
    torch.cuda.synchronize()
    assert flash_attention_bwd_h100.launches == n0 + 3
    want = ops.attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                             do, ln, causal=True)
    for g, x in zip(want, (q, k, v)):
        assert x.grad.dtype == torch.bfloat16 and torch.equal(g, x.grad)


@pytest.mark.gpu
def test_gpu_flash_bwd_refuses_instead_of_falling_back(cuda):
    """On CUDA tensors K2b launches or raises: a paged pool (a table other
    than [[b]]), mixed types and a CPU length tensor all raise."""
    from repro_torch.kernels.autograd import AttentionFn
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_h100
    q, k, v, o, do, ln = _bwd_inputs(2, 4, 2, 16, 16, 64, [16, 16], cuda,
                                     torch.float32)
    swapped = torch.tensor([[1], [0]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="paged pool has no backward"):
        AttentionFn.apply(q, k, v, swapped, ln, True, None)
    kw = dict(bq=16, bkv=16)
    with pytest.raises(TypeError):
        flash_attention_bwd_h100(q, k.bfloat16(), v, o, do, ln, **kw)
    with pytest.raises(ValueError):
        flash_attention_bwd_h100(q, k, v, o, do, ln.cpu(), **kw)
    with pytest.raises(ValueError):
        flash_attention_bwd_h100(q, k, v, o, do, ln, bq=128, bkv=16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_gpu_matmul_fn_backward_matches_autograd_of_plain(cuda, dtype, tol):
    """``MatmulFn`` on the card (K1 forward; K1 over K4's transposes
    backward) against autograd of K1's plain version, at a training shape
    whose reduction dimension (dB's: the token count) is long."""
    from repro_torch.kernels.autograd import MatmulFn
    from repro_torch.kernels.transpose import transpose_h100
    a0 = _t((512, 256), 30, cuda)
    b0 = _t((256, 384), 31, cuda) / 16
    dc = _t((512, 384), 32, cuda)
    a, b = (x.to(dtype).requires_grad_() for x in (a0, b0))
    t0 = transpose_h100.launches
    m0 = matmul_h100.launches
    MatmulFn.apply(a, b).backward(dc)
    torch.cuda.synchronize()
    assert (matmul_h100.launches - m0, transpose_h100.launches - t0) == (3, 2)
    a2, b2 = (x.to(dtype).requires_grad_() for x in (a0, b0))
    matmul_plain(a2, b2, bm=16, bn=32, bk=32, s=1).backward(dc)
    for got, want in ((a.grad, a2.grad), (b.grad, b2.grad)):
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("E,M,N,K", [(16, 80, 384, 256), (3, 5, 40, 200)])
def test_gpu_batched_matmul_fn_backward_matches_autograd_of_plain(
        cuda, dtype, tol, E, M, N, K):
    """``BatchedMatmulFn`` on the card against autograd of the plain
    version of its route: in f32 K1's batched entry forward and the same
    over K4's batched transposes backward (three K1 batched and two K4b
    launches, no 2-D launch); in bf16 K1b forward and backward, dA and dB
    reading the stored operands transposed (three K1b launches, nothing
    else)."""
    from repro_torch.kernels.autograd import BatchedMatmulFn
    from repro_torch.kernels.matmul_experts import (matmul_experts_h100,
                                                    matmul_experts_plain)
    from repro_torch.kernels.transpose import transpose_h100_batched
    a0 = _t((E, M, K), 33, cuda)
    b0 = _t((E, K, N), 34, cuda) / 16
    dc = _t((E, M, N), 35, cuda).to(dtype)
    a, b = (x.to(dtype).requires_grad_() for x in (a0, b0))
    counters = (matmul_h100_batched, transpose_h100_batched,
                matmul_experts_h100, matmul_h100, transpose_h100)
    c0 = [k.launches for k in counters]
    BatchedMatmulFn.apply(a, b).backward(dc)
    torch.cuda.synchronize()
    want = (3, 2, 0, 0, 0) if dtype == torch.float32 else (0, 0, 3, 0, 0)
    assert tuple(k.launches - n for k, n in zip(counters, c0)) == want
    a2, b2 = (x.to(dtype).requires_grad_() for x in (a0, b0))
    if dtype == torch.float32:
        matmul_batched_plain(a2, b2, bm=16, bn=32, bk=32, s=1).backward(dc)
    else:
        matmul_experts_plain(a2, b2).backward(dc)
    for got, want in ((a.grad, a2.grad), (b.grad, b2.grad)):
        assert got.dtype == dtype
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


# ---------------------------------------------------------------------------
# K1b: the experts' batched product on TMA and wgmma (matmul_experts_h100)
# ---------------------------------------------------------------------------

#: Every format the family's domain holds whose ring and staging tile fit.
K1B_FORMATS = [(bm, bn, st) for bm in (64, 128) for bn in (64, 128, 256)
               for st in (2, 3, 4)
               if not (bm == 128 and bn == 256 and st == 4)]
#: (E, M, N, K): E 4, 16 and 384; ragged M (27, 80, 200), K not a multiple
#: of the 64-deep k tile (72, 520), N not a multiple of any bn (136).
K1B_SHAPES = [(4, 80, 192, 256), (16, 27, 136, 72), (4, 200, 256, 520),
              (384, 4, 64, 128)]
#: Layouts (ta, tb): NN the forward, NT dA = dC·Bᵀ, TN dB = Aᵀ·dC.
K1B_LAYOUTS = {"NN": (False, False), "NT": (False, True),
               "TN": (True, False)}


def _k1b_operands(E, M, N, K, ta, tb, dev, seed=41):
    a = _t((E, K, M) if ta else (E, M, K), seed, dev, torch.bfloat16)
    b = (_t((E, N, K) if tb else (E, K, N), seed + 1, dev) / K ** 0.5).to(
        torch.bfloat16)
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(K1B_LAYOUTS))
@pytest.mark.parametrize("E,M,N,K", K1B_SHAPES)
def test_gpu_matmul_experts_matches_plain(cuda, layout, E, M, N, K):
    """K1b at every format of its domain against its plain version, bf16
    out within one bf16 step (rtol = atol = 1e-2: both sum in f32 and
    round once, in another order of sums); a transposed operand is read in
    place (A stored [E, K, M] for TN, B stored [E, N, K] for NT).  A TN
    product whose M is no multiple of 8 has rows of A that TMA cannot
    address and is refused."""
    from repro_torch.kernels.matmul_experts import (format_error,
                                                    matmul_experts_h100,
                                                    matmul_experts_plain)
    ta, tb = K1B_LAYOUTS[layout]
    a, b = _k1b_operands(E, M, N, K, ta, tb, cuda)
    want = matmul_experts_plain(a, b, ta=ta, tb=tb)
    for bm, bn, stages in K1B_FORMATS:
        kw = dict(bm=bm, bn=bn, stages=stages)
        if format_error(E, M, N, K, ta=ta, tb=tb, **kw) is not None:
            assert ta and M % 8
            with pytest.raises(ValueError):
                matmul_experts_h100(a, b, ta, tb, **kw)
            continue
        got = matmul_experts_h100(a, b, ta, tb, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (E, M, N)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2, msg=str(kw))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(K1B_LAYOUTS))
def test_gpu_matmul_experts_is_bit_for_bit_and_counted(cuda, layout):
    """Two launches equal bit for bit (each element one fixed order of
    sums), each counted once on ``matmul_experts_h100`` under its
    signature and on no other wrapper; a CUDA graph's replay (the tensor
    maps captured by value) equals the eager launch."""
    from repro_torch.kernels.matmul_experts import matmul_experts_h100
    ta, tb = K1B_LAYOUTS[layout]
    E, M, N, K = 16, 80, 320, 200
    a, b = _k1b_operands(E, M, N, K, ta, tb, cuda, seed=43)
    kw = dict(bm=128, bn=128, stages=3)
    n0, m0 = matmul_experts_h100.launches, matmul_h100_batched.launches
    s0 = matmul_experts_h100.shapes[(E, M, N, K, ta, tb, 128, 128, 3,
                                     torch.bfloat16)]
    one = matmul_experts_h100(a, b, ta, tb, **kw)
    two = matmul_experts_h100(a, b, ta, tb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert matmul_experts_h100.launches == n0 + 2
    assert matmul_h100_batched.launches == m0
    assert matmul_experts_h100.shapes[(E, M, N, K, ta, tb, 128, 128, 3,
                                       torch.bfloat16)] == s0 + 2
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = matmul_experts_h100(a, b, ta, tb, **kw)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, one)


@pytest.mark.gpu
def test_gpu_matmul_experts_refuses_what_it_cannot_take(cuda):
    """A base off the 16-byte boundary, rows that are no multiple of 16
    bytes, f32 operands, a non-contiguous operand and both operands
    transposed are refused before any launch, and nothing is counted."""
    from repro_torch.kernels.matmul_experts import matmul_experts_h100
    kw = dict(bm=64, bn=64, stages=2)
    E, M, N, K = 4, 16, 64, 64
    a, b = _k1b_operands(E, M, N, K, False, False, cuda)
    flat = torch.zeros(E * M * K + 1, dtype=torch.bfloat16, device=cuda)
    off = flat[1:].view(E, M, K)                  # 2 bytes past the boundary
    off.copy_(a)
    n0 = matmul_experts_h100.launches
    with pytest.raises(ValueError, match="16-byte"):
        matmul_experts_h100(off, b, **kw)
    with pytest.raises(ValueError, match="16 bytes"):
        matmul_experts_h100(a[:, :, :60].contiguous(),
                            b[:, :60].contiguous(), **kw)
    with pytest.raises(TypeError):
        matmul_experts_h100(a.float(), b.float(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_experts_h100(a.transpose(1, 2), b, True, False, **kw)
    with pytest.raises(ValueError, match="both"):
        matmul_experts_h100(a.transpose(1, 2).contiguous(),
                            b.transpose(1, 2).contiguous(), True, True, **kw)
    assert matmul_experts_h100.launches == n0
    torch.testing.assert_close(
        matmul_experts_h100(a, b, **kw).float(),
        (a.float() @ b.float()).to(torch.bfloat16).float(), rtol=1e-2,
        atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_ops_matmul_batched_routes_by_type(cuda, dtype):
    """``ops.matmul_batched`` on the card: bf16 operands launch K1b once a
    call, whatever the layout, and return bf16; f32 operands launch K1's
    batched entry (after a K4b copy of a transposed operand) and return
    f32, each within its tolerance of the product."""
    from repro_torch.kernels.matmul_experts import matmul_experts_h100
    from repro_torch.kernels.transpose import transpose_h100_batched
    E, M, N, K = 8, 40, 96, 128
    for ta, tb in K1B_LAYOUTS.values():
        a, b = (x.to(dtype) for x in _k1b_operands(E, M, N, K, ta, tb,
                                                    cuda))
        counters = (matmul_experts_h100, matmul_h100_batched,
                    transpose_h100_batched)
        c0 = [k.launches for k in counters]
        got = ops.matmul_batched(a, b, ta=ta, tb=tb)
        torch.cuda.synchronize()
        moved = tuple(k.launches - n for k, n in zip(counters, c0))
        A = a.float().transpose(1, 2) if ta else a.float()
        B = b.float().transpose(1, 2) if tb else b.float()
        want = A @ B
        if dtype == torch.bfloat16:
            assert moved == (1, 0, 0) and got.dtype == torch.bfloat16
            torch.testing.assert_close(got.float(), want.to(dtype).float(),
                                       rtol=1e-2, atol=1e-2)
        else:
            assert moved == (0, 1, int(ta) + int(tb))
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=1e-4, atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen1p5_4b",
                                  "chameleon_34b", "whisper_large_v3",
                                  "mamba2_130m", "hymba_1p5b",
                                  "llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_gpu_train_step_equals_cpu(cuda, arch):
    """One f32 train step (AdamW, microbatches 2) of the smoke config on
    the card against the CPU plain versions from the same state: loss at
    rtol 1e-5, grad_norm at 1e-4 (sums in another order), the updated
    parameters within 1e-6 except at most one element in a thousand,
    which may differ by up to 2·lr where its gradient rounds to the other
    sign (AdamW moves every element by about ±lr)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, constant, tree_leaves
    from repro_torch.runtime import build_train_step
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    lr = 1e-3
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)),
             "labels": rng.integers(0, cfg.vocab, (4, 32))}
    if cfg.encoder is not None:
        batch["enc_embeds"] = rng.standard_normal(
            (4, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        params = init_train_state(cfg, seed=2, device="cpu")
        params = _to(params, dev)
        opt = adamw(constant(lr))
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        params, _, m = build_train_step(cfg, opt, microbatches=2)(
            params, opt.init(params), tb, 0)
        out[str(dev)] = ({k: float(v) for k, v in m.items()},
                         [p.detach().cpu() for p in tree_leaves(params)])
    (gm, gp), (wm, wp) = out[str(cuda)], out["cpu"]
    assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-5)
    assert gm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-4)
    flips = total = 0
    for g, w in zip(gp, wp):
        d = (g - w).abs()
        assert float(d.max()) <= 2 * lr + 1e-6
        flips += int((d > 1e-6).sum())
        total += d.numel()
    assert flips <= total / 1000


# ---------------------------------------------------------------------------
# K3b, the SSD scan's backward, and the SSM and hybrid configs' training
# ---------------------------------------------------------------------------

def _ssd_bwd_inputs(rows, seq, heads, hd, state, dev, dtype, *, shared=True,
                    with_state=False, with_dsf=False, seed=50):
    """x, a in (0.05, 0.95), b, c ([rows, seq, state] when shared), state0,
    dy and dS_final, from numpy with a seed."""
    x = _t((rows, seq, heads, hd), seed, dev, dtype)
    a = torch.sigmoid(_t((rows, seq, heads), seed + 1, dev)) * 0.9 + 0.05
    bc = (rows, seq, state) if shared else (rows, seq, heads, state)
    b, c = _t(bc, seed + 2, dev, dtype), _t(bc, seed + 3, dev, dtype)
    s0 = _t((rows, heads, state, hd), seed + 4, dev) if with_state else None
    dy = _t((rows, seq, heads, hd), seed + 5, dev, dtype)
    dsf = _t((rows, heads, state, hd), seed + 6, dev) if with_dsf else None
    return x, a, b, c, s0, dy, dsf


#: K3b's cases on the card (rows, seq, heads, hd, state, chunk, shared,
#: state0 given, dS_final given): the training keys of mamba2-130m (state
#: 128, 24 heads) and hymba-1.5b (state 16, 25 heads) at every chunk of the
#: domain, seq 1, 8, 200 and 1000 (ragged last chunks), b and c per head, a
#: given state0 and dS_final, an hd of 100 (the states kernel's last tile
#: of 32 columns cut).
_SSD_BWD_CASES = [
    (4, 1024, 24, 64, 128, 64, True, False, False),
    (2, 2048, 25, 64, 16, 64, True, False, False),
    (2, 256, 24, 64, 128, 16, True, False, False),
    (2, 256, 25, 64, 16, 32, True, False, False),
    (3, 1, 24, 64, 128, 64, True, True, True),
    (3, 8, 25, 64, 16, 64, True, True, True),
    (2, 200, 24, 64, 128, 64, True, True, True),
    (2, 1000, 25, 64, 16, 64, True, False, True),
    (2, 40, 4, 16, 8, 16, False, True, False),
    (1, 100, 3, 100, 20, 32, True, True, True),
]


def _held_to_plain(got, again, want, s0, tol):
    """Each gradient equal over two launches and within ``tol`` (dx, db,
    dc) or 1e-4 (da, d(state0): f32 in both types) of its largest element
    against the plain version; no state0, no d(state0)."""
    for i, (g, ag, w) in enumerate(zip(got, again, want)):
        if w is None:
            assert i == 4 and s0 is None and g is None and ag is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape and \
            torch.equal(g, ag), i
        t = tol if i in (0, 2, 3) else 1e-4
        w = w.float()
        torch.testing.assert_close(g.float(), w, rtol=t,
                                   atol=t * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "rows,seq,heads,hd,state,chunk,shared,with_state,with_dsf",
    _SSD_BWD_CASES)
def test_gpu_ssd_bwd_kernel_matches_plain(cuda, dtype, tol, rows, seq, heads,
                                          hd, state, chunk, shared,
                                          with_state, with_dsf):
    """K3b against its plain version on the same inputs, each gradient
    within ``tol`` of its largest element: f32 at 1e-4 (the same chunk
    formulas summed in another order, ``expf``/``logf`` against
    ``torch.exp``/``log``), bf16 inputs at 2e-2 (both sum in f32 from the
    same bf16 values and round dx, db, dc once to bf16; the tensor cores'
    products split S_in and dS_out where they reach da; da and d(state0)
    are f32 on both sides and held at 1e-4).  Two launches give the same
    bits (no atomics), three kernels a call; no state0, no d(state0)."""
    from repro_torch.kernels.ssd_scan_bwd import (
        LAUNCHES_A_CALL, ssd_scan_bwd_h100, ssd_scan_bwd_plain)
    x, a, b, c, s0, dy, dsf = _ssd_bwd_inputs(
        rows, seq, heads, hd, state, cuda, dtype, shared=shared,
        with_state=with_state, with_dsf=with_dsf)
    kw = dict(chunk=chunk)
    n0 = ssd_scan_bwd_h100.launches
    got = ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, **kw)
    again = ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, **kw)
    torch.cuda.synchronize()
    assert ssd_scan_bwd_h100.launches == n0 + 2 * LAUNCHES_A_CALL
    want = ssd_scan_bwd_plain(x, a, b, c, s0, dy, dsf, **kw)
    _held_to_plain(got, again, want, s0, tol)


#: The bf16 body at every chunk it takes, 128 (outside the family's tree,
#: which stops at the f32 body's 64) included, at each case's shape.
_SSD_BWD_TC_CASES = [
    case[:5] + (chunk,) + case[6:] for case in _SSD_BWD_CASES
    for chunk in (16, 32, 64, 128) if chunk != case[5]
] + [(2, 999, 24, 64, 128, 64, True, True, True),   # last chunk of 39 steps
     (2, 999, 25, 64, 16, 128, True, False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,seq,heads,hd,state,chunk,shared,with_state,with_dsf",
    _SSD_BWD_TC_CASES)
def test_gpu_ssd_bwd_tc_body_at_every_chunk(cuda, rows, seq, heads, hd,
                                            state, chunk, shared,
                                            with_state, with_dsf):
    """K3b's bf16 body on the tensor cores at each case's shape and every
    other chunk of its domain, and at a seq of 999 (a last chunk that is
    no multiple of 16): held against the plain version at the same chunk
    as ``test_gpu_ssd_bwd_kernel_matches_plain`` holds it, two launches bit
    for bit."""
    from repro_torch.kernels.ssd_scan_bwd import (ssd_scan_bwd_h100,
                                                  ssd_scan_bwd_plain)
    x, a, b, c, s0, dy, dsf = _ssd_bwd_inputs(
        rows, seq, heads, hd, state, cuda, torch.bfloat16, shared=shared,
        with_state=with_state, with_dsf=with_dsf)
    got = ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, chunk=chunk)
    again = ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, chunk=chunk)
    torch.cuda.synchronize()
    want = ssd_scan_bwd_plain(x, a, b, c, s0, dy, dsf, chunk=chunk)
    _held_to_plain(got, again, want, s0, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_gpu_ssd_bwd_in_a_cuda_graph(cuda, chunk):
    """K3b captured in a CUDA graph (its workspace sized by an eager call
    first) replays the eager call's bits."""
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd_h100
    x, a, b, c, s0, dy, dsf = _ssd_bwd_inputs(2, 300, 24, 64, 128, cuda,
                                              torch.bfloat16, with_dsf=True)
    kw = dict(chunk=chunk)
    want = ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = ssd_scan_bwd_h100(x, a, b, c, s0, dy, dsf, **kw)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got[:4], want[:4]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_ssd_scan_fn_bwd_is_k3b_through_ops(cuda, dtype):
    """``SsdScanFn`` on the card: its backward gives the bits of K3b
    called through ``ops.ssd_scan_bwd`` on the saved inputs, in three
    launches, with gradients in the inputs' types and shapes."""
    from repro_torch.kernels.autograd import SsdScanFn
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd_h100
    x, a, b, c, _, dy, _ = _ssd_bwd_inputs(2, 256, 24, 64, 128, cuda, dtype)
    leaves = [t.requires_grad_() for t in (x, a, b, c)]
    y, _ = SsdScanFn.apply(*leaves, None)
    n0 = ssd_scan_bwd_h100.launches
    y.backward(dy)
    torch.cuda.synchronize()
    assert ssd_scan_bwd_h100.launches == n0 + 3
    want = ops.ssd_scan_bwd(*(t.detach() for t in leaves), None, dy, None)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype and torch.equal(leaf.grad, w)


@pytest.mark.gpu
def test_gpu_ssd_bwd_refuses_instead_of_falling_back(cuda):
    """On CUDA tensors K3b launches or raises: mixed types, a CPU decay, a
    chunk over 64 in f32 (over 128 in bf16), an hd over 128 and a bf16
    state over 256 all raise; the autograd function refuses the serve
    path's in-place updates."""
    from repro_torch.kernels.autograd import SsdScanFn
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd_h100
    x, a, b, c, s0, dy, _ = _ssd_bwd_inputs(1, 200, 2, 16, 8, cuda,
                                            torch.float32, with_state=True)
    kw = dict(chunk=16)
    with pytest.raises(TypeError):
        ssd_scan_bwd_h100(x, a, b.bfloat16(), c, None, dy, None, **kw)
    with pytest.raises(ValueError):
        ssd_scan_bwd_h100(x, a.cpu(), b, c, None, dy, None, **kw)
    with pytest.raises(ValueError, match="ck not in"):
        ssd_scan_bwd_h100(x, a, b, c, None, dy, None, chunk=128)
    big = _ssd_bwd_inputs(1, 16, 1, 160, 8, cuda, torch.float32)
    with pytest.raises(ValueError, match="hd over"):
        ssd_scan_bwd_h100(*big, **kw)
    # the bf16 body: a chunk over 128, a state over 256
    x, a, b, c, _, dy, _ = _ssd_bwd_inputs(1, 300, 2, 16, 8, cuda,
                                           torch.bfloat16)
    with pytest.raises(ValueError, match="ck not in"):
        ssd_scan_bwd_h100(x, a, b, c, None, dy, None, chunk=256)
    wide = _ssd_bwd_inputs(1, 32, 1, 16, 272, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="state over"):
        ssd_scan_bwd_h100(*wide, **kw)
    with pytest.raises(ValueError, match="no backward"):
        SsdScanFn.apply(x.requires_grad_(), a, b, c, s0, s0, None, None)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,dtype", [
    (4096, 768, 24, torch.float32),       # mamba2-130m's decay projection
    (8192, 1600, 25, torch.float32),      # hymba-1.5b's
    (8192, 1600, 16, torch.bfloat16),     # hymba-1.5b's b and c
    (4096, 768, 128, torch.bfloat16)])    # mamba2-130m's b and c
def test_gpu_matmul_fn_backward_at_the_ssm_projections(cuda, M, K, N, dtype):
    """``MatmulFn``'s backward at the SSM projections' training shapes,
    whose dA product has an inner dimension of 16-128 and whose f32
    transposes are (768, 24) and (1600, 25): K1 and K4 against autograd of
    K1's plain version (f32 at 1e-4 of the largest element, bf16 at
    2e-2), and each K4 transpose bit for bit."""
    from repro_torch.kernels.autograd import MatmulFn
    a0 = _t((M, K), 60, cuda)
    b0 = _t((K, N), 61, cuda) / 16
    dc = _t((M, N), 62, cuda)
    a, b = (x.to(dtype).requires_grad_() for x in (a0, b0))
    MatmulFn.apply(a, b).backward(dc)
    a2, b2 = (x.to(dtype).requires_grad_() for x in (a0, b0))
    matmul_plain(a2, b2, bm=16, bn=32, bk=32, s=1).backward(dc)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((a.grad, a2.grad), (b.grad, b2.grad)):
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))
    for t in (a.detach(), b.detach()):
        assert torch.equal(ops.transpose(t), t.t().contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_gpu_flash_bwd_at_hymbas_group_and_window(cuda, dtype, tol):
    """K2b at hymba-1.5b's training signature: 25 query heads over 5 KV
    heads (group 5), head dim 64, a window of 1024 over 2048 keys, through
    the pick of its key; against the plain version as
    ``test_gpu_flash_bwd_kernel_matches_plain`` holds it, two launches bit
    for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_paged_plain
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_h100, flash_attention_bwd_plain)
    pick = ops.select("flash_attention_bwd_h100", {
        "SQ": 2048, "HD": 64, "GROUP": 5, "HK": 5}).assignment
    q, k, v, _, do, ln = _bwd_inputs(1, 25, 5, 2048, 2048, 64, [2048], cuda,
                                     dtype)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    o = flash_attention_paged_plain(q, k, v, tables, ln, bq=16, bkv=64,
                                    kv_chunk=4096, causal=True, window=1024)
    kw = dict(bq=pick["bq"], bkv=pick["bkv"], causal=True, window=1024)
    got = flash_attention_bwd_h100(q, k, v, o, do, ln, **kw)
    again = flash_attention_bwd_h100(q, k, v, o, do, ln, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, do, ln, **kw)
    for g, ag, w in zip(got, again, want):
        assert torch.equal(g, ag)
        w = w.float()
        torch.testing.assert_close(g.float(), w, rtol=tol,
                                   atol=tol * float(w.abs().max()))


# ---------------------------------------------------------------------------
# Multi-device at world size 1 (chip_smoke.py phase 14 (a) and (b))
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """NCCL at world size 1 on a ``file://`` store, and its (1, 1) mesh
    over ("data", "model"); the process group ends with the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    store = tmp_path_factory.mktemp("nccl") / "init"
    init_distributed(init_method=f"file://{store}", rank=0, world_size=1,
                     backend="nccl")
    yield make_mesh((1, 1), ("data", "model"))
    tdist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_collectives_at_world_size_one_are_bit_for_bit(nccl_mesh, dtype):
    """At one rank NCCL's all-to-all and all-reduce give their input
    back, and so do their adjoints (the differentiable wrappers')."""
    from repro_torch.distributed.comm import all_reduce_sum, all_to_all
    group = nccl_mesh.group(("data", "model"))
    x = torch.randn((16, 80, 64), device="cuda", dtype=dtype,
                    requires_grad=True)
    y = all_to_all(x, group)
    z = all_reduce_sum(y.float(), group)
    assert torch.equal(y, x) and torch.equal(z, x.float())
    g = torch.randn_like(z)
    z.backward(g)
    assert torch.equal(x.grad, g.to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_gpu_moe_a2a_at_world_size_one_is_the_dense_layer(nccl_mesh, arch):
    """Under the (1, 1) mesh the a2a schedule routes as the dense layer
    does and runs the same kernels on the same rows: y, aux and the
    gradients bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as dist
    from repro_torch.models.moe import moe_block
    from repro_torch.models.moe_a2a import moe_block_a2a
    cfg = get_smoke_config(arch).scaled(dtype="float32",
                                        perf_flags=("moe_a2a",))
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                / shape[-2] ** 0.5)
    E, f = m.num_experts, m.d_ff_expert
    p = {"router": w(d, E), "wi": w(E, d, f), "wg": w(E, d, f),
         "wo": w(E, f, d)}
    x = torch.randn((2, 32, d), generator=gen, device="cuda")
    out = []
    for fn in (moe_block, moe_block_a2a):
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        with dist.use_mesh_rules(nccl_mesh, dist.rules_for(cfg, nccl_mesh)):
            y, aux = fn(q, x, cfg)
            ((y * y).sum() + 0.01 * aux).backward()
        out.append((y.detach(), aux.detach(),
                    {k: v.grad for k, v in q.items()}))
    (y0, a0, g0), (y1, a1, g1) = out
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_gpu_mesh_train_step_card_against_cpu(nccl_mesh, arch):
    """Three f32 steps of the mesh's step under ``moe_a2a`` (each full
    config's optimizer: kimi's Adafactor) on the card (NCCL) against the
    CPU (a gloo mesh of the same process), from one init: chip_smoke.py
    14 (b)'s tolerances."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_train_state
    from repro_torch.optim import (constant, make_optimizer, tree_leaves,
                                   tree_map)
    from repro_torch.runtime import build_train_step
    lr, steps = 1e-3, 3
    cfg = get_smoke_config(arch).scaled(
        dtype="float32", param_dtype="float32", perf_flags=("moe_a2a",),
        optimizer=get_config(arch).optimizer)
    meshes = {"cpu": make_mesh((1, 1), ("data", "model"), backend="gloo"),
              "cuda": nccl_mesh}
    rng = np.random.default_rng(7)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))
                for k in ("tokens", "labels")} for _ in range(steps)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev),
                          init_train_state(cfg, seed=2, device="cpu"))
        opt = make_optimizer(cfg.optimizer, constant(lr))
        state = opt.init(params)
        step_fn = build_train_step(cfg, opt, microbatches=2,
                                   mesh=meshes[dev])
        ms = []
        for i, b in enumerate(batches):
            params, state, m = step_fn(
                params, state, {k: v.to(dev) for k, v in b.items()}, i)
            ms.append({k: float(v) for k, v in m.items()})
        out[dev] = ms, [p.detach().cpu() for p in tree_leaves(params)]
    (gm, gp), (wm, wp) = out["cuda"], out["cpu"]
    for a, b in zip(gm, wm):
        for k in ("loss", "nll", "moe_aux"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    flips = total = 0
    for g, w in zip(gp, wp):
        diff = (g - w).abs()
        assert float(diff.max()) <= 2 * lr * steps + 1e-6
        flips += int((diff > 1e-6).sum())
        total += diff.numel()
    assert flips <= total / 1000


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3_8b", "chameleon_34b",
                                  "mamba2_130m", "hymba_1p5b",
                                  "llama4_scout_17b_a16e"])
def test_gpu_sharded_mesh_step_at_world_size_one_is_the_one_card_step(
        nccl_mesh, arch):
    """chip_smoke.py 14 (e), (h) and (i) at smoke size: the mesh step over
    NCCL at world size 1 (tensor parallelism of the attention, MLP and SSD
    layers, FSDP for chameleon-34b's and llama4-scout's names, ZeRO-1 and
    the dense MoE layer's expert parallelism realised on the (1, 1) mesh,
    every spec whole) from ``launch.specs.rank_state``, three bf16 steps,
    bit for bit with the one-card step: metrics and every parameter."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import rank_state
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, constant, tree_leaves
    from repro_torch.runtime import build_train_step
    cfg = get_smoke_config(arch)
    if arch in ("chameleon_34b", "llama4_scout_17b_a16e"):
        cfg = cfg.scaled(name={"chameleon_34b": "chameleon-34b"}.get(
            arch, "llama4-scout-17b-a16e"))
    rng = np.random.default_rng(11)
    S = 272 if cfg.frontend == "stub" else 32
    batches = []
    for _ in range(3):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, S))).cuda()
             for k in ("tokens", "labels")}
        if cfg.frontend == "stub":
            b["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (4, 256, cfg.d_model)).astype(np.float32)).cuda()
        batches.append(b)
    out = []
    for mesh in (None, nccl_mesh):
        opt = adamw(constant(1e-3))
        if mesh is None:
            params = init_train_state(cfg, seed=4, device="cuda")
            state = opt.init(params)
        else:
            params, state, _ = rank_state(cfg, mesh, opt, seed=4,
                                          device="cuda")
        step = build_train_step(cfg, opt, microbatches=2, mesh=mesh)
        ms = []
        for i, b in enumerate(batches):
            params, state, m = step(params, state, b, i)
            ms.append({k: float(v) for k, v in m.items()})
        out.append((ms, [p.detach().clone() for p in tree_leaves(params)]))
    (wm, wp), (gm, gp) = out
    assert gm == wm
    assert all(torch.equal(g, w) for g, w in zip(gp, wp))
