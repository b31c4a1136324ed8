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
#: split and several.
FA_PAGED_CASES = [
    (32, 8, 128, None, 4, 1, [77, 0, 200, 256], 16, 16, 16, 64, 4096),
    (32, 8, 128, None, 4, 1, [77, 0, 3000, 4096], 256, 16, 16, 64, 256),
    (25, 5, 64, 1024, 4, 1, [77, 0, 1500, 4096], 256, 16, 16, 64, 512),
    (32, 8, 128, None, 1, 32, [96], 16, 16, 128, 32, 4096),
    (32, 8, 128, None, 1, 256, [3000], 256, 16, 64, 64, 1024),
    (25, 5, 64, 1024, 1, 32, [1900], 256, 16, 64, 64, 512)]


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
@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_130m", "hymba_1p5b"])
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
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_gpu_jacobi_leaves_x_and_copies_only_the_ends(cuda, steps):
    """The first sweep reads x itself and every sweep writes its buffer's
    two fixed ends: x is untouched, the result is a new tensor whose ends
    are x's, and it equals the plain version bit for bit."""
    x = _t((2 ** 21 + 2,), 17, cuda)
    before = x.clone()
    got = jacobi1d_h100(x, steps, B=1024, s=8)
    torch.cuda.synchronize()
    assert torch.equal(x, before) and got.data_ptr() != x.data_ptr()
    assert torch.equal(got[[0, -1]], x[[0, -1]])
    assert torch.equal(got, jacobi1d_plain(x, steps, B=1024, s=8))


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


# ---------------------------------------------------------------------------
# The engine options on the card: degrade with recapture, prefix sharing,
# serve plans
# ---------------------------------------------------------------------------

def _f32_engine(arch, dev, seed=5, **kw):
    """An f32 smoke engine on ``dev`` with weights made on the CPU (the
    same weights on either device)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.runtime import ServeEngine

    def to(node):
        if isinstance(node, dict):
            return {k: to(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to(v) for v in node]
        return node.to(dev)
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = to(init_model(cfg, seed=seed, device="cpu"))
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
