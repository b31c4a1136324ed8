"""K2 ``flash_attention_h100`` — online-softmax attention on Hopper.

Replaces the TPU kernel ``pallas_flash_attention``
(``src/repro/kernels/flash_attention.py``, ``_fa_kernel``) with the
hand-written CUDA kernel in ``csrc/flash_attention.cu``: q [h, sq, d],
k, v [hk, sk, d] with h a multiple of hk (query head i reads KV head
i // (h/hk), the JAX grouping), sq <= sk and ends aligned (query i at key
i + sk − sq), causal and sliding-window masks, scale 1/√d, m/l/acc in f32,
output in q's type.  The JAX kernel takes K/V broadcast to every query
head; nothing in the function it computes needs that, and the kernel reads
each K/V tile once for the group of query heads that shares it.

Unlike the TPU kernel, keys at or past ``sk`` never enter the softmax when
``causal=False`` (the TPU kernel pads K/V to a whole tile and scores the
padding: ROADMAP F1); this kernel and its plain version compute
``ref.flash_attention``.

Bound on the card: the serve path's prefill chunks and decode rows do a
few to a few hundred flops per K/V byte — bound by the bytes of K/V.  The
kernel packs the group's query heads × query rows into the tensor-core M
(bf16 on ``mma.sync``, f32 in FMA), streams K/V through a ``cp.async`` ring
of ``stages`` tiles of ``bkv`` keys, and splits the keys into runs of
``kv_chunk`` over blocks, combined in split order by a second small launch
(see the note in the CUDA source).  The number of splits comes from each
call's own sk, so decode steps with a growing cache share one dispatch key.

The paged entry (:func:`flash_attention_h100_paged`) is the same kernel over
the serve path's KV pool: q [rows, h, sq, d], one layer's pools [num_blocks,
page, hk, d] read in place through device block tables [rows, nblk], and the
rows' lengths [rows] on the device, one launch a layer for every row.  Row r
attends over keys 0 .. len[r] − 1 with its queries ends-aligned at
len[r] − 1; a row of length 0 gives zeros.  Its number of splits comes from
the pool (ceil(nblk · page / kv_chunk)), so a CUDA graph can replay it while
the lengths change.  A bf16 pool serves f32 q too, upcast as it is loaded.

Program parameters:  bq (packed rows a block, 16 a warp), bkv (keys a
                     tile), kv_chunk (keys a split), stages (ring depth)
Data parameters:     SQ, HD, GROUP (query heads a KV head), HK (KV heads)
Machine parameters:  V (shared bytes a block), T (threads a block),
                     G (registers a thread), LANE, CORES

The split workspace (f32 partials) is one per device (:mod:`.workspace`):
it grows on demand until a captured CUDA graph holds it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.counters import Counter, performance, resource
from ..core.plan import KernelPlan, ParamDomain
from ..core.polynomial import Poly, V
from ..core.strategies import Strategy
from . import build
from .instantiate_cache import CachedInstantiationMixin
from .workspace import Workspace

_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: flash_attention_h100_launch(q, k, v, o, ws, h, hk, sq, sk, d, bq, bkv,
#: kv_chunk, stages, scale, causal, window, elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9
             + (ctypes.c_float,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
#: flash_attention_h100_paged_launch(q, k, v, o, ws, tables, lens, rows, h,
#: hk, sq, d, num_blocks, page, nblk, bq, bkv, kv_chunk, stages, scale,
#: causal, window, elem, kv_elem, stream)
_PAGED_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 12
                   + (ctypes.c_float,) + (ctypes.c_int,) * 4
                   + (ctypes.c_void_p,))
#: The C entry point's limits (``csrc/flash_attention.cu``).
MAX_HD = 128
MAX_SMEM = 232_448
MAX_GRID_YZ = 65_535
BQ = (16, 32, 64, 128)
BKV = (32, 64)
STAGES = (2, 3, 4)


def tile_dim(d: int) -> int:
    """The head dim the kernel's tiles are built for: 64 or 128 (d <= 64
    runs in the 64-wide tiles, its columns past d zero)."""
    return 64 if d <= 64 else 128


def key_warps(bq: int, bkv: int) -> int:
    """Warps a block gives each row warp: decode's few rows (bq 16 or 32)
    take 64 / bq warps each, on a slice of at least 16 keys of every kv
    tile, so that a block has 4 warps; bq >= 64 runs one."""
    return 1 if bq >= 64 else min(64 // bq, bkv // 16)


def threads(bq: int, bkv: int) -> int:
    """Threads a block: a warp for every 16 packed rows and key warp."""
    return 32 * (bq // 16) * key_warps(bq, bkv)


def _warp_rows() -> Poly:
    """The rows of all a block's warps, 16 a warp (bq · key_warps), as the
    counters' polynomial in bq: 64 + (bq − 32)(bq − 64)/96 is exact at bq
    32, 64 and 128 (64, 64, 128) and 72 at bq 16, where the kernel has 32
    or 64."""
    bq = V("bq")
    return (bq * bq - 96 * bq + Poly.const(8192)) / 96


def smem_bytes(bq: int, bkv: int, stages: int, d: int,
               dtype: torch.dtype) -> int:
    """Shared memory of a launch: the Q tile and the ring of K/V tiles in
    the inputs' type (for f32 also each warp's row of probabilities), which
    the key warps' f32 partials reuse at the end."""
    esz, dt = (2 if dtype == torch.bfloat16 else 4), tile_dim(d)
    warps = threads(bq, bkv) // 32
    ring = esz * stages * 2 * bkv * dt + (4 * warps * 16 * (bkv + 4)
                                          if esz == 4 else 0)
    combine = 4 * warps * 16 * (dt + 6) if key_warps(bq, bkv) > 1 else 0
    return esz * bq * dt + max(ring, combine)


def splits(sk: int, kv_chunk: int) -> list:
    """The key ranges of the splits: runs of ``kv_chunk`` keys, the last cut
    at sk."""
    return [range(z, min(sk, z + kv_chunk)) for z in range(0, sk, kv_chunk)]


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, bq: int, bkv: int, kv_chunk: int,
                          stages: int = 2, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the dense entry: q [h, sq, d] over K/V
    [hk, sk, d] (query head i reads KV head i // (h/hk)) is the paged plain
    version (:func:`flash_attention_paged_plain`) over a pool of one block
    that holds all sk keys, one row of length sk: the same splits of
    ``kv_chunk`` keys, tiles of ``bkv``, masks and split-order combine.
    ``bq`` and ``stages`` shape the launch only and are taken and
    ignored."""
    dev = q.device
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    sk = torch.full((1,), k.shape[1], dtype=torch.int32, device=dev)
    return flash_attention_paged_plain(
        q[None], k.transpose(0, 1)[None], v.transpose(0, 1)[None], one, sk,
        bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages, causal=causal,
        window=window, scale=scale)[0]


def format_error(h: int, hk: int, sq: int, sk: int, d: int, bq: int,
                 bkv: int, kv_chunk: int, stages: int,
                 dtype: torch.dtype, *, rows: int = 1,
                 kv_dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Why ``flash_attention_h100_launch`` refuses this launch, or None: the
    C entry point's checks (``csrc/flash_attention.cu``) in Python.  For the
    paged entry pass ``rows`` and the pool's ``kv_dtype``, with sk = nblk ·
    page."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    checks = [
        (h > 0 and hk > 0 and h % hk == 0, "h not a multiple of hk"),
        (0 < sq <= sk, "not 1 <= sq <= sk"),
        (hk == 0 or h // hk * sq < 1 << 24, "2^24 packed rows or more"),
        (0 < d <= MAX_HD, f"d not in 1..{MAX_HD}"),
        (bq in BQ, f"bq not in {BQ}"),
        (bkv in BKV, f"bkv not in {BKV}"),
        (kv_chunk > 0 and kv_chunk % max(bkv, 1) == 0,
         "kv_chunk not a positive multiple of bkv"),
        (stages in STAGES, f"stages not in {STAGES}"),
        (dtype in _ELEM, "not f32 or bf16"),
        (kv_dtype in _ELEM and (kv_dtype == dtype
                                or kv_dtype == torch.bfloat16),
         "K/V neither q's type nor a bf16 pool"),
        (rows > 0 and sk < 1 << 31, "no rows, or a pool of 2^31 keys"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    if hk * rows > MAX_GRID_YZ or -(-sk // kv_chunk) > MAX_GRID_YZ:
        return "more than 65,535 (row, KV head) pairs or splits"
    if smem_bytes(bq, bkv, stages, d, dtype) > MAX_SMEM:
        return "tiles larger than 232,448 bytes"
    return None


PARTIALS = Workspace("flash_attention_h100 split partials", torch.float32,
                     1 << 20)


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("flash_attention", "flash_attention_h100_launch",
                       _ARGTYPES)


@functools.cache
def _paged_entry() -> Callable[..., int]:
    return build.entry("flash_attention", "flash_attention_h100_paged_launch",
                       _PAGED_ARGTYPES)


def workspace_need(rows: int, h: int, sq: int, sk: int, d: int,
                   kv_chunk: int) -> int:
    """f32 partials a launch over ``rows`` rows of h x sq queries and sk keys
    (the paged entry: the pool's nblk · page) needs: none for one split."""
    nsplit = -(-sk // kv_chunk)
    return nsplit * rows * h * sq * (tile_dim(d) + 2) if nsplit > 1 else 0


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, bq: int,
            bkv: int, kv_chunk: int, stages: int = 2, causal: bool = True,
            window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    if not (q.is_cuda and k.is_cuda and v.is_cuda
            and q.device == k.device == v.device):
        raise ValueError("flash_attention_h100 kernel needs q, k, v on one "
                         "CUDA device")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] == 0 or q.shape[0] % k.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_h100: bad shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)}")
    h, sq, d = q.shape
    hk, sk = k.shape[0], k.shape[1]
    if sq > sk or d > MAX_HD:
        raise ValueError(f"flash_attention_h100 needs sq <= sk and d <= "
                         f"{MAX_HD}: sq={sq} sk={sk} d={d}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ELEM:
        raise TypeError(f"flash_attention_h100 takes f32 or bf16: {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_h100 needs contiguous q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    o = torch.empty_like(q)
    need = workspace_need(1, h, sq, sk, d, kv_chunk) if kv_chunk > 0 else 0
    ws = PARTIALS.get(dev, need).data_ptr() if need else None
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   ws, h, hk, sq, sk, d, bq, bkv, kv_chunk, stages, scale,
                   int(causal), int(window) if window is not None else 0,
                   _ELEM[q.dtype], torch._C._cuda_getCurrentRawStream(
                       dev.index))
    if err:
        build.check(err, f"flash_attention_h100(bq={bq}, bkv={bkv}, "
                         f"kv_chunk={kv_chunk}, stages={stages})")
    flash_attention_h100.launches += 1
    flash_attention_h100.shapes[(h, hk, sq, sk, d, bq, bkv, kv_chunk, stages,
                                 bool(causal), window, q.dtype)] += 1
    return o


def flash_attention_h100(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, bq: int, bkv: int, kv_chunk: int,
                         stages: int = 2, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`flash_attention_plain`.  ``flash_attention_h100.launches`` counts
    kernel launches (a split launch and its combine count once),
    ``flash_attention_h100.shapes`` the same launches by (h, hk, sq, sk, d,
    bq, bkv, kv_chunk, stages, causal, window, dtype)."""
    fn = flash_attention_plain if q.device.type == "cpu" else _launch
    return fn(q, k, v, bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
              causal=causal, window=window, scale=scale)


flash_attention_h100.launches = 0
flash_attention_h100.shapes = collections.Counter()


def flash_attention_paged_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, tables: torch.Tensor,
                                lens: torch.Tensor, *, bq: int, bkv: int,
                                kv_chunk: int, stages: int = 2,
                                causal: bool = True,
                                window: Optional[int] = None,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic, over every row at
    once and with the lengths read from the tensor on its device (no host
    read).  Each row's table gathers its nblk · page keys out of the pools
    (upcast to f32 whatever their type), and keys at or past the row's
    length are masked and zeroed, so nothing a block past the length holds
    can reach the sums.  Each split of ``kv_chunk`` keys walks its tiles of
    ``bkv`` keys in order with the online softmax (running max ``m``, sum
    ``l``, ``acc``, all f32, scores q·k scaled after the product), masking
    keys past the causal limit, before the window and at or past the
    length; then the splits' (m, l, acc) are combined in split order: M =
    max m_z, O = Σ acc_z·e^(m_z − M) / Σ l_z·e^(m_z − M).  One split: O =
    acc / l.  A row of length 0 gives zeros.  q [rows, h, sq, d], k, v
    [num_blocks, page, hk, d], tables [rows, nblk], lens [rows]; query head
    i reads KV head i // (h/hk).  ``bq`` and ``stages`` shape the launch
    only and are taken and ignored.  On the ``meta`` device (the dry run)
    the result's shape and type only."""
    if q.is_meta:
        return torch.empty_like(q)
    rows, h, sq, d = q.shape
    page, hk = k.shape[1], k.shape[2]
    nblk = tables.shape[1]
    keys = nblk * page
    group = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    blk = tables.long().clamp(0, k.shape[0] - 1)
    lens = lens.long().clamp(0, keys)[:, None, None, None]   # [rows,1,1,1]
    kpos = torch.arange(keys, device=dev)
    valid = (kpos[None, :] < lens[:, 0, 0])[:, None, :, None]

    def gather(pool):
        x = pool[blk].reshape(rows, keys, hk, d).permute(0, 2, 1, 3).float()
        return x.masked_fill(~valid, 0.0).repeat_interleave(group, dim=1)

    kf, vf = gather(k), gather(v)                         # [rows, h, keys, d]
    qf = q.float()
    qpos = torch.arange(sq, device=dev)[:, None] + lens - sq  # [rows,1,sq,1]
    parts = []
    for run in splits(keys, kv_chunk):
        m = torch.full((rows, h, sq, 1), -math.inf, device=dev)
        l = torch.zeros((rows, h, sq, 1), device=dev)
        acc = torch.zeros((rows, h, sq, d), device=dev)
        for k0 in range(run.start, run.stop, bkv):
            k1 = min(run.stop, k0 + bkv)
            kidx = kpos[k0:k1]
            mask = kidx < lens                            # [rows,1,1,bk]
            if causal:
                mask = mask & (kidx <= qpos)
            if window is not None:
                mask = mask & (kidx > qpos - window)
            s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
            p = torch.exp(s - m_safe)
            corr = torch.exp(m - m_safe)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[:, :, k0:k1]
            m = m_new
        parts.append((m, l, acc))
    if len(parts) == 1:
        m, l, acc = parts[0]
        return (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    big = torch.zeros((rows, h, sq, 1), device=dev)
    out = torch.zeros((rows, h, sq, d), device=dev)
    for m, l, acc in parts:
        e = torch.where(m == -math.inf, 0.0, torch.exp(m - top))
        big = big + l * e
        out = out + acc * e
    return (out / torch.where(big > 0, big, 1.0)).to(q.dtype)


def _launch_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  tables: torch.Tensor, lens: torch.Tensor, *, bq: int,
                  bkv: int, kv_chunk: int, stages: int = 2,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    dev = q.device
    if not (q.is_cuda and all(t.device == dev
                              for t in (k, v, tables, lens))):
        raise ValueError("flash_attention_h100 paged kernel needs q, the "
                         "pools, the tables and the lengths on one CUDA "
                         "device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[3] != q.shape[3] or tables.dim() != 2 \
            or tables.shape[0] != q.shape[0] \
            or tuple(lens.shape) != (q.shape[0],) or k.shape[2] == 0 \
            or q.shape[1] % k.shape[2]:
        raise ValueError(f"flash_attention_h100 paged: bad shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} tables{tuple(tables.shape)} "
                         f"lens{tuple(lens.shape)}")
    rows, h, sq, d = q.shape
    num_blocks, page, hk = k.shape[:3]
    nblk = tables.shape[1]
    if q.dtype not in _ELEM or k.dtype != v.dtype or k.dtype not in _ELEM \
            or tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"flash_attention_h100 paged takes f32 or bf16 q "
                        f"and pools and int32 tables and lengths: {q.dtype}"
                        f", {k.dtype}, {tables.dtype}, {lens.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, tables, lens)):
        raise ValueError("flash_attention_h100 paged needs contiguous q, "
                         "pools, tables and lengths")
    why = format_error(h, hk, sq, nblk * page, d, bq, bkv, kv_chunk, stages,
                       q.dtype, rows=rows, kv_dtype=k.dtype)
    if why:
        raise ValueError(f"flash_attention_h100 paged: {why}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    need = workspace_need(rows, h, sq, nblk * page, d, kv_chunk)
    ws = PARTIALS.get(dev, need).data_ptr() if need else None
    err = _paged_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ws,
        tables.data_ptr(), lens.data_ptr(), rows, h, hk, sq, d, num_blocks,
        page, nblk, bq, bkv, kv_chunk, stages, scale, int(causal),
        int(window) if window is not None else 0, _ELEM[q.dtype],
        _ELEM[k.dtype], torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        build.check(err, f"flash_attention_h100 paged(bq={bq}, bkv={bkv}, "
                         f"kv_chunk={kv_chunk}, stages={stages})")
    flash_attention_h100.launches += 1
    flash_attention_h100.shapes[paged_signature(
        q, k, tables, bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
        causal=causal, window=window)] += 1
    return o


def paged_signature(q: torch.Tensor, k: torch.Tensor, tables: torch.Tensor,
                    *, bq: int, bkv: int, kv_chunk: int, stages: int,
                    causal: bool, window: Optional[int]) -> tuple:
    """A paged launch's key in ``flash_attention_h100.shapes``: ("paged",
    rows, h, hk, sq, nblk · page, d, page, bq, bkv, kv_chunk, stages,
    causal, window, q's dtype, the pool's dtype).  The lengths are on the
    device and are not in it."""
    rows, h, sq, d = q.shape
    page, hk = k.shape[1], k.shape[2]
    return ("paged", rows, h, hk, sq, tables.shape[1] * page, d, page, bq,
            bkv, kv_chunk, stages, bool(causal), window, q.dtype, k.dtype)


def flash_attention_h100_paged(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, tables: torch.Tensor,
                               lens: torch.Tensor, *, bq: int, bkv: int,
                               kv_chunk: int, stages: int = 2,
                               causal: bool = True,
                               window: Optional[int] = None,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The paged entry: CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`flash_attention_paged_plain`.  A launch counts in
    ``flash_attention_h100.launches`` and under :func:`paged_signature` in
    ``flash_attention_h100.shapes``."""
    fn = (flash_attention_paged_plain if q.device.type == "cpu"
          else _launch_paged)
    return fn(q, k, v, tables, lens, bq=bq, bkv=bkv, kv_chunk=kv_chunk,
              stages=stages, causal=causal, window=window, scale=scale)


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Domains, their product 4·2·6·3 = 144 points a leaf, within ``select``'s
#: cap of 512 candidates a leaf (``tests/test_torch_core.py``).
_DOMAINS = {"bq": BQ, "bkv": BKV,
            "kv_chunk": (128, 256, 512, 1024, 2048, 4096), "stages": STAGES}
_BQ_REDUCED = (16, 32)

# Napkin constants of an H100 SXM: HBM from NVIDIA's data sheet; the rest
# fitted to the kernel's own device times on an H100 (torch.profiler, as
# chip_smoke.py's phase 4 prints them; PERF.md): a block's fixed cost
# (launch, Q and the first tile's latency, the epilogue), the time a warp
# alone takes for its slice of a kv tile (a latency and a cost a unit of 16
# rows x keys x HD), the units an SM gets through when many warps share it,
# and the split combine's fixed cost and rate.  The context is what the
# napkin plans for, since the dispatch key cannot hold it (a decode step's
# sk grows under one key): 4096 keys.  The KV heads come with the key.
_HBM = 3.35e12                   # device memory, bytes/s
_BLOCK_S = 4.5e-6                # s a block costs besides its tiles
_WTILE_S = 1.23e-6               # s a warp alone spends on a tile slice ...
_UNIT_S = 2.03e-11               # ... and this more a unit of its slice,
_STAGE_S = 0.2e-6                #     and this more for each stage below 4
_SM_UNIT_S = 4.3e-12             # s an SM needs a unit, with warps to spare
_KW_SM = 1.5                     # ... times this with key warps (bq 32 at
                                 # the 256-row prefill: 3.37 against 2.25 µs)
_COMBINE_S = 2.6e-6              # s of the split combine's launch ...
_COMBINE_BW = 0.65e12            # ... and its rate over the partials, B/s
_SMEM_SM = 228 * 1024            # shared bytes an SM holds
_REGS_SM = 65536
_THREADS_SM = 2048
_ESZ = 2                         # bytes an element on the serve path (bf16)
_SK = 4096                       # keys the napkin plans for


def _score(v: Mapping[str, object]):
    """Napkin model of the kernel on an H100, over scalars or NumPy columns:
    1 / (estimated µs), so higher is better.

    - grid: ceil(GROUP·SQ/bq) row blocks × HK KV heads × ceil(``_SK``/
      kv_chunk) splits; a block walks min(kv_chunk, ``_SK``) keys in tiles
      of bkv (causal prefill sees about as many), each of its warps a slice
      of bkv / key_warps keys of 16 rows;
    - residency: the blocks an SM holds by shared memory (bf16 tiles),
      registers (about 224 a thread at HD 128, 168 at 64) and threads;
    - a tile round on an SM: the slower of one warp's slice alone (less
      with more tiles in flight ahead of it) and the
      units of all the warps sharing the SM at the SM's rate (slower with
      key warps, as measured); a block pays its fixed cost and its tiles'
      rounds, wave after wave;
    - device memory: K/V and Q/O once, as a floor;
    - a split launch adds the combine: a fixed cost and the f32 partials
      written and read at its rate.
    """
    bq, bkv = np.asarray(v["bq"]), np.asarray(v["bkv"])
    chunk, stages = np.asarray(v["kv_chunk"]), np.asarray(v["stages"])
    sq, hd, group, hk = v["SQ"], v["HD"], v["GROUP"], v["HK"]
    cores = max(1, v.get("CORES", 1))
    rows = group * sq
    nsplit = np.ceil(_SK / chunk)
    blocks = hk * np.ceil(rows / bq) * nsplit
    tiles = np.ceil(np.minimum(chunk, _SK) / bkv)
    kw = np.where(bq >= 64, 1, np.minimum(64 // bq, bkv // 16))
    warps = bq / 16 * kw
    unit = 16.0 * bkv / kw * hd                 # a warp's slice of a tile
    regs = 224 if hd > 64 else 168
    smem = _ESZ * (bq * hd + stages * 2 * bkv * hd)
    per_sm = np.maximum(1, np.minimum.reduce([
        np.floor(_SMEM_SM / smem), np.floor(_REGS_SM / (32 * warps * regs)),
        np.floor(_THREADS_SM / (32 * warps))]))
    resident = np.minimum(blocks, cores * per_sm)
    share = np.minimum(per_sm, np.ceil(blocks / cores))
    rnd = np.maximum(_WTILE_S + _UNIT_S * unit + _STAGE_S * (4 - stages),
                     share * warps * unit * _SM_UNIT_S
                     * np.where(kw > 1, _KW_SM, 1.0))
    t_blocks = np.ceil(blocks / resident) * (_BLOCK_S + tiles * rnd)
    t_mem = (2.0 * hk * _SK * hd + 2.0 * hk * rows * hd) * _ESZ / _HBM
    part = 4.0 * hk * rows * (hd + 2) * nsplit
    t_comb = np.where(nsplit > 1, _COMBINE_S + 2 * part / _COMBINE_BW, 0.0)
    return 1e-6 / (np.maximum(t_blocks, t_mem) + t_comb)


class FlashAttentionH100Family(CachedInstantiationMixin):
    name = "flash_attention_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"granularity_level": 0},
            program_params={n: ParamDomain(n, d)
                            for n, d in _DOMAINS.items()},
        )

    # -- counters (order: resources r_i first, then performance p_i) ---------
    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_q_block",),
                     "Q tile, stages K/V tiles and every warp's probability"
                     " rows, counted in f32 (paper: Z_B)"),
            resource("threads", "T", ("reduce_q_block",),
                     "a lane for every row of a warp's 16 and key warp"
                     " (paper: T)"),
            resource("registers", "G", (),
                     "score, output and Q fragments and softmax state a "
                     "thread (paper: R)"),
            performance("occupancy", "P_occ", ("reduce_q_block",),
                        "share of the SMs a grid of blocks leaves idle"),
        ]

    # -- strategies ------------------------------------------------------------
    def strategies(self) -> Sequence[Strategy]:
        def reduce_q_block(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            p = plan.with_flag("granularity_level", 1, "reduce q block")
            p.program_params["bq"] = ParamDomain("bq", _BQ_REDUCED)
            return p

        return [Strategy("reduce_q_block", reduce_q_block)]

    # -- symbolic counter evaluation (paper §3.3: f_i, g_i) -------------------
    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        bq, bkv, hd = V("bq"), V("bkv"), V("HD")
        one = Poly.const(1)
        if counter == "smem_bytes":
            # smem_bytes() in f32, the widest input type, so a leaf launches
            # for either type: Q, the ring and a row of probabilities (bkv
            # + 4 floats) for each of the warps' rows; the key warps' combine
            # reuses the ring, which is larger at every point of the domain
            return 4 * (bq * hd + V("stages") * 2 * bkv * hd
                        + _warp_rows() * (bkv + 4)), one
        if counter == "threads":
            # threads(): two lanes a warp row (a warp is 16 rows)
            return V("LANE") * _warp_rows(), Poly.const(16)
        if counter == "registers":
            # bkv/2 score and HD/2 output accumulators, HD/4 Q fragment
            # registers, softmax state, indices and addresses
            return (bkv + hd) / 2 + hd / 4 + Poly.const(40), one
        if counter == "occupancy":
            # CORES / (CORES + row blocks): near 1 when a few packed row
            # blocks leave the SMs idle, near 0 when they fill them
            return V("CORES") * bq, V("CORES") * bq + V("GROUP") * V("SQ")
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score(v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        """The dense entry bound to the leaf's parameters; its ``paged``
        attribute is the paged entry bound to the same."""
        kw = {n: int(assignment[n]) for n in _DOMAINS}
        cuda = device == "cuda"
        fn = functools.partial(_launch if cuda else flash_attention_plain,
                               **kw)
        fn.paged = functools.partial(
            _launch_paged if cuda else flash_attention_paged_plain, **kw)
        return fn


FAMILY = FlashAttentionH100Family()
