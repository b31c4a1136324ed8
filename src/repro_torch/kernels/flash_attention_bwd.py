"""K2b ``flash_attention_bwd_h100`` — the gradients of K2's attention on Hopper.

The JAX package has no kernel backward: its train step differentiates
einsum attention (ROADMAP F3).  The port's forward runs every attention core
through K2's paged entry (:mod:`.flash_attention`), which autograd cannot
see, so the gradient of that launch is this hand-written CUDA kernel
(``csrc/flash_attention_bwd.cu``): dQ, dK, dV of K2's function over the
layout of a training forward, q, o, dO [rows, h, sq, d] and k, v [rows,
page, hk, d] (K2's pool of one block a row, the table ``[[b]]``), with the
rows' lengths [rows] (int32) on the device.  It uses K2's masks exactly:
keys at or past a row's length, the ends-aligned causal limit (query i of a
row of length n at position i + n − sq) and the window; a row of length 0
gets zero gradients.  Inputs f32 or bf16 (all of one type), every sum in
f32, outputs in the inputs' type.

Bound on the card: a training layer does about 2.5 times the forward's
flops over the same bytes, hundreds of flops a byte at sq 1024: bound by
operations, which in bf16 only the tensor cores reach.  Two bodies, both
without atomics, so two launches give the same bits:

- bf16, on the tensor cores, three kernels: lse and δ (a block a
  query tile: S = Q·Kᵀ by ``mma.sync`` and each query's log-sum-exp, δ =
  rowsum(dO∘O)), dQ (the same blocks: S and dP = dO·Vᵀ by ``mma.sync``, P
  and dS on the f32 fragments, dQ += dS·K with dS rounded to bf16) and
  dK/dV (a block a key tile over the group's query heads: Sᵀ, dPᵀ, dV +=
  Pᵀ·dO, dK += dSᵀ·Q), from XOR-swizzled bf16 tiles (K2's, in
  ``csrc/attention_tiles.cuh``) fed by a two-stage ``cp.async`` ring; a
  warp owns 16 rows of its block.
- f32, FMA on f32 tiles, never TF32, two kernels: dQ (recomputing
  each query's log-sum-exp in a first sweep) and dK/dV.

Program parameters:  bq (queries a tile), bkv (keys a tile)
Data parameters:     SQ, HD, GROUP (query heads a KV head), HK (KV heads),
                     the key of K2, which a forward and its backward share
Machine parameters:  V (shared bytes a block), T (threads a block),
                     G (registers a thread), CORES
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.counters import Counter, resource
from ..core.plan import KernelPlan, ParamDomain
from ..core.polynomial import Poly, V
from ..core.strategies import Strategy
from . import build
from .instantiate_cache import CachedInstantiationMixin

_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: flash_attention_bwd_h100_launch(q, k, v, o, dout, lens, dq, dk, dv, lse,
#: delta, rows, h, hk, sq, page, d, bq, bkv, scale, causal, window, elem,
#: stream)
_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 8
             + (ctypes.c_float,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
#: The C entry point's limits (``csrc/flash_attention_bwd.cu``).
MAX_HD = 128
MAX_GRID_YZ = 65_535
THREADS = 256
BQ = (16, 32, 64)
BKV = (16, 32, 64)


def tile_dim(d: int) -> int:
    """The head dim the tiles are built for: 64 or 128 (columns past d
    zero)."""
    return 64 if d <= 64 else 128


def f32_smem_bytes(bq, bkv, d):
    """Shared bytes of the FMA body's larger kernel (dK/dV): f32 tiles of
    K and V (bkv rows), Q and dO (bq rows), each row D + 1 words, P and dS
    (bq rows of bkv + 1) and two words a query.  Over ints (``d`` the head
    dim) or over polynomials for the counter."""
    dp = (tile_dim(d) if isinstance(d, int) else d) + 1
    return 4 * (2 * bkv * dp + 2 * bq * dp + 2 * bq * (bkv + 1) + 2 * bq)


def tc_kernel_smem(bq, bkv, dt):
    """Shared bytes of each of the tensor-core body's kernels at tile dim
    ``dt``, bf16 [row][dt] tiles: (lse: Q and two K tiles of the ring, dQ:
    Q, dO and two K and V tiles, dK/dV: K, V and two Q and dO tiles with
    their f32 lse and delta).  Over ints or NumPy columns."""
    return (2 * (bq * dt + 2 * bkv * dt), 2 * (2 * bq * dt + 4 * bkv * dt),
            2 * (2 * bkv * dt + 4 * bq * dt) + 16 * bq)


def tc_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared bytes of the tensor-core body's largest kernel."""
    return max(tc_kernel_smem(bq, bkv, tile_dim(d)))


def smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared bytes of the larger of the two bodies (the FMA body's at every
    point of the domain)."""
    return max(f32_smem_bytes(bq, bkv, d), tc_smem_bytes(bq, bkv, d))


def launches_a_call(dtype: torch.dtype) -> int:
    """Kernel launches of one call: bf16 runs the tensor-core body's three
    (lse and delta, dQ, dK/dV), f32 the FMA body's two (dQ, dK/dV)."""
    return 3 if dtype == torch.bfloat16 else 2


def format_error(rows: int, h: int, hk: int, sq: int, page: int, d: int,
                 bq: int, bkv: int, dtype: torch.dtype) -> Optional[str]:
    """Why ``flash_attention_bwd_h100_launch`` refuses this launch, or None:
    the C entry point's checks in Python."""
    checks = [
        (rows > 0 and sq > 0 and page > 0, "an empty dim"),
        (h > 0 and hk > 0 and h % hk == 0, "h not a multiple of hk"),
        (0 < d <= MAX_HD, f"d not in 1..{MAX_HD}"),
        (bq in BQ and bkv in BKV, f"bq not in {BQ} or bkv not in {BKV}"),
        (rows <= MAX_GRID_YZ and h <= MAX_GRID_YZ,
         "more than 65,535 rows or heads"),
        (dtype in _ELEM, "not f32 or bf16"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    return None


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def _masks(lens: torch.Tensor, sq: int, page: int, causal: bool,
           window: Optional[int]) -> torch.Tensor:
    """[rows, 1, sq, page] bool: query i of row b sees key j — K2's masks."""
    dev = lens.device
    n = lens.long().clamp(0, page)[:, None, None, None]
    qpos = torch.arange(sq, device=dev)[:, None] + n - sq
    kpos = torch.arange(page, device=dev)
    mask = kpos < n
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lens: torch.Tensor, *,
                              bq: int, bkv: int, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of the kernel's arithmetic, in f32 over whole
    rows: s = scale·q·kᵀ masked as K2 masks it, lse = logsumexp(s), P =
    exp(s − lse), δ = rowsum(dO∘O), dV = Pᵀ·dO, dS = P∘(dO·Vᵀ − δ), dQ =
    scale·dS·K, dK = scale·dSᵀ·Q, the group's query heads summed into their
    KV head.  Returns (dq, dk, dv) in the inputs' types.  ``bq`` and
    ``bkv`` shape the launch only and are taken and ignored.  On the
    ``meta`` device (the dry run) the results' shapes and types only."""
    if q.is_meta:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows, h, sq, d = q.shape
    page, hk = k.shape[1], k.shape[2]
    group = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    def heads(x):                                  # [rows, h, page, d]
        return x.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)

    kf, vf = heads(k), heads(v)
    qf, of, dof = q.float(), o.float(), do.float()
    mask = _masks(lens, sq, page, causal, window)
    s = (qf @ kf.transpose(-1, -2) * scale).masked_fill(~mask, -math.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = ds @ kf * scale

    def kv_heads(x):                               # [rows, page, hk, d]
        return x.view(rows, hk, group, page, d).sum(2).permute(0, 2, 1, 3)

    dk = kv_heads(ds.transpose(-1, -2) @ qf * scale)
    dv = kv_heads(p.transpose(-1, -2) @ dof)
    return (dq.to(q.dtype), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("flash_attention_bwd", "flash_attention_bwd_h100_launch",
                       _ARGTYPES)


def signature(q: torch.Tensor, k: torch.Tensor, *, bq: int, bkv: int,
              causal: bool, window: Optional[int]) -> tuple:
    """A call's key in ``flash_attention_bwd_h100.shapes``: (rows, h, hk,
    sq, page, d, bq, bkv, causal, window, dtype)."""
    rows, h, sq, d = q.shape
    return (rows, h, k.shape[2], sq, k.shape[1], d, bq, bkv, bool(causal),
            window, q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, do: torch.Tensor, lens: torch.Tensor, *,
            bq: int, bkv: int, causal: bool = True,
            window: Optional[int] = None, scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, o, do, lens))):
        raise ValueError("flash_attention_bwd_h100 kernel needs q, k, v, o, "
                         "dO and the lengths on one CUDA device")
    if q.dim() != 4 or o.shape != q.shape or do.shape != q.shape \
            or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or tuple(lens.shape) != (q.shape[0],) or k.shape[2] == 0 \
            or q.shape[1] % k.shape[2]:
        raise ValueError(f"flash_attention_bwd_h100: bad shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} o{tuple(o.shape)} "
                         f"dO{tuple(do.shape)} lens{tuple(lens.shape)}")
    if len({t.dtype for t in (q, k, v, o, do)}) != 1 or q.dtype not in _ELEM \
            or lens.dtype != torch.int32:
        raise TypeError(f"flash_attention_bwd_h100 takes q, k, v, o, dO of "
                        f"one type, f32 or bf16, and int32 lengths: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {o.dtype}, "
                        f"{do.dtype}, {lens.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, o, do, lens)):
        raise ValueError("flash_attention_bwd_h100 needs contiguous inputs")
    rows, h, sq, d = q.shape
    page, hk = k.shape[1], k.shape[2]
    why = format_error(rows, h, hk, sq, page, d, bq, bkv, q.dtype)
    if why:
        raise ValueError(f"flash_attention_bwd_h100: {why}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse = torch.empty((rows, h, sq), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lens.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), rows, h, hk, sq, page, d, bq, bkv,
        scale, int(causal), int(window) if window is not None else 0,
        _ELEM[q.dtype], torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        build.check(err, f"flash_attention_bwd_h100(bq={bq}, bkv={bkv})")
    flash_attention_bwd_h100.launches += launches_a_call(q.dtype)
    flash_attention_bwd_h100.shapes[signature(
        q, k, bq=bq, bkv=bkv, causal=causal, window=window)] += 1
    return dq, dk, dv


def flash_attention_bwd_h100(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lens: torch.Tensor, *,
                             bq: int, bkv: int, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv).  CUDA tensors launch the kernels of their type's body
    (or raise); CPU tensors run :func:`flash_attention_bwd_plain`.
    ``flash_attention_bwd_h100.launches`` counts kernel launches,
    :func:`launches_a_call` a call (bf16: lse and δ, dQ, dK/dV; f32: dQ,
    dK/dV); ``flash_attention_bwd_h100.shapes`` counts the calls by
    :func:`signature`."""
    fn = flash_attention_bwd_plain if q.device.type == "cpu" else _launch
    return fn(q, k, v, o, do, lens, bq=bq, bkv=bkv, causal=causal,
              window=window, scale=scale)


flash_attention_bwd_h100.launches = 0
flash_attention_bwd_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

_DOMAINS = {"bq": BQ, "bkv": BKV}
_CLOCK = 1.7e9                   # SM cycles a second (H100 SXM boost)
#: Registers a thread of the tensor-core body's kernels (lse, dQ, dK/dV) at
#: tile dim 64 and 128, as ``ptxas -v`` reports them (sm_90a, no spills),
#: rounded up to the allocation unit of 8.
TC_REGISTERS = {64: (72, 128, 128), 128: (56, 160, 240)}
#: The napkin's constants, SM cycles, fitted to the card's per-kernel times
#: of every leaf at llama3-8b's training key (``chip_smoke.py`` phase 13
#: (a)): the dependent chain of one warp's 16 x 16 block of pairs in each
#: kernel, which the SM's resident warps overlap, and the cost a block's
#: 16-byte ring copy adds to each such block.
_CHAIN = (3700.0, 3700.0, 5000.0)
_COPY = (19.0, 19.0, 53.0)


def _score(v: Mapping[str, object]):
    """Napkin model of the tensor-core body on an H100, over scalars or
    NumPy columns: 1 / (estimated µs), higher is better; the FMA body takes
    the same pick.  Work: the 16 x 16 blocks of query-key pairs, a warp's
    unit, of SQ queries against SQ keys (the training forward's key count)
    over GROUP·HK heads, each visited once by each of the three kernels.
    On an SM a unit costs the larger of its shared-memory reads (``ldmatrix``
    x4 of 512 bytes at 128 bytes a cycle: S costs 2·D/16 of them, dP as
    much, a product from the fragments D/16) and its kernel's dependent
    chain over the SM's resident warps (``mma.sync`` issue and latency,
    the exponentials), plus the ring's copies a unit: 2·D over the block's
    rows (the two-stage ring overlaps a tile's copies with the last
    tile's products, but a thread issues them).  Resident warps: blocks an
    SM by registers (``TC_REGISTERS``), shared memory
    (:func:`tc_smem_bytes`' kernels), 32 blocks and 64 warps, and no more
    than the grid's blocks spread over the SMs; the grid's blocks also cap
    the SMs in use: lse and dQ run (SQ/bq)·GROUP·HK blocks of bq/16 warps,
    dK/dV (SQ/bkv)·HK blocks of bkv/16 warps."""
    bq, bkv = np.asarray(v["bq"], float), np.asarray(v["bkv"], float)
    sq, hd, group, hk = v["SQ"], v["HD"], v["GROUP"], v["HK"]
    cores = max(1, v.get("CORES", 1))
    dt = tile_dim(int(hd))
    units = np.ceil(sq / 16) ** 2 * group * hk
    tq, tk = np.ceil(sq / bq), np.ceil(sq / bkv)
    ldm = (2 * dt / 16, 5 * dt / 16, 6 * dt / 16)
    smem = tc_kernel_smem(bq, bkv, dt)
    rows = (bq, bq, bkv)                      # a block's rows: 16 a warp
    copies = (dt / bq, 2 * dt / bq, 2 * dt / bkv)
    blocks = (tq * group * hk, tq * group * hk, tk * hk)
    us = 0.0
    for k in range(3):
        wpb = rows[k] / 16
        bps = np.minimum.reduce([
            np.full_like(wpb, 32.0), np.floor(64 / wpb),
            np.floor(65536 / (TC_REGISTERS[dt][k] * 32 * wpb)),
            np.floor(232448 / smem[k])])
        warps = wpb * np.minimum(bps, np.maximum(1.0, blocks[k] / cores))
        unit = (np.maximum(4 * ldm[k], _CHAIN[k] / warps)
                + _COPY[k] * copies[k])
        us = us + units * unit / np.minimum(cores, blocks[k]) / _CLOCK * 1e6
    return 1.0 / (us + 3 * 2.0)               # a launch's ~2 µs each


class FlashAttentionBwdH100Family(CachedInstantiationMixin):
    name = "flash_attention_bwd_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={},
            program_params={n: ParamDomain(n, d)
                            for n, d in _DOMAINS.items()},
        )

    # -- counters (resources only) ---------------------------------------------
    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", (),
                     "shared bytes of the larger body: the FMA body's f32 "
                     "K, V, Q, dO, P and dS tiles of its dK/dV kernel "
                     "(paper: Z_B)"),
            resource("threads", "T", (),
                     "threads a block of the larger body: the FMA body's "
                     "16 x 16 (the tensor-core body's at most 4 warps) "
                     "(paper: T)"),
            resource("registers", "G", (),
                     "registers a thread of the larger body: the "
                     "tensor-core dK/dV kernel's, whose dK and dV sums "
                     "alone take HD a thread (paper: R)"),
        ]

    def strategies(self) -> Sequence[Strategy]:
        return []

    # -- symbolic counter evaluation (paper §3.3: f_i) --------------------------
    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        bq, bkv, hd = V("bq"), V("bkv"), V("HD")
        one = Poly.const(1)
        if counter == "smem_bytes":
            # the FMA body's, the larger (f32_smem_bytes with the head dim
            # for the tile width: the tile is 64 or 128 wide; every point of
            # the domain fits at 128)
            return f32_smem_bytes(bq, bkv, hd), one
        if counter == "threads":
            return Poly.const(THREADS), one
        if counter == "registers":
            # the tensor-core dK/dV kernel's ptxas count, linear in the tile
            # dim through TC_REGISTERS' 128 at 64 and 240 at 128 (the FMA
            # body's kernels take at most 128)
            return hd * 7 / 4 + Poly.const(16), one
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score(v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        kw = {n: int(assignment[n]) for n in _DOMAINS}
        return functools.partial(
            _launch if device == "cuda" else flash_attention_bwd_plain, **kw)


FAMILY = FlashAttentionBwdH100Family()
