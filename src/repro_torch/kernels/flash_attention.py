"""K2 ``flash_attention_h100`` — online-softmax attention on Hopper.

Replaces the TPU kernel ``pallas_flash_attention``
(``src/repro/kernels/flash_attention.py``, ``_fa_kernel``) with the
hand-written CUDA kernel in ``csrc/flash_attention.cu``: q [h, sq, d],
k, v [h, sk, d] with sq <= sk and ends aligned (query i at key i + sk − sq),
causal and sliding-window masks, scale 1/√d, m/l/acc in f32, output in q's
type.  GQA heads are broadcast by the caller, as in the JAX contract.

Unlike the TPU kernel, keys at or past ``sk`` never enter the softmax when
``causal=False`` (the TPU kernel pads K/V to a whole tile and scores the
padding: ROADMAP F1); this kernel and its plain version compute
``ref.flash_attention``.

Bound on the card: the serve path's prefill chunks (sq 32) and decode rows
(sq 1) do one to a few dozen flops per K/V byte — bound by bytes.  The
kernel reads K/V once per block of ``bq`` query rows through shared memory
and skips tiles no row of the block can see (see the note in the CUDA
source); tensor cores are left to later work.

Program parameters:  bq (query rows a block, one warp each), bkv (kv tile)
Data parameters:     SQ, HD
Machine parameters:  V (shared bytes a block), T (threads a block), LANE,
                     CORES
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

_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: flash_attention_h100_launch(q, k, v, o, h, sq, sk, d, bq, bkv, scale,
#: causal, window, elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
             + (ctypes.c_float,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
#: largest head dim the kernel takes (four output dims a lane)
MAX_HD = 128


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, bq: int, bkv: int, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: query blocks of
    ``bq`` rows walk kv tiles of ``bkv`` keys in order with the online
    softmax (running max ``m``, sum ``l``, ``acc``, all f32), masking keys
    past the causal limit, before the window and at or past ``sk``."""
    h, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    out = torch.empty((h, sq, d), dtype=q.dtype, device=q.device)
    kidx_all = torch.arange(sk, device=q.device)
    for q0 in range(0, sq, bq):
        qb = qf[:, q0:q0 + bq]
        qpos = torch.arange(q0, q0 + qb.shape[1], device=q.device) + sk - sq
        m = torch.full((h, qb.shape[1], 1), -math.inf, device=q.device)
        l = torch.zeros((h, qb.shape[1], 1), device=q.device)
        acc = torch.zeros((h, qb.shape[1], d), device=q.device)
        for k0 in range(0, sk, bkv):
            kidx = kidx_all[k0:k0 + bkv]
            mask = torch.ones((qb.shape[1], kidx.shape[0]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kidx[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kidx[None, :] > qpos[:, None] - window
            if not bool(mask.any()):
                continue
            s = qb @ kf[:, k0:k0 + bkv].transpose(1, 2)
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
            p = torch.exp(s - m_safe)
            corr = torch.exp(m - m_safe)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[:, k0:k0 + bkv]
            m = m_new
        out[:, q0:q0 + bq] = (acc / torch.where(l > 0, l, 1.0)).to(q.dtype)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, bq: int,
            bkv: int, causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    if not (q.is_cuda and k.is_cuda and v.is_cuda
            and q.device == k.device == v.device):
        raise ValueError("flash_attention_h100 kernel needs q, k, v on one "
                         "CUDA device")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_h100: bad shapes q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} v{tuple(v.shape)}")
    h, sq, d = q.shape
    sk = k.shape[1]
    if sq > sk or d > MAX_HD:
        raise ValueError(f"flash_attention_h100 needs sq <= sk and d <= "
                         f"{MAX_HD}: sq={sq} sk={sk} d={d}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ELEM:
        raise TypeError(f"flash_attention_h100 takes f32 or bf16: {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_h100 needs contiguous q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    fn = build.entry("flash_attention", "flash_attention_h100_launch",
                     _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), h, sq,
             sk, d, bq, bkv, scale, int(causal),
             int(window) if window is not None else 0, _ELEM[q.dtype],
             stream)
    build.check(err, f"flash_attention_h100(bq={bq}, bkv={bkv})")
    flash_attention_h100.launches += 1
    flash_attention_h100.shapes[(h, sq, sk, d, bq, bkv, bool(causal), window,
                                 q.dtype)] += 1
    return o


def flash_attention_h100(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, bq: int, bkv: int, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`flash_attention_plain`.  ``flash_attention_h100.launches`` counts
    kernel launches, ``flash_attention_h100.shapes`` the same launches by
    (h, sq, sk, d, bq, bkv, causal, window, dtype)."""
    fn = flash_attention_plain if q.device.type == "cpu" else _launch
    return fn(q, k, v, bq=bq, bkv=bkv, causal=causal, window=window,
              scale=scale)


flash_attention_h100.launches = 0
flash_attention_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec
# =============================================================================

def _score(v: Mapping[str, object]):
    """Napkin model: warps past ``SQ`` idle; K/V tiles are re-read once per
    block, so more rows a block amortize them (up to 8); long kv tiles pay
    fewer barriers; among equals, fewer rows a block give more blocks."""
    bq, bkv = np.asarray(v["bq"]), np.asarray(v["bkv"])
    sq = v.get("SQ", 4096)
    qfill = np.minimum(1.0, sq / bq)
    reuse = np.minimum(1.0, bq / 8.0)
    tile = np.minimum(1.0, bkv / 64.0)
    return qfill * (0.5 + 0.5 * reuse) * (0.5 + 0.5 * tile) * (1 - bq / 2048)


class FlashAttentionH100Family(CachedInstantiationMixin):
    name = "flash_attention_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"granularity_level": 0},
            program_params={
                "bq": ParamDomain("bq", (1, 2, 4, 8, 16, 32, 64)),
                "bkv": ParamDomain("bkv", (32, 64, 128, 256), align=32),
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_q_block",),
                     "Q, K (padded), V and score tiles in f32 (paper: Z_B)"),
            resource("threads", "T", (), "one warp a query row (paper: T)"),
            resource("registers", "G", (),
                     "scores, output dims and softmax state a lane"),
            performance("occupancy", "P_occ", ("reduce_q_block",),
                        "share of the SMs a grid of blocks leaves idle"),
        ]

    def strategies(self) -> Sequence[Strategy]:
        def reduce_q_block(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            p = plan.with_flag("granularity_level", 1, "reduce q block")
            p.program_params["bq"] = ParamDomain("bq", (1, 2, 4, 8))
            return p

        return [Strategy("reduce_q_block", reduce_q_block)]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        bq, bkv, hd = V("bq"), V("bkv"), V("HD")
        one = Poly.const(1)
        if counter == "smem_bytes":
            return 4 * (bq * hd + bkv * (2 * hd + 1) + bq * bkv), one
        if counter == "threads":
            return V("LANE") * bq, one
        if counter == "registers":
            # bkv/LANE scores + HD/LANE output dims + state and indices
            return bkv / 32 + hd / 32 + Poly.const(32), one
        if counter == "occupancy":
            return V("CORES") * bq, V("CORES") * bq + V("SQ")
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score(v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        fn = _launch if device == "cuda" else flash_attention_plain
        return functools.partial(fn, bq=int(assignment["bq"]),
                                 bkv=int(assignment["bkv"]))


FAMILY = FlashAttentionH100Family()
