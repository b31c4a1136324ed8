"""K3 ``ssd_scan_h100`` — the Mamba-2 SSD chunked scan on Hopper.

Replaces the TPU kernel ``pallas_ssd_scan`` (``src/repro/kernels/ssd_scan.py``,
``_ssd_kernel`` over ``ssd_chunk``) with the hand-written CUDA kernel in
``csrc/ssd_scan.cu``.  Per (row, head): S_t = a_t·S_{t−1} + b_t⊗x_t and
y_t = c_t·S_t, computed chunk by chunk in matmul form (:func:`ssd_chunk`)
with an f32 state carried between chunks.

Unlike the TPU kernel, which starts from a zero state and returns only y,
this one takes the state in and gives it back — ``(y, S_final) =
ssd_scan_h100(x, a, b, c, state0)`` — because that is what the model's SSM
block computes: chunked prefill resumes from the previous chunk's state and
a decode step is the scan at seq 1 (the JAX model threads the state through
``ssd_chunk`` itself and never calls its kernel: ROADMAP F3).
``pallas_ssd_scan`` is the case ``state0 = None`` with S_final dropped.  The
last chunk is cut at seq, where the TPU pads with a = 1 and x = b = c = 0.

B and C are shared across heads (ngroups = 1): the wrapper takes them as
[rows, seq, state] or as a [rows, seq, heads, state] view with head stride 0
and passes strides, so no per-head copy is made.

Bound on the card: bytes at decode (the f32 state is read and written every
step), operations for a prefill chunk at state 128 (see the CUDA source).

Program parameters:  chunk (steps a chunk), bd (hd columns a block)
Data parameters:     SQ, HD, STATE
Machine parameters:  V (shared bytes a block), T (threads a block),
                     G (registers a thread), CORES
"""
from __future__ import annotations

import collections
import ctypes
import functools
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
#: ssd_scan_h100_launch(x, a, b, c, s0, y, s1, rows, seq, heads, hd, state,
#: ck, bd, sb_r, sb_t, sb_h, sc_r, sc_t, sc_h, elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 7
             + (ctypes.c_longlong,) * 6 + (ctypes.c_int, ctypes.c_void_p))
#: threads a block (``NT`` in the CUDA source)
THREADS = 256


# =============================================================================
# Chunk math, plain version, kernel wrapper, launch counter
# =============================================================================

def ssd_chunk(xc: torch.Tensor, ac: torch.Tensor, bc: torch.Tensor,
              cc: torch.Tensor, S_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the SSD recurrence in matmul form, over any leading
    dims (the JAX ``ssd_chunk`` vmapped).

    xc: (..., C, hd)  ac: (..., C)  bc/cc: (..., C, state)
    S_prev: (..., state, hd).  Returns (y (..., C, hd), S_new (..., state,
    hd)).  All f32."""
    C = xc.shape[-2]
    cum = torch.cumsum(torch.log(ac), dim=-1)
    # L[t, i] = exp(cum[t] - cum[i]) for i <= t else 0; masked BEFORE exp so
    # the (positive) upper-triangle differences never overflow to inf
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((C, C), dtype=torch.bool, device=xc.device).tril()
    L = torch.exp(diff.masked_fill(~tri, -torch.inf))
    scores = (cc @ bc.transpose(-1, -2)) * L
    y = scores @ xc + (cc * torch.exp(cum)[..., None]) @ S_prev
    w = torch.exp(cum[..., -1:] - cum)                 # decay to chunk end
    S_new = (torch.exp(cum[..., -1:])[..., None] * S_prev
             + (bc * w[..., None]).transpose(-1, -2) @ xc)
    return y, S_new


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, state0: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate shapes; returns b, c as [rows, seq, heads, state] views."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_h100: x must be [rows, seq, heads, hd]: "
                         f"{tuple(x.shape)}")
    R, S, H, hd = x.shape
    if tuple(a.shape) != (R, S, H):
        raise ValueError(f"ssd_scan_h100: a {tuple(a.shape)} for x "
                         f"{tuple(x.shape)}")
    if b.shape != c.shape or b.dim() not in (3, 4) \
            or tuple(b.shape[:2]) != (R, S) \
            or (b.dim() == 4 and b.shape[2] != H):
        raise ValueError(f"ssd_scan_h100: b {tuple(b.shape)} / c "
                         f"{tuple(c.shape)} for x {tuple(x.shape)}")
    if b.dim() == 3:
        b = b[:, :, None, :].expand(R, S, H, b.shape[-1])
        c = c[:, :, None, :].expand(R, S, H, c.shape[-1])
    if state0 is not None and tuple(state0.shape) != (R, H, b.shape[-1], hd):
        raise ValueError(f"ssd_scan_h100: state0 {tuple(state0.shape)}, "
                         f"want {(R, H, b.shape[-1], hd)}")
    return b, c


def ssd_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, state0: Optional[torch.Tensor] = None,
                   *, chunk: int, bd: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: chunks of ``min(chunk, seq)``
    steps (the last one cut at seq) through :func:`ssd_chunk` in f32, from
    ``state0`` (zero when None).  The hd tile ``bd`` does not change the
    result (paper Def. 2 ii) and is taken and ignored.  Returns (y in x's
    type, final state f32)."""
    b, c = _check(x, a, b, c, state0)
    R, S, H, hd = x.shape
    xf = x.float().transpose(1, 2)                     # (R, H, S, hd)
    af = a.float().transpose(1, 2)                     # (R, H, S)
    bf = b.float().transpose(1, 2)                     # (R, H, S, N)
    cf = c.float().transpose(1, 2)
    St = (state0.float() if state0 is not None else torch.zeros(
        (R, H, b.shape[-1], hd), dtype=torch.float32, device=x.device))
    ck = min(chunk, S)
    ys = []
    for t0 in range(0, S, ck):
        y, St = ssd_chunk(xf[:, :, t0:t0 + ck], af[:, :, t0:t0 + ck],
                          bf[:, :, t0:t0 + ck], cf[:, :, t0:t0 + ck], St)
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2).to(x.dtype)
    return y, St


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
            chunk: int, bd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    tensors = [x, a, b, c] + ([state0] if state0 is not None else [])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan_h100 kernel needs x, a, b, c (and "
                         "state0) on one CUDA device")
    b, c = _check(x, a, b, c, state0)
    if x.dtype not in _ELEM or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan_h100 takes x, b, c of one type, f32 or "
                        f"bf16: {x.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32 or (state0 is not None
                                    and state0.dtype != torch.float32):
        raise TypeError("ssd_scan_h100 takes the decay a and the state in "
                        "f32")
    if not (x.is_contiguous() and a.is_contiguous()
            and (state0 is None or state0.is_contiguous())
            and b.stride(-1) == 1 and c.stride(-1) == 1):
        raise ValueError("ssd_scan_h100 needs contiguous x, a, state0 and "
                         "b, c contiguous in the state dim")
    R, S, H, hd = x.shape
    N = b.shape[-1]
    ck = min(chunk, S)
    y = torch.empty_like(x)
    s1 = torch.empty((R, H, N, hd), dtype=torch.float32, device=x.device)
    fn = build.entry("ssd_scan", "ssd_scan_h100_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             state0.data_ptr() if state0 is not None else None,
             y.data_ptr(), s1.data_ptr(), R, S, H, hd, N, ck, bd,
             *b.stride()[:3], *c.stride()[:3], _ELEM[x.dtype], stream)
    build.check(err, f"ssd_scan_h100(chunk={chunk}, bd={bd})")
    ssd_scan_h100.launches += 1
    ssd_scan_h100.shapes[(R, S, H, hd, N, chunk, bd, state0 is not None,
                          x.dtype)] += 1
    return y, s1


def ssd_scan_h100(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
                  chunk: int, bd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, S_final) of the scan over x [rows, seq, heads, hd], a [rows, seq,
    heads] f32, b, c [rows, seq, state] or [rows, seq, heads, state], from
    ``state0`` [rows, heads, state, hd] f32 (zero when None).  CUDA tensors
    launch the kernel (or raise); CPU tensors run :func:`ssd_scan_plain`.
    ``ssd_scan_h100.launches`` counts kernel launches,
    ``ssd_scan_h100.shapes`` the same launches by (rows, seq, heads, hd,
    state, chunk, bd, state given, dtype)."""
    fn = ssd_scan_plain if x.device.type == "cpu" else _launch
    return fn(x, a, b, c, state0, chunk=chunk, bd=bd)


ssd_scan_h100.launches = 0
ssd_scan_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Napkin constants of :func:`_score`: (row, head) pairs a one-row prefill
#: chunk gives (the served configs have 24 and 25 heads); f32 multiply-adds
#: an SM issues a cycle from shared memory, about one per lane of its four
#: schedulers; cycles a chunk costs in barriers and load latency.
PAIRS = 24
MACS_PER_CYCLE = 128
CHUNK_CYCLES = 3000


def _score(v: Mapping[str, object]):
    """Napkin model, higher is better: the inverse of the cycles of one
    (row, head) pair's blocks.  A block does SQ·(ck·STATE + ck·w +
    2·STATE·w) multiply-adds for its w = min(bd, HD) columns (G is
    recomputed by each of the HD/w tiles) plus a fixed cost a chunk; the
    tiles of ``PAIRS`` pairs run in waves over the SMs."""
    chunk, bd = np.asarray(v["chunk"]), np.asarray(v["bd"])
    sq, hd = v.get("SQ", 256), v.get("HD", 64)
    n = v.get("STATE", 64)
    cores = max(1, v.get("CORES", 1))
    ck = np.minimum(chunk, sq)
    w = np.minimum(bd, hd)
    waves = np.ceil(PAIRS * np.ceil(hd / w) / cores)
    macs = sq * (ck * n + ck * w + 2 * n * w)
    cycles = waves * macs / MACS_PER_CYCLE + np.ceil(sq / ck) * CHUNK_CYCLES
    return 1e3 / cycles


def smem_bytes(chunk, bd, state):
    """Shared bytes a block of the kernel takes, f32 throughout: the state
    tile, the x tile, b and c rows padded to state + 1, the chunk×chunk
    scores and the log-decay prefix.  Over ints, or over polynomials for
    the smem counter."""
    return 4 * (state * bd + chunk * bd + 2 * chunk * (state + 1)
                + chunk * chunk + chunk)


class SsdScanH100Family(CachedInstantiationMixin):
    name = "ssd_scan_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"granularity_level": 0, "tile_level": 0},
            program_params={
                "chunk": ParamDomain("chunk", (16, 32, 64, 128, 256)),
                "bd": ParamDomain("bd", (8, 16, 32, 64)),
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_chunk", "narrow_tile"),
                     "state tile, x tile, padded b/c rows, the C×C decay "
                     "scores and the log-decay prefix in f32 (paper: Z_B)"),
            resource("threads", "T", (), "a fixed 256 threads a block"),
            resource("registers", "G", (),
                     "40 a thread, as ptxas reports for both types"),
            performance("occupancy", "P_occ", ("narrow_tile",),
                        "share of the SMs one (row, head) pair's hd tiles "
                        "leave idle"),
        ]

    def strategies(self) -> Sequence[Strategy]:
        def reduce_chunk(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            p = plan.with_flag("granularity_level", 1, "reduce chunk")
            p.program_params["chunk"] = ParamDomain("chunk", (16, 32, 64))
            return p

        def narrow_tile(plan: KernelPlan):
            if plan.flags.get("tile_level", 0) >= 1:
                return None
            p = plan.with_flag("tile_level", 1, "narrow hd tile")
            p.program_params["bd"] = ParamDomain("bd", (8, 16))
            return p

        return [Strategy("reduce_chunk", reduce_chunk),
                Strategy("narrow_tile", narrow_tile)]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "smem_bytes":
            return smem_bytes(V("chunk"), V("bd"), V("STATE")), one
        if counter == "threads":
            return Poly.const(THREADS), one
        if counter == "registers":
            return Poly.const(40), one
        if counter == "occupancy":
            return V("CORES") * V("bd"), V("CORES") * V("bd") + V("HD")
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score(v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        fn = _launch if device == "cuda" else ssd_scan_plain
        return functools.partial(fn, chunk=int(assignment["chunk"]),
                                 bd=int(assignment["bd"]))


FAMILY = SsdScanH100Family()
