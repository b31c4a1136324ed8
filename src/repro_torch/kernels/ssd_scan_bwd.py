"""K3b ``ssd_scan_bwd_h100`` — the gradients of K3's SSD scan on Hopper.

The JAX package has no kernel backward: its train step differentiates the
einsum math of ``ssd_chunk`` (ROADMAP F3).  The port's forward runs every
SSD core through K3 (:mod:`.ssd_scan`), which autograd cannot see, so the
gradient of that launch is this hand-written CUDA kernel
(``csrc/ssd_scan_bwd.cu``): dx, da, db, dc and d(state0) of K3's function
(y, S_final) = scan(x, a, b, c, state0), given dy and the final state's
gradient dS_final (zero when None).  It replaces no TPU kernel.

Per (row, head) and chunk of n <= ck steps, with cum_t = sum_{i<=t} log
a_i, L[t, i] = exp(cum_t - cum_i) for i <= t (masked before the exp),
M = (C Bᵀ) ⊙ L, w_i = exp(cum_n - cum_i), A = exp(cum_n), S_in the state
entering the chunk and dS_out the gradient of the state leaving it:

    dX = Mᵀ dY + (w⊙B) dS_out
    dC = ((dY Xᵀ) ⊙ L) B + diag(exp cum) dY S_inᵀ
    dB = ((dY Xᵀ) ⊙ L)ᵀ C + diag(w) X dS_outᵀ
    dS_in = A dS_out + (diag(exp cum) C)ᵀ dY       (carried to the chunk before)
    dcum_t = Σ_i Q[t, i] − Σ_t' Q[t', t] + exp(cum_t) ⟨dY_t, (C S_in)_t⟩
             − r_t  (+ A ⟨dS_out, S_in⟩ + Σ_i r_i at t = n)

with Q = (dY Xᵀ) ⊙ M and r_i = w_i ⟨B_i, (X dS_outᵀ)_i⟩; dlog a is the
reverse cumsum of dcum within the chunk and da = dlog a / a (a is the decay
itself, not its log: ROADMAP F2).  b and c given as [rows, seq, state]
(shared across heads, as the model passes them) get their gradients summed
over the heads in head order; da stays per head.

Two bodies, three kernels a call each, every sum in f32 in a fixed order
and no atomics, so two launches give the same bits:

- bf16, on the tensor cores (``mma.sync``, chunks up to 128 steps):
  1. walk: a block a (row, head, 32 hd columns) and direction walks its
     chunks in order as K3's bf16 body does, the state tile in f32
     accumulators and the next chunk's tiles arriving by ``cp.async``;
     forward, the state entering each chunk (K3's recurrence, recomputed
     rather than kept by K3's serve kernels); in reverse, dS_out of each
     chunk, and d(state0) where a state0 was given.  Both into an f32
     workspace (:mod:`.workspace`).
  2. chunks: a block a (row, head, chunk) owning all of hd: every product
     of the formulas above on the tensor cores, S_in and dS_out where they
     reach da fed as a high and a low bf16 part; dx, da, and each head's db
     and dc into the workspace.
- f32, on the CUDA cores (FMA, never TF32; chunks up to 64 steps): states
  (the two walks) and chunks, as first written.
- Both: heads, db and dc summed over the heads in order, in b's type.

Bound on the card: a chunk does about 10·n·N·hd + n²·(3N + 2hd) flops
(the products above) over 2(hd + N) input elements a step: bound by
operations, at the tensor cores' rate in bf16 and the f32 rate in f32.

Program parameters:  chunk (steps a chunk)
Data parameters:     SQ, HD, STATE, the key of K3, which a forward and its
                     backward share
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

from ..core.counters import Counter, resource
from ..core.plan import KernelPlan, ParamDomain
from ..core.polynomial import Poly, V
from ..core.strategies import Strategy
from . import build
from .instantiate_cache import CachedInstantiationMixin
from .ssd_scan import _check, _per_head
from .workspace import Workspace

_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: ssd_scan_bwd_h100_launch(x, a, b, c, s0, dy, dsf, dx, da, db, dc, ds0, ws,
#: rows, seq, heads, hd, state, ck, hsum, sb_r, sb_t, sb_h, sc_r, sc_t,
#: sc_h, elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 7
             + (ctypes.c_longlong,) * 6 + (ctypes.c_int, ctypes.c_void_p))
#: threads a block (``kThreads`` in the CUDA source), every kernel
THREADS = 256
#: The C entry point's limits (``csrc/ssd_scan_bwd.cu``): the f32 FMA body
#: takes chunks up to 64 steps, the bf16 body up to 128 and a state up to
#: 256, at most ``MAX_ITEMS`` items a warp (:func:`tc_items`).
MAX_CHUNK = 64
MAX_CHUNK_TC = 128
MAX_STATE_TC = 256
MAX_ITEMS = 8
MAX_HD = 128
MAX_SMEM = 232_448
#: The chunk lengths of the family's tree.  A leaf must suit both bodies
#: (the key has no type), so the tree stops at the f32 body's 64; the bf16
#: body runs 128 when called with it.
CHUNKS = (16, 32, 64)
#: hd columns a block of the f32 states kernel (``kBd``) and of the bf16
#: walk (``kWalkBd``)
STATES_COLUMNS = 32
#: The f32 workspace of the states and of each head's db and dc.
WORKSPACE = Workspace("ssd_scan_bwd states", torch.float32, 0)


def _up16(v):
    """v rounded up to a multiple of 16 over ints or numpy arrays; over a
    polynomial (a counter) v + 15, a bound above it."""
    return v + 15 if isinstance(v, Poly) else (v + 15) // 16 * 16


def _slabs(v):
    """16-wide slabs of a multiple of 16 (or of its polynomial bound)."""
    return v / 16 if isinstance(v, Poly) else v // 16


def chunk_smem_bytes(chunk, hd, state):
    """Shared bytes of the f32 chunk kernel: x and dy tiles (rows of hd +
    1), b and c (rows of state + 1), S_in and dS_out (state rows of hd + 1),
    the chunk×chunk M, (dY Xᵀ)⊙L and Q (rows of chunk + 1), six vectors of
    the chunk and eight words of warp sums.  Over ints, or over
    polynomials for the counter."""
    return 4 * (2 * chunk * (hd + 1) + 2 * chunk * (state + 1)
                + 2 * state * (hd + 1) + 3 * chunk * (chunk + 1)
                + 6 * chunk + 8)


def states_smem_bytes(chunk, state):
    """Shared bytes of the f32 states kernel: the state tile and an x (or
    dy) tile of ``STATES_COLUMNS`` columns, b (or c) rows padded to state +
    1 and the log-decay prefix."""
    return 4 * (state * STATES_COLUMNS + chunk * STATES_COLUMNS
                + chunk * (state + 1) + chunk)


def tc_chunk_smem_bytes(chunk, hd, state):
    """Shared bytes of the bf16 chunk kernel, with c16, np and hp the chunk,
    state and hd rounded up to 16: bf16 tiles of x and dy (rows of hp + 8),
    b and c (rows of np + 8), dS_out's high part (np rows of hp + 8), M and
    P⊙L (rows of c16 + 8); six f32 vectors of the chunk, Q's row and column
    sums and the ⟨C, U⟩, ⟨B, V⟩ rows by 16-wide slab, eight warp sums."""
    c16, n16, h16 = _up16(chunk), _up16(state), _up16(hd)
    return (2 * (2 * c16 * (h16 + 8) + 2 * c16 * (n16 + 8) + n16 * (h16 + 8)
                 + 2 * c16 * (c16 + 8))
            + 4 * (6 * c16 + 2 * _slabs(c16) * c16 + 2 * _slabs(n16) * c16
                   + 8))


def walk_smem_bytes(chunk, state):
    """Shared bytes of the bf16 walk: two slots of a bf16 x (or dy) tile of
    ``STATES_COLUMNS`` columns (rows of 40), of b (or c) (rows of np + 8)
    and of the scale vector and exp(cum_last), and the log-decay prefix."""
    c16, n16 = _up16(chunk), _up16(state)
    return (2 * (2 * c16 * (STATES_COLUMNS + 8) + 2 * c16 * (n16 + 8))
            + 4 * (3 * c16 + 2))


def tc_items(chunk: int, hd: int, state: int) -> int:
    """Items a warp of the bf16 chunk kernel holds in its linear phases:
    (16 rows, 16 columns) tiles of dX [ck][hd] and of dC, dB [ck][state]
    over 8 warps (``chunk_tc_items``); at most 4 runs two blocks an SM."""
    most = _up16(chunk) // 16 * max(_up16(state), _up16(hd)) // 16
    return -(-most // 8)


#: Kernel launches of one call in either body: walk (or states), chunks,
#: heads.
LAUNCHES_A_CALL = 3


def workspace_need(rows: int, seq: int, heads: int, hd: int, state: int,
                   ck: int) -> int:
    """f32 elements of a call's workspace: the state entering each chunk
    and the gradient leaving it, [rows, heads, chunks, state, hd] each,
    and each head's db and dc, [rows, seq, heads, state] each."""
    nc = -(-seq // ck)
    return 2 * rows * heads * nc * state * hd + 2 * rows * seq * heads * state


def format_error(rows: int, seq: int, heads: int, hd: int, state: int,
                 ck: int, hsum: int, dtype: torch.dtype) -> Optional[str]:
    """Why ``ssd_scan_bwd_h100_launch`` refuses this launch, or None: the C
    entry point's checks in Python."""
    checks = [
        (min(rows, seq, heads, hd, state) > 0, "empty operand"),
        (dtype in _ELEM, "not f32 or bf16"),
    ]
    f32 = dtype == torch.float32
    top = MAX_CHUNK if f32 else MAX_CHUNK_TC
    checks += [
        (1 <= ck <= min(seq, top), f"ck not in 1..min(seq, {top})"
                                   f"{' (the f32 body)' if f32 else ''}"),
        (hd <= MAX_HD, f"hd over {MAX_HD}"),
        (hsum in (1, heads), "heads summed neither 1 nor all"),
        (rows * heads < 1 << 31, "2^31 (row, head) pairs or more"),
        (-(-seq // ck) <= 65_535, "more than 65,535 chunks"),
    ]
    if not f32:
        checks += [
            (state <= MAX_STATE_TC, f"state over {MAX_STATE_TC} (the bf16 "
                                    f"body)"),
            (tc_items(ck, hd, state) <= MAX_ITEMS,
             f"more than {MAX_ITEMS} items a warp (the bf16 body)"),
        ]
    for ok, why in checks:
        if not ok:
            return why
    smem = (max(chunk_smem_bytes(ck, hd, state),
                states_smem_bytes(ck, state)) if f32 else
            max(tc_chunk_smem_bytes(ck, hd, state),
                walk_smem_bytes(ck, state)))
    if smem > MAX_SMEM:
        return "a kernel larger than 232,448 bytes of shared memory"
    return None


# =============================================================================
# Plain version, kernel wrapper, launch counter
# =============================================================================

def _tri(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def ssd_scan_bwd_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, state0: Optional[torch.Tensor],
                       dy: torch.Tensor, dS_final: Optional[torch.Tensor],
                       *, chunk: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: the chunk formulas of the
    module docstring in f32 over chunks of ``min(chunk, seq)`` steps (the
    last one cut at seq), the states entering each chunk recomputed from
    ``state0`` (zero when None), dS carried from ``dS_final`` (zero when
    None) back to the first chunk.  Returns (dx in x's type, da f32, db and
    dc in b's type and shape, d(state0) f32, None when ``state0`` is)."""
    N = _check(x, a, b, c, state0, None, None)[0]
    R, S, H, hd = x.shape
    dev = x.device
    xf = x.float().transpose(1, 2)                     # (R, H, S, hd)
    dyf = dy.float().transpose(1, 2)
    af = a.float().transpose(1, 2)                     # (R, H, S)
    bf = _per_head(b, H).float().transpose(1, 2)       # (R, H, S, N)
    cf = _per_head(c, H).float().transpose(1, 2)
    zero = torch.zeros((R, H, N, hd), dtype=torch.float32, device=dev)
    ck = min(chunk, S)
    starts = list(range(0, S, ck))
    S_in, St = [], (zero if state0 is None else state0.float())
    for t0 in starts:                                  # the forward states
        S_in.append(St)
        sl = slice(t0, t0 + ck)
        cum = torch.cumsum(torch.log(af[:, :, sl]), dim=-1)
        w = torch.exp(cum[..., -1:] - cum)
        St = (torch.exp(cum[..., -1:])[..., None] * St
              + (bf[:, :, sl] * w[..., None]).transpose(-1, -2) @ xf[:, :, sl])
    dx, da, db, dc = (torch.empty_like(t) for t in (xf, af, bf, cf))
    dS = zero if dS_final is None else dS_final.float()
    for k in reversed(range(len(starts))):
        sl = slice(starts[k], starts[k] + ck)
        X, DY, A_, B, C = (t[:, :, sl] for t in (xf, dyf, af, bf, cf))
        n = X.shape[-2]
        cum = torch.cumsum(torch.log(A_), dim=-1)
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~_tri(n, dev), -torch.inf)
        L = torch.exp(diff)
        e = torch.exp(cum)
        w = torch.exp(cum[..., -1:] - cum)
        atot = torch.exp(cum[..., -1])
        M = (C @ B.transpose(-1, -2)) * L
        P = DY @ X.transpose(-1, -2)
        PL, Q = P * L, P * M
        U = DY @ S_in[k].transpose(-1, -2)             # (.., n, N)
        Vx = X @ dS.transpose(-1, -2)
        dx[:, :, sl] = M.transpose(-1, -2) @ DY + (B * w[..., None]) @ dS
        dc[:, :, sl] = PL @ B + e[..., None] * U
        db[:, :, sl] = PL.transpose(-1, -2) @ C + w[..., None] * Vx
        r = w * (B * Vx).sum(-1)
        dcum = Q.sum(-1) - Q.sum(-2) + e * (C * U).sum(-1) - r
        dcum[..., -1] += atot * (dS * S_in[k]).sum((-1, -2)) + r.sum(-1)
        dlog = dcum.flip(-1).cumsum(-1).flip(-1)
        da[:, :, sl] = dlog / A_
        dS = atot[..., None, None] * dS + (C * e[..., None]).transpose(
            -1, -2) @ DY
    db, dc = db.transpose(1, 2), dc.transpose(1, 2)    # (R, S, H, N)
    if b.dim() == 3:
        db, dc = db.sum(2), dc.sum(2)
    return (dx.transpose(1, 2).to(x.dtype), da.transpose(1, 2).contiguous(),
            db.to(b.dtype).contiguous(), dc.to(c.dtype).contiguous(),
            None if state0 is None else dS)


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("ssd_scan_bwd", "ssd_scan_bwd_h100_launch", _ARGTYPES)


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, state0: Optional[torch.Tensor],
            dy: torch.Tensor, dS_final: Optional[torch.Tensor], *,
            chunk: int) -> Tuple[torch.Tensor, ...]:
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (a, b, c, dy))
            and all(t is None or t.device == dev for t in (state0,
                                                           dS_final))):
        raise ValueError("ssd_scan_bwd_h100 kernel needs x, a, b, c, dy "
                         "(state0, dS_final) on one CUDA device")
    N, sb, sc = _check(x, a, b, c, state0, None, None)
    R, S, H, hd = x.shape
    if dy.shape != x.shape or (dS_final is not None
                               and dS_final.shape != (R, H, N, hd)):
        raise ValueError(f"ssd_scan_bwd_h100: dy {tuple(dy.shape)}, "
                         f"dS_final "
                         f"{None if dS_final is None else tuple(dS_final.shape)}"
                         f" for x {tuple(x.shape)}")
    dtype = x.dtype
    if dtype not in _ELEM or any(t.dtype != dtype for t in (b, c, dy)):
        raise TypeError(f"ssd_scan_bwd_h100 takes x, b, c, dy of one type, "
                        f"f32 or bf16: {dtype}, {b.dtype}, {c.dtype}, "
                        f"{dy.dtype}")
    if a.dtype != torch.float32 or any(
            t is not None and t.dtype != torch.float32
            for t in (state0, dS_final)):
        raise TypeError("ssd_scan_bwd_h100 takes the decay a and the states "
                        "in f32")
    if not (all(t.is_contiguous() for t in (x, a, dy))
            and all(t is None or t.is_contiguous()
                    for t in (state0, dS_final))
            and b.stride(-1) == 1 and c.stride(-1) == 1):
        raise ValueError("ssd_scan_bwd_h100 needs contiguous x, a, dy and "
                         "states, and b, c contiguous in the state dim")
    ck = min(chunk, S)
    hsum = H if b.dim() == 3 else 1
    why = format_error(R, S, H, hd, N, ck, hsum, dtype)
    if why:
        raise ValueError(f"ssd_scan_bwd_h100(chunk={chunk}): {why}")
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    db = torch.empty(b.shape, dtype=dtype, device=dev)
    dc = torch.empty(c.shape, dtype=dtype, device=dev)
    ds0 = (None if state0 is None else
           torch.empty((R, H, N, hd), dtype=torch.float32, device=dev))
    ws = WORKSPACE.get(dev, workspace_need(R, S, H, hd, N, ck))
    err = _entry()(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        state0.data_ptr() if state0 is not None else None, dy.data_ptr(),
        dS_final.data_ptr() if dS_final is not None else None,
        dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        ds0.data_ptr() if ds0 is not None else None, ws.data_ptr(), R, S,
        H, hd, N, ck, hsum, *sb,
        *sc, _ELEM[dtype], torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        build.check(err, f"ssd_scan_bwd_h100(chunk={chunk})")
    ssd_scan_bwd_h100.launches += LAUNCHES_A_CALL
    ssd_scan_bwd_h100.shapes[signature(x, b, chunk=chunk, state0=state0,
                                       dS_final=dS_final)] += 1
    return dx, da, db, dc, ds0


def signature(x: torch.Tensor, b: torch.Tensor, *, chunk: int,
              state0: Optional[torch.Tensor] = None,
              dS_final: Optional[torch.Tensor] = None) -> tuple:
    """A call's key in ``ssd_scan_bwd_h100.shapes``: (rows, seq, heads, hd,
    state, chunk, b shared across heads, state0 given, dS_final given,
    dtype)."""
    R, S, H, hd = x.shape
    return (R, S, H, hd, b.shape[-1], chunk, b.dim() == 3,
            state0 is not None, dS_final is not None, x.dtype)


def ssd_scan_bwd_h100(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, state0: Optional[torch.Tensor],
                      dy: torch.Tensor, dS_final: Optional[torch.Tensor], *,
                      chunk: int) -> Tuple[torch.Tensor, ...]:
    """(dx, da, db, dc, d(state0)) of K3's scan over x [rows, seq, heads,
    hd], a [rows, seq, heads] f32, b, c [rows, seq, state] (shared across
    heads: their gradients summed over the heads) or [rows, seq, heads,
    state], from ``state0`` [rows, heads, state, hd] f32 (zero when None),
    given dy (x's shape and type) and ``dS_final`` (state0's shape, f32;
    zero when None); d(state0) is None when ``state0`` is.  CUDA tensors launch the kernels (or raise); CPU
    tensors run :func:`ssd_scan_bwd_plain`.  ``ssd_scan_bwd_h100.launches``
    counts kernel launches (``LAUNCHES_A_CALL`` a call),
    ``ssd_scan_bwd_h100.shapes`` the calls by :func:`signature`."""
    fn = ssd_scan_bwd_plain if x.device.type == "cpu" else _launch
    return fn(x, a, b, c, state0, dy, dS_final, chunk=chunk)


ssd_scan_bwd_h100.launches = 0
ssd_scan_bwd_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Napkin constants of :func:`_score`, least-squares fits to the card's
#: device time of the bf16 body's walk and chunk kernels, each under
#: ``torch.profiler``, at the three leaves of mamba2-130m's and hymba-1.5b's
#: training keys (``chip_k3b.py``, which runs ``chip_smoke.py`` phase 13
#: (f); NVIDIA H100 80GB HBM3 at 700 W); its picks held at three keys out
#: of the fit.  The key has no rows and no heads: a call is taken as a
#: training microbatch of ``TOKENS`` tokens (both training paths' 8 x 1024
#: and 4 x 2048 in two microbatches) over ``HEADS`` heads.
TOKENS = 4096
HEADS = 24
#: walk, µs a chunk of its serial walk, in each wave of its blocks: fixed
#: (the barrier, the copies' and the decays' wait, the prefix), a warp's
#: 16-step product of its n8 tiles, a state row stored.
WALK_US = (1.605, 0.1158, 0.002463)
#: Blocks of the walk an SM holds (its ``__launch_bounds__``; 124 registers
#: a thread).
WALK_BLOCKS = 2
#: chunk kernel, SM-µs a block: fixed (its loads, five barriers, the dcum
#: rows), and a multiply-add of its products (:func:`_chunk_macs`).
CHUNK_US = (12.45, 7.839e-6)
#: Registers a thread, the most of the eight kernels' ptxas counts (the
#: bf16 chunk kernel's for 8 items a warp; ``chip_smoke.py`` phase 2 prints
#: them all, CUDA 12.8).
REGISTERS = 191


def _chunk_macs(c16, n16, h16):
    """Multiply-adds of a bf16 chunk block, its split parts counted: C·Bᵀ,
    dY·Xᵀ, Mᵀ·dY, (P⊙L)·B and (P⊙L)ᵀ·C over the causal half of the chunk,
    B·dS_out once and U, V twice (high and low)."""
    return c16 * c16 * (3 * n16 + 2 * h16) / 2 + 5 * c16 * n16 * h16


def _score(v: Mapping[str, object]):
    """Napkin model of the bf16 body, higher is better: 1000 / (µs of a
    call's walk and chunk kernels; the heads kernel is a few percent and
    the same for every leaf).  The walk's blocks, pairs·ceil(HD/32)·2 with
    pairs = TOKENS / SQ · HEADS, walk their ceil(SQ/ck) chunks in order in
    whole waves of ``WALK_BLOCKS`` an SM, a warp's n8 tiles the power of
    two at or above ceil(STATE/32).  The chunk kernel runs pairs·ceil(SQ/ck)
    blocks over the SMs, as many an SM as its shared memory and its items a
    warp (:func:`tc_items`) allow, up to 2."""
    chunk = np.asarray(v["chunk"])
    sq, hd = v.get("SQ", 1024), v.get("HD", 64)
    n = v.get("STATE", 128)
    cores = max(1, v.get("CORES", 1))
    ck = np.minimum(chunk, sq)
    c16, n16, h16 = _up16(ck), _up16(n), _up16(hd)
    nc = np.ceil(sq / ck)
    pairs = TOKENS / sq * HEADS
    waves = np.ceil(pairs * np.ceil(hd / STATES_COLUMNS) * 2
                    / (cores * WALK_BLOCKS))
    per = np.exp2(np.ceil(np.log2(np.maximum(1, np.ceil(n16 / 32)))))
    w0, w1, w2 = WALK_US
    walk = nc * waves * (w0 + w1 * c16 / 16 * per + w2 * n16)
    per_sm = np.clip(np.floor(MAX_SMEM / tc_chunk_smem_bytes(ck, hd, n)), 1,
                     np.where(tc_items(ck, hd, n) <= 4, 2, 1))
    b0, b1 = CHUNK_US
    chunks = (pairs * nc / (cores * per_sm)
              * (b0 + b1 * _chunk_macs(c16, n16, h16)))
    return 1e3 / (walk + chunks)


class SsdScanBwdH100Family(CachedInstantiationMixin):
    name = "ssd_scan_bwd_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={},
            program_params={"chunk": ParamDomain("chunk", CHUNKS)},
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", (),
                     "the f32 chunk kernel's: x, dy, b, c tiles, S_in and "
                     "dS_out, the chunk×chunk M, (dY Xᵀ)⊙L and Q (paper: "
                     "Z_B); the largest of the four at every leaf both "
                     "bodies take"),
            resource("states_smem_bytes", "V", (),
                     "the f32 states kernel's: state tile, x or dy tile, b "
                     "or c rows, the log-decay prefix (paper: Z_B)"),
            resource("tc_smem_bytes", "V", (),
                     "the bf16 chunk kernel's, each size rounded up by 15 "
                     "(a bound above it): x, dy, b, c, dS_out's high part, "
                     "M and P⊙L in bf16, the f32 vectors (paper: Z_B)"),
            resource("walk_smem_bytes", "V", (),
                     "the bf16 walk's, sizes rounded up by 15: two slots of "
                     "x or dy, b or c and decays (paper: Z_B)"),
            resource("threads", "T", (), "a fixed 256 threads a block"),
            resource("registers", "G", (),
                     "the most of the seven kernels' ptxas counts"),
        ]

    def strategies(self) -> Sequence[Strategy]:
        return []

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "smem_bytes":
            return chunk_smem_bytes(V("chunk"), V("HD"), V("STATE")), one
        if counter == "states_smem_bytes":
            return states_smem_bytes(V("chunk"), V("STATE")), one
        if counter == "tc_smem_bytes":
            return tc_chunk_smem_bytes(V("chunk"), V("HD"), V("STATE")), one
        if counter == "walk_smem_bytes":
            return walk_smem_bytes(V("chunk"), V("STATE")), one
        if counter == "threads":
            return Poly.const(THREADS), one
        if counter == "registers":
            return Poly.const(REGISTERS), one
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score(v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        fn = _launch if device == "cuda" else ssd_scan_bwd_plain
        return functools.partial(fn, chunk=int(assignment["chunk"]))


FAMILY = SsdScanBwdH100Family()
