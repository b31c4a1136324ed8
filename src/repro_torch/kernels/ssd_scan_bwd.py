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

Three kernels a call, every sum in f32 on the CUDA cores (FMA, never TF32),
no atomics, so two launches give the same bits:

1. states: a block a (row, head, hd tile of 32 columns) and direction;
   forward, the state entering each chunk (K3's recurrence, recomputed
   rather than kept by K3's serve kernels); in reverse, dS_out of each
   chunk, and d(state0) where a state0 was given.  Both into an f32
   workspace (:mod:`.workspace`).
2. chunks: a block a (row, head, chunk) owning all of hd: dx, da, and each
   head's db and dc into the workspace.
3. heads: db and dc summed over the heads in order, in b's type.

Bound on the card: a chunk does about 10·n·N·hd + n²·(3N + 2hd) flops
(the products above) over 2(hd + N) input elements a step: bound by
operations, which the FMA body reaches only at the f32 rate.

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
#: The C entry point's limits (``csrc/ssd_scan_bwd.cu``).
MAX_CHUNK = 64
MAX_HD = 128
MAX_SMEM = 232_448
CHUNKS = (16, 32, 64)
#: hd columns a states block (``kBd``)
STATES_COLUMNS = 32
#: The f32 workspace of the states and of each head's db and dc.
WORKSPACE = Workspace("ssd_scan_bwd states", torch.float32, 0)


def chunk_smem_bytes(chunk, hd, state):
    """Shared bytes of the chunk kernel: x and dy tiles (rows of hd + 1),
    b and c (rows of state + 1), S_in and dS_out (state rows of hd + 1),
    the chunk×chunk M, (dY Xᵀ)⊙L and Q (rows of chunk + 1), six vectors of
    the chunk and eight words of warp sums.  Over ints, or over
    polynomials for the counter."""
    return 4 * (2 * chunk * (hd + 1) + 2 * chunk * (state + 1)
                + 2 * state * (hd + 1) + 3 * chunk * (chunk + 1)
                + 6 * chunk + 8)


def states_smem_bytes(chunk, state):
    """Shared bytes of the states kernel: the state tile and an x (or dy)
    tile of ``STATES_COLUMNS`` columns, b (or c) rows padded to state + 1
    and the log-decay prefix."""
    return 4 * (state * STATES_COLUMNS + chunk * STATES_COLUMNS
                + chunk * (state + 1) + chunk)


def smem_bytes(chunk: int, hd: int, state: int) -> int:
    """Shared bytes of the larger of the kernels."""
    return max(chunk_smem_bytes(chunk, hd, state),
               states_smem_bytes(chunk, state))


#: Kernel launches of one call: states, chunks, heads.
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
        (1 <= ck <= min(seq, MAX_CHUNK), f"ck not in 1..min(seq, "
                                         f"{MAX_CHUNK})"),
        (hd <= MAX_HD, f"hd over {MAX_HD}"),
        (hsum in (1, heads), "heads summed neither 1 nor all"),
        (rows * heads < 1 << 31, "2^31 (row, head) pairs or more"),
        (-(-seq // ck) <= 65_535, "more than 65,535 chunks"),
        (dtype in _ELEM, "not f32 or bf16"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    if smem_bytes(ck, hd, state) > MAX_SMEM:
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
#: device time of each kernel of every leaf at mamba2-130m's and
#: hymba-1.5b's training keys (``chip_smoke.py`` phase 13 (f), each kernel
#: under ``torch.profiler``; H100 SXM at 700 W).  The key has no rows and
#: no heads: a call is taken as a training microbatch of ``TOKENS`` tokens
#: (both training paths' 8 x 1024 and 4 x 2048 in two microbatches) over
#: ``HEADS`` heads.
TOKENS = 4096
HEADS = 24
#: states kernel, µs a chunk of its serial walk: fixed, a state row, a
#: step·state row.
STATES_US = (0.6156, 0.06971, 0.003903)
#: chunk kernel, SM-µs a block: a ck·STATE·HD product, a ck²·HD product,
#: divided by the square root of the blocks an SM holds (1 or 2, by its
#: shared memory and its 128 registers: a second block hides part of the
#: first's latency).
CHUNK_US = (1.807e-4, 1.566e-4)
#: Registers a thread, the most of the six kernels' ptxas counts (the f32
#: chunk kernel's; ``chip_smoke.py`` phase 2 prints them all, CUDA 12.8).
REGISTERS = 128


def _score(v: Mapping[str, object]):
    """Napkin model, higher is better: 1000 / (µs of a call's states and
    chunk kernels; the heads kernel is a few percent and the same for every
    leaf).  The states kernel's blocks walk their ceil(SQ/ck) chunks in
    order; the chunk kernel runs pairs·ceil(SQ/ck) blocks, pairs =
    TOKENS / SQ · HEADS, over the SMs, as many an SM as its shared memory
    allows, up to 2."""
    chunk = np.asarray(v["chunk"])
    sq, hd = v.get("SQ", 1024), v.get("HD", 64)
    n = v.get("STATE", 128)
    cores = max(1, v.get("CORES", 1))
    ck = np.minimum(chunk, sq)
    nc = np.ceil(sq / ck)
    s0, s1, s2 = STATES_US
    states = nc * (s0 + s1 * n + s2 * ck * n)
    per_sm = np.clip(np.floor(MAX_SMEM / chunk_smem_bytes(ck, hd, n)), 1, 2)
    c1, c2 = CHUNK_US
    block = (c1 * ck * n * hd + c2 * ck * ck * hd) / np.sqrt(per_sm)
    chunks = TOKENS / sq * HEADS * nc / cores * block
    return 1e3 / (states + chunks)


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
                     "the chunk kernel's: x, dy, b, c tiles, S_in and "
                     "dS_out, the chunk×chunk M, (dY Xᵀ)⊙L and Q (paper: "
                     "Z_B)"),
            resource("states_smem_bytes", "V", (),
                     "the states kernel's: state tile, x or dy tile, b or "
                     "c rows, the log-decay prefix (paper: Z_B)"),
            resource("threads", "T", (), "a fixed 256 threads a block"),
            resource("registers", "G", (),
                     "the most of the three kernels' ptxas counts"),
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
