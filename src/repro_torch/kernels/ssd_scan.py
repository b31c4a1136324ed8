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

**The state is updated in place.**  ``out_state`` may be ``state0``
itself: the kernel reads each (row, head) state tile fully before it writes
any of it.  ``mask`` [rows] (bool, on the tensors' device) leaves rows out:
a row left out keeps its ``out_state`` bit for bit and gets y = 0.  The
serving engine hands its per-slot cache ``ssm[i, :B]`` in as both, with
the decoding rows as the mask, so a decode step allocates and scatters no
state.  This is an in-place update of an f32 buffer only the engine owns;
the JAX model returns a new state and masks it with ``ssm_mask``.  The
plain version does the same on the CPU, in place and masked.

**The state row is chosen on the device.**  ``state_rows`` [rows] (int32,
on the tensors' device, with an ``out_state``) maps each row of x to the
row of ``state0`` / ``out_state`` it reads and updates in place; the two
states then have any number of rows, and the indices must differ.  A
prefill chunk hands in the whole of its layer's per-slot cache with its
slot as the one index, so the chunk stays one launch and a CUDA graph
reads the slot from a buffer.  An index outside the state's rows leaves
its row out, as a mask would (the plain version raises).

B and C are shared across heads (ngroups = 1): the wrapper takes them as
[rows, seq, state] or as a [rows, seq, heads, state] view with head stride 0
and passes strides, so no per-head copy is made.

Which body runs (see the CUDA source): at seq 1 every leaf runs the step
body, since ck = min(chunk, seq) is 1 there: the recurrence itself, no
scan, no score tile, no chunk loop, the state read and written once.  The
step body also takes chunks of up to 8 steps (:func:`step_body`), the
state held in registers across them.  Longer chunks run a chunk body:
bf16 the tensor-core body, with G, S and w⊙b fed as a high and a low bf16
part, f32 an FMA body (never TF32).  A block owns ``bd`` columns of one
(row, head), so at hd 64 and bd 64 the C×C scores are computed once a
chunk.

Bound on the card: bytes at decode (the f32 state is read and written every
step), operations for a prefill chunk at state 128, on the bf16 tensor
cores.

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
#: ssd_scan_h100_launch(x, a, b, c, s0, y, s1, mask, state_rows, rows,
#: srows, seq, heads, hd, state, ck, bd, sb_r, sb_t, sb_h, sc_r, sc_t, sc_h,
#: elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 8
             + (ctypes.c_longlong,) * 6 + (ctypes.c_int, ctypes.c_void_p))
#: threads a block (``kThreads`` in the CUDA source), every body
THREADS = 256
#: The C entry point's limits (``csrc/ssd_scan.cu``).
MAX_CHUNK = 128
MAX_SMEM = 232_448
BD = (32, 64)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(chunk, bd, np_):
    """Shared bytes of the tensor-core body (bf16) for ``chunk`` steps (a
    multiple of 16) and ``np_`` state rows (state rounded up to 16): two
    slots of x, b and c tiles in bf16 with rows padded by 8 elements, the
    state in f32 and as a high and a low bf16 part, and the decays, their
    log prefix, exp(cum) and the weights w.  Over ints, or over polynomials
    for the smem counter."""
    return (4 * chunk * (bd + 8) + 8 * chunk * (np_ + 8)
            + 8 * np_ * (bd + 8) + 20 * chunk)


def fma_smem_bytes(chunk, bd, state):
    """Shared bytes of the FMA body (f32): the state tile, the x tile, b
    and c rows padded to state + 1, the chunk×chunk scores and the
    log-decay prefix.  Over ints, or over polynomials."""
    return 4 * (state * bd + chunk * bd + 2 * chunk * (state + 1)
                + chunk * chunk + chunk)


#: Steps the step body takes, and state rows a thread of it holds
#: (``kStepSeq``, ``kRows`` in the CUDA source).
STEP_SEQ = 8
STEP_ROWS = 8


def step_body(seq: int, state: int, bd: int, vec: bool = True) -> bool:
    """Whether a launch runs the step body: at most 8 steps, and the state
    within the rows its threads hold (8 each, THREADS / (bd / 4) state
    groups with 16-byte vectors, THREADS / bd without)."""
    groups = THREADS // (bd // 4 if vec else bd)
    return seq <= STEP_SEQ and state <= groups * STEP_ROWS


def launch_smem(seq: int, ck: int, bd: int, state: int,
                dtype: torch.dtype) -> int:
    """Shared bytes one launch takes in dynamic memory: 0 for the step body
    (its 4 KB are static), else its chunk body's."""
    if step_body(seq, state, bd):
        return 0
    if dtype == torch.bfloat16:
        return smem_bytes(_round16(ck), bd, _round16(state))
    return fma_smem_bytes(ck, bd, state)


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
           c: torch.Tensor, state0: Optional[torch.Tensor],
           out_state: Optional[torch.Tensor], mask: Optional[torch.Tensor],
           state_rows: Optional[torch.Tensor] = None
           ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """Validate shapes; returns the state dim and b's and c's (row, step,
    head) strides, the head stride 0 for a [rows, seq, state] projection
    shared across heads (no view is made: a view costs the host more than
    the rest of a launch)."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan_h100: x must be [rows, seq, heads, hd]: "
                         f"{tuple(x.shape)}")
    R, S, H, hd = x.shape
    bs = b.shape
    N = bs[-1]
    four = len(bs) == 4
    if a.shape != (R, S, H) or bs != c.shape or len(bs) not in (3, 4) \
            or bs[0] != R or bs[1] != S or (four and bs[2] != H):
        raise ValueError(f"ssd_scan_h100: a {tuple(a.shape)}, b {tuple(bs)}, "
                         f"c {tuple(c.shape)} for x {tuple(x.shape)}")
    if state_rows is not None and (state_rows.shape != (R,)
                                   or out_state is None):
        raise ValueError(f"ssd_scan_h100: state_rows "
                         f"{tuple(state_rows.shape)} needs the shape ({R},) "
                         "and an out_state")
    for name, st in (("state0", state0), ("out_state", out_state)):
        if st is None:
            continue
        want = ((st.shape[0] if state_rows is not None else R), H, N, hd)
        if st.shape != want or (state_rows is not None
                                and out_state.shape != st.shape):
            raise ValueError(f"ssd_scan_h100: {name} {tuple(st.shape)}, "
                             f"want {want}")
    if mask is not None and (mask.shape != (R,) or out_state is None):
        raise ValueError(f"ssd_scan_h100: mask {tuple(mask.shape)} needs "
                         f"the shape ({R},) and an out_state")
    sb, sc = b.stride(), c.stride()
    if four:
        return N, sb[:3], sc[:3]
    return N, (sb[0], sb[1], 0), (sc[0], sc[1], 0)


def _per_head(t: torch.Tensor, heads: int) -> torch.Tensor:
    """b or c as [rows, seq, heads, state] (a view)."""
    return t if t.dim() == 4 else t[:, :, None, :].expand(
        t.shape[0], t.shape[1], heads, t.shape[2])


def ssd_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, state0: Optional[torch.Tensor] = None,
                   *, chunk: int, bd: int,
                   out_state: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   state_rows: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: chunks of ``min(chunk, seq)``
    steps (the last one cut at seq) through :func:`ssd_chunk` in f32, from
    ``state0`` (zero when None).  The hd tile ``bd`` does not change the
    result (paper Def. 2 ii) and is taken and ignored.  The final state
    goes into ``out_state`` when given (which may be ``state0``: the whole
    scan reads state0 before anything is written), rows that ``mask``
    leaves out keeping theirs and getting y = 0, as the kernel does; with
    ``state_rows`` row r reads and writes state row ``state_rows[r]`` by
    indexing.  Returns (y in x's type, final state f32); on the ``meta``
    device (the dry run) their shapes and types only."""
    N = _check(x, a, b, c, state0, out_state, mask, state_rows)[0]
    R, S, H, hd = x.shape
    if x.is_meta:
        return torch.empty_like(x), (
            out_state if out_state is not None else torch.empty(
                (R, H, N, hd), dtype=torch.float32, device="meta"))
    rows = state_rows.long() if state_rows is not None else None
    xf = x.float().transpose(1, 2)                     # (R, H, S, hd)
    af = a.float().transpose(1, 2)                     # (R, H, S)
    bf = _per_head(b, H).float().transpose(1, 2)       # (R, H, S, N)
    cf = _per_head(c, H).float().transpose(1, 2)
    if state0 is None:
        St = torch.zeros((R, H, N, hd), dtype=torch.float32, device=x.device)
    else:
        St = (state0 if rows is None else state0.index_select(0, rows)
              ).float()
    ck = min(chunk, S)
    ys = []
    for t0 in range(0, S, ck):
        y, St = ssd_chunk(xf[:, :, t0:t0 + ck], af[:, :, t0:t0 + ck],
                          bf[:, :, t0:t0 + ck], cf[:, :, t0:t0 + ck], St)
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2).to(x.dtype)
    if out_state is None:
        return y, St
    if rows is not None:
        if mask is not None:
            keep = mask.to(torch.bool)[:, None, None, None]
            St = torch.where(keep, St, out_state.index_select(0, rows))
            y[~mask.to(torch.bool)] = 0
        out_state.index_copy_(0, rows, St)
    elif mask is None:
        out_state.copy_(St)
    else:
        keep = mask.to(torch.bool)
        out_state[keep] = St[keep]
        y[~keep] = 0
    return y, out_state


def format_error(rows: int, seq: int, heads: int, hd: int, state: int,
                 ck: int, bd: int, dtype: torch.dtype, srows: int = 0
                 ) -> Optional[str]:
    """Why ``ssd_scan_h100_launch`` refuses this launch, or None: the C
    entry point's checks (``csrc/ssd_scan.cu``) in Python.  ``srows`` is
    the state's row count when ``state_rows`` picks the rows, else 0."""
    checks = [
        (min(rows, seq, heads, hd, state) > 0, "empty operand"),
        (1 <= ck <= min(seq, MAX_CHUNK), f"ck not in 1..min(seq, "
                                         f"{MAX_CHUNK})"),
        (bd in BD, f"bd not in {BD}"),
        (max(rows, srows) * heads < 1 << 31,
         "2^31 (row, head) pairs or more"),
        (srows >= 0, "negative state rows"),
        (dtype in _ELEM, "not f32 or bf16"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    if launch_smem(seq, ck, bd, state, dtype) > MAX_SMEM:
        return "chunk body larger than 232,448 bytes"
    return None


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("ssd_scan", "ssd_scan_h100_launch", _ARGTYPES)


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
            chunk: int, bd: int, out_state: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None,
            state_rows: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = x.device
    if not (x.is_cuda and a.device == dev and b.device == dev
            and c.device == dev
            and (state0 is None or state0.device == dev)
            and (out_state is None or out_state.device == dev)
            and (mask is None or mask.device == dev)
            and (state_rows is None or state_rows.device == dev)):
        raise ValueError("ssd_scan_h100 kernel needs x, a, b, c (state0, "
                         "out_state, mask, state_rows) on one CUDA device")
    N, sb, sc = _check(x, a, b, c, state0, out_state, mask, state_rows)
    dtype = x.dtype
    if dtype not in _ELEM or b.dtype != dtype or c.dtype != dtype:
        raise TypeError(f"ssd_scan_h100 takes x, b, c of one type, f32 or "
                        f"bf16: {dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32 or (
            state0 is not None and state0.dtype != torch.float32) or (
            out_state is not None and out_state.dtype != torch.float32):
        raise TypeError("ssd_scan_h100 takes the decay a and the state in "
                        "f32")
    if not (x.is_contiguous() and a.is_contiguous()
            and (state0 is None or state0.is_contiguous())
            and (out_state is None or out_state.is_contiguous())
            and (mask is None or (mask.dtype == torch.bool
                                  and mask.is_contiguous()))
            and (state_rows is None or (state_rows.dtype == torch.int32
                                        and state_rows.is_contiguous()))
            and b.stride(-1) == 1 and c.stride(-1) == 1):
        raise ValueError("ssd_scan_h100 needs contiguous x, a, states, a "
                         "bool mask and int32 state_rows, and b, c "
                         "contiguous in the state dim")
    R, S, H, hd = x.shape
    ck = min(chunk, S)
    srows = out_state.shape[0] if state_rows is not None else 0
    y = torch.empty_like(x)
    if out_state is None:
        out_state = torch.empty((R, H, N, hd), dtype=torch.float32,
                                device=dev)
    err = _entry()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   state0.data_ptr() if state0 is not None else None,
                   y.data_ptr(), out_state.data_ptr(),
                   mask.data_ptr() if mask is not None else None,
                   state_rows.data_ptr() if state_rows is not None else None,
                   R, srows, S, H, hd, N, ck, bd, *sb, *sc, _ELEM[dtype],
                   torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        why = format_error(R, S, H, hd, N, ck, bd, dtype, srows)
        build.check(err, f"ssd_scan_h100(chunk={chunk}, bd={bd}): {why}")
    ssd_scan_h100.launches += 1
    ssd_scan_h100.shapes[(R, S, H, hd, N, chunk, bd, state0 is not None,
                          mask is not None, srows, dtype)] += 1
    return y, out_state


def ssd_scan_h100(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
                  chunk: int, bd: int,
                  out_state: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  state_rows: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, S_final) of the scan over x [rows, seq, heads, hd], a [rows, seq,
    heads] f32, b, c [rows, seq, state] or [rows, seq, heads, state], from
    ``state0`` [rows, heads, state, hd] f32 (zero when None), the final
    state written into ``out_state`` when given (``state0`` itself updates
    in place), rows that ``mask`` [rows] (bool, with an ``out_state``)
    leaves out untouched; with ``state_rows`` [rows] (int32, with an
    ``out_state``) row r reads and writes state row ``state_rows[r]`` of
    states of any row count.  CUDA tensors launch the kernel (or raise);
    CPU tensors run :func:`ssd_scan_plain`.  ``ssd_scan_h100.launches``
    counts kernel launches, ``ssd_scan_h100.shapes`` the same launches by
    (rows, seq, heads, hd, state, chunk, bd, state given, masked, state
    rows picked from (0: none), dtype)."""
    fn = ssd_scan_plain if x.device.type == "cpu" else _launch
    return fn(x, a, b, c, state0, chunk=chunk, bd=bd, out_state=out_state,
              mask=mask, state_rows=state_rows)


ssd_scan_h100.launches = 0
ssd_scan_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Napkin constants of :func:`_score`: (row, head) pairs a one-row prefill
#: chunk gives (the served configs have 24 and 25 heads); tensor-core
#: multiply-adds a block of 8 warps does a cycle through ``mma.sync``
#: (each product counted twice, for its high and low part) and cycles a
#: chunk costs in barriers, the decay scan and load latency, both fitted
#: (least squares, at 1.755 GHz) to the device times of the seven leaves
#: ``chip_smoke.py`` phase 5 times at a 256-step mamba2-130m chunk on an
#: H100 (PERF.md); state bytes a step block moves a cycle, and cycles it
#: spends on a step (its loads, the reduction of y, one barrier).
PAIRS = 24
MACS_PER_CYCLE = 205
CHUNK_CYCLES = 5750
STEP_BYTES_PER_CYCLE = 16
STEP_CYCLES = 600
#: Registers a thread, the most of the three bodies as ``ptxas -v`` reports
#: them for sm_90a.
REGISTERS = 128


def _score(v: Mapping[str, object]):
    """Napkin model, higher is better: the inverse of the cycles of one
    (row, head) pair's blocks.  Up to 8 steps (the step body, whatever the
    chunk) a block reads and writes its 4·N·w bytes of state for its w =
    min(bd, HD) columns and pays a fixed cost a step.  Past that, a chunk
    of ck = min(chunk, SQ) steps does ck·N·w multiply-adds (c·S), the
    lower-triangular 16×16 score slabs of its 16-row tiles over N, once for
    each 32-column group (c·bᵀ), the same slabs × w (G·x) and N·w·ck (the
    state), every product but c·bᵀ twice, plus a fixed cost a chunk.  The
    HD/w tiles of ``PAIRS`` pairs run in waves over the SMs."""
    chunk, bd = np.asarray(v["chunk"]), np.asarray(v["bd"])
    sq, hd = v.get("SQ", 256), v.get("HD", 64)
    n = v.get("STATE", 64)
    cores = max(1, v.get("CORES", 1))
    ck = np.minimum(chunk, sq)
    w = np.minimum(bd, hd)
    waves = np.ceil(PAIRS * np.ceil(hd / w) / cores)
    slabs = (ck / 16) * (ck / 16 + 1) / 2 * 256
    macs = (2 * ck * n * w + slabs * n * np.ceil(w / 32) + 2 * slabs * w
            + 2 * n * w * ck)
    chunked = np.ceil(sq / ck) * (macs / MACS_PER_CYCLE + CHUNK_CYCLES)
    stepped = 8.0 * n * w / STEP_BYTES_PER_CYCLE + sq * STEP_CYCLES
    step = (sq <= STEP_SEQ) & (n <= THREADS // (bd // 4) * STEP_ROWS)
    return 1e3 / (waves * np.where(step, stepped, chunked))


class SsdScanH100Family(CachedInstantiationMixin):
    name = "ssd_scan_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"granularity_level": 0, "tile_level": 0},
            program_params={
                "chunk": ParamDomain("chunk", (16, 32, 64, 128)),
                "bd": ParamDomain("bd", BD),
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_chunk", "narrow_tile"),
                     "the tensor-core body (bf16): two slots of padded x, "
                     "b, c tiles, the state in f32 and as two bf16 parts, "
                     "the decays (paper: Z_B)"),
            resource("fma_smem_bytes", "V", ("reduce_chunk", "narrow_tile"),
                     "the FMA body (f32): state tile, x tile, padded b/c "
                     "rows, the C×C scores and the log-decay prefix "
                     "(paper: Z_B)"),
            resource("threads", "T", (), "a fixed 256 threads a block"),
            resource("registers", "G", (),
                     "the most of the bodies' ptxas counts"),
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
            p.program_params["bd"] = ParamDomain("bd", (32,))
            return p

        return [Strategy("reduce_chunk", reduce_chunk),
                Strategy("narrow_tile", narrow_tile)]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "smem_bytes":
            # the kernel's np = STATE rounded up to 16 is at most STATE + 15
            return smem_bytes(V("chunk"), V("bd"), V("STATE") + 15), one
        if counter == "fma_smem_bytes":
            return fma_smem_bytes(V("chunk"), V("bd"), V("STATE")), one
        if counter == "threads":
            return Poly.const(THREADS), one
        if counter == "registers":
            return Poly.const(REGISTERS), one
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
