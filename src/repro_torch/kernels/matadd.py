"""K5 ``matadd_h100`` — the paper's introductory example (Fig. 1/2) on Hopper.

Replaces the TPU kernel ``pallas_matadd`` (``src/repro/kernels/matadd.py``,
``_add_kernel``) with the hand-written CUDA kernel in ``csrc/matadd.cu``:
C = A + B over [M, N], f32 or bf16, with no padding copies.  The paper's
thread-block format is the launch shape: a block of bm × bn threads, each
writing ``s`` 16-byte vectors of its row (4 f32 or 8 bf16 values each)
spaced bn vectors apart.  The vector width is fixed by the kernel, not a
program parameter; operands whose row length or base pointers break
16-byte alignment take masked scalar loads over the same grid.

The comprehensive tree reproduces the paper's two-case discussion on R:
the source plan has grain s = 2 (register estimate 14); reduce_granularity
gives grain 1 (estimate 10), so

    C1: { B0·B1 <= T,  14 <= R }          -> grain 2
    C2: { B0·B1 <= T,  10 <= R < 14 }     -> grain 1

(and cse_1 a third, 8 <= R < 10), with B0·B1 = bm·bn threads and R = G.
The kernel stages nothing, so it has no shared-memory counter (the JAX
family's ``vmem_bytes`` counts TPU double-buffering).  No occupancy counter
either: bound by the free measure P_occ its refusal would only repeat the
grain-1 leaves; the napkin :func:`_score` ranks the grid's fill.

Bound on the card: bytes (see the note in the CUDA source).

Program parameters:  bm, bn, s
Data parameters:     M, N
Machine parameters:  T (threads a block), G (registers a thread), CORES
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..core.counters import Counter, resource
from ..core.plan import KernelPlan, ParamDomain
from ..core.polynomial import Poly, V
from ..core.strategies import Strategy
from . import build, ref
from .instantiate_cache import CachedInstantiationMixin

_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: matadd_h100_launch(a, b, c, M, N, bm, bn, s, elem, stream)
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
#: Elements a thread moves in one 16-byte vector, in the napkin: f32's 4
#: (bf16's 8 halve the column blocks again; the ranking does not change).
VEC = 4


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def matadd_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                 s: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the oracle :func:`ref.matadd`,
    one ``a + b``.  The block format does not change the sum (paper Def. 2
    ii), so ``bm``/``bn``/``s`` are taken and ignored."""
    return ref.matadd(a, b)


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("matadd", "matadd_h100_launch", _ARGTYPES)


def _launch(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
            s: int) -> torch.Tensor:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matadd_h100 kernel needs both operands on one CUDA "
                         f"device: {a.device}, {b.device}")
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"matadd_h100: shapes {tuple(a.shape)} + "
                         f"{tuple(b.shape)}; want two equal [M, N]")
    if a.dtype != b.dtype or a.dtype not in _ELEM:
        raise TypeError(f"matadd_h100 takes f32 or bf16 pairs: {a.dtype}, "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matadd_h100 needs contiguous operands")
    M, N = a.shape
    c = torch.empty_like(a)
    if a.numel() == 0:
        return c
    err = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, bm, bn, s,
                   _ELEM[a.dtype],
                   torch._C._cuda_getCurrentRawStream(a.device.index))
    if err:
        build.check(err, f"matadd_h100(bm={bm}, bn={bn}, s={s})")
    matadd_h100.launches += 1
    matadd_h100.shapes[(M, N, bm, bn, s, a.dtype)] += 1
    return c


def matadd_h100(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                s: int) -> torch.Tensor:
    """C = A + B.  CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`matadd_plain`.  ``matadd_h100.launches`` counts kernel launches,
    ``matadd_h100.shapes`` the same launches by (M, N, bm, bn, s, dtype)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matadd_plain(a, b, bm=bm, bn=bn, s=s)
    return _launch(a, b, bm=bm, bn=bn, s=s)


matadd_h100.launches = 0
matadd_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

def _score(v: Mapping[str, object]):
    """Napkin model, over scalars or NumPy columns, higher is better: a
    block of fewer than 256 threads leaves an SM's issue slots idle; the
    grid should give every SM a block; threads past the ragged edge of the
    data do no work, where a block covers bm · bn · s · VEC elements.  Every
    bn is a whole number of warps on neighbouring 16-byte vectors, so
    coalescing does not separate the leaves."""
    bm, bn, s = np.asarray(v["bm"]), np.asarray(v["bn"]), np.asarray(v["s"])
    M, N = v.get("M", 4096), v.get("N", 4096)
    cores = max(1, v.get("CORES", 1))
    span = bn * s * VEC
    row_blocks, col_blocks = np.ceil(M / bm), np.ceil(N / span)
    fill = np.minimum(1.0, row_blocks * col_blocks / cores)
    width = np.minimum(1.0, (bm * bn) / 256.0)
    used = (M * N) / (row_blocks * bm * col_blocks * span)
    return fill * width * used


class MataddH100Family(CachedInstantiationMixin):
    name = "matadd_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"granularity_level": 0, "cse_level": 0},
            program_params={
                "bm": ParamDomain("bm", (1, 2, 4, 8, 16, 32)),
                "bn": ParamDomain("bn", (32, 64, 128, 256, 512, 1024),
                                  align=32),
                "s": ParamDomain("s", (2,)),     # paper source: two halves
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("threads", "T", (), "threads a block, bm·bn (paper: T)"),
            resource("registers", "G", ("reduce_granularity", "cse_1"),
                     "paper's register estimate: 14 at s=2, 10 at s=1, "
                     "2 fewer after CSE (paper: R)"),
        ]

    def strategies(self) -> Sequence[Strategy]:
        def reduce_granularity(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            p = plan.with_flag("granularity_level", 1, "reduce granularity")
            p.program_params["s"] = ParamDomain("s", (1,))
            return p

        def cse(plan: KernelPlan):
            if plan.flags.get("cse_level", 0) >= 1:
                return None
            return plan.with_flag("cse_level", 1, "CSE on index arithmetic")

        return [Strategy("reduce_granularity", reduce_granularity),
                Strategy("cse_1", cse)]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "threads":
            return V("bm") * V("bn"), one
        if counter == "registers":
            g = plan.flags.get("granularity_level", 0)
            c = plan.flags.get("cse_level", 0)
            return Poly.const((14 if g == 0 else 10) - 2 * c), one
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score(v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        fn = _launch if device == "cuda" else matadd_plain
        return functools.partial(fn, bm=int(assignment["bm"]),
                                 bn=int(assignment["bn"]),
                                 s=int(assignment["s"]))


FAMILY = MataddH100Family()
