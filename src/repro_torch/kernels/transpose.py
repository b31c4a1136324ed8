"""K4 ``transpose_h100`` — matrix transposition (paper Fig. 8, Table 3) on Hopper.

Replaces the TPU kernel ``pallas_transpose`` (``src/repro/kernels/
transpose.py``, ``_tr_kernel_cached`` / ``_tr_kernel_uncached``) with the
hand-written CUDA kernel in ``csrc/transpose.cu``: B = Aᵀ for elements of 2
or 4 bytes (f32, bf16), moved as raw bits, so bit-exact, with no padding
copies.  A block of bm × bn threads owns a bm × (s·bn) tile.

The comprehensive tree reproduces the paper's three cases on Z_B = V, with
the smem counter Z(g) = 4·bm·(g·bn + 1) bytes, the staged tile padded by one
column (:func:`smem_bytes`, also the kernel's allocation):

  case 1:  Z(s) <= V              cached, grain s
  case 2:  Z(1) <= V < Z(s)       cached, grain 1   (reduce_granularity)
  case 3:  V < Z(1)               uncached, grain 1 (then uncache)

After reduce_granularity the program parameter ``s`` keeps its domain and
stands for the source grain that did not fit: the counters and the kernel
use grain 1 (``instantiate_cache.grain``), so the refusal ``Z(s) > V``
stays satisfiable beside the new ``Z(1) <= V``.  (The JAX family narrows
the domain of ``s`` to 1 instead, which leaves its case 2 empty.)  With bm·bn <= 1024 threads
and s <= 8 one tile is at most 33,024 bytes, under both H100_SXM's 232,448
and PAPER_M2050's 49,152: on both real machines only case 1 is live, and
cases 2 and 3 need a smaller V (``tests/test_torch_core.py``).

Bound on the card: bytes (see the note in the CUDA source).

Program parameters:  bm, bn, s
Data parameters:     M, N
Machine parameters:  V (shared bytes a block), T (threads a block),
                     G (registers a thread), CORES
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
from .instantiate_cache import CachedInstantiationMixin, grain

#: transpose_h100_launch(a, b, M, N, bm, bn, s, cached, esize, stream)
_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def smem_bytes(bm, bn, g):
    """Shared bytes of the cached kernel's tile: bm rows of g·bn elements
    plus one padding column, each element a 32-bit word (both element
    sizes).  Over ints, or over polynomials for the smem counter."""
    return 4 * bm * (g * bn + 1)



# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def transpose_plain(a: torch.Tensor, *, bm: int, bn: int, s: int,
                    cached: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a contiguous copy of the oracle
    :func:`ref.transpose`, ``a.t()``.  The block format does not change the
    result (paper Def. 2 ii), so it is taken and ignored."""
    return ref.transpose(a).contiguous()


def _launch(a: torch.Tensor, *, bm: int, bn: int, s: int,
            cached: bool = True) -> torch.Tensor:
    if not a.is_cuda:
        raise ValueError(f"transpose_h100 kernel needs a CUDA tensor: "
                         f"{a.device}")
    if a.dim() != 2:
        raise ValueError(f"transpose_h100: want [M, N], got {tuple(a.shape)}")
    if a.element_size() not in (2, 4):
        raise TypeError(f"transpose_h100 moves 2- or 4-byte elements: "
                        f"{a.dtype}")
    if not a.is_contiguous():
        raise ValueError("transpose_h100 needs a contiguous operand")
    M, N = a.shape
    b = torch.empty((N, M), dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return b
    fn = build.entry("transpose", "transpose_h100_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), M, N, bm, bn, s, int(cached),
             a.element_size(), stream)
    build.check(err, f"transpose_h100(bm={bm}, bn={bn}, s={s}, "
                     f"cached={cached})")
    transpose_h100.launches += 1
    transpose_h100.shapes[(M, N, bm, bn, s, bool(cached), a.dtype)] += 1
    return b


def transpose_h100(a: torch.Tensor, *, bm: int, bn: int, s: int,
                   cached: bool = True) -> torch.Tensor:
    """B = Aᵀ as a new [N, M] tensor.  CUDA tensors launch the kernel (or
    raise); CPU tensors run :func:`transpose_plain`.
    ``transpose_h100.launches`` counts kernel launches,
    ``transpose_h100.shapes`` the same launches by (M, N, bm, bn, s, cached,
    dtype)."""
    fn = transpose_plain if a.device.type == "cpu" else _launch
    return fn(a, bm=bm, bn=bn, s=s, cached=cached)


transpose_h100.launches = 0
transpose_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

def _score(v: Mapping[str, object], g, cached: bool):
    """Napkin model at grain ``g``, over scalars or NumPy columns, higher is
    better.  Cached: a warp writes 32/bm output rows of bm elements, so
    bm >= 8 (f32) fills the 32-byte sectors, and reads shared memory
    conflict-free only at bm = 32.  Uncached: every store lands in its own
    sector (a quarter).  Then the bytes a thread has in flight, 4·g of f32
    issued together (before the cached tile's barrier): by Little's law
    HBM3 needs about 25 KB in flight an SM, some 12 bytes for each of its
    2048 threads, twice that where the barrier idles the loads half the
    time, so the term is full at 32 bytes (g = 8).  Then the grid's fill of
    the SMs, blocks of at least 256 threads, and threads past the ragged
    edge doing no work."""
    bm, bn, g = np.asarray(v["bm"]), np.asarray(v["bn"]), np.asarray(g)
    M, N = v.get("M", 4096), v.get("N", 4096)
    cores = max(1, v.get("CORES", 1))
    row_blocks, col_blocks = np.ceil(M / bm), np.ceil(N / (bn * g))
    fill = np.minimum(1.0, row_blocks * col_blocks / cores)
    width = np.minimum(1.0, (bm * bn) / 256.0)
    used = (M * N) / (row_blocks * bm * col_blocks * bn * g)
    inflight = np.minimum(1.0, 4.0 * g / 32.0)
    if cached:
        store = np.minimum(1.0, bm / 8.0) * (0.5 + 0.5 * np.minimum(
            1.0, bm / 32.0))
    else:
        store = 0.25
    return fill * width * used * store * inflight


class TransposeH100Family(CachedInstantiationMixin):
    name = "transpose_h100"
    phantom_grain = "s"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"smem_cache": True, "granularity_level": 0,
                   "cse_level": 0},
            program_params={
                "bm": ParamDomain("bm", (1, 2, 4, 8, 16, 32)),
                "bn": ParamDomain("bn", (32, 64, 128, 256, 512, 1024),
                                  align=32),
                "s": ParamDomain("s", (1, 2, 4, 8)),
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_granularity", "uncache"),
                     "the staged tile, bm × (s·bn + 1) words (paper: Z_B)"),
            resource("threads", "T", (), "threads a block, bm·bn (paper: T)"),
            resource("registers", "G", ("cse_1", "cse_2"),
                     "paper: 6 at source, 5 after CSE (paper: R)"),
        ]

    def strategies(self) -> Sequence[Strategy]:
        def reduce_granularity(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            return plan.with_flag("granularity_level", 1,
                                  "reduce granularity")

        def uncache(plan: KernelPlan):
            if not plan.flags.get("smem_cache", True):
                return None
            return plan.with_flag("smem_cache", False, "drop shared staging")

        def cse(level):
            def apply(plan: KernelPlan):
                if plan.flags.get("cse_level", 0) >= level:
                    return None
                return plan.with_flag("cse_level", level, f"CSE L{level}")
            return apply

        return [Strategy("reduce_granularity", reduce_granularity),
                Strategy("uncache", uncache),
                Strategy("cse_1", cse(1)), Strategy("cse_2", cse(2))]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "smem_bytes":
            if plan.flags.get("smem_cache", True):
                return smem_bytes(V("bm"), V("bn"), grain(plan, V("s"))), one
            return Poly.const(0), one
        if counter == "threads":
            return V("bm") * V("bn"), one
        if counter == "registers":
            c = plan.flags.get("cse_level", 0)
            return Poly.const(6 - min(c, 1)), one
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(self.score_batch(plan, v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v, grain(plan, v["s"]),
                      plan.flags.get("smem_cache", True))

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        # instantiate has put the grain the kernel runs in s (phantom_grain)
        fn = _launch if device == "cuda" else transpose_plain
        return functools.partial(
            fn, bm=int(assignment["bm"]), bn=int(assignment["bn"]),
            s=int(assignment["s"]),
            cached=bool(plan.flags.get("smem_cache", True)))


FAMILY = TransposeH100Family()
