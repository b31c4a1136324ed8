"""K1 ``matmul_h100`` — the paper's flagship kernel (Fig. 3/4, Table 1) on Hopper.

Replaces the TPU kernel ``pallas_matmul`` (``src/repro/kernels/matmul.py``,
``_mm_kernel_cached`` / ``_mm_kernel_uncached``) with the hand-written CUDA
kernel in ``csrc/matmul.cu``: C[M,N] = A[M,K] @ B[K,N], A and B both f32 or
bf16, f32 accumulation, f32 output.  This is a return home for the paper: its
thread-block format ``bm × bn`` with grain ``s`` (coefficients per thread,
spaced ``bn`` apart) is the kernel's launch shape, and ``cached`` is its
``__shared__`` staging of A and B tiles.

Bound on the card: at the serving shapes (M = 4..32) every weight byte is
read once for 2·M flops — bound by bytes.  The design reads each weight once
per row block with coalesced loads (see the note in the CUDA source); tensor
cores and TMA are left to later work.

Program parameters:  bm, bn, bk, s   (all symbolic during tree construction)
Data parameters:     M, N, K
Machine parameters:  V (shared bytes a block), G (registers a thread),
                     T (threads a block), CORES (SMs)
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..core.counters import Counter, performance, resource
from ..core.plan import KernelPlan, ParamDomain
from ..core.polynomial import Poly, V
from ..core.strategies import Strategy
from . import build
from .instantiate_cache import CachedInstantiationMixin

#: Shared-memory bytes a staged element takes in the counters: the widest
#: input type (f32), so a leaf chosen for a triple launches for either type.
DIN = 4
_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: matmul_h100_launch(a, b, c, M, N, K, bm, bn, bk, s, cached, elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9
             + (ctypes.c_void_p,))


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                 bk: int, s: int, cached: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 sums over k tiles of ``bk``,
    the kernel's accumulation order across tiles.  The block format does not
    change the result (paper Def. 2 ii), so ``bm``/``bn``/``s``/``cached``
    are taken and ignored."""
    M, K = a.shape
    out = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        out += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return out


def _launch(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int, bk: int,
            s: int, cached: bool) -> torch.Tensor:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matmul_h100 kernel needs both operands on one "
                         f"CUDA device: {a.device}, {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_h100: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _ELEM:
        raise TypeError(f"matmul_h100 takes f32 or bf16 pairs: {a.dtype}, "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_h100 needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    fn = build.entry("matmul", "matmul_h100_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, bm, bn, bk,
             s, int(cached), _ELEM[a.dtype], stream)
    build.check(err, f"matmul_h100(bm={bm}, bn={bn}, bk={bk}, s={s}, "
                     f"cached={cached})")
    matmul_h100.launches += 1
    matmul_h100.shapes[(M, N, K, bm, bn, bk, s, bool(cached), a.dtype)] += 1
    return c


def matmul_h100(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                bk: int, s: int, cached: bool = True) -> torch.Tensor:
    """C = A @ B.  CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`matmul_plain`.  ``matmul_h100.launches`` counts kernel launches,
    ``matmul_h100.shapes`` the same launches by (M, N, K, bm, bn, bk, s,
    cached, dtype)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, bm=bm, bn=bn, bk=bk, s=s, cached=cached)
    return _launch(a, b, bm=bm, bn=bn, bk=bk, s=s, cached=cached)


matmul_h100.launches = 0
matmul_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

_S_DOMAIN_BY_LEVEL = {0: (1, 2, 4, 8, 16), 1: (1, 2)}


def _score(v: Mapping[str, object]):
    """Napkin model of the simple kernel on an H100, over scalars or NumPy
    columns: a row block of ``bm`` re-reads all of B once, so ``bm >= M``
    reads each weight once; the grid should give every SM a block; a block
    of fewer than 256 threads leaves an SM's issue slots idle; staging in
    shared memory keeps more loads in flight than direct loads; short k tiles
    pay a barrier each."""
    bm, bn = np.asarray(v["bm"]), np.asarray(v["bn"])
    bk, s = np.asarray(v["bk"]), np.asarray(v["s"])
    M = v.get("M", 4096)
    N = v.get("N", 4096)
    cores = max(1, v.get("CORES", 1))
    row_blocks = np.ceil(M / bm)
    blocks = row_blocks * np.ceil(N / (bn * s))
    fill = np.minimum(1.0, blocks / cores)
    reread = 1.0 / row_blocks
    width = np.minimum(1.0, (bm * bn) / 256.0)
    idle = np.minimum(1.0, M / bm)                  # rows of the block in use
    return fill * reread * width * idle * (0.5 + 0.5 * np.minimum(1.0, bk / 64))


class MatmulH100Family(CachedInstantiationMixin):
    name = "matmul_h100"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"smem_cache": True, "granularity_level": 0,
                   "pressure_level": 0, "cse_level": 0},
            program_params={
                "bm": ParamDomain("bm", (1, 2, 4, 8, 16, 32, 64)),
                "bn": ParamDomain("bn", (32, 64, 128, 256), align=32),
                "bk": ParamDomain("bk", (16, 32, 64, 128)),
                "s": ParamDomain("s", _S_DOMAIN_BY_LEVEL[0]),
            },
        )

    # -- counters (order: resources r_i first, then performance p_i) ---------
    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_granularity", "uncache"),
                     "shared memory a block stages (paper: Z_B)"),
            resource("threads", "T", (),
                     "threads a block, bm·bn (paper: T)"),
            resource("registers", "G",
                     ("pressure_1", "pressure_2", "pressure_3",
                      "cse_1", "cse_2"),
                     "registers a thread (paper: R)"),
            performance("occupancy", "P_occ", ("reduce_granularity",),
                        "share of the SMs a grid of blocks leaves idle"),
        ]

    # -- strategies O_1..O_w (the JAX family's list, paper §5) ---------------
    def strategies(self) -> Sequence[Strategy]:
        def reduce_granularity(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            p = plan.with_flag("granularity_level", 1, "reduce granularity")
            p.program_params["s"] = ParamDomain("s", _S_DOMAIN_BY_LEVEL[1])
            return p

        def uncache(plan: KernelPlan):
            if not plan.flags.get("smem_cache", True):
                return None
            return plan.with_flag("smem_cache", False, "drop shared staging")

        def pressure(level):
            def apply(plan: KernelPlan):
                if plan.flags.get("pressure_level", 0) >= level:
                    return None
                return plan.with_flag("pressure_level", level,
                                      f"split accumulator L{level}")
            return apply

        def cse(level):
            def apply(plan: KernelPlan):
                if plan.flags.get("cse_level", 0) >= level:
                    return None
                return plan.with_flag("cse_level", level, f"CSE L{level}")
            return apply

        return [
            Strategy("reduce_granularity", reduce_granularity),
            Strategy("uncache", uncache),
            Strategy("pressure_1", pressure(1)),
            Strategy("pressure_2", pressure(2)),
            Strategy("pressure_3", pressure(3)),
            Strategy("cse_1", cse(1)),
            Strategy("cse_2", cse(2)),
        ]

    # -- symbolic counter evaluation (paper §3.3: f_i, g_i) -------------------
    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        bm, bn, bk, s = V("bm"), V("bn"), V("bk"), V("s")
        one = Poly.const(1)
        if counter == "smem_bytes":
            if plan.flags.get("smem_cache", True):
                return DIN * (bm * bk + bk * bn * s), one
            return Poly.const(0), one
        if counter == "threads":
            return bm * bn, one
        if counter == "registers":
            # s f32 accumulators, s staged B values per k step (split per
            # pressure level), and the index arithmetic CSE trims.  As in the
            # JAX family the levels change the estimate, not the kernel.
            p = plan.flags.get("pressure_level", 0)
            c = plan.flags.get("cse_level", 0)
            return s + s * 4 / (2 ** p) + Poly.const(24 - 4 * c), one
        if counter == "occupancy":
            # CORES / (CORES + blocks), blocks = M·N / (bm·bn·s): near 1 when
            # the grid starves the SMs, near 0 when it fills them
            tile = bm * bn * s
            return V("CORES") * tile, V("CORES") * tile + V("M") * V("N")
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        base = float(_score(v))
        return base if plan.flags.get("smem_cache", True) else 0.5 * base

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        base = _score(v)
        return base if plan.flags.get("smem_cache", True) else 0.5 * base

    # -- instantiation (memoized by CachedInstantiationMixin.instantiate) ----
    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        fn = _launch if device == "cuda" else matmul_plain
        return functools.partial(
            fn, bm=int(assignment["bm"]), bn=int(assignment["bn"]),
            bk=int(assignment["bk"]), s=int(assignment["s"]),
            cached=bool(plan.flags.get("smem_cache", True)))


FAMILY = MatmulH100Family()
