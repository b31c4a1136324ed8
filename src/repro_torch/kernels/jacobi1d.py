"""K6 ``jacobi1d_h100`` — the 1D Jacobi stencil (paper Fig. 7, Table 2) on Hopper.

Replaces the TPU kernel ``pallas_jacobi1d`` (``src/repro/kernels/
jacobi1d.py``, ``_jacobi_kernel_cached`` / ``_jacobi_kernel_uncached``) with
the hand-written CUDA kernel in ``csrc/jacobi1d.cu``: ``steps`` sweeps of
the 3-point mean over an f32 vector with fixed ends, one launch a sweep
(the paper's t-loop stays outside the kernel, as on the TPU).  A block of B
threads computes B·s interior points; no padding copies.  The first sweep
reads x itself and two work buffers ping-pong after it, each sweep copying
the two fixed ends into its destination, so x is never copied whole.

The comprehensive tree reproduces the paper's three cases on Z_B = V, with
the smem counter Z(g) = 4·(B·g + 2) bytes, the staged window
(:func:`smem_bytes`, also the kernel's allocation):

  case 1:  Z(s) <= V              cached, grain s
  case 2:  Z(1) <= V < Z(s)       cached, grain 1   (reduce_granularity)
  case 3:  V < Z(1)               uncached, grain 1 (then uncache)

As for K4, after reduce_granularity ``s`` stands for the source grain that
did not fit and the kernel runs grain 1 (``instantiate_cache.grain``).  A
window is at most 32,776 bytes (B <= 1024, s <= 8), so on H100_SXM and
PAPER_M2050 only case 1 is live.

The dispatch keys on N alone, as the JAX op does: the step count is no
data parameter of the tree (a ``"T"`` key would name the machine's threads
a block, and ``select`` refuses it).

Bound on the card: bytes, and at the paper's n = 2^15 + 2 the launch (see
the note in the CUDA source).

Program parameters:  B, s
Data parameters:     N
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
from . import build, ref
from .instantiate_cache import CachedInstantiationMixin, grain

#: jacobi1d_h100_launch(x, y, n, B, s, cached, stream)
_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def smem_bytes(B, g):
    """Shared bytes of the cached kernel's window: B·g interior points and
    their two neighbours in f32.  Over ints, or over polynomials for the
    smem counter."""
    return 4 * (B * g + 2)


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def jacobi1d_plain(x: torch.Tensor, steps: int, *, B: int, s: int,
                   cached: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the oracle :func:`ref.jacobi1d`
    on a copy of x, ``steps`` sweeps of ``(x[:-2] + x[1:-1] + x[2:]) / 3``
    into the interior, the ends kept, each division as IEEE says.  The block
    format does not change the result (paper Def. 2 ii), so it is taken and
    ignored."""
    return ref.jacobi1d(x.clone(), steps)


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("jacobi1d", "jacobi1d_h100_launch", _ARGTYPES)


def sweep(src: torch.Tensor, dst: torch.Tensor, *, B: int, s: int,
          cached: bool = True, stream: Optional[int] = None) -> None:
    """One launch: write dst's interior from src and copy src's two ends
    into dst (both n f32 on one CUDA device, n >= 3), on ``stream`` (the
    raw handle; the current stream when None)."""
    n = src.numel()
    if stream is None:
        stream = torch._C._cuda_getCurrentRawStream(src.device.index)
    err = _entry()(src.data_ptr(), dst.data_ptr(), n, B, s, int(cached),
                   stream)
    if err:
        build.check(err, f"jacobi1d_h100(B={B}, s={s}, cached={cached})")
    jacobi1d_h100.launches += 1
    jacobi1d_h100.shapes[(n, B, s, bool(cached), src.dtype)] += 1


def _launch(x: torch.Tensor, steps: int, *, B: int, s: int,
            cached: bool = True) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"jacobi1d_h100 kernel needs a CUDA tensor: "
                         f"{x.device}")
    if x.dim() != 1:
        raise ValueError(f"jacobi1d_h100: want a vector, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"jacobi1d_h100 takes float32 only, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("jacobi1d_h100 needs a contiguous vector")
    if steps < 0:
        raise ValueError(f"jacobi1d_h100: steps {steps} < 0")
    if steps == 0 or x.numel() < 3:           # no interior: x comes back
        return x.clone()
    # the first sweep reads x; then two buffers ping-pong on the stream, with
    # no host sync, each sweep copying the fixed ends into its destination
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    bufs = [torch.empty_like(x) for _ in range(min(steps, 2))]
    src = x
    for k in range(steps):
        sweep(src, bufs[k % 2], B=B, s=s, cached=cached, stream=stream)
        src = bufs[k % 2]
    return src


def jacobi1d_h100(x: torch.Tensor, steps: int, *, B: int, s: int,
                  cached: bool = True) -> torch.Tensor:
    """``steps`` Jacobi sweeps of the f32 vector ``x``, ends fixed, as a new
    tensor.  CUDA tensors launch the kernel once a sweep (or raise); CPU
    tensors run :func:`jacobi1d_plain`.  ``jacobi1d_h100.launches`` counts
    kernel launches, ``jacobi1d_h100.shapes`` the same launches by (n, B, s,
    cached, dtype)."""
    fn = jacobi1d_plain if x.device.type == "cpu" else _launch
    return fn(x, steps, B=B, s=s, cached=cached)


jacobi1d_h100.launches = 0
jacobi1d_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

def _score(v: Mapping[str, object], g, cached: bool):
    """Napkin model at grain ``g``, over scalars or NumPy columns, higher is
    better: the grid should give every SM a block; a block of fewer than
    256 threads leaves an SM's issue slots idle; threads past n - 2 do no
    work; a staged window re-reads 2 halo values a block, direct loads 3
    values a point (from L1/L2, counted at half)."""
    B, g = np.asarray(v["B"]), np.asarray(g)
    inner = max(1, v.get("N", (1 << 15) + 2) - 2)
    cores = max(1, v.get("CORES", 1))
    blocks = np.ceil(inner / (B * g))
    fill = np.minimum(1.0, blocks / cores)
    width = np.minimum(1.0, B / 256.0)
    used = inner / (blocks * B * g)
    reads = (B * g) / (B * g + 2) if cached else 0.5
    return fill * width * used * reads


class Jacobi1dH100Family(CachedInstantiationMixin):
    name = "jacobi1d_h100"
    phantom_grain = "s"

    def initial_plan(self) -> KernelPlan:
        return KernelPlan(
            family=self.name,
            flags={"smem_cache": True, "granularity_level": 0},
            program_params={
                "B": ParamDomain("B", (32, 64, 128, 256, 512, 1024),
                                 align=32),
                "s": ParamDomain("s", (1, 2, 4, 8)),
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_granularity", "uncache"),
                     "the staged window, B·s + 2 f32 (paper: Z_B)"),
            resource("threads", "T", (), "threads a block, B (paper: T)"),
            resource("registers", "G", (),
                     "paper: 9 <= R in all three cases"),
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

        return [Strategy("reduce_granularity", reduce_granularity),
                Strategy("uncache", uncache)]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "smem_bytes":
            if plan.flags.get("smem_cache", True):
                return smem_bytes(V("B"), grain(plan, V("s"))), one
            return Poly.const(0), one
        if counter == "threads":
            return V("B"), one
        if counter == "registers":
            return Poly.const(9), one
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(self.score_batch(plan, v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v, grain(plan, v["s"]),
                      plan.flags.get("smem_cache", True))

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        # instantiate has put the grain the kernel runs in s (phantom_grain)
        fn = _launch if device == "cuda" else jacobi1d_plain
        return functools.partial(
            fn, B=int(assignment["B"]), s=int(assignment["s"]),
            cached=bool(plan.flags.get("smem_cache", True)))


FAMILY = Jacobi1dH100Family()
