"""K6 ``jacobi1d_h100`` — the 1D Jacobi stencil (paper Fig. 7, Table 2) on Hopper.

Replaces the TPU kernel ``pallas_jacobi1d`` (``src/repro/kernels/
jacobi1d.py``, ``_jacobi_kernel_cached`` / ``_jacobi_kernel_uncached``) with
the hand-written CUDA kernels in ``csrc/jacobi1d.cu``: ``steps`` sweeps of
the 3-point mean over an f32 vector with fixed ends.  The TPU runs one sweep
a ``pallas_call``; here one launch runs up to F sweeps (the program
parameter ``F``) on a window held in shared memory, staged by one bulk copy,
so a call is ceil(steps / F) launches (:func:`launch_plan`).  A block of B
threads owns B·s interior points and recomputes the halo its depth needs; no
padding copies.  The first launch reads x itself and two work buffers
ping-pong after it; x is never written.

The comprehensive tree reproduces the paper's three cases on Z_B = V, with
the smem counter Z(g, F) (:func:`smem_bytes`, also the kernel's dynamic
shared memory): 4·(B·g + 2) bytes at F = 1, the one-sweep kernel's window;
8·(B·g + 2F + 4) + 8 at F > 1, two buffers of the window's B·g + 2F values
and 16-byte slack, and the bulk copy's mbarrier.

  case 1:  Z(s, F) <= V              cached, grain s
  case 2:  Z(1, F) <= V < Z(s, F)    cached, grain 1   (reduce_granularity)
  case 3:  V < Z(1, F)               uncached, grain 1, F = 1 (then uncache)

As for K4, after reduce_granularity ``s`` stands for the source grain that
did not fit and the kernel runs grain 1 (``instantiate_cache.grain``);
uncache pins F's domain to 1 (direct loads, one sweep a launch).  F's domain
is cut by the same counter as B's and s's.  A window is at most 66,088 bytes
(B <= 1024, s <= 8, F <= 32), so on H100_SXM only case 1 is live; on
PAPER_M2050 (48 KB) the widest windows (B·s = 8192) at F > 1 take case 2.

The dispatch keys on N alone, as the JAX op does: the step count is no
data parameter of the tree (a ``"T"`` key would name the machine's threads
a block, and ``select`` refuses it), so F is chosen without it and a call's
last launch runs what is left.

Bound on the card: bytes, x read and y written once a launch whatever its
depth (see the note in the CUDA source).

Program parameters:  B, s, F
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

#: jacobi1d_h100_launch(x, y, n, B, s, F, depth, cached, stream)
_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)

#: F's domain: the most sweeps one launch runs.
FUSE_DOMAIN = (1, 2, 4, 8, 16, 32)


def _fused(F):
    """1 where F > 1 (a second buffer and the mbarrier), 0 at F = 1.  Over
    polynomials, for the smem counter, the polynomial 1 − ℓ₁(F) that takes
    these values on :data:`FUSE_DOMAIN` (ℓ₁ the Lagrange basis polynomial of
    F = 1 over the domain)."""
    if not isinstance(F, Poly):
        return (F > 1) * 1
    ell = Poly.const(1)
    for f in FUSE_DOMAIN[1:]:
        ell = ell * (F - f) / (1 - f)
    return 1 - ell


def smem_bytes(B, g, F):
    """Shared bytes of the cached kernel at grain g and F: at F = 1 the
    window of B·g interior points and their two neighbours in f32; at F > 1
    two buffers of B·g + 2F values and 16-byte slack each, and the bulk
    copy's 8-byte mbarrier.  Over ints, or over polynomials for the smem
    counter."""
    window = 4 * (B * g + 2 * F)
    return window + _fused(F) * (window + 40)


def launch_plan(steps: int, F: int) -> list:
    """The depths of a call's launches: ceil(steps / F) launches, each of F
    sweeps but the last, which runs what is left (none for 0 steps)."""
    if steps <= 0:
        return []
    launches = -(-steps // F)
    return [F] * (launches - 1) + [steps - F * (launches - 1)]


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def jacobi1d_plain(x: torch.Tensor, steps: int, *, B: int, s: int,
                   F: int = 1, cached: bool = True) -> torch.Tensor:
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


def launch(src: torch.Tensor, dst: torch.Tensor, *, B: int, s: int, F: int,
           depth: int, cached: bool = True,
           stream: Optional[int] = None) -> None:
    """One launch: ``depth`` <= F sweeps of src into dst, its two ends
    copied (both n f32 on one CUDA device, n >= 3), on ``stream`` (the raw
    handle; the current stream when None)."""
    n = src.numel()
    if stream is None:
        stream = torch._C._cuda_getCurrentRawStream(src.device.index)
    err = _entry()(src.data_ptr(), dst.data_ptr(), n, B, s, F, depth,
                   int(cached), stream)
    if err:
        build.check(err, f"jacobi1d_h100(B={B}, s={s}, F={F}, depth={depth},"
                         f" cached={cached})")
    jacobi1d_h100.launches += 1
    jacobi1d_h100.shapes[(n, B, s, F, depth, bool(cached), src.dtype)] += 1


def _launch(x: torch.Tensor, steps: int, *, B: int, s: int, F: int = 1,
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
    if F < 1 or (F > 1 and not cached):
        raise ValueError(f"jacobi1d_h100: F {F} (the uncached kernel runs "
                         f"one sweep a launch)")
    depths = launch_plan(steps, F)
    if not depths or x.numel() < 3:           # no interior: x comes back
        return x.clone()
    # the first launch reads x; then two buffers ping-pong on the stream,
    # with no host sync
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    bufs = [torch.empty_like(x) for _ in range(min(len(depths), 2))]
    src = x
    for k, depth in enumerate(depths):
        launch(src, bufs[k % 2], B=B, s=s, F=F, depth=depth, cached=cached,
               stream=stream)
        src = bufs[k % 2]
    return src


def jacobi1d_h100(x: torch.Tensor, steps: int, *, B: int, s: int,
                  F: int = 1, cached: bool = True) -> torch.Tensor:
    """``steps`` Jacobi sweeps of the f32 vector ``x``, ends fixed, as a new
    tensor.  CUDA tensors launch the kernel ceil(steps / F) times (or
    raise); CPU tensors run :func:`jacobi1d_plain`.
    ``jacobi1d_h100.launches`` counts kernel launches,
    ``jacobi1d_h100.shapes`` the same launches by (n, B, s, F, depth,
    cached, dtype)."""
    fn = jacobi1d_plain if x.device.type == "cpu" else _launch
    return fn(x, steps, B=B, s=s, F=F, cached=cached)


jacobi1d_h100.launches = 0
jacobi1d_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: The napkin's cost of one sweep in shared memory, as a share of one pass
#: of the vector through device memory (a launch's read of x and write of
#: y): on an H100 at n = 2^21 + 2, a launch of 4 sweeps takes about twice
#: a launch of one.
SWEEP_SHARE = 1 / 3
#: Threads an SM holds (an H100's), for the napkin's occupancy.
SM_THREADS = 2048


def _score(v: Mapping[str, object], g, F, cached: bool):
    """Napkin model at grain ``g`` and ``F``, over scalars or NumPy
    columns, higher is better: the grid should give every SM a block; a
    block of fewer than 256 threads leaves an SM's issue slots idle;
    threads past n - 2 do no work.  A call's sweeps pay a pass through
    device memory every F sweeps and a sweep in shared memory each
    (``SWEEP_SHARE`` of a pass), F / (F + 1 / SWEEP_SHARE) of the rate of
    sweeps that pay no pass.  A staged window re-reads and recomputes its
    halo, 2F values a block of W = B·g (W / (W + 2F)), and a window too
    large for an SM to hold its 2048 threads' worth of blocks (V / smem of
    them) leaves the rest idle; direct loads read 3 values a point (from
    L1/L2, counted at half)."""
    B, g, F = np.asarray(v["B"]), np.asarray(g), np.asarray(F)
    inner = max(1, v.get("N", (1 << 15) + 2) - 2)
    cores = max(1, v.get("CORES", 1))
    W = B * g
    blocks = np.ceil(inner / W)
    fill = np.minimum(1.0, blocks / cores)
    width = np.minimum(1.0, B / 256.0)
    used = inner / (blocks * W)
    fuse = F / (F + 1.0 / SWEEP_SHARE)
    if not cached:
        return fill * width * used * fuse * 0.5
    resident = np.minimum(np.floor(v.get("V", 232_448) / smem_bytes(B, g, F)),
                          SM_THREADS // B)
    occupancy = np.minimum(1.0, resident * B / SM_THREADS)
    return fill * width * used * fuse * W / (W + 2 * F) * occupancy


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
                "F": ParamDomain("F", FUSE_DOMAIN),
            },
        )

    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("reduce_granularity", "uncache"),
                     "the staged window of B·s + 2F f32, and at F > 1 a "
                     "second buffer (paper: Z_B)"),
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
            out = plan.with_flag("smem_cache", False, "drop shared staging")
            out.program_params["F"] = ParamDomain("F", (1,))
            return out

        return [Strategy("reduce_granularity", reduce_granularity),
                Strategy("uncache", uncache)]

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        one = Poly.const(1)
        if counter == "smem_bytes":
            if plan.flags.get("smem_cache", True):
                return smem_bytes(V("B"), grain(plan, V("s")), V("F")), one
            return Poly.const(0), one
        if counter == "threads":
            return V("B"), one
        if counter == "registers":
            return Poly.const(9), one
        raise KeyError(counter)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(self.score_batch(plan, v))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score(v, grain(plan, v["s"]), v["F"],
                      plan.flags.get("smem_cache", True))

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        # instantiate has put the grain the kernel runs in s (phantom_grain)
        fn = _launch if device == "cuda" else jacobi1d_plain
        return functools.partial(
            fn, B=int(assignment["B"]), s=int(assignment["s"]),
            F=int(assignment["F"]),
            cached=bool(plan.flags.get("smem_cache", True)))


FAMILY = Jacobi1dH100Family()
