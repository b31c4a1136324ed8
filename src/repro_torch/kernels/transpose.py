"""K4 ``transpose_h100`` — matrix transposition (paper Fig. 8, Table 3) on Hopper.

Replaces the TPU kernel ``pallas_transpose`` (``src/repro/kernels/
transpose.py``, ``_tr_kernel_cached`` / ``_tr_kernel_uncached``) with the
hand-written CUDA kernel in ``csrc/transpose.cu``: B = Aᵀ for elements of 2
or 4 bytes (f32, bf16), moved as raw bits, so bit-exact, with no padding
copies.  A block of bm × bn threads owns a bm × (s·bn) tile; each thread
loads its s neighbouring elements of a tile row in accesses of up to 16
bytes, the tile is staged at the element's width (XOR-swizzled 16-byte
chunks, bm·s·bn·size bytes), and the transposed tile is written in accesses
of up to 16 bytes along B's rows.  The C entry point chooses the access
widths per launch: what the base address and the row's bytes allow.

The comprehensive tree reproduces the paper's three cases on Z_B = V, with
the smem counter Z(g) = 4·bm·(g·bn + 1) bytes (:func:`smem_bytes`), the
paper's staged tile of 32-bit words padded by one column.  The kernel
allocates bm·g·bn·size bytes, never more than Z(g), so the counter stays
the bound the tree reasons about:

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

The batched entry (:func:`transpose_h100_batched`, the built callable's
``.batched``) writes B[e] = A[e]ᵀ for A [E, M, N] in one launch, the expert
on the grid's z, as K1's batched entry has it: the backward of the experts'
products (``kernels/autograd.py`` ``BatchedMatmulFn``) transposes every
expert's weights and activations so.  It takes the pick of the per-expert
key {M, N}.

Program parameters:  bm, bn, s
Data parameters:     M, N
Machine parameters:  V (shared bytes a block), T (threads a block),
                     G (registers a thread), CORES
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Callable, Mapping, Optional, Sequence, Tuple

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
#: transpose_h100_batched_launch(a, b, E, M, N, bm, bn, s, cached, esize,
#: stream)
_ARGTYPES_BATCHED = ((ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 8
                     + (ctypes.c_void_p,))
#: The C entry point's limit on E (the grid's z).
MAX_EXPERTS = 65_535


def smem_bytes(bm, bn, g):
    """The smem counter Z(g): the paper's staged tile, bm rows of g·bn
    32-bit words plus one padding column.  The cached kernel allocates
    bm·g·bn·size bytes, at most this.  Over ints, or over polynomials for
    the smem counter."""
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


def transpose_batched_plain(a: torch.Tensor, *, bm: int, bn: int, s: int,
                            cached: bool = True) -> torch.Tensor:
    """Plain version of the batched entry: :func:`transpose_plain` for each
    expert, A [E, M, N] -> B [E, N, M]."""
    if a.is_meta:
        return a.transpose(1, 2).contiguous()
    return torch.stack([transpose_plain(a[e], bm=bm, bn=bn, s=s,
                                        cached=cached)
                        for e in range(a.shape[0])])


def format_error(M: int, N: int, bm: int, bn: int, s: int, esize: int,
                 experts: int = 1) -> Optional[str]:
    """Why ``transpose_h100_launch`` (``transpose_h100_batched_launch`` over
    ``experts`` matrices) refuses this launch, or None: the C entry point's
    checks (``csrc/transpose.cu``) in Python."""
    def pow2(x):
        return x > 0 and x & (x - 1) == 0
    checks = [
        (1 <= experts <= MAX_EXPERTS, "experts not in 1..65,535"),
        (M > 0 and N > 0, "empty operand"),
        (pow2(bm) and pow2(bn) and pow2(s), "bm, bn or s not a power of two"),
        (bn >= 32, "bn below 32"),
        (bm <= 1024 and bn <= 1024 and bm * bn <= 1024,
         "more than 1024 threads"),
        (s <= 8, "s above 8"),
        (esize in (2, 4), "not 2- or 4-byte elements"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    return None


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("transpose", "transpose_h100_launch", _ARGTYPES)


@functools.cache
def _batched_entry() -> Callable[..., int]:
    return build.entry("transpose", "transpose_h100_batched_launch",
                       _ARGTYPES_BATCHED)


def _run(a: torch.Tensor, batched: bool, *, bm: int, bn: int, s: int,
         cached: bool) -> torch.Tensor:
    """Both entries: B = Aᵀ for A [M, N], or B[e] = A[e]ᵀ for A [E, M, N]
    in one launch when ``batched``; counts the launch on its wrapper."""
    what = "transpose_h100" + (" batched" if batched else "")
    if not a.is_cuda:
        raise ValueError(f"{what} kernel needs a CUDA tensor: {a.device}")
    nd = 3 if batched else 2
    if a.dim() != nd:
        raise ValueError(f"{what}: want [{'E, ' * batched}M, N], got "
                         f"{tuple(a.shape)}")
    if a.element_size() not in (2, 4):
        raise TypeError(f"{what} moves 2- or 4-byte elements: {a.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{what} needs a contiguous operand")
    E = a.shape[0] if batched else 1
    M, N = a.shape[-2:]
    b = torch.empty((*a.shape[:-2], N, M), dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return b
    rest = (M, N, bm, bn, s, int(cached), a.element_size(),
            torch._C._cuda_getCurrentRawStream(a.device.index))
    err = (_batched_entry()(a.data_ptr(), b.data_ptr(), E, *rest) if batched
           else _entry()(a.data_ptr(), b.data_ptr(), *rest))
    if err:
        build.check(err, f"{what}(E={E}, bm={bm}, bn={bn}, s={s}, "
                         f"cached={cached})")
    wrapper = transpose_h100_batched if batched else transpose_h100
    wrapper.launches += 1
    wrapper.shapes[(E,) * batched + (M, N, bm, bn, s, bool(cached),
                                     a.dtype)] += 1
    return b


def _launch(a: torch.Tensor, *, bm: int, bn: int, s: int,
            cached: bool = True) -> torch.Tensor:
    return _run(a, False, bm=bm, bn=bn, s=s, cached=cached)


def _launch_batched(a: torch.Tensor, *, bm: int, bn: int, s: int,
                    cached: bool = True) -> torch.Tensor:
    return _run(a, True, bm=bm, bn=bn, s=s, cached=cached)


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


def transpose_h100_batched(a: torch.Tensor, *, bm: int, bn: int, s: int,
                           cached: bool = True) -> torch.Tensor:
    """B[e] = A[e]ᵀ for every expert e, one launch, as a new [E, N, M]
    tensor.  CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`transpose_batched_plain`.  ``transpose_h100_batched.launches``
    counts its launches, ``.shapes`` them by (E, M, N, bm, bn, s, cached,
    dtype)."""
    fn = transpose_batched_plain if a.device.type == "cpu" \
        else _launch_batched
    return fn(a, bm=bm, bn=bn, s=s, cached=cached)


transpose_h100_batched.launches = 0
transpose_h100_batched.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Threads an H100 SM holds: 2048 / (bm·bn) blocks share one.
_SM_THREADS = 2048


def _sector_fill(M, seg_bytes):
    """The useful share of the 32-byte sectors that a segment of
    ``seg_bytes`` bytes of a B row touches, averaged over where B's rows
    (2·M bytes apart at bf16) start within a sector."""
    offsets = np.arange(0, 32, math.gcd(2 * int(M), 32))
    seg = np.asarray(seg_bytes, dtype=np.float64)
    sectors = np.ceil((offsets + seg[..., None]) / 32.0).mean(axis=-1)
    return seg / (32.0 * sectors)


def _score(v: Mapping[str, object], g, cached: bool):
    """Napkin model at grain ``g``, over scalars or NumPy columns, higher is
    better.  The dispatch key has no element type, so it scores bf16, the
    type of every training product; its constants are fitted by hand to
    the card's device times of the cached leaves at the training
    signatures and at Table 3's 16384² (``chip_smoke.py`` phase 13 (e) and
    phase 6 time leaves beside the napkin's rank; ``chip_k4.py`` also at
    keys held out of the fit: the other dense configs' and f32).  The
    product of:
    - loads: a thread's run of 2·g bytes, in flight before the barrier,
      x / (x + 2) against 16 bytes' 16 / 18 (Little's law saturating);
    - stores: the useful share of the 32-byte sectors a B row segment of
      2·bm bytes (one element uncached) touches: bm 8 writes half sectors
      and an M whose rows start mid-sector costs bm 16 a third of its
      bytes; 64-byte segments (bm 32) gain 5 % over 32-byte ones;
    - wide tiles: 1 / (1 + 0.05·log2(bn / 32)), 1 KB row pieces (bn 64)
      lose to 512-byte ones;
    - the grid's fill, (blocks / CORES)^0.2 up to 1;
    - residency: 2048 / (bm·bn) blocks share an SM, so that one's loads
      overlap another's stores once the grid runs in w waves:
      1 + 0.1·(1 − 2 / R)·w / (w + 5)."""
    bm, bn, g = np.asarray(v["bm"]), np.asarray(v["bn"]), np.asarray(g)
    M, N = v.get("M", 4096), v.get("N", 4096)
    cores = max(1, v.get("CORES", 1))
    x = np.minimum(16.0, 2.0 * g)
    load = (x / (x + 2.0)) / (16.0 / 18.0)
    seg = 2.0 * bm if cached else np.full(np.shape(bm), 2.0)
    store = _sector_fill(M, seg) * (0.95 + 0.05 * np.minimum(1.0, seg / 64.0))
    wide = 1.0 / (1.0 + 0.05 * np.log2(bn / 32.0))
    blocks = np.ceil(M / bm) * np.ceil(N / (bn * g))
    fill = np.minimum(1.0, blocks / cores) ** 0.2
    resident = np.minimum(_SM_THREADS // (bm * bn), 32)
    waves = blocks / (cores * resident)
    overlap = 1.0 + 0.1 * (1.0 - 2.0 / resident) * waves / (waves + 5.0)
    return load * store * wide * fill * overlap


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
        """The 2-D entry bound to the leaf's parameters; its ``batched``
        attribute is the batched entry bound to the same."""
        # instantiate has put the grain the kernel runs in s (phantom_grain)
        kw = dict(bm=int(assignment["bm"]), bn=int(assignment["bn"]),
                  s=int(assignment["s"]),
                  cached=bool(plan.flags.get("smem_cache", True)))
        cuda = device == "cuda"
        fn = functools.partial(_launch if cuda else transpose_plain, **kw)
        fn.batched = functools.partial(
            _launch_batched if cuda else transpose_batched_plain, **kw)
        return fn


FAMILY = TransposeH100Family()
