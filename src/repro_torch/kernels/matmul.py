"""K1 ``matmul_h100`` — the paper's flagship kernel (Fig. 3/4, Table 1) on Hopper.

Replaces the TPU kernel ``pallas_matmul`` (``src/repro/kernels/matmul.py``,
``_mm_kernel_cached`` / ``_mm_kernel_uncached``) with the hand-written CUDA
kernel in ``csrc/matmul.cu``: C[M,N] = A[M,K] @ B[K,N], A and B both f32 or
bf16, B in the model's [K, N] row-major layout, f32 accumulation, f32
output.

Bound on the card: every serve-path call has M <= 256, so the product is
bound by the bytes of B.  The kernel keeps those bytes in flight with a ring
of ``stages`` shared-memory tiles filled by ``cp.async`` and splits K over
``kb`` blocks an output tile (combined in split order, deterministically);
bf16 runs on the tensor cores (``mma.sync`` m16n8k16), f32 in FMA.  See the
note in the CUDA source.

The paper's block format is the launch shape: a block computes a bm × bn
tile of C with (bm/16)·(bn/(8·s)) warps, each owning a 16 × 8·s tile (grain
s: its n8 tensor-core tiles, 4·s f32 a thread).  ``uncache`` keeps the
domain of ``stages`` (the ring depth that did not fit) and the kernel runs
one stage: load, barrier, compute, with nothing in flight.

Program parameters:  bm, bn, bk, s, kb, stages (all symbolic during tree
                     construction)
Data parameters:     M, N, K
Machine parameters:  V (shared bytes a block), G (registers a thread),
                     T (threads a block), CORES (SMs)

The batched entry (:func:`matmul_h100_batched`, the built callable's
``.batched``) runs E independent products A [E, M, K] @ B [E, K, N] in one
launch, E x kb blocks on the grid's z: a mixture-of-experts layer's expert
projections, each expert at its capacity of M token rows.  It takes the
pick of the per-expert key {M, N, K}, as the JAX trace keys the experts'
matmuls.

The split-K workspace (f32 partials and per-tile tickets) is one per device
(:mod:`.workspace`): it grows on demand until a captured CUDA graph holds
it, and :func:`workspace_need` says what a launch needs.
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
from .workspace import Workspace

#: Shared-memory bytes a staged element takes in the counters: the widest
#: input type (f32), so a leaf chosen for a triple launches for either type.
DIN = 4
_ELEM = {torch.float32: 0, torch.bfloat16: 1}
#: matmul_h100_launch(a, b, c, ws, tickets, M, N, K, bm, bn, bk, s, kb,
#: stages, cached, elem, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 11
             + (ctypes.c_void_p,))
#: matmul_h100_batched_launch(a, b, c, ws, tickets, E, M, N, K, bm, bn, bk,
#: s, kb, stages, cached, elem, stream)
_ARGTYPES_BATCHED = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 12
                     + (ctypes.c_void_p,))
#: The C entry point's limits (``csrc/matmul.cu``).
MAX_THREADS = 1024
MAX_SMEM = 232_448
MAX_GRID_YZ = 65_535


# =============================================================================
# Kernel wrapper, plain version, launch counter
# =============================================================================

def split_tiles(K: int, bk: int, kb: int) -> list:
    """The k tiles of each of the ``kb`` splits, as ``range``s: ceil(K/bk)
    tiles of ``bk``, split into contiguous runs of ceil(tiles/kb) (the last
    splits may be empty), as the kernel walks them."""
    nkt = -(-K // bk)
    per = -(-nkt // kb)
    return [range(z * per, min(nkt, (z + 1) * per)) for z in range(kb)]


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                 bk: int, s: int, kb: int = 1, stages: int = 2,
                 cached: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel in its order of sums: each split
    sums its k tiles of ``bk`` in f32 in order, then the splits are added in
    order 0..kb-1.  The block format does not change the result (paper
    Def. 2 ii), so ``bm``/``bn``/``s``/``stages``/``cached`` are taken and
    ignored.  On the ``meta`` device (the dry run) the result's shape and
    type only."""
    M, K = a.shape
    N = b.shape[1]
    if a.is_meta:
        return torch.empty((M, N), dtype=torch.float32, device="meta")
    out = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for tiles in split_tiles(K, bk, kb):
        part = torch.zeros_like(out)
        for t in tiles:
            part += a[:, t * bk:(t + 1) * bk].float() @ \
                b[t * bk:(t + 1) * bk].float()
        out += part
    return out


def matmul_batched_plain(a: torch.Tensor, b: torch.Tensor, **kw
                         ) -> torch.Tensor:
    """Plain version of the batched entry: :func:`matmul_plain` for each
    expert, A [E, M, K] and B [E, K, N] -> C [E, M, N] f32."""
    if a.is_meta:
        return torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                           dtype=torch.float32, device="meta")
    return torch.stack([matmul_plain(a[e], b[e], **kw)
                        for e in range(a.shape[0])])


def format_error(M: int, N: int, K: int, bm: int, bn: int, bk: int, s: int,
                 kb: int, stages: int, cached: bool,
                 dtype: torch.dtype, experts: int = 1) -> Optional[str]:
    """Why ``matmul_h100_launch`` (``matmul_h100_batched_launch`` over
    ``experts`` products) refuses this launch, or None: the C entry point's
    checks (``csrc/matmul.cu``) in Python."""
    def pow2(x):
        return x >= 32 and x & (x - 1) == 0
    esz = 2 if dtype == torch.bfloat16 else 4
    run = stages if cached else 1
    checks = [
        (min(M, N, K) > 0, "empty operand"),
        (bm >= 16 and bm % 16 == 0, "bm not a multiple of 16"),
        (pow2(bn) and pow2(bk), "bn or bk not a power of two >= 32"),
        (s in (1, 2), "s not in {1, 2}"),
        (stages in (1, 2, 4), "stages not in {1, 2, 4}"),
        (experts >= 1 and 1 <= kb and experts * kb <= MAX_GRID_YZ,
         "kb (times the experts) out of range"),
        (dtype in _ELEM, "not f32 or bf16"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    if 32 * (bm // 16) * (bn // (8 * s)) > MAX_THREADS:
        return "more than 1024 threads"
    if -(-N // bn) > MAX_GRID_YZ:
        return "more than 65,535 column blocks"
    if run * (bm * bk + bk * bn) * esz > MAX_SMEM:
        return "ring larger than 232,448 bytes"
    return None


PARTIALS = Workspace("matmul_h100 split-K partials", torch.float32, 1 << 20)
#: Tickets are zeroed when allocated; each launch leaves them at 0.
TICKETS = Workspace("matmul_h100 split-K tickets", torch.int32, 1 << 12,
                    zeroed=True)


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("matmul", "matmul_h100_launch", _ARGTYPES)


@functools.cache
def _batched_entry() -> Callable[..., int]:
    return build.entry("matmul", "matmul_h100_batched_launch",
                       _ARGTYPES_BATCHED)


def workspace_need(M: int, N: int, *, bm: int, bn: int, kb: int = 1,
                   experts: int = 1, **_) -> Tuple[int, int]:
    """(f32 partials, tickets) a launch at M x N with this format needs;
    the batched entry needs ``experts`` times as many."""
    if kb <= 1:
        return 0, 0
    return (experts * kb * M * N,
            experts * -(-M // max(bm, 1)) * -(-N // max(bn, 1)))


def _run(a: torch.Tensor, b: torch.Tensor, batched: bool, *, bm: int,
         bn: int, bk: int, s: int, kb: int, stages: int,
         cached: bool) -> torch.Tensor:
    """Both entries: A [M, K] @ B [K, N], or A [E, M, K] @ B [E, K, N] in
    one launch when ``batched``; counts the launch on its wrapper."""
    what = "matmul_h100" + (" batched" if batched else "")
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"{what} kernel needs both operands on one CUDA "
                         f"device: {a.device}, {b.device}")
    nd = 3 if batched else 2
    if a.dim() != nd or b.dim() != nd or a.shape[:-2] != b.shape[:-2] \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{what}: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _ELEM:
        raise TypeError(f"{what} takes f32 or bf16 pairs: {a.dtype}, "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} needs contiguous operands")
    E = a.shape[0] if batched else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    dev = a.device
    c = torch.empty((*a.shape[:-1], N), dtype=torch.float32, device=dev)
    ws = tickets = None
    if kb > 1:
        floats, tiles = workspace_need(M, N, bm=bm, bn=bn, kb=kb, experts=E)
        ws = PARTIALS.get(dev, floats).data_ptr()
        tickets = TICKETS.get(dev, tiles).data_ptr()
    ptrs = (a.data_ptr(), b.data_ptr(), c.data_ptr(), ws, tickets)
    rest = (M, N, K, bm, bn, bk, s, kb, stages, int(cached), _ELEM[a.dtype],
            torch._C._cuda_getCurrentRawStream(dev.index))
    err = (_batched_entry()(*ptrs, E, *rest) if batched
           else _entry()(*ptrs, *rest))
    if err:
        build.check(err, f"{what}(E={E}, bm={bm}, bn={bn}, bk={bk}, s={s}, "
                         f"kb={kb}, stages={stages}, cached={cached})")
    wrapper = matmul_h100_batched if batched else matmul_h100
    wrapper.launches += 1
    wrapper.shapes[(E,) * batched + (M, N, K, bm, bn, bk, s, kb, stages,
                                     bool(cached), a.dtype)] += 1
    return c


def _launch(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int, bk: int,
            s: int, kb: int = 1, stages: int = 2,
            cached: bool = True) -> torch.Tensor:
    return _run(a, b, False, bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages,
                cached=cached)


def _launch_batched(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                    bk: int, s: int, kb: int = 1, stages: int = 2,
                    cached: bool = True) -> torch.Tensor:
    return _run(a, b, True, bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages,
                cached=cached)


def matmul_h100(a: torch.Tensor, b: torch.Tensor, *, bm: int, bn: int,
                bk: int, s: int, kb: int = 1, stages: int = 2,
                cached: bool = True) -> torch.Tensor:
    """C = A @ B.  CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`matmul_plain`.  ``matmul_h100.launches`` counts kernel launches,
    ``matmul_h100.shapes`` the same launches by (M, N, K, bm, bn, bk, s, kb,
    stages, cached, dtype)."""
    kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages, cached=cached)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, **kw)
    return _launch(a, b, **kw)


matmul_h100.launches = 0
matmul_h100.shapes = collections.Counter()


def matmul_h100_batched(a: torch.Tensor, b: torch.Tensor, *, bm: int,
                        bn: int, bk: int, s: int, kb: int = 1,
                        stages: int = 2, cached: bool = True
                        ) -> torch.Tensor:
    """C[e] = A[e] @ B[e] for every expert e, one launch.  CUDA tensors
    launch the kernel (or raise); CPU tensors run
    :func:`matmul_batched_plain`.  ``matmul_h100_batched.launches`` counts
    its launches, ``.shapes`` them by (E, M, N, K, bm, bn, bk, s, kb,
    stages, cached, dtype)."""
    kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages, cached=cached)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_batched_plain(a, b, **kw)
    return _launch_batched(a, b, **kw)


matmul_h100_batched.launches = 0
matmul_h100_batched.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Domains, their product 3·4·2·2·5·2 = 480 points a leaf, within
#: ``select``'s cap of 512 candidates a leaf (``tests/test_torch_core.py``).
_DOMAINS = {"bm": (16, 32, 64), "bn": (32, 64, 128, 256), "bk": (32, 64),
            "s": (1, 2), "kb": (1, 2, 4, 8, 16), "stages": (2, 4)}
_S_DOMAIN_BY_LEVEL = {0: _DOMAINS["s"], 1: (1,)}

# Napkin constants of an H100 SXM: HBM and the tensor-core peak from
# NVIDIA's data sheet; the latency, the per-tile costs and the shared-memory
# rate are round values chosen so that the model ranks the leaves timed at
# the llama lm_head (4, 128256, 4096) and MLP down (1, 4096, 14336)
# projections as the card did (chip_smoke.py phase 3; PERF.md).
_HBM = 3.35e12                   # device memory, bytes/s
_LATENCY = 1e-6                  # s from a tile's copy to its use
_TILE_S = 0.4e-6                 # s a block spends on a k tile at least ...
_WARP_S = 0.02e-6                # ... and this more for each of its warps
_SMEM_BW = 100e9                 # shared-memory bytes/s an SM moves
_TC = 0.5 * 989e12               # bf16 flop/s of mma.sync (half of wgmma's)
_SMEM_SM = 228 * 1024            # shared bytes an SM holds
_THREADS_SM = 2048
_ESZ = 2                         # bytes an element on the serve path (bf16)


def _score(v: Mapping[str, object]):
    """Napkin model of the kernel on an H100, over scalars or NumPy columns:
    1 / (estimated µs), so higher is better.

    - bytes: B is read ceil(M/bm) times and A ceil(N/bn) times, C written
      once, and a split tile writes and reads kb f32 partials;
    - a block's rate: one k tile (its bytes of A and B, idle rows and
      columns not loaded) each max(step, latency / tiles ahead), where a
      step is a fixed cost, a cost a warp (the barrier) and the tile's
      shared-memory traffic (cp.async writes, every warp's A fragments, the
      B fragments) over the SM's share; tiles ahead = stages − 1 (one stage:
      latency and step add up);
    - the card's rate: the resident blocks' rates up to device memory, wave
      after wave (the last wave has fewer blocks), plus a latency a wave and
      one for a split tile's combine;
    - tensor cores: the padded bm × bn tiles at half the bf16 peak;
    - idle rows and columns count against a leaf: min(1, M/bm)·min(1, N/bn)
      of its warps do work, the others still load and wait.
    """
    bm, bn = np.asarray(v["bm"]), np.asarray(v["bn"])
    bk, s = np.asarray(v["bk"]), np.asarray(v["s"])
    kb, stages = np.asarray(v["kb"]), np.asarray(v["stages"])
    M, N, K = v.get("M", 4096), v.get("N", 4096), v.get("K", 4096)
    cores = max(1, v.get("CORES", 1))
    rows, cols = np.ceil(M / bm), np.ceil(N / bn)
    blocks = rows * cols * kb
    nbytes = (_ESZ * (K * N * rows + M * K * cols) + 4 * M * N
              + np.where(kb > 1, 8.0 * kb * M * N, 0.0))
    threads = bm * bn / (4 * s)
    warps = threads / 32
    per_sm = np.minimum(np.minimum(
        np.floor(_SMEM_SM / (stages * (bm * bk + bk * bn) * _ESZ)),
        np.floor(_THREADS_SM / threads)), 32)
    resident = np.minimum(blocks, cores * per_sm)
    ahead = np.minimum(stages - 1, np.ceil(np.ceil(K / bk) / kb))
    tile = bk * (np.minimum(bn, N) + np.minimum(bm, M)) * _ESZ
    traffic = (warps * bk / 16 * 512 + bk * bn * _ESZ
               + (bm * bk + bk * bn) * _ESZ)
    sharing = np.minimum(per_sm, np.ceil(blocks / cores))
    step = _TILE_S + _WARP_S * warps + traffic * sharing / _SMEM_BW
    per_tile = np.where(ahead <= 0, step + _LATENCY,
                        np.maximum(step, _LATENCY / np.maximum(ahead, 1)))
    rate = tile / per_tile                      # bytes/s a block
    per_block = nbytes / blocks
    full = np.floor(blocks / resident)
    rest = blocks - full * resident
    t_mem = (full * resident * per_block / np.minimum(_HBM, resident * rate)
             + rest * per_block / np.minimum(_HBM, np.maximum(rest, 1) * rate)
             + (full + (rest > 0)) * _LATENCY
             + np.where(kb > 1, _LATENCY, 0.0))
    t_tc = 2.0 * rows * bm * cols * bn * K / _TC
    t = np.maximum(t_mem, t_tc)
    fill = np.minimum(1.0, M / bm) * np.minimum(1.0, N / bn)
    return (0.75 + 0.25 * fill) * 1e-6 / t


class MatmulH100Family(CachedInstantiationMixin):
    name = "matmul_h100"

    def initial_plan(self) -> KernelPlan:
        params = {n: ParamDomain(n, d) for n, d in _DOMAINS.items()}
        return KernelPlan(
            family=self.name,
            flags={"smem_cache": True, "granularity_level": 0,
                   "pressure_level": 0, "cse_level": 0},
            program_params=params,
        )

    # -- counters (order: resources r_i first, then performance p_i) ---------
    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("uncache",),
                     "shared memory the ring takes, stages·(bm·bk + bk·bn)"
                     "·DIN (paper: Z_B)"),
            resource("threads", "T", (),
                     "threads a block, 32·(bm/16)·(bn/(8·s)) (paper: T)"),
            resource("registers", "G",
                     ("reduce_granularity", "pressure_1", "pressure_2",
                      "pressure_3", "cse_1", "cse_2"),
                     "registers a thread (paper: R)"),
            performance("occupancy", "P_occ", (),
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
            return plan.with_flag("smem_cache", False, "one stage, no ring")

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
            tile = DIN * (bm * bk + bk * bn)
            if plan.flags.get("smem_cache", True):
                return V("stages") * tile, one
            return tile, one
        if counter == "threads":
            return bm * bn, 4 * s              # 32·(bm/16)·(bn/(8·s))
        if counter == "registers":
            # 4·s f32 accumulators; the A fragment (4) and s B fragments
            # (2 each), split per pressure level; the addressing CSE trims.
            # As in the JAX family the levels change the estimate, not the
            # kernel.
            p = plan.flags.get("pressure_level", 0)
            c = plan.flags.get("cse_level", 0)
            return (4 * s + (2 * s + 4) / (2 ** p)
                    + Poly.const(24 - 4 * c)), one
        if counter == "occupancy":
            # CORES / (CORES + blocks), blocks = M·N·kb / (bm·bn): near 1
            # when the grid starves the SMs, near 0 when it fills them
            tile = bm * bn
            return V("CORES") * tile, V("CORES") * tile + V("M") * V("N") * \
                V("kb")
        raise KeyError(counter)

    @staticmethod
    def _run_stages(plan: KernelPlan, v: Mapping[str, object]):
        return v["stages"] if plan.flags.get("smem_cache", True) else 1

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score({**v, "stages": self._run_stages(plan, v)}))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score({**v, "stages": self._run_stages(plan, v)})

    # -- instantiation (memoized by CachedInstantiationMixin.instantiate) ----
    def instantiate(self, plan: KernelPlan, assignment: Mapping[str, int],
                    device: str = "cuda", *,
                    leaf_index: Optional[int] = None) -> Callable:
        """An uncached leaf's ``stages`` names the ring that did not fit; it
        runs one stage, so its candidates build one callable."""
        if not plan.flags.get("smem_cache", True):
            assignment = {**assignment, "stages": 1}
        return super().instantiate(plan, assignment, device,
                                   leaf_index=leaf_index)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        """The 2-D entry bound to the leaf's parameters; its ``batched``
        attribute is the batched entry bound to the same."""
        kw = {n: int(assignment[n]) for n in _DOMAINS}
        kw["cached"] = bool(plan.flags.get("smem_cache", True))
        cuda = device == "cuda"
        fn = functools.partial(_launch if cuda else matmul_plain, **kw)
        fn.batched = functools.partial(
            _launch_batched if cuda else matmul_batched_plain, **kw)
        return fn


FAMILY = MatmulH100Family()
