"""K1b ``matmul_experts_h100`` — the experts' batched product on TMA and ``wgmma``.

Replaces the TPU kernel ``pallas_matmul`` (``src/repro/kernels/matmul.py``)
as the JAX MoE layer runs it over the experts, one matmul an expert at the
per-expert key (``src/repro/plans/trace.py``), with the hand-written CUDA
kernel in ``csrc/matmul_experts.cu``: C[e] = op(A[e]) @ op(B[e]) for every
expert e in one launch, bf16 in, f32 accumulation, bf16 out (rounded once,
as ``.to(torch.bfloat16)`` rounds).  op reads a transposed operand in
place: ``ta`` says A is stored [E, K, M], ``tb`` that B is stored [E, N,
K]; otherwise A is [E, M, K] and B [E, K, N].  So the backward of the
experts' products, dA = dC·Bᵀ (``tb``) and dB = Aᵀ·dC (``ta``), reads the
stored weight and activations with no transposed copy.

Bound on the card: the weights' bytes at the serve keys (M = 4-32 rows an
expert), the bytes or the tensor cores at the training keys; see the note
in the CUDA source.  Persistent blocks, as many as the SMs hold, walk the
E·⌈M/bm⌉·⌈N/bn⌉ tiles; in each, one producer warp keeps a ring of
``stages`` TMA loads of 64-deep k tiles in flight across the block's
tiles, bm / 64 consumer warpgroups each own 64 rows × bn columns of C on
``wgmma`` (bn / 2 f32 accumulators a thread), and the epilogue stages the
tile in shared memory and writes it with TMA stores while the next tile
loads.  Each output element is summed in one fixed order (the k tiles in
order, no split), so two launches are equal bit for bit.

The family is keyed on the product's (E, M, N, K), and there is no
split-K.  f32 operands never reach it: ``ops.matmul_batched`` runs them on
K1's batched entry.

Program parameters:  bm, bn, bk (64), stages (all symbolic during tree
                     construction)
Data parameters:     E, M, N, K
Machine parameters:  V (shared bytes a block), G (registers a thread),
                     T (threads a block), CORES (SMs)
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

#: Bytes an element: the family takes bf16 only.
ESZ = 2
#: k a tile: one 128-byte swizzled row of bf16.
BK = 64
#: matmul_experts_h100_launch(a, b, c, E, M, N, K, ta, tb, bm, bn, stages,
#: stream)
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9
             + (ctypes.c_void_p,))
#: The C entry point's limits (``csrc/matmul_experts.cu``).
MAX_SMEM = 232_448
MAX_TILES = 2**31 - 1
#: The ring a leaf whose ring did not fit (``uncache``) runs.
UNCACHED_STAGES = 2


# =============================================================================
# Shapes, plain version, kernel wrapper, launch counter
# =============================================================================

def product_dims(a: torch.Tensor, b: torch.Tensor, ta: bool = False,
                 tb: bool = False) -> Tuple[int, int, int, int]:
    """(E, M, N, K) of op(A) @ op(B) over the stored A and B; raises on
    shapes that do not make a product."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"matmul_experts_h100: bad shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    E = a.shape[0]
    K, M = a.shape[1:] if ta else a.shape[:0:-1]
    N, Kb = b.shape[1:] if tb else b.shape[:0:-1]
    if K != Kb:
        raise ValueError(f"matmul_experts_h100: bad shapes {tuple(a.shape)}"
                         f"{'ᵀ' if ta else ''} @ {tuple(b.shape)}"
                         f"{'ᵀ' if tb else ''}")
    return E, M, N, K


def matmul_experts_plain(a: torch.Tensor, b: torch.Tensor, *,
                         ta: bool = False, tb: bool = False,
                         **_) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each expert's product in f32,
    rounded once to the operands' type.  A transposed operand is copied
    contiguous first, so ``ta`` / ``tb`` equal the explicit copies bit for
    bit.  The block format does
    not change the result (paper Def. 2 ii), so bm/bn/stages are taken and
    ignored.  On the ``meta`` device (the dry run) the result's shape and
    type only."""
    E, M, N, K = product_dims(a, b, ta, tb)
    if a.is_meta:
        return torch.empty((E, M, N), dtype=a.dtype, device="meta")
    A = a.transpose(1, 2).contiguous() if ta else a
    B = b.transpose(1, 2).contiguous() if tb else b
    return torch.bmm(A.float(), B.float()).to(a.dtype)


def format_error(E: int, M: int, N: int, K: int, *, ta: bool, tb: bool,
                 bm: int, bn: int, stages: int,
                 dtype: torch.dtype = torch.bfloat16,
                 ptrs: Sequence[int] = ()) -> Optional[str]:
    """Why ``matmul_experts_h100_launch`` refuses this launch, or None: the
    C entry point's checks (``csrc/matmul_experts.cu``) in Python, the
    operands' addresses ``ptrs`` among them."""
    checks = [
        (dtype == torch.bfloat16, "not bf16"),
        (min(E, M, N, K) > 0, "empty operand"),
        (bm in (64, 128), "bm not 64 or 128"),
        (bn in (64, 128, 256), "bn not 64, 128 or 256"),
        (2 <= stages <= 4, "stages not in 2..4"),
        (not (ta and tb), "both operands transposed"),
        (all(p % 16 == 0 for p in ptrs), "a base not 16-byte aligned"),
        ((M if ta else K) % 8 == 0, "A's rows not a multiple of 16 bytes"),
        ((K if tb else N) % 8 == 0, "B's rows not a multiple of 16 bytes"),
        (N % 8 == 0, "C's rows not a multiple of 16 bytes"),
        (E * -(-M // bm) * -(-N // bn) <= MAX_TILES,
         "more than 2^31 - 1 tiles"),
        (smem_bytes(bm, bn, stages) <= MAX_SMEM,
         "ring and staging tile larger than 232,448 bytes"),
    ]
    for ok, why in checks:
        if not ok:
            return why
    return None


def smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Shared bytes a block allocates: the ring, the staging tile, the
    barriers and 1 KB to align the ring to its swizzle (the counter Z_B
    leaves out the last two)."""
    return 1024 + stages * (bm + bn) * BK * ESZ + bm * bn * ESZ + 16 * stages


@functools.cache
def _entry() -> Callable[..., int]:
    """The C entry point, resolved once a process."""
    return build.entry("matmul_experts", "matmul_experts_h100_launch",
                       _ARGTYPES)


def _launch(a: torch.Tensor, b: torch.Tensor, ta: bool = False,
            tb: bool = False, *, bm: int, bn: int, stages: int
            ) -> torch.Tensor:
    """One launch of the kernel; counts it on its wrapper."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul_experts_h100 needs both operands on one "
                         f"CUDA device: {a.device}, {b.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul_experts_h100 takes bf16 pairs: {a.dtype}, "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_experts_h100 needs contiguous operands")
    E, M, N, K = product_dims(a, b, ta, tb)
    dev = a.device
    c = torch.empty((E, M, N), dtype=a.dtype, device=dev)
    why = format_error(E, M, N, K, ta=ta, tb=tb, bm=bm, bn=bn, stages=stages,
                       ptrs=(a.data_ptr(), b.data_ptr(), c.data_ptr()))
    if why is not None:
        raise ValueError(f"matmul_experts_h100(E={E}, M={M}, N={N}, K={K}, "
                         f"ta={ta}, tb={tb}, bm={bm}, bn={bn}, "
                         f"stages={stages}): {why}")
    err = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), E, M, N, K,
                   int(ta), int(tb), bm, bn, stages,
                   torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        build.check(err, f"matmul_experts_h100(E={E}, M={M}, N={N}, K={K}, "
                         f"ta={ta}, tb={tb}, bm={bm}, bn={bn}, "
                         f"stages={stages})")
    matmul_experts_h100.launches += 1
    matmul_experts_h100.shapes[(E, M, N, K, bool(ta), bool(tb), bm, bn,
                                stages, a.dtype)] += 1
    return c


def matmul_experts_h100(a: torch.Tensor, b: torch.Tensor, ta: bool = False,
                        tb: bool = False, *, bm: int, bn: int,
                        stages: int) -> torch.Tensor:
    """C[e] = op(A[e]) @ op(B[e]) for every expert e, one launch, in the
    operands' type (bf16).  CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`matmul_experts_plain`.
    ``matmul_experts_h100.launches`` counts kernel launches, ``.shapes``
    the same launches by (E, M, N, K, ta, tb, bm, bn, stages, dtype)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
            raise TypeError(f"matmul_experts_h100 takes bf16 pairs: "
                            f"{a.dtype}, {b.dtype}")
        return matmul_experts_plain(a, b, ta=ta, tb=tb)
    return _launch(a, b, ta, tb, bm=bm, bn=bn, stages=stages)


matmul_experts_h100.launches = 0
matmul_experts_h100.shapes = collections.Counter()


# =============================================================================
# FamilySpec — the paper's GPU counters for the comprehensive tree
# =============================================================================

#: Domains, their product 2·3·1·3 = 18 points a leaf, within ``select``'s
#: cap of 512 candidates a leaf.
_DOMAINS = {"bm": (64, 128), "bn": (64, 128, 256), "bk": (BK,),
            "stages": (2, 3, 4)}
_BN_DOMAIN_BY_LEVEL = {0: _DOMAINS["bn"], 1: (64, 128)}

# Napkin constants of an H100 SXM: HBM, the L2 and the dense bf16
# tensor-core peak from NVIDIA's data sheet (wgmma runs at the full rate);
# the rate the SMs fill their rings at, a load's latency and the fixed
# costs of a tile and a launch are round values chosen so that the model
# ranks the leaves timed at llama4-scout's expert keys (forward, dA, dB and
# a decode step's) as the card did (chip_smoke.py phase 13 (i)'s leaf
# sweep; PERF.md).
_HBM = 3.35e12                   # device memory, bytes/s
_L2_BYTES = 50e6                 # an operand this small is re-read from L2
_TC = 989e12                     # bf16 flop/s of wgmma
_FILL = 3e12                     # bytes/s of TMA boxes into the SMs' rings
_LATENCY = 8e-6                  # s from a TMA load's issue to its use
_TILE_S = 4e-6                   # s a block spends on a tile outside its loads
_START_S = 2e-6                  # s a launch takes to start its blocks
_SMEM_SM = 228 * 1024            # shared bytes an SM holds
_REGS_SM = 65536


def _score(v: Mapping[str, object]):
    """Napkin model of the kernel on an H100, over scalars or NumPy
    columns: 1 / (estimated µs), so higher is better.

    - blocks: as many a SM as its shared memory and registers hold, over
      132 SMs, each walking ⌈tiles / blocks⌉ of the E·⌈M/bm⌉·⌈N/bn⌉ tiles
      (the last round's idle blocks count);
    - bytes: every expert's B read ⌈M/bm⌉ times (the re-reads from L2 when
      all the experts' B fit in it), A once, C written once in bf16, at
      the lesser of HBM and what the resident rings keep in flight
      (stages − 1 slots a block ahead, across its tiles, over one
      latency);
    - the rings' fill: every tile's boxes, padding rows and columns
      included, at the SMs' fill rate;
    - tensor cores: the padded bm × bn tiles at the full bf16 rate over
      the SMs the grid fills;
    - a fixed cost a tile (its barriers and epilogue past the loads) a
      round, and one a launch.
    """
    bm, bn = np.asarray(v["bm"]), np.asarray(v["bn"])
    stages = np.asarray(v["stages"])
    E, M = v.get("E", 1), v.get("M", 4096)
    N, K = v.get("N", 4096), v.get("K", 4096)
    cores = max(1, v.get("CORES", 132))
    rows, cols = np.ceil(M / bm), np.ceil(N / bn)
    nk = np.ceil(K / BK)
    tiles = E * rows * cols
    smem = stages * (bm + bn) * BK * ESZ + bm * bn * ESZ + 1024
    regs = (bm / 64 * 128 + 32) * (bn / 2 + 40)
    per_sm = np.maximum(1, np.minimum(np.floor(_SMEM_SM / smem),
                                      np.floor(_REGS_SM / regs)))
    resident = np.minimum(tiles, cores * per_sm)
    rounds = np.ceil(tiles / resident)
    again = 0.0 if E * K * N * ESZ <= _L2_BYTES else 1.0
    nbytes = ESZ * E * (K * N * (1 + (rows - 1) * again) + M * K + M * N)
    tile = (bm + bn) * BK * ESZ
    t_mem = nbytes / np.minimum(_HBM,
                                resident * (stages - 1) * tile / _LATENCY)
    t_fill = tiles * nk * tile / _FILL
    busy = np.minimum(tiles, cores)
    t_tc = 2.0 * tiles * bm * bn * K / (_TC * busy / cores)
    stream = np.maximum(np.maximum(t_mem, t_fill), t_tc)
    t = stream * rounds * resident / tiles + rounds * _TILE_S + _START_S
    return 1e-6 / t


class MatmulExpertsH100Family(CachedInstantiationMixin):
    name = "matmul_experts_h100"

    def initial_plan(self) -> KernelPlan:
        params = {n: ParamDomain(n, d) for n, d in _DOMAINS.items()}
        return KernelPlan(
            family=self.name,
            flags={"smem_cache": True, "granularity_level": 0},
            program_params=params,
        )

    # -- counters (order: resources r_i first, then performance p_i) ---------
    def counters(self) -> Sequence[Counter]:
        return [
            resource("smem_bytes", "V", ("uncache",),
                     "the ring and the epilogue's staging tile, "
                     "stages·(bm·bk + bk·bn)·2 + bm·bn·2 (paper: Z_B)"),
            resource("threads", "T", (),
                     "threads a block: the consumer warpgroups and the "
                     "producer warp, 128·(bm/64) + 32 (paper: T)"),
            resource("registers", "G", ("reduce_granularity",),
                     "registers a consumer thread: bn/2 f32 accumulators "
                     "and its addressing (paper: R)"),
            performance("occupancy", "P_occ", (),
                        "share of the SMs a grid of E·⌈M/bm⌉·⌈N/bn⌉ blocks "
                        "leaves idle"),
        ]

    # -- strategies (the JAX family's that apply, paper §5) ------------------
    def strategies(self) -> Sequence[Strategy]:
        def reduce_granularity(plan: KernelPlan):
            if plan.flags.get("granularity_level", 0) >= 1:
                return None
            p = plan.with_flag("granularity_level", 1, "narrower bn")
            p.program_params["bn"] = ParamDomain("bn", _BN_DOMAIN_BY_LEVEL[1])
            return p

        def uncache(plan: KernelPlan):
            if not plan.flags.get("smem_cache", True):
                return None
            return plan.with_flag("smem_cache", False,
                                  f"{UNCACHED_STAGES}-slot ring")

        return [
            Strategy("reduce_granularity", reduce_granularity),
            Strategy("uncache", uncache),
        ]

    # -- symbolic counter evaluation (paper §3.3: f_i, g_i) -------------------
    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        bm, bn, bk = V("bm"), V("bn"), V("bk")
        one = Poly.const(1)
        if counter == "smem_bytes":
            stages = (V("stages") if plan.flags.get("smem_cache", True)
                      else Poly.const(UNCACHED_STAGES))
            return stages * (bm * bk + bk * bn) * ESZ + bm * bn * ESZ, one
        if counter == "threads":
            return 2 * bm + Poly.const(32), one     # 128·(bm/64) + 32
        if counter == "registers":
            return bn / 2 + Poly.const(40), one
        if counter == "occupancy":
            # CORES / (CORES + blocks), blocks = E·M·N / (bm·bn)
            tile = bm * bn
            return V("CORES") * tile, V("CORES") * tile + \
                V("E") * V("M") * V("N")
        raise KeyError(counter)

    @staticmethod
    def _run_stages(plan: KernelPlan, v: Mapping[str, object]):
        return (v["stages"] if plan.flags.get("smem_cache", True)
                else UNCACHED_STAGES)

    def score(self, plan: KernelPlan, v: Mapping[str, int]) -> float:
        return float(_score({**v, "stages": self._run_stages(plan, v)}))

    def score_batch(self, plan: KernelPlan, v: Mapping[str, object]):
        return _score({**v, "stages": self._run_stages(plan, v)})

    # -- instantiation (memoized by CachedInstantiationMixin.instantiate) ----
    def instantiate(self, plan: KernelPlan, assignment: Mapping[str, int],
                    device: str = "cuda", *,
                    leaf_index: Optional[int] = None) -> Callable:
        """An uncached leaf's ``stages`` names the ring that did not fit; it
        runs ``UNCACHED_STAGES``, so its candidates build one callable."""
        if not plan.flags.get("smem_cache", True):
            assignment = {**assignment, "stages": UNCACHED_STAGES}
        return super().instantiate(plan, assignment, device,
                                   leaf_index=leaf_index)

    def _build(self, plan: KernelPlan, assignment: Mapping[str, int],
               device: str = "cuda") -> Callable:
        """The entry bound to the leaf's parameters: ``fn(a, b, ta=False,
        tb=False)``."""
        kw = {n: int(assignment[n]) for n in ("bm", "bn", "stages")}
        if device == "cuda":
            return functools.partial(_launch, **kw)
        return functools.partial(matmul_experts_plain, **kw)


FAMILY = MatmulExpertsH100Family()
