"""Machine / program / data parameters (paper §3.1-§3.2).

The paper's machine parameters are hardware resource limits ``R_1..R_s`` and
performance measures ``P_1..P_t``; program/data parameters come from the code
fragment.  All stay *symbolic* through comprehensive optimization and are only
bound when the generated artifact is loaded on a concrete machine.

The symbols keep the JAX package's TPU names (V, G, CORES, LANE, ...) so a
family's constraint systems read the same in both packages.  On a GPU they
carry the paper's own meaning: V is shared memory per block (Z_B's limit),
G registers per thread (R), CORES streaming multiprocessors, LANE the warp
width; T, threads per block, is the paper's third GPU limit and is new here.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple


class ParamKind(enum.Enum):
    MACHINE_RESOURCE = "machine_resource"     # R_i — hardware resource limit
    MACHINE_PERFORMANCE = "machine_perf"      # P_i — performance measure in [0,1]
    PROGRAM = "program"                       # E_i — e.g. block sizes, grain
    DATA = "data"                             # D_i — e.g. matrix order, seq len


@dataclass(frozen=True)
class ParamSymbol:
    name: str
    kind: ParamKind
    doc: str = ""


# --- canonical TPU machine-parameter symbols --------------------------------
VMEM = ParamSymbol("V", ParamKind.MACHINE_RESOURCE,
                   "VMEM bytes available per TensorCore")
VREGS = ParamSymbol("G", ParamKind.MACHINE_RESOURCE,
                    "vector-register budget (lane-values) per core")
CORES = ParamSymbol("CORES", ParamKind.MACHINE_RESOURCE,
                    "number of TensorCores in the slice")
SUBLANE = ParamSymbol("SUBLANE", ParamKind.MACHINE_RESOURCE,
                      "second-minor tile dim (8 for f32, 16 bf16, 32 int8)")
LANE = ParamSymbol("LANE", ParamKind.MACHINE_RESOURCE,
                   "minor tile dim (128)")
MXU = ParamSymbol("MXU", ParamKind.MACHINE_RESOURCE,
                  "systolic array dimension (128)")
THREADS = ParamSymbol("T", ParamKind.MACHINE_RESOURCE,
                      "threads per block (the paper's T; GPU machines only)")

OCCUPANCY = ParamSymbol("P_occ", ParamKind.MACHINE_PERFORMANCE,
                        "achievable grid-occupancy ratio")
MXU_UTIL = ParamSymbol("P_mxu", ParamKind.MACHINE_PERFORMANCE,
                       "achievable MXU tile-utilization ratio")

RESOURCE_SYMBOLS = (VMEM, VREGS, CORES, SUBLANE, LANE, MXU, THREADS)
PERFORMANCE_SYMBOLS = (OCCUPANCY, MXU_UTIL)


@dataclass(frozen=True)
class MachineDescription:
    """Concrete values bound at load time (paper: 'looked up when the
    generated code is loaded on the target machine')."""

    name: str
    vmem_bytes: int
    vreg_budget: int              # lane-values; 2 * 512 VREGs * (8*128) is gen-dep
    num_cores: int
    sublane: int
    lane: int
    mxu: int
    hbm_bytes: int
    hbm_bw: float                 # bytes/s
    peak_flops_bf16: float        # FLOP/s per core-pair (chip)
    ici_bw: float                 # bytes/s per link per chip
    ici_links: int = 4            # v5e 2D torus: 4 links/chip
    threads_per_block: int = 0    # T; 0 on machines without thread blocks

    def bindings(self) -> Dict[str, int]:
        """Values for the machine symbols used in constraint systems."""
        return {
            VMEM.name: self.vmem_bytes,
            VREGS.name: self.vreg_budget,
            CORES.name: self.num_cores,
            SUBLANE.name: self.sublane,
            LANE.name: self.lane,
            MXU.name: self.mxu,
            THREADS.name: self.threads_per_block,
        }


# TPU v5e (the dry-run / roofline target; constants from the task spec).
TPU_V5E = MachineDescription(
    name="tpu_v5e",
    vmem_bytes=128 * 1024 * 1024,     # ~128 MiB VMEM per core
    vreg_budget=4096,                  # usable f32 lane-rows before spill (est.)
    num_cores=1,                       # per-chip kernels see one TensorCore
    sublane=8,
    lane=128,
    mxu=128,
    hbm_bytes=16 * 1024**3,
    hbm_bw=819e9,
    peak_flops_bf16=197e12,
    ici_bw=50e9,
    ici_links=4,
)

# A Fermi-class description used only to replay the paper's own case studies
# (Tesla M2050 figures: R registers/thread, T threads/block, Z_B shared words).
PAPER_M2050 = MachineDescription(
    name="paper_m2050",
    vmem_bytes=48 * 1024,              # 48 KiB shared memory / block ~ Z_B
    vreg_budget=63,                    # max registers per thread ~ R
    num_cores=14,                      # SMs
    sublane=1,
    lane=32,                           # warp size
    mxu=1,
    hbm_bytes=3 * 1024**3,
    hbm_bw=148e9,
    peak_flops_bf16=1.03e12,
    ici_bw=8e9,
    ici_links=1,
    threads_per_block=1024,
)

# NVIDIA H100 SXM, bound the way PAPER_M2050 is (NVIDIA's H100 data sheet and
# Hopper architecture white paper): V = 227 KB of shared memory one block can
# use (dynamic, above 48 KB after cudaFuncSetAttribute), G = 255 registers a
# thread, 132 SMs, warps of 32, T = 1024 threads a block.  MXU = 1: the
# simple kernels of the port run on CUDA cores, so tile fill is not bound by
# a systolic array.  NVLink (450 GB/s each way) stands in for ICI.
H100_SXM = MachineDescription(
    name="h100_sxm",
    vmem_bytes=232_448,
    vreg_budget=255,
    num_cores=132,
    sublane=1,
    lane=32,
    mxu=1,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    peak_flops_bf16=989e12,
    ici_bw=450e9,
    ici_links=1,
    threads_per_block=1024,
)

MACHINES: Mapping[str, MachineDescription] = {
    m.name: m for m in (TPU_V5E, PAPER_M2050, H100_SXM)
}
