"""Offline artifact compiler of the port — the machine-free step of the
paper, persisted for the port's kernel families.

``compile_family`` runs comprehensive optimization once, saves the tree,
and for each target machine emits a *dispatch table*: the
machine-consistent leaves plus, per representative data-shape bucket, the
top-k candidates pre-ranked by the offline performance model.
``compile_all`` sweeps every registered family: the port's eight ``*_h100``
families, by default for ``H100_SXM`` and ``PAPER_M2050`` (the JAX package
compiles its two machines, ``TPU_V5E`` and ``PAPER_M2050``).
``python -m repro_torch.launch.compile_artifacts`` drives it.

The tables land beside the JAX package's under the same root and format:
the port's families have their own names, so neither package reads the
other's tables.  Kernel families are imported lazily; the serde and store
layers stay importable without them.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from ..core.comprehensive import comprehensive_tree
from ..core.params import H100_SXM, PAPER_M2050, MachineDescription
from ..core.plan import FamilySpec
from ..core.select import STATS, rank_candidates, specialize
from . import serde
from .dispatch import bucket_key
from .store import ArtifactStore

#: The machines a compile covers when none is named.
DEFAULT_MACHINES = (H100_SXM, PAPER_M2050)

# Representative data shapes per family: the serve paths' shapes (llama3-8b
# decode at 4 rows, a 32-token prefill chunk, its lm_head) and the paper's
# case-study sizes.  Off-grid shapes still resolve (dispatch re-validates
# against exact data); on-grid shapes hit the precompiled ranking directly.
_LLAMA = dict(d=4096, ff=14336, kv=1024, vocab=128256)
DEFAULT_DATA_GRIDS: Dict[str, List[Dict[str, int]]] = {
    "matmul_h100": (
        [{"M": m, "N": _LLAMA["d"], "K": _LLAMA["d"]} for m in (4, 32)]
        + [{"M": m, "N": _LLAMA["kv"], "K": _LLAMA["d"]} for m in (4, 32)]
        + [{"M": m, "N": _LLAMA["ff"], "K": _LLAMA["d"]} for m in (4, 32)]
        + [{"M": m, "N": _LLAMA["d"], "K": _LLAMA["ff"]} for m in (4, 32)]
        + [{"M": m, "N": _LLAMA["vocab"], "K": _LLAMA["d"]} for m in (1, 4)]
        + [{"M": n, "N": n, "K": n} for n in (512, 1024, 2048, 4096)]),
    "matadd_h100": [{"M": n, "N": n} for n in (1024, 4096, 8192)],
    "transpose_h100": [{"M": n, "N": n} for n in (1024, 4096, 16384)],
    "jacobi1d_h100": [{"N": n} for n in ((1 << 15) + 2, (1 << 18) + 2,
                                         (1 << 21) + 2)],
    "flash_attention_h100": [{"SQ": sq, "HD": hd, "GROUP": g, "HK": hk}
                             for sq in (1, 32, 256)
                             for hd, g, hk in ((128, 4, 8), (64, 5, 5))],
    "ssd_scan_h100": [{"SQ": sq, "HD": 64, "STATE": st}
                      for sq in (1, 32, 256) for st in (128, 16)],
    # the training keys: llama3-8b at seq 1024, whisper's encoder (1500
    # frames) and its decoder's cross-attention at 64 tokens
    "flash_attention_bwd_h100": [
        {"SQ": 1024, "HD": 128, "GROUP": 4, "HK": 8},
        {"SQ": 1500, "HD": 64, "GROUP": 1, "HK": 20},
        {"SQ": 64, "HD": 64, "GROUP": 1, "HK": 20}],
    # the training keys: mamba2-130m at seq 1024, hymba-1.5b at 2048
    "ssd_scan_bwd_h100": [{"SQ": 1024, "HD": 64, "STATE": 128},
                          {"SQ": 2048, "HD": 64, "STATE": 16}],
    # llama4-scout's experts (E 16, d 5120, ff 8192): a decode step's 4
    # rows, and a training group's 80 rows forward, dA and dB
    "matmul_experts_h100": [
        {"E": 16, "M": 4, "N": 8192, "K": 5120},
        {"E": 16, "M": 4, "N": 5120, "K": 8192},
        {"E": 16, "M": 80, "N": 8192, "K": 5120},
        {"E": 16, "M": 80, "N": 5120, "K": 8192},
        {"E": 16, "M": 5120, "N": 8192, "K": 80}],
}


def registered_families() -> Dict[str, FamilySpec]:
    from ..kernels.ops import FAMILIES
    return dict(FAMILIES)


def build_dispatch_table(family: FamilySpec, machine: MachineDescription,
                         shapes: Sequence[Mapping[str, int]],
                         top_k: int = 8) -> Dict[str, Any]:
    """Specialize the family tree for one machine; pre-rank per bucket."""
    leaves = comprehensive_tree(family)
    kept = specialize(leaves, machine, {})    # machine-consistent leaves
    kept_indices = {i for i, _, _ in kept}

    buckets: Dict[str, List[Dict[str, Any]]] = {}
    for data in shapes:
        key = bucket_key(data)
        if key in buckets:
            continue
        try:
            ranked = rank_candidates(family, machine, data, leaves=leaves)
        except ValueError:
            buckets[key] = []                 # nothing feasible at this shape
            continue
        buckets[key] = [
            {"leaf_index": c.leaf_index,
             "assignment": dict(c.assignment),
             "score": float(c.score)}
            for c in ranked[:top_k] if c.leaf_index in kept_indices
        ]
    # leaves keyed by their index in the *full* tree, so a disk-served
    # Candidate carries the same leaf_index the cold path would produce
    return {
        "format": serde.FORMAT_VERSION,
        "kind": "dispatch",
        "family": family.name,
        "machine": machine.name,
        "machine_bindings": machine.bindings(),
        "leaves": {str(i): serde.leaf_to_obj(leaves[i])
                   for i in sorted(kept_indices)},
        "buckets": buckets,
        "top_k": top_k,
    }


def compile_family(family: FamilySpec, store: ArtifactStore,
                   machines: Optional[Iterable[MachineDescription]] = None,
                   shapes: Optional[Sequence[Mapping[str, int]]] = None,
                   top_k: int = 8, quick: bool = False) -> Dict[str, Any]:
    """Tree + per-machine dispatch tables for one family.  Returns a report.

    ``quick`` compiles a single data-shape bucket (a smoke of the whole
    pipeline without sweeping the grid)."""
    t0 = time.perf_counter()
    leaves = comprehensive_tree(family)
    tree_path = store.save_tree(family.name, leaves)
    report: Dict[str, Any] = {
        "family": family.name,
        "leaves": len(leaves),
        "tree_path": str(tree_path),
        "tree_digest": serde.digest(serde.tree_to_obj(family.name, leaves)),
        "dispatch": {},
    }
    shapes = shapes if shapes is not None else \
        DEFAULT_DATA_GRIDS.get(family.name, [])
    if quick:
        shapes = shapes[:1]
    rows0, calls0 = STATS.rows_screened, STATS.enumerate_calls
    for machine in (machines if machines is not None else DEFAULT_MACHINES):
        tm = time.perf_counter()
        table = build_dispatch_table(family, machine, shapes, top_k=top_k)
        path = store.save_dispatch(table)
        report["dispatch"][machine.name] = {
            "path": str(path),
            "kept_leaves": len(table["leaves"]),
            "buckets": len(table["buckets"]),
            "seconds": round(time.perf_counter() - tm, 3),
        }
    report["seconds"] = round(time.perf_counter() - t0, 3)
    report["enumerate_calls"] = STATS.enumerate_calls - calls0
    report["rows_screened"] = STATS.rows_screened - rows0
    return report


def compile_all(store: ArtifactStore,
                families: Optional[Iterable[str]] = None,
                machines: Optional[Iterable[MachineDescription]] = None,
                top_k: int = 8, quick: bool = False) -> List[Dict[str, Any]]:
    registry = registered_families()
    names = list(families) if families else sorted(registry)
    reports = []
    for name in names:
        if name not in registry:
            raise KeyError(
                f"unknown kernel family {name!r}; have {sorted(registry)}")
        reports.append(
            compile_family(registry[name], store, machines=machines,
                           top_k=top_k, quick=quick))
    return reports
