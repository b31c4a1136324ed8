"""The port's dry run: memory, kernel cost, the collective schedule and an
H100 roofline for each (arch × shape × mesh) cell (the port of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
        --mesh 1,4
    python -m repro_torch.launch.dryrun --all [--multi-pod]

The JAX module compiles each cell's step on 512 placeholder devices and
reads XLA's memory and cost analyses and the partitioned HLO.  The port has
no compiler, so for rank 0 of the cell's mesh (an abstract mesh:
``launch.mesh.abstract_mesh``) it

1. sizes what the rank holds from the layout (``launch.specs.
   state_layout``: parameters and optimizer state; the batch by its specs;
   the serve steps' cache by ``cache_specs``): ``memory``;
2. walks one step's launches with their counts (``plans.trace.
   trace_train_launches`` / ``trace_serve_launches``), resolves each
   launch's pick through the dispatch and counts its work with
   ``launch.roofline.work``, the count ``chip_smoke.py``'s kernel table
   reads: ``cost``, by kernel family too;
3. runs the rank's step once on the ``meta`` device under
   ``distributed.comm.recording()`` (the abstract mesh's groups then
   communicate nothing) and reads the record through
   ``launch.comm_analysis``: ``collectives``.  A config deeper than
   :data:`FULL_DEPTH` layers runs at the probe depths 2 and 4, and a step
   of more than two microbatches at one and two, and the record is
   extended linearly to the cell's (fixed + L·per-layer, as
   ``benchmarks/roofline.py`` reconstructs the JAX probes); the record
   says which (``collective_run``);
4. reads the three against ``core.params.H100_SXM``'s datasheet rates:
   ``roofline`` (compute, memory and collective seconds, the bound their
   max).

and writes one JSON per cell under ``experiments/dryrun_torch/``.  The
record keeps the JAX keys (``arch, shape, mesh, probe_layers, status,
skip_reason, microbatches, devices, memory, cost, collectives,
kernel_dispatch`` and a FAIL's ``error, traceback``); ``memory``'s
``temp_bytes``, ``peak_bytes`` and ``generated_code_bytes`` are null, as
no compiler plans buffers here (the card measures the peak:
``chip_smoke.py`` phase 15), and ``cost``'s ``transcendentals`` too.
Besides the JAX meshes (16x16, 2x16x16 with ``--multi-pod``) ``--mesh``
takes the one- and four-card meshes, "D,M" over ("data", "model") or
"P,D,M" over ("pod", "data", "model").
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..artifacts.dispatch import get_default_cache
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.params import H100_SXM
from ..distributed import comm
from ..distributed import sharding as dist
from ..kernels.ops import FAMILIES
from ..models.config import SHAPES_BY_NAME, ModelConfig, ShapeConfig
from ..optim import make_optimizer, warmup_cosine
from ..plans.trace import (Launch, trace_serve_launches,
                           trace_train_launches)
from . import comm_analysis, roofline
from .mesh import abstract_mesh
from .specs import (abstract_state, batch_entry, cache_specs,
                    default_microbatches, grad_dtype_for, probe_config,
                    skip_reason, state_layout, train_batch_specs)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: Deeper configs run the collective record at the probe depths 2 and 4.
FULL_DEPTH = 4
PROBES = (2, 4)
#: Bytes of the train step's outputs beyond the state it updates in place:
#: its four f32 metrics.
METRIC_BYTES = 4 * 4


def mesh_of(shape: Sequence[int]):
    """An abstract mesh: ("data", "model") for two sizes, ("pod", "data",
    "model") for three."""
    shape = tuple(int(n) for n in shape)
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return abstract_mesh(shape, axes)


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(int(n)) for n in shape)


def _optimizer_for(cfg: ModelConfig):
    return make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 100, 10_000))


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def kernel_dispatch_record(cfg: ModelConfig, shape: ShapeConfig
                           ) -> Dict[str, Any]:
    """The cell's kernel picks through the dispatch cache on ``H100_SXM``
    (the JAX record's two queries, at the port's families)."""
    queries = {
        "flash_attention_h100": {"SQ": shape.seq_len, "HD": cfg.hd,
                                 "GROUP": cfg.heads // cfg.kv_heads,
                                 "HK": cfg.kv_heads},
        "matmul_h100": {"M": shape.seq_len, "N": cfg.d_ff or
                        4 * cfg.d_model, "K": cfg.d_model},
    }
    rec: Dict[str, Any] = {}
    for fam, data in queries.items():
        try:
            cand = get_default_cache().best_variant(FAMILIES[fam], H100_SXM,
                                                    data)
        except ValueError as e:
            rec[fam] = {"status": "INFEASIBLE", "error": str(e)}
            continue
        rec[fam] = {"data": dict(data), "plan": cand.plan.describe(),
                    "assignment": dict(cand.assignment),
                    "score": cand.score}
    rec["cache"] = get_default_cache().stats.as_dict()
    return rec


# ---------------------------------------------------------------------------
# Cost: the walk through the one count of a launch's work
# ---------------------------------------------------------------------------

def launch_cost(launches: List[Launch]) -> Dict[str, Any]:
    """``cost`` and the roofline's compute and memory seconds of a step's
    walked launches: each launch's pick resolved on ``H100_SXM``, its work
    by ``roofline.work``, times its calls."""
    cache = get_default_cache()
    flops = nbytes = compute_s = 0.0
    fams: Dict[str, Dict[str, float]] = {}
    for ln in launches:
        pick = cache.best_variant(FAMILIES[ln.family], H100_SXM,
                                  dict(ln.key)).assignment
        sig, lens = roofline.launch_signature(ln, pick)
        b, f, peak = roofline.work(ln.wrapper, sig, lens)
        flops += ln.calls * f
        nbytes += ln.calls * b
        compute_s += ln.calls * f / peak
        row = fams.setdefault(ln.wrapper, {"launches": 0, "calls": 0,
                                           "flops": 0.0, "bytes": 0.0})
        row["launches"] += ln.launches
        row["calls"] += ln.calls
        row["flops"] += ln.calls * f
        row["bytes"] += ln.calls * b
    return {"flops": flops, "bytes_accessed": nbytes,
            "transcendentals": None, "by_family": fams,
            "compute_s": compute_s,
            "memory_s": nbytes / roofline.HBM_BYTES_PER_S}


# ---------------------------------------------------------------------------
# The rank's step on meta under the collective record
# ---------------------------------------------------------------------------

def record_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                      microbatches: int) -> List[comm.Collective]:
    """The collectives of one train step of the mesh's rank 0, run on
    ``meta`` over the abstract mesh."""
    from ..runtime.steps import build_train_step
    opt = _optimizer_for(cfg)
    p_meta, o_meta = abstract_state(cfg, opt)
    layout = state_layout(cfg, mesh, p_meta, o_meta)
    batch, _ = train_batch_specs(cfg, shape, mesh)
    with comm.recording() as rec:
        step = build_train_step(cfg, opt, microbatches=microbatches,
                                grad_dtype=grad_dtype_for(cfg), mesh=mesh)
        step(layout.part(0).zeros(p_meta, "meta"),
             layout.part(1).zeros(o_meta, "meta"), batch, 0)
    return rec


def _serve_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens, extras) of a serve cell, on ``meta``: the whole batch."""
    GB, S = shape.global_batch, shape.seq_len
    steps = S if shape.kind == "prefill" else 1
    tokens = torch.empty((GB, steps), dtype=torch.int32, device="meta")
    kw = {}
    if cfg.encoder is not None and shape.kind == "prefill":
        kw["enc_embeds"] = torch.empty(
            (GB, cfg.encoder.seq_len, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device="meta")
    return tokens, kw


def record_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig
                      ) -> List[comm.Collective]:
    """The collectives of one prefill or decode step of the mesh's rank 0
    (``build_serve_steps(cfg, mesh)``), run on ``meta``."""
    from ..runtime.steps import build_serve_steps
    p_meta, _ = abstract_state(cfg)
    layout = state_layout(cfg, mesh, p_meta)
    c_meta, c_sh = cache_specs(cfg, shape.global_batch, shape.seq_len, mesh)
    tokens, kw = _serve_inputs(cfg, shape)
    with comm.recording() as rec:
        prefill_step, decode_one = build_serve_steps(cfg, mesh)
        params = layout.zeros(p_meta, "meta")
        cache = {k: torch.empty(dist.shard_shape(v.shape, c_sh[k], mesh),
                                dtype=v.dtype, device="meta")
                 for k, v in c_meta.items()}
        if shape.kind == "prefill":
            prefill_step(params, tokens, cache, **kw)
        else:
            decode_one(params, tokens, cache, shape.seq_len - 1)
    return rec


def _linear(a, b, la: int, lb: int, L: int):
    """``a`` at ``la`` and ``b`` at ``lb``, extended linearly to ``L``
    (dicts key by key; ints stay ints)."""
    if isinstance(a, dict):
        return {k: _linear(a.get(k, 0), b.get(k, 0), la, lb, L)
                for k in sorted(set(a) | set(b))}
    v = a + (b - a) * (L - la) / (lb - la)
    return int(round(v)) if isinstance(a, int) and isinstance(b, int) \
        else v


def collectives(cfg: ModelConfig, mesh, shape: ShapeConfig,
                microbatches: Optional[int]
                ) -> Tuple[Dict[str, Any], str, Dict[str, Any]]:
    """(the report's summary, how it was run, bytes by op and by call
    site) of one step of rank 0.  A step's collectives are linear in its
    depth (a layer's) and in its microbatches (a microbatch's; the
    gradients' and metrics' reductions once a step), so a config deeper
    than :data:`FULL_DEPTH` runs at the probe depths and a train step of
    more than two microbatches at one and two microbatches of the same
    rows, and the record is extended linearly in each."""
    def one(c, m):
        if shape.kind == "train":
            rows = shape.global_batch // microbatches
            s = dataclasses.replace(shape, global_batch=rows * m)
            rec = record_train_step(c, mesh, s, m)
        else:
            rec = record_serve_step(c, mesh, shape)
        rep = comm_analysis.collective_report(rec)
        return {"summary": rep.summary(),
                "detail": {"by_op": comm_analysis.by_op_bytes(rec),
                           "by_site": dict(rep.by_comp)}}

    L = cfg.layers
    depths = (L,) if L <= FULL_DEPTH else PROBES
    mb = microbatches or 1
    mbs = (mb,) if mb <= 2 else (1, 2)
    runs = {(d, m): one(cfg if d == L else probe_config(cfg, d), m)
            for d in depths for m in mbs}
    by_m = {m: (runs[(L, m)] if len(depths) == 1 else
                _linear(runs[(depths[0], m)], runs[(depths[1], m)],
                        *depths, L)) for m in mbs}
    out = by_m[mb] if len(mbs) == 1 else _linear(by_m[1], by_m[2], 1, 2, mb)
    how = []
    if len(depths) > 1:
        how.append(f"probes at depths {PROBES[0]} and {PROBES[1]}, "
                   f"extended to {L}")
    if len(mbs) > 1:
        how.append(f"1 and 2 microbatches, extended to {mb}")
    return (out["summary"], ", ".join(how) or "full depth, every microbatch",
            out["detail"])


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def cell_record(cfg: ModelConfig, shape: ShapeConfig,
                mesh_shape: Sequence[int], *,
                microbatches: Optional[int] = None) -> Dict[str, Any]:
    """The OK record's measures of ``cfg`` at ``shape`` for rank 0 of an
    abstract mesh of ``mesh_shape``: ``microbatches`` (a train step's;
    ``default_microbatches`` when None), ``devices``, ``memory``,
    ``cost`` and ``collectives`` under the JAX keys, and ``roofline``."""
    mesh = mesh_of(mesh_shape)
    GB, S = shape.global_batch, shape.seq_len
    rec: Dict[str, Any] = {}
    if shape.kind == "train":
        opt = _optimizer_for(cfg)
        p_meta, o_meta = abstract_state(cfg, opt)
        layout = state_layout(cfg, mesh, p_meta, o_meta)
        batch, b_sh = train_batch_specs(cfg, shape, mesh)
        mb = microbatches or default_microbatches(cfg, shape, mesh)
        rec["microbatches"] = mb
        state = layout.rank_bytes()
        args = state + sum(_nbytes(dist.shard_shape(v.shape, b_sh[k], mesh),
                                   v.dtype) for k, v in batch.items())
        out = state + METRIC_BYTES
        launches = trace_train_launches(cfg, global_batch=GB, seq=S,
                                        microbatches=mb, mesh=mesh)
    else:
        p_meta, _ = abstract_state(cfg)
        layout = state_layout(cfg, mesh, p_meta)
        c_meta, c_sh = cache_specs(cfg, GB, S, mesh)
        rows = GB // mesh.axis_size(dist.entry_axes(batch_entry(mesh, GB)))
        tokens, kw = _serve_inputs(cfg, shape)
        cache = sum(_nbytes(dist.shard_shape(v.shape, c_sh[k], mesh),
                            v.dtype) for k, v in c_meta.items())
        ins = sum(_nbytes((rows,) + tuple(t.shape[1:]), t.dtype)
                  for t in [tokens, *kw.values()])
        args = layout.rank_bytes() + cache + ins
        out = cache + _nbytes((GB, cfg.vocab), getattr(torch, cfg.dtype))
        mb = None
        launches = trace_serve_launches(
            cfg, batch=GB, prompt_len=S, max_len=S, part=shape.kind,
            mesh=mesh)
    cost = launch_cost(launches)
    summary, how, detail = collectives(cfg, mesh, shape, mb)
    rec["devices"] = mesh.size
    rec["memory"] = {
        "argument_bytes": args, "output_bytes": out, "temp_bytes": None,
        "peak_bytes": None, "generated_code_bytes": None,
        "note": "no compiler plans buffers in the port: temp, peak and "
                "code bytes are not known here; the card measures the "
                "peak (chip_smoke.py phase 15)"}
    rec["cost"] = {k: cost[k] for k in ("flops", "bytes_accessed",
                                        "transcendentals", "by_family")}
    rec["collectives"] = summary
    coll_s = summary["weighted_bytes"] / roofline.LINK_BYTES_PER_S
    rec["roofline"] = {
        "compute_s": cost["compute_s"], "memory_s": cost["memory_s"],
        "collective_s": coll_s,
        "bound_s": max(cost["compute_s"], cost["memory_s"], coll_s),
        "machine": roofline.MACHINE,
        "rates": {"hbm_bytes_per_s": roofline.HBM_BYTES_PER_S,
                  "link_bytes_per_s": roofline.LINK_BYTES_PER_S,
                  "bf16_flops": roofline.PEAK_FLOPS[torch.bfloat16],
                  "f32_flops": roofline.PEAK_FLOPS[torch.float32]},
        "collective_run": how,
        "collective_bytes_by_op": detail["by_op"],
        "collective_bytes_by_site": detail["by_site"]}
    return rec


def lower_cell(arch: str, shape_name: str, *, mesh_shape: Sequence[int],
               probe_layers: Optional[int] = None,
               overrides: Optional[Dict[str, Any]] = None,
               microbatches: Optional[int] = None,
               kernel_table: bool = False, smoke: bool = False
               ) -> Dict[str, Any]:
    """One cell's record (raises where the JAX module's compile would);
    ``smoke``: the config's smoke size (a quick check of the path)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES_BY_NAME[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name(mesh_shape),
                           "probe_layers": probe_layers}
    skip = skip_reason(cfg, shape)
    if skip:
        rec["status"] = "SKIP"
        rec["skip_reason"] = skip
        return rec
    if probe_layers is not None:
        cfg = probe_config(cfg, probe_layers)
        # probes take one microbatch, as the JAX module's
        microbatches = 1 if shape.kind == "train" else None
    body = cell_record(cfg, shape, mesh_shape, microbatches=microbatches)
    rec["status"] = "OK"
    rec.update(body)
    if kernel_table:
        rec["kernel_dispatch"] = kernel_dispatch_record(cfg, shape)
    return rec


def run_cell(arch: str, shape_name: str, mesh_shape: Sequence[int],
             probe_layers: Optional[int] = None,
             overrides: Optional[Dict[str, Any]] = None,
             microbatches: Optional[int] = None,
             kernel_table: bool = False, tag: str = "",
             out_dir: str = OUT_DIR, smoke: bool = False) -> Dict[str, Any]:
    """:func:`lower_cell`, a failure recorded as FAIL (as the JAX module
    records it), written to ``out_dir``."""
    try:
        rec = lower_cell(arch, shape_name, mesh_shape=mesh_shape,
                         probe_layers=probe_layers, overrides=overrides,
                         microbatches=microbatches,
                         kernel_table=kernel_table, smoke=smoke)
    except Exception as e:                                    # noqa: BLE001
        rec = {"arch": arch, "shape": shape_name,
               "mesh": mesh_name(mesh_shape), "probe_layers": probe_layers,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    os.makedirs(out_dir, exist_ok=True)
    fname = (f"{arch}_{shape_name}_{rec['mesh']}"
             f"{'_probe' + str(probe_layers) if probe_layers else ''}"
             f"{('_' + tag) if tag else ''}")
    with open(os.path.join(out_dir, fname + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", type=str, default=None,
                    help="D,M or P,D,M (default 16,16; 2,16,16 with "
                         "--multi-pod)")
    ap.add_argument("--probe-layers", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--perf-flags", type=str, default=None,
                    help="comma list of the config's perf flags")
    ap.add_argument("--remat", type=str, default=None)
    ap.add_argument("--param-dtype", type=str, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--kernel-table", action="store_true",
                    help="record the cell's kernel picks on H100_SXM")
    ap.add_argument("--tag", type=str, default="",
                    help="suffix for the output JSON (variant runs)")
    ap.add_argument("--out", type=str, default=OUT_DIR,
                    help="directory of the JSONs")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' smoke sizes (a quick check)")
    args = ap.parse_args(argv)

    overrides: Dict[str, Any] = {}
    if args.perf_flags is not None:
        overrides["perf_flags"] = tuple(
            f for f in args.perf_flags.split(",") if f)
    if args.remat is not None:
        overrides["remat"] = args.remat
    if args.param_dtype is not None:
        overrides["param_dtype"] = args.param_dtype
    if args.mesh:
        mesh_shape = tuple(int(n) for n in args.mesh.split(","))
        if len(mesh_shape) not in (2, 3):
            ap.error("--mesh takes D,M or P,D,M")
    else:
        mesh_shape = (2, 16, 16) if args.multi_pod else (16, 16)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPE_NAMES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    fails = 0
    for arch, shape in cells:
        t0 = time.time()
        rec = run_cell(arch, shape, mesh_shape, args.probe_layers,
                       overrides=overrides or None,
                       microbatches=args.microbatches,
                       kernel_table=args.kernel_table, tag=args.tag,
                       out_dir=args.out, smoke=args.smoke)
        status = rec["status"]
        extra = ""
        if status == "OK":
            extra = (f" flops={rec['cost']['flops']:.3g} "
                     f"coll={rec['collectives']['weighted_bytes']:.3g}B "
                     f"bound={rec['roofline']['bound_s']:.3g}s "
                     f"({time.time() - t0:.1f}s)")
        elif status == "FAIL":
            fails += 1
            extra = " " + rec["error"][:160]
        print(f"[{status}] {arch} {shape} {rec['mesh']}"
              f"{' probe' + str(args.probe_layers) if args.probe_layers else ''}"
              f"{extra}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
