"""Tune the port's dispatch tables against the card: measure -> calibrate
-> compact -> rewrite.

Loads each (family, machine) dispatch table of the port (compiling it
first when absent), times the top-k pre-ranked candidates of every
data-shape bucket (``--device cuda``: device time on the card, CUDA-graph
replays between CUDA events; ``--device cpu``: the plain versions under
the host clock, a smoke of the code path), fits the KLARAPTOR-style
per-family calibration, computes the "few fit most" variant subset, and
rewrites the table in place with the optional FORMAT_VERSION-2 sections
(``calibration``, ``measured_ranks``, ``compaction``).  The port's
``DispatchCache`` then prefers the measured order; untuned tables keep
resolving symbolically.

    PYTHONPATH=src python -m repro_torch.launch.tune_artifacts \\
        --family matmul_h100 --out artifacts          # on the card
    PYTHONPATH=src python -m repro_torch.launch.tune_artifacts --dry-run

``--machine`` defaults to ``h100_sxm``: times taken on the card describe
that machine alone (a machine named on the command line is still tuned).
``--dry-run`` resolves the tables and lists the measurement plan; it runs
no kernel and writes no tuning section.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.artifacts import ArtifactStore, compile_family
from repro_torch.core.params import MACHINES
from repro_torch.tuning import MeasureConfig, calibrate_table, \
    compact_table, measure_table
from repro_torch.tuning.compact import compaction_summary
from repro_torch.tuning.measure import FA_KEYS, DeviceTimer, \
    measure_shape, parse_bucket_key

#: ``--max-dim`` when none is given: no clamp on the card, the JAX tuner's
#: 256 for a CPU smoke.
MAX_DIM = {"cuda": 1 << 30, "cpu": 256}

#: Families whose measured order is known not to carry over to the serve
#: path, printed beside their lines.
CONTEXT_WARNINGS = {
    "flash_attention_h100": (
        f"timed over {FA_KEYS} keys at one row (the napkin's context); the "
        "decode step reads pools of a few hundred keys over several rows, "
        "where this measured order has been slower than the symbolic one"),
}


def _load_or_compile(store, family, machine, quick):
    table = store.load_dispatch(family.name, machine.name)
    if table is None:
        print(f"[compile] no dispatch table for {family.name}/{machine.name}"
              f" under {store.root}; compiling", flush=True)
        compile_family(family, store, machines=[machine], quick=quick)
        table = store.load_dispatch(family.name, machine.name)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", action="append", default=None,
                    help="kernel family to tune (repeatable; default all "
                         "seven)")
    ap.add_argument("--machine", action="append", default=None,
                    choices=sorted(MACHINES),
                    help="target machine (repeatable; default h100_sxm)")
    ap.add_argument("--out", default=None,
                    help="artifact root (default: $REPRO_ARTIFACT_DIR "
                         "or ./artifacts)")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed repeats per candidate")
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed runs per candidate (after its first "
                         "launch, which always runs)")
    ap.add_argument("--trim", type=int, default=1,
                    help="repeats trimmed from each end before the mean")
    ap.add_argument("--top-k", type=int, default=4,
                    help="candidates measured per bucket (prefix of the "
                         "table's symbolic ranking)")
    ap.add_argument("--max-dim", type=int, default=None,
                    help="clamp measured data dims (default: none on cuda, "
                         "256 on cpu, where the plain versions run)")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="few-fit-most relative tolerance vs per-bucket best")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for deterministic operand tensors")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: time the kernels on the card; cpu: time "
                         "their plain versions (a smoke, no card numbers)")
    ap.add_argument("--quick", action="store_true",
                    help="when compiling a missing table, build one bucket")
    ap.add_argument("--dry-run", action="store_true",
                    help="resolve tables and list the measurement plan "
                         "without running any kernel")
    args = ap.parse_args(argv)

    from repro_torch.artifacts.compile import registered_families
    registry = registered_families()
    names = args.family if args.family else sorted(registry)
    unknown = [n for n in names if n not in registry]
    if unknown:
        ap.error(f"unknown kernel family {unknown}; have {sorted(registry)}")
    machines = [MACHINES[m] for m in (args.machine or ["h100_sxm"])]
    store = ArtifactStore(args.out)
    max_dim = (args.max_dim if args.max_dim is not None
               else MAX_DIM[args.device])
    cfg = MeasureConfig(iters=args.iters, warmup=args.warmup, trim=args.trim,
                        max_dim=max_dim, top_k=args.top_k,
                        seed=args.seed, device=args.device)
    meta = {"iters": cfg.iters, "warmup": cfg.warmup, "trim": cfg.trim,
            "max_dim": cfg.max_dim, "top_k": cfg.top_k, "seed": cfg.seed,
            "device": cfg.device}
    if args.device == "cuda" and not args.dry_run:
        import torch
        if not torch.cuda.is_available():
            print("[FAIL] --device cuda: no CUDA device (pass --device cpu "
                  "for a smoke of the plain versions)", file=sys.stderr)
            return 1
        meta["card"] = torch.cuda.get_device_name(0)

    failures = 0
    for name in names:
        family = registry[name]
        for machine in machines:
            t0 = time.perf_counter()
            table = _load_or_compile(store, family, machine, args.quick)
            if table is None:
                print(f"[FAIL] {name}/{machine.name}: could not load or "
                      f"compile a dispatch table", file=sys.stderr)
                failures += 1
                continue
            buckets = table.get("buckets", {})
            plan_rows = sum(min(len(v), cfg.top_k) for v in buckets.values())
            if args.dry_run:
                print(f"[dry-run] {name}/{machine.name}: "
                      f"{len(buckets)} buckets, {plan_rows} candidate "
                      f"timings planned (top-{cfg.top_k}, "
                      f"max_dim={cfg.max_dim}, device={cfg.device})")
                for b in sorted(buckets):
                    head = buckets[b][:cfg.top_k]
                    try:
                        shape = measure_shape(
                            name, parse_bucket_key(b),
                            [e["assignment"] for e in head], cfg.max_dim)
                    except (KeyError, TypeError, ValueError):
                        # same tolerance as measure_table: a mangled bucket
                        # is skipped, not a crash
                        print(f"           {b} -> skipped (unparseable)")
                        continue
                    print(f"           {b} -> measure at {shape} "
                          f"({len(head)} candidates)")
                continue
            timer = DeviceTimer()
            samples = measure_table(
                family, table, cfg, timer=timer,
                progress=lambda s: print(f"  [measure] {s}", flush=True))
            timer.clear()
            ok = [s for s in samples if s.us is not None]
            tuned = calibrate_table(family, table, samples, meta=meta)
            tuned = compact_table(tuned, samples, tolerance=args.tolerance)
            path = store.save_dispatch(tuned)
            cal = tuned.get("calibration")
            fit_line = ("no fit (too few samples)" if cal is None else
                        f"fit n={cal['n_samples']} "
                        f"rms_log_resid={cal['rms_log_residual']:.3f} "
                        f"top1_agreement={cal['top1_agreement']}")
            print(f"[OK] {name}/{machine.name}: {len(ok)}/{len(samples)} "
                  f"candidates measured across {len(buckets)} buckets on "
                  f"{meta.get('card', cfg.device)} "
                  f"({time.perf_counter() - t0:.1f}s)\n"
                  f"     {fit_line}\n"
                  f"     compaction: {compaction_summary(tuned)}\n"
                  f"     -> {path}", flush=True)
            if name in CONTEXT_WARNINGS:
                print(f"[warn] {name}/{machine.name}: "
                      f"{CONTEXT_WARNINGS[name]}", flush=True)
            if not ok:
                print(f"[FAIL] {name}/{machine.name}: every measurement "
                      f"failed", file=sys.stderr)
                failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
