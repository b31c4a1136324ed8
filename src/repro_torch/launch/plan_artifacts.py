"""Build the port's serve plans offline: trace -> resolve -> ship.

For each model config, traces the exact (family, machine, data) warm set
the port's serve path dispatches for one engine (``--max-len``,
``--max-batch``, ``--prefill-chunk``), resolves every triple through the
dispatch tiers against the artifact root (so compiled tables decide the
picks), and writes a serve plan next to the dispatch tables:

    <out>/plans/<config>/serve-v<V>-<machine>.json

``ServeEngine(warm_kernels=True)`` with the same engine sizes then starts
from the plan with zero online tree enumeration.

    PYTHONPATH=src python -m repro_torch.launch.plan_artifacts \\
        --config llama3_8b --out artifacts                    # build
    PYTHONPATH=src python -m repro_torch.launch.plan_artifacts \\
        --config llama3_8b --dry-run                          # trace only
    PYTHONPATH=src python -m repro_torch.launch.plan_artifacts \\
        --config llama3_8b --out artifacts --check [--strict]   # audit

``--check`` audits shipped plans instead of building: each plan's recorded
dispatch-table digests are compared with the tables under the artifact
root, as engine start does.  Stale plans are reported; the exit code is 0
unless ``--strict`` is given, which exits 1 on a stale plan, as
``strict_plans`` refuses to serve one.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time

from repro_torch.artifacts import ArtifactStore, DispatchCache
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.params import MACHINES
from repro_torch.plans import (PlanStore, build_serve_plan, plan_staleness,
                               trace_warm_set)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", action="append", default=None,
                    help="model config to plan (repeatable; default: every "
                         "config of the port)")
    ap.add_argument("--machine", action="append", default=None,
                    choices=sorted(MACHINES),
                    help="target machine (repeatable; default h100_sxm)")
    ap.add_argument("--out", default=None,
                    help="artifact root (default: $REPRO_ARTIFACT_DIR "
                         "or ./artifacts); dispatch tables found there "
                         "decide the resolutions")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="the engine sizes the warm set is traced for; a "
                         "plan is a hit only for an engine with the same")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--dry-run", action="store_true",
                    help="print each config's traced warm set without "
                         "resolving or writing anything")
    ap.add_argument("--check", action="store_true",
                    help="audit shipped plans for digest staleness instead "
                         "of building")
    ap.add_argument("--strict", action="store_true",
                    help="with --check: exit 1 on any stale plan")
    args = ap.parse_args(argv)

    names = args.config if args.config else list(ARCH_IDS)
    get = get_smoke_config if args.smoke else get_config
    try:
        cfgs = [get(n) for n in names]
    except (KeyError, ModuleNotFoundError) as e:
        ap.error(f"unknown config {e}; have {sorted(ARCH_IDS)}")
    machines = [MACHINES[m] for m in (args.machine or ["h100_sxm"])]
    trace_kw = dict(max_len=args.max_len, max_batch=args.max_batch,
                    prefill_chunk=args.prefill_chunk)

    if args.dry_run:
        for cfg in cfgs:
            traced = trace_warm_set(cfg, **trace_kw)
            fams = collections.Counter(op.family for op in traced)
            print(f"[dry-run] {cfg.name}: {len(traced)} traced triples "
                  f"({', '.join(f'{f}x{n}' for f, n in sorted(fams.items()))})")
            for op in traced:
                print(f"           {op.label}  <- {', '.join(op.sites)}")
        return 0

    if args.check:
        plan_store = PlanStore(args.out)
        dispatch_store = ArtifactStore(args.out) if args.out else None
        stale_count = 0
        for machine in machines:
            for cfg in cfgs:
                plan = plan_store.load_plan(cfg.name, machine.name)
                if plan is None:
                    print(f"[MISS] {cfg.name}/{machine.name}: no readable "
                          f"plan of the port under {plan_store.root}")
                    continue
                stale = plan_staleness(plan, machine=machine,
                                       store=dispatch_store)
                if stale:
                    stale_count += 1
                    for fam, (rec, cur) in sorted(stale.items()):
                        print(f"[STALE] {cfg.name}/{machine.name} {fam}: "
                              f"plan={rec or 'none'} host={cur or 'none'}")
                else:
                    print(f"[FRESH] {cfg.name}/{machine.name}: "
                          f"{len(plan.entries)} entries, digests match")
        if stale_count:
            print(f"{stale_count} stale plan(s); rebuild with python -m "
                  f"repro_torch.launch.plan_artifacts", file=sys.stderr)
            return 1 if args.strict else 0
        return 0

    plan_store = PlanStore(args.out)
    failures = 0
    for machine in machines:
        cache = DispatchCache(store=ArtifactStore(args.out))
        for cfg in cfgs:
            t0 = time.perf_counter()
            plan, dropped = build_serve_plan(cfg, machine=machine,
                                             cache=cache, **trace_kw)
            if not plan.entries or dropped:
                print(f"[FAIL] {cfg.name}/{machine.name}: "
                      f"{len(dropped)} traced triples have no feasible "
                      f"leaf: {', '.join(op.label for op in dropped)}",
                      file=sys.stderr)
                failures += 1
                continue
            path = plan_store.save_plan(plan)
            sources = collections.Counter(e.rank_source
                                          for e in plan.entries)
            print(f"[OK] {cfg.name}/{machine.name}: {len(plan.entries)} "
                  f"entries ({', '.join(f'{s}={n}' for s, n in sorted(sources.items()))}) "
                  f"digest={plan.digest()} "
                  f"({time.perf_counter() - t0:.1f}s)\n     -> {path}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
