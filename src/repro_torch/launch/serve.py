"""Serving launcher of the port: paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --full --warm-kernels                      # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --device cpu                               # smoke config, plain ops

``--arch`` takes llama3-8b, mamba2-130m or hymba-1.5b.

``--async-depth`` keeps that many ticks in flight (1: synchronous).
``--trace PATH`` installs a flight recorder before the engine is built and
writes the run's trace as JSONL to PATH (``scripts/trace_report.py`` reads
it); ``--trace-sample N`` also samples 1 in N hits of the frozen dispatch
lane.  The options of the JAX launcher that the port does not serve yet
(``--prefix-sharing``, ``--monitor``, ``--degrade``,
``--plan-dir``/``--strict-plans``) are accepted and refused by the engine
with the slice they wait for.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.artifacts.dispatch import get_default_cache
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_h100
from repro_torch.kernels.matmul import matmul_h100
from repro_torch.kernels.ssd_scan import ssd_scan_h100
from repro_torch.models import init_model
from repro_torch.obs import FlightRecorder, install
from repro_torch.runtime import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="full published config (default: smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV cache block size in token positions")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks incl. the garbage block")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="max tokens prefilled per engine tick")
    ap.add_argument("--prefix-sharing", action="store_true")
    ap.add_argument("--async-depth", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm-kernels", action="store_true",
                    help="resolve and freeze the serve path's kernel picks "
                         "before the first request")
    ap.add_argument("--plan-dir", default=None)
    ap.add_argument("--strict-plans", action="store_true")
    ap.add_argument("--monitor", action="store_true")
    ap.add_argument("--degrade", action="store_true")
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="flight recorder: write the run's trace "
                         "(scheduling decisions, dispatch resolutions, tick "
                         "spans) as JSONL to PATH; feed it to "
                         "scripts/trace_report.py")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="with --trace: sample 1-in-N hits of the frozen "
                         "warm_callable lane as dispatch_decision records "
                         "(default 0 = the warm lane stays uncounted)")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="flight-recorder ring size in events; the oldest "
                         "age out first and are counted as dropped")
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    recorder = None
    if args.trace:
        recorder = FlightRecorder(capacity=args.trace_capacity,
                                  sample_frozen_every=args.trace_sample)
        install(recorder)
    params = init_model(cfg, seed=args.seed, device=args.device)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len, page_size=args.block_size,
                      num_blocks=args.num_blocks,
                      prefill_chunk=args.prefill_chunk,
                      prefix_sharing=args.prefix_sharing,
                      async_depth=args.async_depth,
                      warm_kernels=args.warm_kernels,
                      plan_store=args.plan_dir,
                      strict_plans=args.strict_plans,
                      monitor=args.monitor, degrade=args.degrade,
                      max_queue=args.max_queue,
                      deadline_ms=args.deadline_ms, device=args.device)
    if eng.kernel_plan:
        print(f"warm-up: {len(eng.kernel_plan)} kernel picks frozen")
    stats = get_default_cache().stats
    cold0 = stats.cold_builds
    kernels = (matmul_h100, flash_attention_h100, ssd_scan_h100)
    for k in kernels:
        k.launches = 0

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(rng.integers(0, cfg.vocab, plen), max_new=args.max_new)
    done = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    for r in done[:4]:
        if r.error is not None:
            print(f"req {r.rid}: [{r.error.code}] {r.error}")
        else:
            print(f"req {r.rid}: {r.out}")
    print(f"{len(done)} requests, {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.2f} tok/s) on {eng.device}")
    print("kernel launches: "
          + " ".join(f"{k.__name__}={k.launches}" for k in kernels)
          + f"; cold dispatch builds during the run: "
          f"{stats.cold_builds - cold0}")
    reg = eng.registry()
    print(reg.summary_line())
    for line in reg.kernel_report():
        print(line)
    if recorder is not None:
        with open(args.trace, "w") as fh:
            fh.write(recorder.export_jsonl())
        print(f"trace: {recorder.emitted} events "
              f"({recorder.dropped} dropped) -> {args.trace}")


if __name__ == "__main__":
    main()
