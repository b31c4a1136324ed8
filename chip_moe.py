"""The MoE training path on one card alone: the kernels' build with its
``ptxas`` check, ``chip_smoke.py`` phase 13 (i) and (j), and with
``--parity`` 13 (d)'s MoE smoke steps against the CPU, with ``--mesh``
phase 14 (a) and (c) after (j).

    python3 chip_moe.py [--parity] [--skip-kernels] [--mesh]

The work is ``chip_smoke.py``'s own: :func:`chip_smoke.phase_build`,
:func:`chip_smoke.phase_train_moe_kernels` (K1b and K4's batched entry at
llama4-scout's and kimi-k2's expert training keys: two launches bit for
bit, held against their plain versions, timed eagerly and as device time
beside the bound, K1b beside today's entry and ``torch.bmm``, K4b beside
``a.transpose(1, 2).contiguous()``; then K1b's leaf sweep),
:func:`chip_smoke.phase_train_llama4` (llama4-scout at full width, 1 of 48
layers, with its launches a step against ``_train_counts``, peak memory
and the profiled step) and, with ``--parity``, the MoE steps of
:func:`chip_smoke.phase_train_parity` (the f32 experts' route, counted).
``--skip-kernels`` leaves out (i).  ``--mesh`` then starts NCCL at world
size 1 (:func:`chip_smoke.phase_multi_group`) and runs (j)'s llama4-scout
through ``moe_a2a`` and the mesh step beside the communicator
(:func:`chip_smoke.phase_multi_llama4`), held to (j).
Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parity", action="store_true",
                    help="also the MoE smoke steps against the CPU, 13 (d)")
    ap.add_argument("--skip-kernels", action="store_true",
                    help="leave out 13 (i)")
    ap.add_argument("--mesh", action="store_true",
                    help="also 14 (a) and (c) after (j)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_moe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.workspace import scratch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(0)
    cs.phase_device()
    cs.phase_build()
    with scratch():
        if args.parity:
            t0 = time.perf_counter()
            cs.phase_train_parity(("llama4_scout_17b_a16e",
                                   "kimi_k2_1t_a32b"))
            cs.say(f"[moe] (d) {time.perf_counter() - t0:.1f} s")
        if not args.skip_kernels:
            t0 = time.perf_counter()
            k1_err, _, k4_err, _ = cs.phase_train_moe_kernels(gen)
            cs.say(f"[moe] (i) {time.perf_counter() - t0:.1f} s, largest "
                   f"error against the plain version: K1b {k1_err:.3e}, "
                   f"K4b {k4_err:.3e}")
        t0 = time.perf_counter()
        p = cs.phase_train_llama4(gen)
        share = {n: p["kernel_ms"][n] / p["profiled_ms"]
                 for n in ("K1", "K1b", "K4", "K2", "K2b", "other")}
        cs.say(f"[moe] (j) {time.perf_counter() - t0:.1f} s; {p['name']}: "
               f"median step {p['step_ms']:.1f} ms (CUDA events), peak "
               f"{p['peak_gb']:.2f} GB; share of the profiled step's device "
               f"time: " + ", ".join(f"{n} {100 * v:.1f} %"
                                     for n, v in share.items()))
        torch.cuda.synchronize()
        if args.mesh:
            import shutil
            import torch.distributed as tdist
            t0 = time.perf_counter()
            mesh, store = cs.phase_multi_group(gen)
            cs.phase_multi_llama4(mesh, gen, p)
            cs.say(f"[moe] (14 a, c) {time.perf_counter() - t0:.1f} s")
            tdist.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
