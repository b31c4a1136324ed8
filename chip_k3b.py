"""K3b (``ssd_scan_bwd_h100``, the SSD scan's backward) on one card alone:
the kernels' build with its ``ptxas`` check, ``chip_smoke.py`` phase 13
(f), and with ``--train`` the SSM training paths (g) and (h).

    python3 chip_k3b.py [--train]

The work is ``chip_smoke.py``'s own: :func:`chip_smoke.phase_build` (each
K3b kernel's registers and spills, a spill fails),
:func:`chip_smoke.phase_train_k3b` (at each key of
``SSD_BWD_SIGNATURES`` the pick in bf16, the tensor-core body, and f32,
the FMA body, held against the plain version and autograd, two launches
bit for bit, timed beside the bound and each other; then every leaf at the
training and held-out keys, each kernel under the profiler: the data the
napkin's constants are fitted to) and :func:`chip_smoke.train_path`
(mamba2-130m at full depth, hymba-1.5b at 4 of 32 layers, with K3 and
K3b's shares of the profiled step).  Exits 2 without a card.
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
    ap.add_argument("--train", action="store_true",
                    help="also train mamba2-130m and hymba-1.5b, 13 (g), (h)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k3b: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.workspace import scratch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(0)
    cs.phase_device()
    cs.phase_build()
    with scratch():
        t0 = time.perf_counter()
        err, _ = cs.phase_train_k3b(gen)
        cs.say(f"[k3b] (f) {time.perf_counter() - t0:.1f} s, largest error "
               f"against the plain version {err:.3e}")
        if args.train:
            paths = [cs.train_path("(g)", get_config("mamba2_130m"), None,
                                   cs.MAMBA_TRAIN),
                     cs.train_path("(h)", get_config("hymba_1p5b"),
                                   cs.HYMBA_LAYERS, cs.HYMBA_TRAIN)]
            for p in paths:
                share = {n: p["kernel_ms"][n] / p["profiled_ms"]
                         for n in ("K3", "K3b")}
                cs.say(f"[k3b] {p['name']}: median step {p['step_ms']:.1f} "
                       f"ms (CUDA events), peak {p['peak_gb']:.2f} GB; share "
                       f"of the profiled step's device time: " + ", ".join(
                           f"{n} {100 * v:.1f} %" for n, v in share.items()))
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
