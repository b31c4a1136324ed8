"""K4 (``transpose_h100``, the port's transpose) timed on one card at the
K4 keys of the training paths, every launch cold, for one source tree.

    python3 chip_k4.py [--src DIR] [--tag NAME] [--out FILE]

``--src`` is the ``src`` directory of a checkout (default: the one beside
this script), so that two trees are compared in one call: unpack the
other into a directory that ``.gitignore`` lists and run the script on
each in turn, alternating (A B B A).  The timing is ``chip_smoke.py``'s
own (:func:`chip_smoke.k4_leaves`): at each signature the tree's pick
(its napkin under H100_SXM) eagerly and as CUDA-graph device time, beside
the byte bound, ``a.t().contiguous()`` and ``a.clone()``, then the pick
and the leaves of ``chip_smoke.K4_TRAIN_LEAVES``, each bit for bit
against the plain version and as device time, with the napkin's rank
beside the card's.
Every launch reads a copy of its input and writes an output that the L2
does not hold.

The signatures: ``fit``, llama3-8b's and whisper-large-v3's (bf16), the
ones the napkin's constants were set on; ``held out``, the other dense
configs' (yi-6b, qwen1.5-4b, granite-3-8b, bf16, 8 × 1024 tokens in 2
microbatches, the trace of ``plans/trace.py``) and four training shapes
in f32.  Prints one line a signature and a summary, and writes the rows
to ``--out`` as JSON.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

FIT = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
       (4096, 128256), (1280, 1280), (3000, 1280), (1280, 5120),
       (5120, 1280), (3000, 5120), (128, 1280), (128, 5120), (1280, 51866)]
#: K4 launches of the fit signatures over ``chip_smoke.py`` phase 13's
#: training run (launches a step times steps: llama3-8b 6 steps, whisper 2;
#: 988 in all), to weigh the fit signatures as that run does.
TRAIN_LAUNCHES = dict(zip(FIT, (396, 96, 144, 48, 12, 96, 64, 32, 16, 8,
                                66, 8, 2)))
HELD_OUT = [(4096, 512), (4096, 11008), (4096, 64000), (11008, 4096),
            (2560, 2560), (2560, 6912), (2560, 151936), (4096, 2560),
            (4096, 6912), (6912, 2560), (4096, 12800), (4096, 49155),
            (12800, 4096)]
HELD_OUT_F32 = [(4096, 4096), (4096, 14336), (3000, 1280), (1280, 5120)]


def signatures():
    """(set, M, N, dtype) of every signature timed."""
    return ([("fit", m, n, torch.bfloat16) for m, n in FIT]
            + [("held out", m, n, torch.bfloat16) for m, n in HELD_OUT]
            + [("held out", m, n, torch.float32) for m, n in HELD_OUT_F32])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    t0 = time.perf_counter()
    build.load("transpose")
    cs.say(f"[k4 {args.tag}] {args.src}: built in "
           f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=cs.DEV)
    gen.manual_seed(0)
    family = ops.FAMILIES["transpose_h100"]
    rows = []
    for which, M, N, dtype in signatures():
        pick = cs._format(family, ops.select("transpose_h100",
                                             {"M": M, "N": N}))
        row = cs.k4_leaves((M, N, *pick, dtype), gen,
                           f"[k4 {args.tag}] {which} {(M, N)} {dtype}")
        rows.append({"set": which, "M": M, "N": N, "dtype": str(dtype),
                     "pick": list(pick), **{k: row[k] for k in (
                         "ms", "device_ms", "bound_ms", "library_ms",
                         "library_device_ms", "copy_device_ms",
                         "first_over_fastest")},
                     "leaves": {str(list(f)): ms
                                for f, ms in row["leaves"].items()},
                     "napkin": [list(f) for f in row["napkin"]]})
    for which in ("fit", "held out"):
        sub = [r for r in rows if r["set"] == which]
        if not sub:
            continue
        dev = sum(r["device_ms"] for r in sub)
        bound = sum(r["bound_ms"] for r in sub)
        cs.say(f"[k4 {args.tag}] {which}: {len(sub)} signatures, picks' "
               f"device ms summed {dev:.4f} against the bounds' {bound:.4f} "
               f"({dev / bound:.3f} x); the napkin's first within 1.10 x "
               f"of the card's fastest at "
               f"{sum(r['first_over_fastest'] <= 1.10 for r in sub)}, "
               f"worst {max(r['first_over_fastest'] for r in sub):.3f} x")
    fit = {(r["M"], r["N"]): r for r in rows if r["set"] == "fit"}

    def over_run(key: str) -> float:
        return sum(n * fit[k][key] for k, n in TRAIN_LAUNCHES.items())
    cs.say(f"[k4 {args.tag}] over the training run's "
           f"{sum(TRAIN_LAUNCHES.values())} launches: device ms "
           f"{over_run('device_ms'):.4f}, eager {over_run('ms'):.4f}, byte "
           f"bound {over_run('bound_ms'):.4f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
