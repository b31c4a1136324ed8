"""Compile the port's comprehensive-optimization artifacts offline.

Builds the case-discussion tree of each of the port's kernel families,
serializes it, and emits per-machine dispatch tables with pre-ranked
candidates per data-shape bucket.  At load time the port's dispatch cache
resolves a kernel variant with a table lookup instead of a tree search
(set ``REPRO_ARTIFACT_DIR`` or run from the directory holding
``artifacts/``).

    PYTHONPATH=src python -m repro_torch.launch.compile_artifacts      # all
    PYTHONPATH=src python -m repro_torch.launch.compile_artifacts \\
        --family matmul_h100 --machine h100_sxm --out artifacts --verify

``--machine`` defaults to ``h100_sxm`` and ``paper_m2050``; ``--quick``
compiles one data-shape bucket a family; ``--verify`` reloads each tree
and checks it leaf for leaf against a fresh build.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.artifacts import ArtifactStore, compile_all
from repro_torch.artifacts.compile import registered_families
from repro_torch.core.comprehensive import comprehensive_optimization
from repro_torch.core.params import MACHINES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", action="append", default=None,
                    help="kernel family to compile (repeatable; default "
                         "all seven)")
    ap.add_argument("--machine", action="append", default=None,
                    choices=sorted(MACHINES),
                    help="target machine (repeatable; default h100_sxm and "
                         "paper_m2050)")
    ap.add_argument("--out", default=None,
                    help="artifact root (default: $REPRO_ARTIFACT_DIR "
                         "or ./artifacts)")
    ap.add_argument("--top-k", type=int, default=8,
                    help="pre-ranked candidates kept per data-shape bucket")
    ap.add_argument("--quick", action="store_true",
                    help="one data-shape bucket per family (a smoke)")
    ap.add_argument("--verify", action="store_true",
                    help="reload each tree and check leaf-for-leaf equality "
                         "against a fresh in-process build")
    args = ap.parse_args(argv)

    store = ArtifactStore(args.out)
    machines = ([MACHINES[m] for m in args.machine] if args.machine else None)
    try:
        reports = compile_all(store, families=args.family, machines=machines,
                              top_k=args.top_k, quick=args.quick)
    except KeyError as e:
        ap.error(str(e.args[0] if e.args else e))

    failures = 0
    for rep in reports:
        line = (f"[OK] {rep['family']}: {rep['leaves']} leaves "
                f"digest={rep['tree_digest']} ({rep['seconds']}s)")
        for mname, d in rep["dispatch"].items():
            line += (f"\n     {mname}: {d['kept_leaves']} leaves, "
                     f"{d['buckets']} buckets -> {d['path']}")
        print(line, flush=True)
        if args.verify:
            family = registered_families()[rep["family"]]
            reloaded = store.load_tree(rep["family"])
            fresh = comprehensive_optimization(family)
            if reloaded is None or reloaded != fresh:
                print(f"[VERIFY FAIL] {rep['family']}: reloaded tree != "
                      f"fresh build", file=sys.stderr)
                failures += 1
            else:
                print(f"     verify: reloaded == fresh "
                      f"({len(reloaded)} leaves)")
    print(f"compiled {len(reports)} families into {store.root}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
