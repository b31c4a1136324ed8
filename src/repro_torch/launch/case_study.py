"""The paper's §5 experiments as case discussions, for the port's families.

    PYTHONPATH=src python -m repro_torch.launch.case_study

Prints the comprehensive optimization (the cases of the tree and the plan
each machine picks) of the paper's four test problems — matrix addition
(Fig. 2), matmul (Fig. 3/4, Table 1), 1D Jacobi (Fig. 7, Table 2) and
matrix transposition (Fig. 8, Table 3) — under ``H100_SXM`` and
``PAPER_M2050``, at the sizes of ``examples/paper_case_study.py``, then the
Table-1 analogue: the best three matmul variants at n = 2^10 and 2^11 by
the offline model.  Symbolic only: no device, no kernel launch.
"""
from __future__ import annotations

from typing import List

from repro_torch.core import (H100_SXM, PAPER_M2050, case_table,
                              comprehensive_tree, enumerate_candidates,
                              tree_report)
from repro_torch.kernels.jacobi1d import FAMILY as JACOBI
from repro_torch.kernels.matadd import FAMILY as MATADD
from repro_torch.kernels.matmul import FAMILY as MATMUL
from repro_torch.kernels.transpose import FAMILY as TRANSPOSE

MACHINES = (H100_SXM, PAPER_M2050)
# The Jacobi size is keyed on N alone: the JAX benchmark also passed the
# step count as "T" (benchmarks/run.py), which in the port names the
# machine's threads a block, and select refuses a data key that names a
# machine symbol.
CASES = (
    (MATADD, [{"M": 1 << 10, "N": 1 << 10}, {"M": 1 << 13, "N": 1 << 13}]),
    (MATMUL, [{"M": 1 << 10, "N": 1 << 10, "K": 1 << 10},
              {"M": 1 << 11, "N": 1 << 11, "K": 1 << 11}]),   # Table 1
    (JACOBI, [{"N": (1 << 15) + 2}]),                          # Table 2
    (TRANSPOSE, [{"M": 1 << 14, "N": 1 << 14}]),               # Table 3
)


def report() -> List[str]:
    lines = []
    for family, datasets in CASES:
        leaves = comprehensive_tree(family)
        lines.append("=" * 72)
        lines.append(f"{family.name}: {len(leaves)} cases in the "
                     f"comprehensive tree")
        lines.append(tree_report(leaves[:2]))
        lines.append("  ...")
        for machine in MACHINES:
            for data, cand in case_table(family, machine, datasets):
                lines.append(f"  {machine.name} input {data} -> "
                             f"{cand.describe()}")
    lines.append("=" * 72)
    lines.append("Paper Table-1 analogue: best matmul variant shifts with "
                 f"input size ({H100_SXM.name})")
    for n in (1 << 10, 1 << 11):
        cands = enumerate_candidates(MATMUL, H100_SXM, {"M": n, "N": n,
                                                        "K": n})
        cands.sort(key=lambda c: c.score, reverse=True)
        lines.append(f"  n=2^{n.bit_length() - 1}: "
                     + " | ".join(c.describe() for c in cands[:3]))
    return lines


def main() -> None:
    print("\n".join(report()))


if __name__ == "__main__":
    main()
