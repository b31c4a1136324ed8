"""Comprehensive optimization of parametric kernels (the paper's contribution).

Public API:

- :mod:`repro_torch.core.polynomial`    — exact multivariate polynomials over Q
- :mod:`repro_torch.core.compiled`      — compiled batch evaluation (NumPy) of
  polynomials and specialized constraint systems
- :mod:`repro_torch.core.constraints`   — semi-algebraic systems + consistency
- :mod:`repro_torch.core.params`        — machine/program/data parameter symbols
- :mod:`repro_torch.core.plan`          — kernel plans + the optimization quintuple
- :mod:`repro_torch.core.counters`      — resource/performance counters (f_i, g_i)
- :mod:`repro_torch.core.strategies`    — optimization strategies O_1..O_w
- :mod:`repro_torch.core.comprehensive` — Algorithms 1 & 2 (the decision tree)
- :mod:`repro_torch.core.select`        — load-time leaf selection + auto-tuning
"""
from .polynomial import Poly, V
from .compiled import CompiledPoly, CompiledSystem, specialize_system
from .constraints import (Constraint, ConstraintSystem, Rel, Verdict,
                          is_integer_var)
from .params import (MachineDescription, MACHINES, TPU_V5E, PAPER_M2050, H100_SXM,
                     ParamKind, ParamSymbol)
from .plan import FamilySpec, KernelPlan, Leaf, ParamDomain, Quintuple
from .counters import Counter, CounterKind, performance, resource
from .strategies import Strategy, level_strategy, toggle_strategy
from .comprehensive import (comprehensive_optimization, comprehensive_tree,
                            initial_quintuple, optimize, tree_report)
from .select import (STATS, Candidate, SelectStats, best_variant, case_table,
                     enumerate_candidates, rank_candidates)

__all__ = [
    "Poly", "V", "CompiledPoly", "CompiledSystem", "specialize_system",
    "Constraint", "ConstraintSystem", "Rel", "Verdict", "is_integer_var",
    "MachineDescription", "MACHINES", "TPU_V5E", "PAPER_M2050", "H100_SXM",
    "ParamKind", "ParamSymbol", "FamilySpec", "KernelPlan", "Leaf",
    "ParamDomain", "Quintuple", "Counter", "CounterKind", "performance",
    "resource", "Strategy", "level_strategy", "toggle_strategy",
    "comprehensive_optimization", "comprehensive_tree", "initial_quintuple",
    "optimize", "tree_report", "Candidate", "best_variant", "case_table",
    "enumerate_candidates", "rank_candidates", "SelectStats", "STATS",
]
