"""Persistent case-discussion artifacts of the port (the paper's
offline/online split).

- :mod:`repro_torch.artifacts.serde`    — versioned deterministic
  serialization of the core objects (a copy of the JAX package's)
- :mod:`repro_torch.artifacts.store`    — filesystem layout + forgiving
  loads (a copy)
- :mod:`repro_torch.artifacts.compile`  — offline compiler for the port's
  families (``python -m repro_torch.launch.compile_artifacts``)
- :mod:`repro_torch.artifacts.dispatch` — runtime ``DispatchCache``: frozen
  plan fast lane -> memory LRU -> disk artifact -> cold rebuild, with
  demotion down the ranking
"""
from .serde import FORMAT_VERSION, ArtifactFormatError
from .store import ArtifactStore
from .dispatch import (DegradeEvent, DispatchCache, DispatchRecord,
                       DispatchStats, FrozenDispatchPlan, FrozenEntry,
                       bucket_key, cand_key, frozen_key, get_default_cache,
                       set_default_cache)
from .compile import (DEFAULT_DATA_GRIDS, DEFAULT_MACHINES,
                      build_dispatch_table, compile_all, compile_family)

__all__ = [
    "FORMAT_VERSION", "ArtifactFormatError", "ArtifactStore",
    "DegradeEvent", "DispatchCache", "DispatchRecord", "DispatchStats",
    "FrozenDispatchPlan", "FrozenEntry", "bucket_key", "cand_key",
    "frozen_key", "get_default_cache", "set_default_cache",
    "DEFAULT_DATA_GRIDS", "DEFAULT_MACHINES", "build_dispatch_table",
    "compile_all", "compile_family",
]
