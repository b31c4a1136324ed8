"""Filesystem store for serve-plan artifacts.

Layout (canonical bytes from :mod:`repro_torch.plans.serde`):

    <root>/plans/<config>/serve-v<V>-<machine>.json

``root`` resolution matches the dispatch artifacts (explicit argument >
``REPRO_ARTIFACT_DIR`` env var > ``./artifacts``) so a deployment ships one
directory: dispatch tables, trees, and serve plans travel together to every
host of the mesh.  Loads are forgiving by design — missing file, unreadable
JSON, version mismatch, or a mangled payload all return ``None`` (cache
miss: the engine falls back to online warm-up); only writes raise.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..artifacts.serde import ArtifactFormatError
# one source of truth for the root-resolution rule and the atomic-write /
# forgiving-read machinery: serve plans live under the same root and follow
# the same IO discipline as trees/dispatch tables
from ..artifacts.store import (_DEFAULT_ROOT, _ENV_ROOT, atomic_write_text,
                               read_json_dict)
from . import serde


class PlanStore:
    def __init__(self, root: str | os.PathLike | None = None):
        self.root = Path(root or os.environ.get(_ENV_ROOT, _DEFAULT_ROOT))

    def plan_path(self, config_name: str, machine_name: str) -> Path:
        return (self.root / "plans" / config_name /
                f"serve-v{serde.PLAN_FORMAT_VERSION}-{machine_name}.json")

    def save_plan(self, plan: serde.ServePlan) -> Path:
        return atomic_write_text(self.plan_path(plan.config, plan.machine),
                                 serde.dumps(plan))

    def load_plan(self, config_name: str,
                  machine_name: str) -> Optional[serde.ServePlan]:
        payload = read_json_dict(self.plan_path(config_name, machine_name),
                                 fault_site="plan.read")
        if payload is None:
            return None
        try:
            return serde.obj_to_plan(payload)
        except (ArtifactFormatError, AttributeError, KeyError, TypeError,
                ValueError):
            return None                      # mangled/stale == cache miss

    def __repr__(self) -> str:
        return f"PlanStore({str(self.root)!r})"


def resolve_env_store() -> Optional[PlanStore]:
    """The environment-resolved store, or ``None`` when the artifact root
    does not exist (mirrors ``dispatch._resolve_env_store``)."""
    root = os.environ.get(_ENV_ROOT, _DEFAULT_ROOT)
    return PlanStore(root) if os.path.isdir(root) else None
