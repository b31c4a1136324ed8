"""Filesystem artifact store: where compiled case discussions live.

Layout (all JSON, canonical bytes from :mod:`repro_torch.artifacts.serde`):

    <root>/<family>/tree-v<V>-<axioms_key>.json
    <root>/<family>/dispatch-v<V>-<machine>.json

``root`` resolution: explicit argument > ``REPRO_ARTIFACT_DIR`` env var >
``./artifacts``.  Loads are forgiving by design — a missing file, unreadable
JSON, or a format-version mismatch all return ``None`` (cache miss, caller
rebuilds); only writes raise.  That is the version policy the format needs:
old runtimes keep working against new trees by rebuilding, never by crashing.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

from ..core.constraints import Constraint
from ..core.plan import Leaf
# chaos-drill hooks only: repro_torch.runtime.faults is torch-free and its site
# checks cost one module-global load when no injector is armed
from ..runtime import faults
from . import serde

_ENV_ROOT = "REPRO_ARTIFACT_DIR"
_DEFAULT_ROOT = "artifacts"


def atomic_write_text(path: Path, text: str) -> Path:
    """Write via mkstemp + rename so a concurrent reader never sees a torn
    artifact (shared by every artifact store, incl. repro_torch.plans)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def read_json_dict(path: Path,
                   fault_site: str = "artifact.read"
                   ) -> Optional[Dict[str, Any]]:
    """Forgiving read: a missing file, unreadable JSON, or a non-dict
    payload returns ``None`` (cache miss), never raises.

    ``fault_site`` names this read for the chaos drills
    (:mod:`repro_torch.runtime.faults`): an armed injector can raise an I/O
    failure mid-open or corrupt the bytes before parsing (torn truncation /
    NUL garbling).  Both land inside the ``except`` below — the drills
    *prove* the forgiving-read policy rather than bypass it.  Only a
    :class:`~repro_torch.runtime.faults.FatalFault` escapes, by design."""
    try:
        with open(path) as f:
            text = f.read()
        # the one injection hook: raising kinds (io) raise from inside it,
        # byte kinds (torn/garble) mangle the text before parsing
        payload = json.loads(faults.corrupt_text(fault_site, text))
    except faults.FatalFault:
        raise
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


class ArtifactStore:
    def __init__(self, root: str | os.PathLike | None = None):
        self.root = Path(root or os.environ.get(_ENV_ROOT, _DEFAULT_ROOT))

    # -- paths ---------------------------------------------------------------
    def tree_path(self, family_name: str,
                  axioms: Sequence[Constraint] = ()) -> Path:
        key = serde.axioms_key(axioms)
        return (self.root / family_name /
                f"tree-v{serde.FORMAT_VERSION}-{key}.json")

    def dispatch_path(self, family_name: str, machine_name: str) -> Path:
        return (self.root / family_name /
                f"dispatch-v{serde.FORMAT_VERSION}-{machine_name}.json")

    # -- low-level IO --------------------------------------------------------
    def _write(self, path: Path, payload: Mapping[str, Any]) -> Path:
        return atomic_write_text(path, serde.dumps(payload))

    def _read(self, path: Path) -> Optional[Dict[str, Any]]:
        payload = read_json_dict(path)
        if payload is None:
            return None
        if payload.get("format") != serde.FORMAT_VERSION:
            return None                      # version mismatch == cache miss
        return payload

    # -- trees ---------------------------------------------------------------
    def save_tree(self, family_name: str, leaves: Sequence[Leaf],
                  axioms: Sequence[Constraint] = ()) -> Path:
        payload = serde.tree_to_obj(family_name, leaves, axioms)
        return self._write(self.tree_path(family_name, axioms), payload)

    def load_tree(self, family_name: str,
                  axioms: Sequence[Constraint] = ()) -> Optional[List[Leaf]]:
        payload = self._read(self.tree_path(family_name, axioms))
        if payload is None or payload.get("kind") != "tree":
            return None
        try:
            return serde.obj_to_tree(payload)
        except (serde.ArtifactFormatError, KeyError, TypeError, ValueError):
            return None

    # -- dispatch tables -----------------------------------------------------
    def save_dispatch(self, payload: Mapping[str, Any]) -> Path:
        if payload.get("kind") != "dispatch":
            raise serde.ArtifactFormatError("payload is not a dispatch table")
        return self._write(
            self.dispatch_path(payload["family"], payload["machine"]), payload)

    def load_dispatch(self, family_name: str,
                      machine_name: str) -> Optional[Dict[str, Any]]:
        payload = self._read(self.dispatch_path(family_name, machine_name))
        if payload is None or payload.get("kind") != "dispatch":
            return None
        return payload

    def __repr__(self) -> str:
        return f"ArtifactStore({str(self.root)!r})"
