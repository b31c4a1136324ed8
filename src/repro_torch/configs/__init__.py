"""Architecture registry of the port: one module per arch (``--arch <id>``).

Each module exports ``CONFIG`` (the published configuration) and ``SMOKE``
(a reduced same-family configuration for CPU tests).  This slice of the port
serves the dense ``attn_mlp`` block, so only llama3-8b is registered; the
JAX package's other nine configs join with the slices that port their
blocks.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCH_IDS = (
    "llama3_8b",
)

# canonical external ids -> module names
ALIASES = {
    "llama3-8b": "llama3_8b",
}


def _module(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported yet (ported: "
                         f"{', '.join(ARCH_IDS)})")
    return importlib.import_module(f".{mod_name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
