"""Architecture registry of the port: one module per arch (``--arch <id>``).

Each module exports ``CONFIG`` (the published configuration) and ``SMOKE``
(a reduced same-family configuration for CPU tests).  The port serves the
dense ``attn_mlp``, the mixture-of-experts ``attn_moe``, the attention-free
``ssm`` and the ``hybrid`` blocks and the whisper encoder-decoder, so every
config of the JAX package is registered.  Whisper, as in the JAX package,
is served through the non-paged steps (``runtime.steps.build_serve_steps``),
not the engine.
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCH_IDS = (
    "llama3_8b",
    "mamba2_130m",
    "hymba_1p5b",
    "granite_3_8b",
    "yi_6b",
    "qwen1p5_4b",
    "chameleon_34b",
    "llama4_scout_17b_a16e",
    "kimi_k2_1t_a32b",
    "whisper_large_v3",
)

# canonical external ids -> module names
ALIASES = {
    "llama3-8b": "llama3_8b",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1p5b",
    "granite-3-8b": "granite_3_8b",
    "yi-6b": "yi_6b",
    "qwen1.5-4b": "qwen1p5_4b",
    "chameleon-34b": "chameleon_34b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-large-v3": "whisper_large_v3",
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
