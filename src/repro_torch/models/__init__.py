"""LM substrate of the port: config, functional layers, model assembly."""
from .config import ModelConfig
from .transformer import (forward, init_model, init_paged_cache,
                          paged_copy_block, paged_decode_step,
                          paged_prefill_chunk)

__all__ = [
    "ModelConfig", "forward", "init_model", "init_paged_cache",
    "paged_copy_block", "paged_decode_step", "paged_prefill_chunk",
]
