"""LM substrate of the port: config, functional layers, model assembly."""
from .config import ModelConfig
from .transformer import (check_train, decode_step, encode, forward,
                          init_cache, init_model, init_paged_cache,
                          init_train_state, paged_copy_block,
                          paged_decode_step, paged_prefill_chunk,
                          paged_prefill_step, prefill)

__all__ = [
    "ModelConfig", "check_train", "decode_step", "encode", "forward",
    "init_cache", "init_model", "init_paged_cache", "init_train_state",
    "paged_copy_block", "paged_decode_step", "paged_prefill_chunk",
    "paged_prefill_step", "prefill",
]
