"""Whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.  The conv frontend is a
STUB per the task spec: ``input_specs()`` supplies precomputed 1500-frame
encoder embeddings; the transformer backbone (32 enc + 32 dec layers with
cross-attention) is fully implemented.
"""
from ..models.config import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    layers=32, d_model=1280, heads=20, kv_heads=20, d_ff=5120, vocab=51866,
    encoder=EncoderConfig(layers=32, seq_len=1500),
    frontend="stub",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    layers=2, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=256,
    encoder=EncoderConfig(layers=2, seq_len=32),
    frontend="stub",
)
