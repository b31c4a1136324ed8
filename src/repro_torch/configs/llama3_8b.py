"""Llama-3-8B — dense GQA, 128k vocab [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    layers=32, d_model=4096, heads=32, kv_heads=8, d_ff=14336, vocab=128256,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=192, vocab=512,
)
