"""Qwen1.5-4B — MHA with QKV bias, 152k vocab [hf:Qwen/Qwen1.5-0.5B; hf].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    layers=40, d_model=2560, heads=20, kv_heads=20, d_ff=6912, vocab=151936,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen-smoke",
    layers=2, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=512,
    qkv_bias=True,
)
