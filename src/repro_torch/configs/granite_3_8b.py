"""Granite-3 8B — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    layers=40, d_model=4096, heads=32, kv_heads=8, d_ff=12800, vocab=49155,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=160, vocab=256,
)
