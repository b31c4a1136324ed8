"""Yi-6B — llama-architecture dense GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    layers=32, d_model=4096, heads=32, kv_heads=4, d_ff=11008, vocab=64000,
)

SMOKE = ModelConfig(
    name="yi-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=160, vocab=256,
)
