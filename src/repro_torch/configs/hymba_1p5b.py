"""Hymba-1.5B — hybrid parallel attention + Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hybrid block: attention and SSD paths run in parallel on the same input and
their outputs are summed (the paper's "parallel heads").  Sliding-window
attention (1k) keeps the attention path sub-quadratic for long_500k.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    layers=32, d_model=1600, heads=25, kv_heads=5, d_ff=5504, vocab=32001,
    head_dim=64,
    block="hybrid",
    ssm=SSMConfig(state=16, heads=25, head_dim=64, chunk=128),
    window=1024,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=256,
    head_dim=16,
    block="hybrid",
    ssm=SSMConfig(state=8, heads=4, head_dim=16, chunk=16),
    window=32,
    subquadratic=True,
)
