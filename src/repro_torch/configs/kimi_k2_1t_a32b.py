"""Kimi-K2 — trillion-parameter MoE (paper-table config) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8.  head_dim=128 (decoupled from d_model/heads).
Optimizer: adafactor — full-Adam states for 1T params do not fit 512x16GB;
this is a deliberate production decision recorded in DESIGN.md.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    layers=61, d_model=7168, heads=64, kv_heads=8, d_ff=2048, vocab=163840,
    head_dim=128,
    block="attn_moe",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048),
    optimizer="adafactor",
    remat="full",
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=96, vocab=256,
    head_dim=16,
    block="attn_moe",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96),
)
