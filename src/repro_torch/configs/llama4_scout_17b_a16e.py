"""Llama-4-Scout 17B-A16E — MoE top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, MoE 16e top-1.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    layers=48, d_model=5120, heads=40, kv_heads=8, d_ff=8192, vocab=202048,
    head_dim=128,
    block="attn_moe",
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192),
    remat="full",
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=256,
    head_dim=16,
    block="attn_moe",
    moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128),
)
