"""Chameleon-34B — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Early fusion means
image patches arrive as discrete VQ tokens in the same vocabulary — the VQ
tokenizer is the stubbed frontend; the backbone is a standard dense LM.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    layers=48, d_model=8192, heads=64, kv_heads=8, d_ff=22016, vocab=65536,
    frontend="stub",
    remat="full",
)

SMOKE = ModelConfig(
    name="chameleon-smoke",
    layers=2, d_model=64, heads=4, kv_heads=2, d_ff=192, vocab=256,
    frontend="stub",
)
