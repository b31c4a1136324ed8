"""Mamba2-130M — attention-free SSD [arXiv:2405.21060].

24L d_model=768 vocab=50280, ssm_state=128.  expand=2 -> d_inner=1536,
head_dim=64 -> 24 SSD heads.  The paper's attention-blocking technique is
inapplicable (no attention); the comprehensive tree instead drives the SSD
scan kernel (K3, ``ssd_scan_h100``).
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    layers=24, d_model=768, heads=12, kv_heads=12, d_ff=0, vocab=50280,
    block="ssm",
    ssm=SSMConfig(state=128, heads=24, head_dim=64, chunk=128),
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    layers=2, d_model=64, heads=4, kv_heads=4, d_ff=0, vocab=256,
    block="ssm",
    ssm=SSMConfig(state=16, heads=4, head_dim=16, chunk=16),
    subquadratic=True,
)
