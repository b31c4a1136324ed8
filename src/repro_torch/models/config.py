"""Model / run configuration for every assigned architecture."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    state: int
    heads: int            # SSD heads (d_model // head_dim)
    head_dim: int
    chunk: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    layers: int
    seq_len: int          # fixed frontend frames (whisper: 1500)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None           # default d_model // heads
    block: str = "attn_mlp"                  # attn_mlp | attn_moe | ssm | hybrid
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None  # enc-dec (whisper)
    window: Optional[int] = None             # sliding-window attention (hybrid)
    qkv_bias: bool = False                   # qwen-style
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # storage dtype of >=2D weights; "bfloat16" for the 1T MoE, where f32
    # masters cannot fit on 512x16GB (adafactor updates in f32 internally)
    param_dtype: str = "float32"
    # beyond-paper perf toggles (EXPERIMENTS.md §Perf); empty = the
    # paper-faithful baseline.  Known flags:
    #   attn_q_heads   — GQA computes on repeated query heads so the head
    #                    dim shards by nh (divisible by 16) instead of nk
    #   rope_compute   — rope cos/sin in compute dtype (bf16) not f32
    #   probs_bf16     — attention probabilities cast to compute dtype
    #                    after the f32 softmax, before the PV matmul
    perf_flags: Tuple[str, ...] = ()
    # long-context policy: "linear" archs may run the 500k decode cell
    subquadratic: bool = False
    # modality frontend: "none" (token ids) | "stub" (precomputed embeddings)
    frontend: str = "none"
    optimizer: str = "adamw"                 # adamw | adafactor (1T-scale)
    remat: str = "none"                      # none | full | dots

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.heads)

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.layers
        hd, nh, nk = self.hd, self.heads, self.kv_heads
        attn = d * nh * hd + 2 * d * nk * hd + nh * hd * d
        mlp = 3 * d * f                                       # SwiGLU
        if self.block in ("attn_moe",) and self.moe:
            mlp = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            proj = d * s.heads * s.head_dim                   # x proj
            bc = 2 * d * s.state                              # B, C (shared)
            out = s.heads * s.head_dim * d
            ssm = proj + bc + out + d * s.heads + s.heads     # + decay proj
        per_layer = {
            "attn_mlp": attn + mlp,
            "attn_moe": attn + mlp,
            "ssm": ssm + 3 * d * f if f else ssm,
            "hybrid": attn + ssm + mlp,
        }[self.block]
        emb = v * d * 2                                       # in + out (untied)
        enc = 0
        if self.encoder is not None:
            enc = self.encoder.layers * (attn + 3 * d * f + attn)  # + cross
        return emb + L * per_layer + enc

    def active_param_count(self) -> int:
        """MoE: only routed experts count toward per-token FLOPs."""
        if self.block != "attn_moe" or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.layers
        dense = self.param_count() - L * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        return dense + L * self.moe.top_k * 3 * d * self.moe.d_ff_expert


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
