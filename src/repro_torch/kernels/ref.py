"""PyTorch oracles for the port's kernel families.

The semantic ground truth the kernels and their plain versions are held
against (code soundness, paper Def. 2 ii): ports of ``matmul`` and
``flash_attention`` in the JAX package's ``kernels/ref.py``, held against
those on the CPU by ``tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation (paper Fig. 3/4)."""
    return (a.float() @ b.float()).to(out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention oracle.  q, k, v: [heads, seq, head_dim]; ends
    aligned (query i sits at key position i + sk - sq)."""
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    logits = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    sq, sk = q.shape[-2], k.shape[-2]
    idx_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    idx_k = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx_k <= idx_q
    if window is not None:
        mask &= idx_k > (idx_q - window)
    logits = logits.masked_fill(~mask[None], -math.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", probs, v.float()).to(q.dtype)
