"""PyTorch oracles for the port's kernel families.

The semantic ground truth the kernels and their plain versions are held
against (code soundness, paper Def. 2 ii): ports of the six oracles in the
JAX package's ``kernels/ref.py``, held against those on the CPU by
``tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation (paper Fig. 3/4)."""
    return (a.float() @ b.float()).to(out_dtype)


def matadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A + B (paper Fig. 1/2)."""
    return a + b


def jacobi1d(a: torch.Tensor, steps: int) -> torch.Tensor:
    """1D Jacobi with fixed boundary (paper Fig. 7).

    ``a`` has length n; interior points are averaged over the 3-stencil for
    ``steps`` time iterations; boundary values stay fixed.  The left sum
    comes first, then a true division by 3, as in the JAX oracle.  The 3 is
    a tensor on a's device: PyTorch's CUDA kernel for a division by a
    Python or CPU scalar multiplies by its reciprocal, which can round one
    bit apart from the IEEE division."""
    three = torch.tensor(3.0, dtype=a.dtype, device=a.device)
    for _ in range(steps):
        nxt = a.clone()
        nxt[1:-1] = (a[:-2] + a[1:-1] + a[2:]) / three
        a = nxt
    return a


def transpose(a: torch.Tensor) -> torch.Tensor:
    """B = A^T (paper Fig. 8)."""
    return a.t()


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


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD sequential oracle, from a zero state.

    x: [seq, heads, head_dim]; a: [seq, heads], the per-step decay itself,
    in (0, 1) (the JAX docstring calls it a log-decay, its code uses it as
    the decay: ROADMAP F2); b, c: [seq, heads, state].
    Per head: S_t = a_t * S_{t-1} + b_t ⊗ x_t;  y_t = c_t · S_t.
    """
    seq, heads, hd = x.shape
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    S = torch.zeros((heads, b.shape[-1], hd), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(seq):
        S = af[t][:, None, None] * S + torch.einsum("hs,hd->hsd", bf[t],
                                                    xf[t])
        ys.append(torch.einsum("hs,hsd->hd", cf[t], S))
    return torch.stack(ys).to(x.dtype)
