"""Gradients through the port's kernels: ``torch.autograd.Function``s whose
forward and backward are kernels of the port.

The JAX package differentiates einsum math (ROADMAP F3); the port's forward
launches K1, K2 and K3 through ``ctypes``, which autograd cannot see, and a
plain version never runs on a CUDA tensor.  So:

- :class:`MatmulFn`: C = A·B through K1 (f32 out); its backward is K1
  again, dA = dC·Bᵀ and dB = Aᵀ·dC, with each transposed operand made by K4
  (``transpose_h100``, bit-exact).  K1 takes two operands of one type, so
  dC is cast to the operands' type first, as the JAX bf16 einsum's
  cotangent is bf16; the gradients come back in the operands' type.
- :class:`BatchedMatmulFn`: C[e] = A[e]·B[e] for every expert e, one
  launch (``ops.matmul_batched``).  In bf16 that is K1b
  (``matmul_experts_h100``, bf16 out) and its backward is K1b again, dA[e]
  = dC[e]·B[e]ᵀ and dB[e] = Aᵀ[e]·dC[e], each one launch reading the
  stored B or A transposed in place (``tb`` / ``ta``): no copy, no cast.
  In f32 it is K1's batched entry (f32 out) and the backward's transposed
  operands are copies by K4's batched entry inside the op, as the 2-D
  :class:`MatmulFn` has it; the gradients come back in the operands'
  types (the output's, as C has them).
- :class:`AttentionFn`: K2's paged entry over a batch's K/V read as a pool
  of one block a row (the table ``[[b]]``); it saves q, k, v, o and the
  lengths, and its backward is K2b (``flash_attention_bwd_h100``).  A real
  paged pool (any other table) is refused: K2b reads the rows' own K/V.
- :class:`SsdScanFn`: K3 (``ops.ssd_scan``) from a state (None is zero),
  returning (y, final state); it saves x, a, b, c and the state, and its
  backward is K3b (``ssd_scan_bwd_h100``), which recomputes the states
  entering each chunk.  The serve-only in-place updates (``out_state``,
  ``mask``, ``state_rows``) are refused.

On CPU tensors the same functions run the kernels' plain versions, as every
wrapper does.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ops


class MatmulFn(torch.autograd.Function):
    """C[M, N] = A[M, K]·B[K, N] in f32 (K1), differentiable."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return ops.matmul(a, b)

    @staticmethod
    def backward(ctx, dc: torch.Tensor):
        a, b = ctx.saved_tensors
        dc = dc.to(a.dtype).contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ops.matmul(dc, ops.transpose(b)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = ops.matmul(ops.transpose(a), dc).to(b.dtype)
        return da, db


class BatchedMatmulFn(torch.autograd.Function):
    """C[E, M, N] = A[E, M, K]·B[E, K, N] (``ops.matmul_batched``: K1b in
    bf16, K1's batched entry in f32), differentiable."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return ops.matmul_batched(a, b)

    @staticmethod
    def backward(ctx, dc: torch.Tensor):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ops.matmul_batched(dc, b, tb=True)
        if ctx.needs_input_grad[1]:
            db = ops.matmul_batched(a, dc, ta=True)
        return da, db


def _identity_tables(rows: int, device) -> torch.Tensor:
    return torch.arange(rows, dtype=torch.int32, device=device)[:, None]


class AttentionFn(torch.autograd.Function):
    """K2 over q [rows, h, sq, d] and each row's own K/V k, v [rows, page,
    hk, d] up to its length ``lens`` [rows] (int32, on the device), queries
    ends-aligned; the backward is K2b.  ``tables`` None is the table
    ``[[b]]``; a table given is checked to be it (one host read), and any
    other, a paged pool K2b cannot differentiate, raises."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                tables: Optional[torch.Tensor], lens: torch.Tensor,
                causal: bool, window: Optional[int]) -> torch.Tensor:
        rows = q.shape[0]
        if tables is not None and (
                tuple(tables.shape) != (rows, 1) or k.shape[0] != rows
                or not torch.equal(tables.cpu(),
                                   _identity_tables(rows, "cpu"))):
            raise ValueError("attention backward takes a pool of one block "
                             "a row (the table [[b]]); a paged pool has no "
                             "backward")
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"attention backward needs q, k, v of one "
                            f"type: {q.dtype}, {k.dtype}, {v.dtype}")
        o = ops.paged_attention(q, k, v, _identity_tables(rows, q.device),
                                lens, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lens)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, o, lens = ctx.saved_tensors
        dq, dk, dv = ops.attention_bwd(q, k, v, o, do.contiguous(), lens,
                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


class SsdScanFn(torch.autograd.Function):
    """K3 over x [rows, seq, heads, hd], a [rows, seq, heads] f32, b, c
    [rows, seq, state] (shared across heads) or [rows, seq, heads, state],
    from ``state0`` [rows, heads, state, hd] f32 or None (zero); returns (y,
    final state).  The backward is K3b, given dy and the final state's
    gradient (zero when it has none); it returns dx, da, db, dc and
    d(state0) in the inputs' types and shapes.  ``out_state``, ``mask``
    and ``state_rows``, the serve path's in-place updates of an engine's
    cache, have no backward and raise."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, state0: Optional[torch.Tensor],
                out_state: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                state_rows: Optional[torch.Tensor] = None):
        if out_state is not None or mask is not None \
                or state_rows is not None:
            raise ValueError("the SSD scan's backward takes no out_state, "
                             "mask or state_rows: they update a serving "
                             "cache in place and have no backward")
        y, s = ops.ssd_scan(x, a, b, c, state0)
        ctx.save_for_backward(x, a, b, c, state0)
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor],
                 ds: Optional[torch.Tensor]):
        x, a, b, c, state0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        ds = None if ds is None else ds.contiguous()
        dx, da, db, dc, ds0 = ops.ssd_scan_bwd(x, a, b, c, state0, dy, ds)
        return dx, da, db, dc, ds0, None, None, None
