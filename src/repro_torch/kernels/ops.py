"""Public op wrappers: every call goes through the comprehensive tree.

Each op builds its data mapping as an items tuple and calls
``DispatchCache.warm_callable`` with the device type of its operands — one
lock-free dict lookup returning the pre-built callable when the triple was
frozen (``DispatchCache.freeze``, fed by serving warm-up), else a locked LRU
(or cold) resolve plus the family's memoized ``instantiate``.  On ``"cuda"``
the callable launches the hand-written kernel or raises; on ``"cpu"`` it
runs the kernel's plain version.  The *selection* (which leaf, which block
sizes) does not depend on the device, so the CPU tests exercise the same
decision path the card takes.  The default machine is ``H100_SXM``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..core.select import Candidate
from .flash_attention import FAMILY as FLASH_FAMILY
from .jacobi1d import FAMILY as JACOBI_FAMILY
from .matadd import FAMILY as MATADD_FAMILY
from .matmul import FAMILY as MATMUL_FAMILY
from .ssd_scan import FAMILY as SSD_FAMILY
from .transpose import FAMILY as TRANSPOSE_FAMILY

FAMILIES = {f.name: f for f in (MATMUL_FAMILY, MATADD_FAMILY, JACOBI_FAMILY,
                                TRANSPOSE_FAMILY, FLASH_FAMILY, SSD_FAMILY)}


def select(family_name: str, data: Mapping[str, int],
           machine: MachineDescription = H100_SXM) -> Candidate:
    """Resolve the kernel variant through the process-wide DispatchCache."""
    return get_default_cache().best_variant(FAMILIES[family_name], machine,
                                            data)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] in f32 (K1)."""
    M, K = a.shape
    N = b.shape[1]
    fn = get_default_cache().warm_callable(
        MATMUL_FAMILY, machine, (("M", M), ("N", N), ("K", K)), a.device.type)
    return fn(a, b)


def matadd(a: torch.Tensor, b: torch.Tensor, *,
           machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """C = A + B over [M, N], f32 or bf16 (K5)."""
    M, N = a.shape
    fn = get_default_cache().warm_callable(
        MATADD_FAMILY, machine, (("M", M), ("N", N)), a.device.type)
    return fn(a, b)


def jacobi1d(x: torch.Tensor, steps: int, *,
             machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """``steps`` sweeps of the 1D Jacobi stencil over the f32 vector x, ends
    fixed (K6), keyed on N alone as the JAX op is."""
    (n,) = x.shape
    fn = get_default_cache().warm_callable(
        JACOBI_FAMILY, machine, (("N", n),), x.device.type)
    return fn(x, steps)


def transpose(a: torch.Tensor, *,
              machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """B = Aᵀ as a new [N, M] tensor, bit-exact (K4)."""
    M, N = a.shape
    fn = get_default_cache().warm_callable(
        TRANSPOSE_FAMILY, machine, (("M", M), ("N", N)), a.device.type)
    return fn(a)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """Attention over q [h, sq, d], k, v [h, sk, d], ends aligned (K2)."""
    h, sq, d = q.shape
    fn = get_default_cache().warm_callable(
        FLASH_FAMILY, machine, (("SQ", sq), ("HD", d)), q.device.type)
    return fn(q, k, v, causal=causal, window=window)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
             machine: MachineDescription = H100_SXM
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the Mamba-2 SSD scan (K3), keyed on (SQ, HD,
    STATE).  x [seq, heads, hd], a [seq, heads], b, c [seq, heads, state]
    and state0 [heads, state, hd] as in the JAX op, or each with a leading
    rows dim (b, c then also [rows, seq, state], shared across heads)."""
    unbatched = x.dim() == 3
    if unbatched:
        x, a, b, c = x[None], a[None], b[None], c[None]
        state0 = state0[None] if state0 is not None else None
    seq, hd, state = x.shape[1], x.shape[3], b.shape[-1]
    fn = get_default_cache().warm_callable(
        SSD_FAMILY, machine, (("SQ", seq), ("HD", hd), ("STATE", state)),
        x.device.type)
    y, s = fn(x, a, b, c, state0)
    return (y[0], s[0]) if unbatched else (y, s)
