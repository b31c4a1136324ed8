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

from typing import Mapping, Optional

import torch

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..core.select import Candidate
from .flash_attention import FAMILY as FLASH_FAMILY
from .matmul import FAMILY as MATMUL_FAMILY

FAMILIES = {f.name: f for f in (MATMUL_FAMILY, FLASH_FAMILY)}


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """Attention over q [h, sq, d], k, v [h, sk, d], ends aligned (K2)."""
    h, sq, d = q.shape
    fn = get_default_cache().warm_callable(
        FLASH_FAMILY, machine, (("SQ", sq), ("HD", d)), q.device.type)
    return fn(q, k, v, causal=causal, window=window)
