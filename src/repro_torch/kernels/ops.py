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
from .flash_attention_bwd import FAMILY as FLASH_BWD_FAMILY
from .jacobi1d import FAMILY as JACOBI_FAMILY
from .matadd import FAMILY as MATADD_FAMILY
from .matmul import FAMILY as MATMUL_FAMILY
from .matmul_experts import FAMILY as EXPERTS_FAMILY, product_dims
from .ssd_scan import FAMILY as SSD_FAMILY
from .ssd_scan_bwd import FAMILY as SSD_BWD_FAMILY
from .transpose import FAMILY as TRANSPOSE_FAMILY

FAMILIES = {f.name: f for f in (MATMUL_FAMILY, MATADD_FAMILY, JACOBI_FAMILY,
                                TRANSPOSE_FAMILY, FLASH_FAMILY, SSD_FAMILY,
                                FLASH_BWD_FAMILY, SSD_BWD_FAMILY,
                                EXPERTS_FAMILY)}


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


def matmul_batched(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
                   tb: bool = False,
                   machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """C[e] = op(A[e]) @ op(B[e]) for every expert e, one launch: A [E, M,
    K] (or [E, K, M] with ``ta``), B [E, K, N] (or [E, N, K] with ``tb``).

    bf16 operands run K1b (``matmul_experts_h100``) keyed on the product's
    (E, M, N, K), which reads a transposed operand in place and returns
    bf16.  f32 operands run K1's batched entry through the pick of the
    per-expert key (M, N, K), the same frozen lane as :func:`matmul`, and
    return f32; ``ta`` / ``tb`` then copy the operand transposed by K4's
    batched entry first.  The branch is on the operands' type alone."""
    E, M, N, K = product_dims(a, b, ta, tb)
    cache = get_default_cache()
    if a.dtype == torch.bfloat16:
        fn = cache.warm_callable(
            EXPERTS_FAMILY, machine, (("E", E), ("M", M), ("N", N), ("K", K)),
            a.device.type)
        return fn(a, b, ta=ta, tb=tb)
    if ta:
        a = transpose_batched(a, machine=machine)
    if tb:
        b = transpose_batched(b, machine=machine)
    fn = cache.warm_callable(
        MATMUL_FAMILY, machine, (("M", M), ("N", N), ("K", K)), a.device.type)
    return fn.batched(a, b)


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


def transpose_batched(a: torch.Tensor, *,
                      machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """B[e] = A[e]ᵀ over A [E, M, N] as a new [E, N, M] tensor, bit-exact
    (K4's batched entry, one launch for every e), keyed on the per-expert
    (M, N) as :func:`transpose`, through the same frozen lane."""
    _, M, N = a.shape
    fn = get_default_cache().warm_callable(
        TRANSPOSE_FAMILY, machine, (("M", M), ("N", N)), a.device.type)
    return fn.batched(a)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """Attention over q [h, sq, d], k, v [hk, sk, d] (query head i reads KV
    head i // (h/hk)), ends aligned (K2), keyed on (SQ, HD, GROUP, HK):
    the number of key splits follows each call's own sk, so a decode step's
    growing cache keeps one key."""
    h, sq, d = q.shape
    hk = k.shape[0]
    fn = get_default_cache().warm_callable(
        FLASH_FAMILY, machine,
        (("SQ", sq), ("HD", d), ("GROUP", h // hk), ("HK", hk)),
        q.device.type)
    return fn(q, k, v, causal=causal, window=window)


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    machine: MachineDescription = H100_SXM) -> torch.Tensor:
    """Attention of q [rows, h, sq, d] over one layer's KV pools k, v
    [num_blocks, page, hk, d], read through the block tables [rows, nblk]
    (int32) up to each row's length ``lens`` [rows] (int32, on the device),
    queries ends-aligned at len − 1 (K2's paged entry, one launch for all
    rows).  Keyed on (SQ, HD, GROUP, HK) as :func:`flash_attention`, through
    the same frozen lane."""
    fn = get_default_cache().warm_callable(
        FLASH_FAMILY, machine, attention_key(q, k), q.device.type)
    return fn.paged(q, k, v, tables, lens, causal=causal, window=window)


def attention_key(q: torch.Tensor, k: torch.Tensor
                  ) -> Tuple[Tuple[str, int], ...]:
    """K2's and K2b's dispatch key of q [rows, h, sq, d] over a pool k
    [num_blocks, page, hk, d]: (SQ, HD, GROUP, HK)."""
    h, d = q.shape[1], q.shape[3]
    hk = k.shape[2]
    return (("SQ", q.shape[2]), ("HD", d), ("GROUP", h // hk), ("HK", hk))


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, lens: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  machine: MachineDescription = H100_SXM
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`paged_attention` over a pool of one block a
    row (the table ``[[b]]``): q, o, dO [rows, h, sq, d], k, v [rows, page,
    hk, d], ``lens`` [rows] int32 on the device (K2b), keyed on K2's (SQ,
    HD, GROUP, HK), through the same frozen lane."""
    fn = get_default_cache().warm_callable(
        FLASH_BWD_FAMILY, machine, attention_key(q, k), q.device.type)
    return fn(q, k, v, o, do, lens, causal=causal, window=window)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
             out_state: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None,
             state_rows: Optional[torch.Tensor] = None,
             machine: MachineDescription = H100_SXM
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the Mamba-2 SSD scan (K3), keyed on (SQ, HD,
    STATE).  x [seq, heads, hd], a [seq, heads], b, c [seq, heads, state]
    and state0 [heads, state, hd] as in the JAX op, or each with a leading
    rows dim (b, c then also [rows, seq, state], shared across heads).  The
    final state goes into ``out_state`` when given (``state0`` itself
    updates in place); rows that ``mask`` [rows] (bool) leaves out keep
    theirs; ``state_rows`` [rows] (int32, batched calls) picks the state
    row each row reads and writes."""
    unbatched = x.dim() == 3
    if unbatched:
        x, a, b, c = x[None], a[None], b[None], c[None]
        state0 = state0[None] if state0 is not None else None
        out_state = out_state[None] if out_state is not None else None
    seq, hd, state = x.shape[1], x.shape[3], b.shape[-1]
    fn = get_default_cache().warm_callable(
        SSD_FAMILY, machine, (("SQ", seq), ("HD", hd), ("STATE", state)),
        x.device.type)
    y, s = fn(x, a, b, c, state0, out_state=out_state, mask=mask,
              state_rows=state_rows)
    return (y[0], s[0]) if unbatched else (y, s)


def ssd_scan_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, state0: Optional[torch.Tensor],
                 dy: torch.Tensor, dS_final: Optional[torch.Tensor], *,
                 machine: MachineDescription = H100_SXM
                 ) -> Tuple[torch.Tensor, ...]:
    """(dx, da, db, dc, d(state0)) of :func:`ssd_scan`'s batched form
    from ``state0`` (zero when None), given dy and the final state's
    gradient ``dS_final`` (zero when None) (K3b), keyed on K3's (SQ, HD,
    STATE), through the same frozen lane; b and c shared across heads
    ([rows, seq, state]) or per head, and their gradients in the same
    form."""
    seq, hd, state = x.shape[1], x.shape[3], b.shape[-1]
    fn = get_default_cache().warm_callable(
        SSD_BWD_FAMILY, machine, (("SQ", seq), ("HD", hd), ("STATE", state)),
        x.device.type)
    return fn(x, a, b, c, state0, dy, dS_final)
