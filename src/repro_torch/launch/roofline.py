"""One count of a kernel launch's work, and the H100's rates it is read at.

:func:`work` gives (bytes, flops, peak flop/s) of one launch of a kernel
wrapper at its signature (the key the wrapper counts the launch under in
its ``.shapes``): each input read once, each output written once;
attention counts the query-key pairs its masks leave visible, the SSD scan
the recurrence's multiply-adds.  ``chip_smoke.py`` reads every launch of
its kernel table through it, and the dry run (:mod:`.dryrun`) every launch
of a step's walk (:func:`repro_torch.plans.trace.trace_train_launches`)
through :func:`launch_signature`, so one count serves both.

The machine numbers are datasheet figures of the H100 SXM:
``core.params.H100_SXM``'s HBM rate (3.35 TB/s), dense bf16 tensor-core
peak (989 TFLOP/s) and NVLink rate (450 GB/s each way), and the data
sheet's f32 peak on the CUDA cores (67 TFLOP/s), which
``MachineDescription`` does not hold.  None is a measurement.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.params import H100_SXM

MACHINE = "h100_sxm"
#: HBM bytes/s (datasheet, ``H100_SXM.hbm_bw``)
HBM_BYTES_PER_S = H100_SXM.hbm_bw
#: NVLink bytes/s each way (datasheet, ``H100_SXM.ici_bw``)
LINK_BYTES_PER_S = H100_SXM.ici_bw
#: f32 on the CUDA cores, 67 TFLOP/s (datasheet; not in H100_SXM)
PEAK_F32_FLOPS = 67e12
#: flop/s by the type a unit computes in (datasheet)
PEAK_FLOPS = {torch.bfloat16: H100_SXM.peak_flops_bf16,
              torch.float32: PEAK_F32_FLOPS}


def visible(sq: int, sk: int, causal: bool, window,
            device="cpu") -> torch.Tensor:
    """[sq, sk] bool: which keys each query sees, the queries' ends aligned
    to the keys' (query i at position sk - sq + i)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def visible_counts(sq: int, sk: int, causal: bool, window
                   ) -> Tuple[int, int]:
    """(keys some query sees, query-key pairs seen) of :func:`visible`'s
    mask, from each query's interval of keys: O(sq + sk), so a 32k-token
    prompt is counted without its mask."""
    p = np.arange(sk - sq, sk, dtype=np.int64)
    lo = np.maximum(p - window + 1, 0) if window is not None else \
        np.zeros_like(p)
    hi = np.minimum(p, sk - 1) if causal else np.full_like(p, sk - 1)
    n = np.maximum(hi - lo + 1, 0)
    cover = np.zeros(sk + 1, dtype=np.int64)
    seen = n > 0
    np.add.at(cover, lo[seen], 1)
    np.add.at(cover, hi[seen] + 1, -1)
    return int((np.cumsum(cover[:sk]) > 0).sum()), int(n.sum())


def work(name: str, sig, lens: Optional[Sequence[int]] = None) -> tuple:
    """(bytes, flops, peak flop/s) of one launch of ``name`` at ``sig``:
    each input read once, each output written once; attention counts the
    query-key pairs its masks leave visible, the SSD scan the recurrence's
    multiply-adds (S = a·S + b⊗x, y = c·S: 5·state·hd flops a step and
    head) at the rate of the unit that does them (the bf16 tensor cores
    for a bf16 chunk, f32 for a step or f32; :func:`ssd_f32_bound_ms`
    gives a bf16 chunk's bound at the f32 rate), attention's K/V bytes over
    its hk KV heads and only the keys some query can see (a window's),
    matadd one f32 add an element, a Jacobi sweep two adds and a division
    a point, a transpose none.  A paged K2 launch and a K2b call count
    each row at its length in ``lens`` (its q and output, and the pool's
    bytes of the keys it can see)."""
    esz = torch.empty((), dtype=sig[-2 if sig[0] == "paged" else -1]
                      ).element_size()
    if name == "matmul_h100":
        M, N, K = sig[:3]
        return ((M * K + K * N) * esz + M * N * 4, 2.0 * M * N * K,
                PEAK_FLOPS[sig[-1]])
    if name == "matmul_h100_batched":       # every expert's A, B and C
        E, M, N, K = sig[:4]
        return (E * ((M * K + K * N) * esz + M * N * 4), 2.0 * E * M * N * K,
                PEAK_FLOPS[sig[-1]])
    if name == "matadd_h100":
        M, N = sig[:2]
        return 3 * M * N * esz, float(M * N), PEAK_FLOPS[torch.float32]
    if name == "transpose_h100":
        M, N = sig[:2]
        return 2 * M * N * esz, 0.0, PEAK_FLOPS[torch.float32]
    if name == "transpose_h100_batched":
        E, M, N = sig[:3]
        return 2 * E * M * N * esz, 0.0, PEAK_FLOPS[torch.float32]
    if name == "jacobi1d_h100":          # one sweep: n read, n - 2 written
        n = sig[0]
        return (2 * n - 2) * esz, 3.0 * (n - 2), PEAK_FLOPS[torch.float32]
    if name == "ssd_scan_h100":
        R, S, H, hd, n, _, _, with_state, masked, srows, dtype = sig
        state_bytes = 4 * R * H * n * hd          # the R rows read, written
        # a bf16 chunk runs its products on the tensor cores; the step body
        # and f32 run on the CUDA cores in f32
        peak = PEAK_FLOPS[dtype if S > 1 else torch.float32]
        return (2 * R * S * H * hd * esz + 4 * R * S * H + 2 * R * S * n * esz
                + R * masked + 4 * R * (srows > 0)
                + state_bytes * (2 if with_state else 1),
                5.0 * R * S * H * n * hd, peak)
    if name == "ssd_scan_bwd_h100":
        return ssd_bwd_work(sig)
    if name == "flash_attention_bwd_h100":    # 2.5 times the forward's flops
        rows, h, hk, sq, page, d, _, _, causal, window, _ = sig
        pairs = sum(visible_counts(sq, n, causal, window)[1] for n in lens)
        return (esz * 4 * rows * d * (h * sq + hk * page) + 8 * rows * h * sq,
                2.5 * 4.0 * h * pairs * d, PEAK_FLOPS[sig[-1]])
    if sig[0] == "paged":
        _, rows, h, hk, sq, _, d, _, _, _, _, _, causal, window, dtype, kv = sig
        kv_esz = torch.empty((), dtype=kv).element_size()
        nbytes, flops = 0, 0.0
        for n in lens:                       # each row at its own length
            keys, pairs = visible_counts(sq, n, causal, window) if n \
                else (0, 0)
            nbytes += 2 * h * sq * d * esz + 2 * hk * keys * d * kv_esz
            flops += 4.0 * h * pairs * d
        return nbytes, flops, PEAK_FLOPS[dtype]
    h, hk, sq, sk, d = sig[:5]
    causal, window = sig[9:11]
    keys, pairs = visible_counts(sq, sk, causal, window)
    return (2 * (h * sq * d + hk * keys * d) * esz, 4.0 * h * pairs * d,
            PEAK_FLOPS[sig[-1]])


def bound_terms_ms(name: str, sig, lens: Optional[Sequence[int]] = None
                   ) -> tuple:
    """(the bytes' time, the flops' time) of one launch, in ms."""
    nbytes, flops, peak = work(name, sig, lens)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak


def ssd_bwd_work(sig) -> tuple:
    """(bytes, flops, peak) of one K3b call at (rows, seq, heads, hd, state,
    chunk, shared, state0 given, dS_final given, dtype): x, dy, b, c,
    the decay and the given states read once, dx, da, db, dc and d(state0)
    written once; the flops of the chunk formulas (kernels/ssd_scan_bwd.py)
    over the call's own chunks of n <= min(chunk, seq) steps, 10·n·N·hd +
    n²·(3N + 2hd) a (row, head), at the bf16 tensor-core peak for bf16
    inputs (:func:`ssd_bwd_f32_bound_ms` gives them at the f32 rate)."""
    R, S, H, hd, n, chunk, shared, with_state, with_dsf, dtype = sig
    esz = torch.empty((), dtype=dtype).element_size()
    nb = n if shared else H * n
    ck = min(chunk, S)
    steps = [min(ck, S - t0) for t0 in range(0, S, ck)]
    flops = R * H * sum(10.0 * m * n * hd + m * m * (3 * n + 2 * hd)
                        for m in steps)
    nbytes = (3 * R * S * H * hd * esz + 8 * R * S * H + 4 * R * S * nb * esz
              + 4 * R * H * n * hd * (1 + with_state + with_dsf))
    return nbytes, flops, PEAK_FLOPS[dtype]


def ssd_bwd_f32_bound_ms(sig) -> float:
    """K3b's bound at ``sig`` with every flop at the f32 rate, the rate of
    its FMA body."""
    nbytes, flops, _ = ssd_bwd_work(sig)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     flops / PEAK_FLOPS[torch.float32])


def ssd_f32_bound_ms(sig) -> float:
    """K3's bound at ``sig`` with every flop at the f32 rate, as the
    parent's kernel (all on the CUDA cores) was bound."""
    nbytes, flops, _ = work("ssd_scan_h100", sig)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     flops / PEAK_FLOPS[torch.float32])


# ---------------------------------------------------------------------------
# A walked launch's signature, in its wrapper's format
# ---------------------------------------------------------------------------

def launch_signature(launch, pick: Dict[str, int]) -> Tuple[tuple, tuple]:
    """(signature, row lengths) of a walked launch
    (:class:`~repro_torch.plans.trace.Launch`) in its wrapper's ``.shapes``
    format, the block parameters from the dispatch's ``pick`` (its
    assignment); the lengths are those a paged K2 launch or a K2b call
    reads (empty otherwise)."""
    info, key = launch.info, dict(launch.key)
    dt = info["dtype"]
    name = launch.wrapper
    if name in ("matmul_h100", "matmul_h100_batched"):
        tail = tuple(pick.get(k) for k in ("bm", "bn", "bk", "s", "kb",
                                           "stages")) + (True, dt)
        E = (info["E"],) if name == "matmul_h100_batched" else ()
        return E + (key["M"], key["N"], key["K"]) + tail, ()
    if name in ("transpose_h100", "transpose_h100_batched"):
        tail = tuple(pick.get(k) for k in ("bm", "bn", "s")) + (True, dt)
        E = (info["E"],) if name == "transpose_h100_batched" else ()
        return E + (key["M"], key["N"]) + tail, ()
    if name in ("flash_attention_h100", "flash_attention_bwd_h100"):
        h, hk = key["GROUP"] * key["HK"], key["HK"]
        lens = (info["len"],) * info["rows"]
        if name == "flash_attention_bwd_h100":
            return (info["rows"], h, hk, key["SQ"], info["sk"], key["HD"],
                    pick.get("bq"), pick.get("bkv"), info["causal"],
                    info["window"], dt), lens
        return ("paged", info["rows"], h, hk, key["SQ"], info["sk"],
                key["HD"], info["sk"], pick.get("bq"), pick.get("bkv"),
                pick.get("kv_chunk"), pick.get("stages"), info["causal"],
                info["window"], dt, info.get("kv_dtype", dt)), lens
    if name == "ssd_scan_h100":
        return (info["rows"], key["SQ"], info["H"], key["HD"], key["STATE"],
                pick.get("chunk"), pick.get("bd"), False, False, 0, dt), ()
    if name == "ssd_scan_bwd_h100":
        return (info["rows"], key["SQ"], info["H"], key["HD"], key["STATE"],
                pick.get("chunk", key["SQ"]), True, False, False, dt), ()
    raise ValueError(f"no signature of wrapper {name!r}")
