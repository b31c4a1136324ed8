#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases print on their own lines; any failure raises and exits non-zero, and
no phase is caught.

1. device: torch and CUDA versions, the card's name and power limit.
2. build: ``nvcc`` builds the six kernels (``csrc/*.cu``), one process
   each, all started together; the build time.
3. K1 ``matmul_h100`` against its plain version in bf16, at every matmul
   triple of the full llama3-8b serve path at M = 4 and 32 through the leaf
   the dispatch picks, and at six feasible leaves of the tree of different
   (bm, bn, bk, s, cached) at one shape (the paper's code soundness,
   Def. 2 ii).
4. K2 ``flash_attention_h100`` against its plain version in bf16: prefill
   chunk, decode over a ragged cache, non-causal sk = 200, window 128.
5. K3 ``ssd_scan_h100`` against its plain version in bf16 with an f32
   state, at the mamba2-130m (24 heads of 64, state 128) and hymba-1.5b (25
   heads of 64, state 16) signatures: a decode step of 4 rows at seq 1 with
   the state in, every chunk length 1..256 with the state in, seq 200 (no
   multiple of any chunk) with and without a state, through the leaf the
   dispatch picks; and at five feasible leaves of different (chunk, bd).
6. case studies, the paper's own evaluation through the port's ``ops``
   (``DispatchCache.warm_callable`` -> the family's tree under ``H100_SXM``
   -> memoized ``instantiate`` -> the kernel), at the paper's sizes: the
   four dispatch triples are frozen, every launch counter is set to 0, then
   ``ops.matadd`` at 8192 x 8192 f32 (Fig. 2), ``ops.transpose`` at 16384
   x 16384 f32 (Table 3), ``ops.jacobi1d`` at n = 2^15 + 2 (Table 2) and
   at n = 2^21 + 2 (the largest Jacobi bucket of the JAX artifacts), 4
   sweeps each.  Each call moves its counter by 1, 1 and 4; no dispatch
   leaves the frozen lane; each result agrees with the plain version.
   Then matadd and transpose in bf16 at 8192 x 8192, each family at a
   ragged shape (300 x 700; n = 1026), and matadd at 1 x 2^25 and
   transpose at 4 x 2^25, whose picks have more than 65,535 column
   blocks; and at each of the four sizes up to eight leaves of different
   formats, each held against the plain version and timed, with the
   napkin's rank beside the card's: the leaves live under ``H100_SXM``
   (matadd: grain 2; transpose and Jacobi: cached, case 1, grains 1-8) and
   the leaves the tree keeps for a smaller machine (matadd's grain-1 case
   C2 at G = 12; the uncached case 3 of transpose and Jacobi at V = 0),
   which ``H100_SXM`` never picks.
7. serve parity: the llama3, mamba2 and hymba SMOKE configs in f32, each
   served on ``cuda`` (the kernels) and on ``cpu`` (their plain versions)
   from the same weights; the greedy tokens are equal.
8. serve, the main paths, each through ``init_model`` (bf16, random weights
   from a seeded ``torch.Generator`` on the card) and
   ``ServeEngine(warm_kernels=True)``, 4 requests of 8 new tokens, every
   launch counter set to 0 just before and read just after each path:
   mamba2-130m at full width (24 layers; prompts of 200-500 tokens,
   ``prefill_chunk`` 256, ``max_len`` 1024), hymba-1.5b at full width (32
   layers) and llama3-8b at full width (32 layers), the last two with
   prompts of 16-64 tokens, ``prefill_chunk`` 32, ``max_len`` 256.  Every
   request returns ``max_new`` tokens, each kernel of the path launched
   (K1 and K3; K1, K2 and K3; K1 and K2), the launch counts match the steps
   run, no dispatch resolved cold after warm-up, and a full-width forward
   gives finite logits.
9. main-path shapes: every launch signature of phase 8 is run again on
   fresh inputs of its shape, held against the plain version, and timed:
   kernel, plain version, the library call, and the bound.

Times are medians over 5 CUDA-event batches of repeated launches after one
warm-up launch, printed with their spread (the slowest batch less the
fastest): one mean over one batch let a single slow batch set a row.  A
matmul cycles through copies of its weight operand so that each launch
reads it from device memory, as the serve path does (attention reads K/V
and the SSD scan reads x, b, c that the serve path has just written, so
repeated launches on the same inputs stand for it).  A Jacobi sweep is
timed alone (one launch of ``jacobi1d.sweep``) and cycles through copies of
its two buffers, 2^15 + 2 and 2^21 + 2 alike, so that each launch reads and
writes memory the L2 does not hold; matadd and transpose move 0.8 and 2 GB
a launch, far past the L2.  The bound of a launch
is max(bytes / 3.35 TB/s, flops / peak), with each input read once and each
output written once, the flops of the keys the masks leave visible, the
recurrence's 5·state·hd flops a step and head for the SSD scan, and the
peak of the H100 SXM data sheet for the arithmetic's type (989 TFLOP/s bf16
on the tensor cores, 67 TFLOP/s f32; the SSD scan's decay products and
state are f32), a sum or a Jacobi point in f32, a transpose none.  The
library call is a yardstick timed only here: ``torch.matmul`` (its output
is bf16, the kernel's f32), ``scaled_dot_product_attention``, ``torch.add``
for matadd and ``a.t().contiguous()`` for transpose (the plain versions of
K5 and K4 are those very calls), and for a Jacobi sweep ``avg_pool1d(x, 3,
stride=1)``, the sweep's interior as a new vector (its largest difference
from the plain sweep is printed, not held); no single PyTorch call computes
the SSD scan, so K3 has none.

The line before the last is the kernels' JSON record.  For K1-K3
``launches`` is phase 8's count over the three serve paths; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over those
launches, each timed at its own signature in phase 9.  For K4-K6 the same
numbers come from phase 6's case-study path (1, 1 and 8 launches), each
signature timed in phase 6.  ``max_abs_err`` is the largest error against
the plain version over phases 3-6 and 9.  The last line is the device
record.

Tolerances, kernel against plain version on the same inputs:

- matmul (bf16 in, f32 out), rtol 1e-4 / atol 1e-3: a bf16 product is
  exact in f32, so the two differ only in the order of K f32 additions;
  with B scaled by 1/sqrt(K), as the model's weights are, outputs are O(1)
  and K <= 14336 additions drift by at most K * 2^-24 ~ 1e-3.
- attention in bf16, rtol = atol = 1e-2: both compute in f32 and round the
  output to bf16 once; the two may round apart by one bf16 step (2^-7).
- SSD scan: rtol = atol = 1e-3 on the f32 state, which both compute in f32
  by the same chunk math in another order of sums (at most 256 + state
  terms of O(1)) and with ``expf``/``logf`` against ``torch.exp``/``log``;
  rtol = atol = 1e-2 on the bf16 y, one bf16 step as for attention.
- matadd and transpose: bit for bit (``torch.equal``): a transpose moves
  raw bits, and a sum is one f32 add rounded once to the element type on
  both sides.
- Jacobi, rtol = atol = 1e-5 (the JAX test's): both add the left pair
  first and divide by 3 as IEEE says, so the error printed should be 0;
  the tolerance allows the one-bit roundings of a reciprocal multiply.

TF32 is off for the plain versions (``allow_tf32 = False``), so their f32
products on the card are full f32.
"""
from __future__ import annotations

import importlib
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 128 * 2**20          # more than twice the H100's 50 MB L2
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
MM_TOL = dict(rtol=1e-4, atol=1e-3)
FA_TOL = dict(rtol=1e-2, atol=1e-2)
SSD_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
SSD_Y_TOL = dict(rtol=1e-2, atol=1e-2)
JACOBI_TOL = dict(rtol=1e-5, atol=1e-5)
JACOBI_STEPS = 4
BATCHES = 5
MAX_NEW = 8
# (arch, engine sizes, prompt lengths [lo, hi)) of the main paths
PATHS = (
    ("mamba2_130m", dict(max_batch=4, max_len=1024, page_size=16,
                         prefill_chunk=256), (200, 501)),
    ("hymba_1p5b", dict(max_batch=4, max_len=256, page_size=16,
                        prefill_chunk=32), (16, 65)),
    ("llama3_8b", dict(max_batch=4, max_len=256, page_size=16,
                       prefill_chunk=32), (16, 65)),
)
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "matmul_h100": ("src/repro_torch/csrc/matmul.cu",
                    "src/repro/kernels/matmul.py:73"),
    "flash_attention_h100": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:75"),
    "ssd_scan_h100": ("src/repro_torch/csrc/ssd_scan.cu",
                      "src/repro/kernels/ssd_scan.py:70"),
    "transpose_h100": ("src/repro_torch/csrc/transpose.cu",
                       "src/repro/kernels/transpose.py:46"),
    "matadd_h100": ("src/repro_torch/csrc/matadd.cu",
                    "src/repro/kernels/matadd.py:37"),
    "jacobi1d_h100": ("src/repro_torch/csrc/jacobi1d.cu",
                      "src/repro/kernels/jacobi1d.py:51"),
}
SERVE_KERNELS = ("matmul_h100", "flash_attention_h100", "ssd_scan_h100")
CASE_KERNELS = ("transpose_h100", "matadd_h100", "jacobi1d_h100")
#: The case-study path (phase 6): (family, data) at the paper's sizes.
CASE_PATH = (
    ("matadd_h100", {"M": 8192, "N": 8192}),             # Fig. 2
    ("transpose_h100", {"M": 16384, "N": 16384}),        # Table 3
    ("jacobi1d_h100", {"N": (1 << 15) + 2}),             # Table 2
    ("jacobi1d_h100", {"N": (1 << 21) + 2}),             # largest bucket
)


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int) -> tuple:
    """(median, spread) in ms a launch over ``BATCHES`` CUDA-event batches
    of ``reps`` launches each, after one warm-up launch; the spread is the
    slowest batch less the fastest."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2], per[-1] - per[0]


def time_into(row: dict, key: str, fn, reps: int) -> None:
    row[key], row[key + "_spread"] = time_ms(fn, reps)


def held(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict
         ) -> float:
    """Max |got - want|; raises unless every element is within tol."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **tol):
        raise AssertionError(f"{name}: max_abs_err {err:.3e} outside "
                             f"rtol {tol['rtol']} / atol {tol['atol']}")
    return err


def work(name: str, sig) -> tuple:
    """(bytes, flops, peak flop/s) of one launch of ``name`` at ``sig``:
    each input read once, each output written once; attention counts the
    query-key pairs its masks leave visible, the SSD scan the recurrence's
    multiply-adds (S = a·S + b⊗x, y = c·S: 5·state·hd flops a step and
    head) at the f32 rate, matadd one f32 add an element, a Jacobi sweep
    two adds and a division a point, a transpose none."""
    esz = torch.empty((), dtype=sig[-1]).element_size()
    if name == "matmul_h100":
        M, N, K = sig[:3]
        return ((M * K + K * N) * esz + M * N * 4, 2.0 * M * N * K,
                PEAK_FLOPS[sig[-1]])
    if name == "matadd_h100":
        M, N = sig[:2]
        return 3 * M * N * esz, float(M * N), PEAK_FLOPS[torch.float32]
    if name == "transpose_h100":
        M, N = sig[:2]
        return 2 * M * N * esz, 0.0, PEAK_FLOPS[torch.float32]
    if name == "jacobi1d_h100":          # one sweep: n read, n - 2 written
        n = sig[0]
        return (2 * n - 2) * esz, 3.0 * (n - 2), PEAK_FLOPS[torch.float32]
    if name == "ssd_scan_h100":
        R, S, H, hd, n, _, _, with_state, _ = sig
        state_bytes = 4 * R * H * n * hd
        return (2 * R * S * H * hd * esz + 4 * R * S * H + 2 * R * S * n * esz
                + state_bytes * (2 if with_state else 1),
                5.0 * R * S * H * n * hd, PEAK_FLOPS[torch.float32])
    h, sq, sk, d, _, _, causal, window, _ = sig
    pairs = int(_visible(sq, sk, causal, window).sum())
    return (2 * (h * sq * d + h * sk * d) * esz, 4.0 * h * pairs * d,
            PEAK_FLOPS[sig[-1]])


def bound_terms_ms(name: str, sig) -> tuple:
    nbytes, flops, peak = work(name, sig)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak


# ---------------------------------------------------------------------------
# K1, K2 and K3 at one signature: check against plain, time, bound
# ---------------------------------------------------------------------------

def matmul_case(sig, gen, *, timed: bool):
    from repro_torch.kernels.matmul import matmul_h100, matmul_plain
    M, N, K, bm, bn, bk, s, cached, dtype = sig
    a = torch.randn((M, K), generator=gen, device=DEV).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=DEV)
         / math.sqrt(K)).to(dtype)
    kw = dict(bm=bm, bn=bn, bk=bk, s=s, cached=cached)
    got = matmul_h100(a, b, **kw)
    torch.cuda.synchronize()
    want = matmul_plain(a, b, **kw)
    row = {"err": held(f"matmul {sig}", got, want, MM_TOL)}
    if timed:
        # the serve path reads each weight matrix cold: cycle through enough
        # copies of B that none is still in the 50 MB L2 when it comes back
        bs = itertools.cycle([b] + [b.clone() for _ in range(
            math.ceil(L2_FLUSH_BYTES / (b.numel() * b.element_size())) - 1)])
        time_into(row, "ms", lambda: matmul_h100(a, next(bs), **kw), 10)
        time_into(row, "plain_ms",
                  lambda: matmul_plain(a, next(bs), **kw), 2)
        time_into(row, "library_ms", lambda: torch.matmul(a, next(bs)), 10)
        row["bound_ms"] = max(bound_terms_ms("matmul_h100", sig))
    return row


def _visible(sq: int, sk: int, causal: bool, window) -> torch.Tensor:
    qpos = torch.arange(sq, device=DEV)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=DEV)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=DEV)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_case(sig, gen, *, timed: bool):
    from repro_torch.kernels.flash_attention import (flash_attention_h100,
                                                     flash_attention_plain)
    h, sq, sk, d, bq, bkv, causal, window, dtype = sig
    q = torch.randn((h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((h, sk, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((h, sk, d), generator=gen, device=DEV).to(dtype)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
    got = flash_attention_h100(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    row = {"err": held(f"flash {sig}", got, want, FA_TOL)}
    if timed:
        mask = _visible(sq, sk, causal, window)
        sdpa_mask = None if bool(mask.all()) else mask
        time_into(row, "ms",
                  lambda: flash_attention_h100(q, k, v, **kw), 10)
        time_into(row, "plain_ms",
                  lambda: flash_attention_plain(q, k, v, **kw), 2)
        time_into(row, "library_ms", lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=sdpa_mask), 10)
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
    return row


def ssd_case(sig, gen, *, timed: bool):
    """K3 at (rows, seq, heads, hd, state, chunk, bd, state given, dtype)
    on inputs shaped as the model makes them: x, b, c in the compute type,
    b and c one [rows, seq, state] projection shared across heads, the
    decay in (0.05, 0.95) and the state in f32."""
    from repro_torch.kernels.ssd_scan import ssd_scan_h100, ssd_scan_plain
    R, S, H, hd, n, chunk, bd, with_state, dtype = sig
    x = torch.randn((R, S, H, hd), generator=gen, device=DEV).to(dtype)
    a = torch.sigmoid(torch.randn((R, S, H), generator=gen,
                                  device=DEV)) * 0.9 + 0.05
    b = torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
    c = torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
    s0 = (torch.randn((R, H, n, hd), generator=gen, device=DEV)
          if with_state else None)
    kw = dict(chunk=chunk, bd=bd)
    y, s1 = ssd_scan_h100(x, a, b, c, s0, **kw)
    torch.cuda.synchronize()
    wy, ws = ssd_scan_plain(x, a, b, c, s0, **kw)
    row = {"err": max(held(f"ssd state {sig}", s1, ws, SSD_STATE_TOL),
                      held(f"ssd y {sig}", y, wy, SSD_Y_TOL))}
    if timed:
        time_into(row, "ms",
                  lambda: ssd_scan_h100(x, a, b, c, s0, **kw), 10)
        time_into(row, "plain_ms",
                  lambda: ssd_scan_plain(x, a, b, c, s0, **kw), 2)
        row["library_ms"] = None
        row["bound_ms"] = max(bound_terms_ms("ssd_scan_h100", sig))
    return row


def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0; raises unless ``got`` equals ``want`` bit for bit."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(
            got, want):
        raise AssertionError(f"{name}: not equal to the plain version")
    return 0.0


def _cold_copies(tensors, nbytes: int):
    """A cycle over copies of ``tensors`` (the originals first), enough
    that ``L2_FLUSH_BYTES`` lie between two uses of one copy."""
    n = max(1, math.ceil(L2_FLUSH_BYTES / nbytes))
    return itertools.cycle([tensors] + [tuple(t.clone() for t in tensors)
                                        for _ in range(n - 1)])


def matadd_case(sig, gen, *, timed: bool):
    from repro_torch.kernels.matadd import matadd_h100, matadd_plain
    M, N, bm, bn, s, dtype = sig
    a = torch.randn((M, N), generator=gen, device=DEV).to(dtype)
    b = torch.randn((M, N), generator=gen, device=DEV).to(dtype)
    kw = dict(bm=bm, bn=bn, s=s)
    got = matadd_h100(a, b, **kw)
    torch.cuda.synchronize()
    row = {"err": exact(f"matadd {sig}", got, matadd_plain(a, b, **kw))}
    if timed:
        time_into(row, "ms", lambda: matadd_h100(a, b, **kw), 10)
        time_into(row, "plain_ms", lambda: matadd_plain(a, b, **kw), 10)
        time_into(row, "library_ms", lambda: torch.add(a, b), 10)
        row["bound_ms"] = max(bound_terms_ms("matadd_h100", sig))
    return row


def transpose_case(sig, gen, *, timed: bool):
    from repro_torch.kernels.transpose import transpose_h100, transpose_plain
    M, N, bm, bn, s, cached, dtype = sig
    a = torch.randn((M, N), generator=gen, device=DEV).to(dtype)
    kw = dict(bm=bm, bn=bn, s=s, cached=cached)
    got = transpose_h100(a, **kw)
    torch.cuda.synchronize()
    row = {"err": exact(f"transpose {sig}", got, transpose_plain(a, **kw))}
    if timed:
        time_into(row, "ms", lambda: transpose_h100(a, **kw), 10)
        time_into(row, "plain_ms", lambda: transpose_plain(a, **kw), 10)
        time_into(row, "library_ms", lambda: a.t().contiguous(), 10)
        row["bound_ms"] = max(bound_terms_ms("transpose_h100", sig))
    return row


def jacobi_case(sig, gen, *, timed: bool):
    """K6 at (n, B, s, cached, dtype): ``JACOBI_STEPS`` sweeps against the
    plain version; timed a sweep (one launch) at a time."""
    from repro_torch.kernels.jacobi1d import (jacobi1d_h100, jacobi1d_plain,
                                              sweep)
    n, B, s, cached, _ = sig
    x = torch.randn((n,), generator=gen, device=DEV)
    kw = dict(B=B, s=s, cached=cached)
    got = jacobi1d_h100(x, JACOBI_STEPS, **kw)
    torch.cuda.synchronize()
    row = {"err": held(f"jacobi {sig}", got,
                       jacobi1d_plain(x, JACOBI_STEPS, **kw), JACOBI_TOL)}
    if timed:
        bufs = _cold_copies((x, x.clone()), 8 * n)
        time_into(row, "ms", lambda: sweep(*next(bufs), **kw), 10)
        time_into(row, "plain_ms",
                  lambda: jacobi1d_plain(next(bufs)[0], 1, **kw), 10)
        time_into(row, "library_ms", lambda: F.avg_pool1d(
            next(bufs)[0].view(1, 1, -1), 3, 1), 10)
        one = jacobi1d_plain(x, 1, **kw)[1:-1]
        row["library_err"] = float(
            (F.avg_pool1d(x.view(1, 1, -1), 3, 1).view(-1) - one).abs().max())
        row["bound_ms"] = max(bound_terms_ms("jacobi1d_h100", sig))
    return row


CASES = {"matmul_h100": matmul_case, "flash_attention_h100": flash_case,
         "ssd_scan_h100": ssd_case, "transpose_h100": transpose_case,
         "matadd_h100": matadd_case, "jacobi1d_h100": jacobi_case}


def fmt(row) -> str:
    out = f"max_abs_err {row['err']:.3e}"
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        if row.get(key) is not None:
            out += f" {key} {row[key]:.4f}"
            if key + "_spread" in row:
                out += f" (spread {row[key + '_spread']:.4f})"
    if "library_err" in row:
        out += f" library_err {row['library_err']:.3e}"
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0])
    say(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")


def phase_build() -> None:
    from repro_torch.kernels import build
    secs = build.build_all()
    say(f"[build] nvcc sm_90a, {len(build.SOURCES)} sources in parallel: "
        f"{secs:.1f} s")


def phase_k1(gen) -> float:
    from repro_torch.configs import get_config
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import enumerate_candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import FAMILY as MATMUL
    cfg = get_config("llama3_8b")
    d, hd = cfg.d_model, cfg.hd
    err = 0.0
    for M in (4, 32):
        triples = [(cfg.heads * hd, d), (cfg.kv_heads * hd, d),
                   (cfg.d_ff, d), (d, cfg.d_ff), (cfg.vocab, d)]
        for N, K in triples:                  # q and out proj are 4096²
            m = 1 if (N == cfg.vocab and M == 32) else M  # prefill lm_head
            cand = ops.select("matmul_h100", {"M": m, "N": N, "K": K})
            a = cand.assignment
            sig = (m, N, K, a["bm"], a["bn"], a["bk"], a["s"],
                   bool(cand.plan.flags["smem_cache"]), torch.bfloat16)
            row = matmul_case(sig, gen, timed=False)
            err = max(err, row["err"])
            say(f"[K1] M{m} N{N} K{K} leaf {dict(a)} cached {sig[7]}: "
                f"{fmt(row)}")
    data = {"M": 32, "N": 4096, "K": 4096}
    feasible = {(c.assignment["bm"], c.assignment["bn"], c.assignment["bk"],
                 c.assignment["s"], bool(c.plan.flags["smem_cache"]))
                for c in enumerate_candidates(MATMUL, H100_SXM, data,
                                              max_per_leaf=4096)}
    for leaf in [(1, 32, 16, 1, True), (4, 64, 32, 2, True),
                 (2, 256, 128, 2, False), (16, 64, 32, 16, True),
                 (32, 32, 64, 1, True), (4, 256, 128, 2, False)]:
        if leaf not in feasible:
            raise AssertionError(f"{leaf} is no feasible leaf at {data}")
        bm, bn, bk, s, cached = leaf
        sig = (32, 4096, 4096, bm, bn, bk, s, cached, torch.bfloat16)
        row = matmul_case(sig, gen, timed=True)
        err = max(err, row["err"])
        say(f"[K1] leaf bm{bm} bn{bn} bk{bk} s{s} cached {cached} at M32 "
            f"N4096 K4096: {fmt(row)}")
    return err


def phase_k2(gen) -> float:
    from repro_torch.kernels import ops
    err = 0.0
    for name, sq, sk, causal, window in [
            ("prefill chunk", 32, 96, True, None),
            ("decode", 1, 77, True, None),
            ("non-causal sk 200", 32, 200, False, None),
            ("window 128", 32, 300, True, 128)]:
        a = ops.select("flash_attention_h100", {"SQ": sq, "HD": 128}
                       ).assignment
        sig = (32, sq, sk, 128, a["bq"], a["bkv"], causal, window,
               torch.bfloat16)
        row = flash_case(sig, gen, timed=True)
        err = max(err, row["err"])
        say(f"[K2] {name}: h32 sq{sq} sk{sk} d128 leaf {dict(a)}: "
            f"{fmt(row)}")
    return err


def phase_k3(gen) -> float:
    from repro_torch.configs import get_config
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import enumerate_candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import FAMILY as SSD
    err = 0.0
    for arch in ("mamba2_130m", "hymba_1p5b"):
        s = get_config(arch).ssm
        cases = [("decode, 4 rows", 4, 1, True)]
        cases += [(f"chunk {n}", 1, n, True) for n in
                  (1, 2, 4, 8, 16, 32, 64, 128, 256)]
        cases += [("seq 200, no state", 1, 200, False),
                  ("seq 200, state in", 1, 200, True)]
        for name, rows, seq, with_state in cases:
            a = ops.select("ssd_scan_h100", {"SQ": seq, "HD": s.head_dim,
                                             "STATE": s.state}).assignment
            sig = (rows, seq, s.heads, s.head_dim, s.state, a["chunk"],
                   a["bd"], with_state, torch.bfloat16)
            row = ssd_case(sig, gen, timed=False)
            err = max(err, row["err"])
            say(f"[K3] {arch} {name}: heads {s.heads} hd {s.head_dim} state "
                f"{s.state} leaf {dict(a)}: {fmt(row)}")
    data = {"SQ": 256, "HD": 64, "STATE": 128}
    feasible = {(c.assignment["chunk"], c.assignment["bd"])
                for c in enumerate_candidates(SSD, H100_SXM, data)}
    for chunk, bd in [(16, 8), (32, 16), (64, 64), (128, 32), (64, 16)]:
        if (chunk, bd) not in feasible:
            raise AssertionError(f"chunk {chunk} bd {bd} is no feasible leaf "
                                 f"at {data}")
        sig = (1, 256, 24, 64, 128, chunk, bd, True, torch.bfloat16)
        row = ssd_case(sig, gen, timed=True)
        err = max(err, row["err"])
        say(f"[K3] leaf chunk {chunk} bd {bd} at seq 256, heads 24, hd 64, "
            f"state 128: {fmt(row)}")
    return err


def _format(family, cand) -> tuple:
    """The launch format of a candidate: its program parameters with the
    grain the kernel runs, and whether it stages in shared memory."""
    from repro_torch.kernels.instantiate_cache import grain
    a, plan = cand.assignment, cand.plan
    if family.name == "matadd_h100":
        return a["bm"], a["bn"], a["s"], True
    cached = bool(plan.flags["smem_cache"])
    if family.name == "transpose_h100":
        return a["bm"], a["bn"], grain(plan, a["s"]), cached
    return a["B"], grain(plan, a["s"]), cached


def _feasible_formats(family, machine, data) -> dict:
    """{launch format: its best-scored candidate} over the tree's feasible
    candidates for ``machine`` and ``data``."""
    from repro_torch.core.select import rank_candidates
    out = {}
    for cand in rank_candidates(family, machine, data, max_per_leaf=4096):
        out.setdefault(_format(family, cand), cand)
    return out


#: Leaves timed at each size of the case-study path (phase 6), as launch
#: formats: (bm, bn, grain, cached) for matadd and transpose, (B, grain,
#: cached) for Jacobi.  The H100_SXM pick is timed first, then these
#: formats feasible under H100_SXM, then those of the leaves only a
#: smaller machine keeps (matadd's grain-1 case C2 at G = 12, the uncached
#: case 3 at V = 0), which H100_SXM never picks.
CASE_LEAVES = {
    "matadd_h100": (
        [(1, 32, 2, True), (4, 64, 2, True), (8, 128, 2, True),
         (32, 32, 2, True), (1, 1024, 2, True)],
        ("G = 12", dict(vreg_budget=12),
         [(1, 256, 1, True), (32, 32, 1, True)])),
    "transpose_h100": (
        [(32, 32, 1, True), (32, 32, 4, True), (32, 32, 8, True),
         (8, 128, 2, True), (16, 64, 1, True), (1, 1024, 1, True)],
        ("V = 0", dict(vmem_bytes=0),
         [(32, 32, 1, False), (1, 1024, 1, False)])),
    "jacobi1d_h100": (
        [(32, 1, True), (128, 2, True), (256, 4, True), (1024, 8, True),
         (512, 1, True)],
        ("V = 0", dict(vmem_bytes=0), [(256, 1, False)])),
}


def _sig(name, data, form, dtype) -> tuple:
    """The launch signature (the wrapper's ``shapes`` key) of the launch
    format ``form``."""
    if name == "jacobi1d_h100":
        return (data["N"], *form, dtype)
    if name == "matadd_h100":
        return (data["M"], data["N"], *form[:3], dtype)
    return (data["M"], data["N"], *form, dtype)


def case_leaf_rows(name, data, gen) -> dict:
    """Time up to eight leaves of different launch formats at one size of
    the case-study path; print each beside the napkin's and the card's
    rank.  Returns {signature: row}."""
    import dataclasses
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels import ops
    family = ops.FAMILIES[name]
    live, (label, change, small) = CASE_LEAVES[name]
    picks = _feasible_formats(family, H100_SXM, data)
    pick = _format(family, ops.select(name, data))
    runs = [(pick, picks[pick], "H100_SXM pick")]
    runs += [(f, picks.get(f), "live under H100_SXM") for f in live
             if f != pick]
    others = _feasible_formats(family, dataclasses.replace(H100_SXM,
                                                           **change), data)
    runs += [(f, others.get(f), f"live only at {label}") for f in small]
    rows = {}
    for form, cand, why in runs:
        if cand is None:
            raise AssertionError(f"{name} {form} is no feasible leaf at "
                                 f"{data} ({why})")
        sig = _sig(name, data, form, torch.float32)
        rows[sig] = dict(CASES[name](sig, gen, timed=True),
                         score=cand.score, why=why)
    by_score = sorted(rows, key=lambda k: -rows[k]["score"])
    by_ms = sorted(rows, key=lambda k: rows[k]["ms"])
    for sig, row in rows.items():
        say(f"[cases] leaf {name} {sig[:-1]} ({row['why']}): {fmt(row)}; "
            f"napkin score {row['score']:.4g} rank "
            f"{by_score.index(sig) + 1}, card rank {by_ms.index(sig) + 1} "
            f"of {len(rows)}")
    return rows


def _counters(names) -> dict:
    """{name: the kernel's public wrapper, which carries its launch
    counter}, each from the module named after its CUDA source."""
    return {n: getattr(importlib.import_module(
        "repro_torch.kernels." + Path(KERNELS[n][0]).stem), n) for n in names}


def phase_cases(gen) -> dict:
    """The case-study path at the paper's sizes (phase 6); returns each
    kernel's launches and launch shapes on the path, the rows timed at
    those shapes and the largest error of each kernel."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.core.params import H100_SXM
    from repro_torch.kernels import ops
    from repro_torch.kernels.jacobi1d import jacobi1d_plain
    from repro_torch.kernels.matadd import matadd_plain
    from repro_torch.kernels.transpose import transpose_plain
    t0 = time.perf_counter()
    cache = get_default_cache()
    cache.freeze([(ops.FAMILIES[f], H100_SXM, d) for f, d in CASE_PATH])
    stats = cache.stats
    resolved0 = (stats.cold_builds, stats.memory_hits)
    (_, add_d), (_, tr_d) = CASE_PATH[:2]
    a = torch.randn(add_d["M"], add_d["N"], generator=gen, device=DEV)
    b = torch.randn(add_d["M"], add_d["N"], generator=gen, device=DEV)
    t = torch.randn(tr_d["M"], tr_d["N"], generator=gen, device=DEV)
    xs = [torch.randn((d["N"],), generator=gen, device=DEV)
          for _, d in CASE_PATH[2:]]

    kernels = _counters(CASE_KERNELS)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()

    def counted(name, want, fn):
        n0 = kernels[name].launches
        out = fn()
        if kernels[name].launches - n0 != want:
            raise AssertionError(f"{name}: {kernels[name].launches - n0} "
                                 f"launches, want {want}")
        return out

    add = counted("matadd_h100", 1, lambda: ops.matadd(a, b))
    tr = counted("transpose_h100", 1, lambda: ops.transpose(t))
    jac = [counted("jacobi1d_h100", JACOBI_STEPS,
                   lambda x=x: ops.jacobi1d(x, JACOBI_STEPS)) for x in xs]
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    shapes = {n: dict(k.shapes) for n, k in kernels.items()}
    wall = time.perf_counter() - t0
    resolved = (stats.cold_builds - resolved0[0],
                stats.memory_hits - resolved0[1])
    say(f"[cases] path: matadd {tuple(a.shape)}, transpose "
        f"{tuple(t.shape)}, jacobi n {[x.numel() for x in xs]} x "
        f"{JACOBI_STEPS} sweeps; launches {json.dumps(launches)}; "
        f"dispatches outside the frozen lane (cold, LRU): {resolved}")
    if any(resolved):
        raise AssertionError(f"{resolved} dispatches left the frozen lane")
    errs = {"matadd_h100": exact("ops.matadd", add, a + b),
            "transpose_h100": exact("ops.transpose", tr,
                                    t.t().contiguous())}
    errs["jacobi1d_h100"] = max(
        held(f"ops.jacobi1d n {x.numel()}", y,
             jacobi1d_plain(x, JACOBI_STEPS, B=32, s=1), JACOBI_TOL)
        for x, y in zip(xs, jac))
    say(f"[cases] path agrees with the plain versions: matadd and "
        f"transpose bit for bit, jacobi max_abs_err "
        f"{errs['jacobi1d_h100']:.3e}")
    del add, tr, jac

    # bf16 at 8192² and ragged shapes, through the same ops
    ab = a.bfloat16()
    tb = t[:add_d["M"], :add_d["N"]].contiguous().bfloat16()
    exact("ops.matadd bf16", ops.matadd(ab, ab.flip(0)), ab + ab.flip(0))
    exact("ops.transpose bf16", ops.transpose(tb), tb.t().contiguous())
    r = a[:300, :700].contiguous()
    exact("ops.matadd 300x700", ops.matadd(r, r.flip(1)), r + r.flip(1))
    exact("ops.transpose 300x700", ops.transpose(r), r.t().contiguous())
    x = xs[0][:1026].contiguous()
    errs["jacobi1d_h100"] = max(errs["jacobi1d_h100"], held(
        "ops.jacobi1d n 1026", ops.jacobi1d(x, JACOBI_STEPS),
        jacobi1d_plain(x, JACOBI_STEPS, B=32, s=1), JACOBI_TOL))
    # thin operands whose picks have more than 65,535 column blocks
    w = torch.randn((1 << 25,), generator=gen, device=DEV)
    exact("ops.matadd 1x2^25", ops.matadd(w[None], w.flip(0)[None]),
          w[None] + w.flip(0)[None])
    w = w.repeat(4).view(4, 1 << 25)
    exact("ops.transpose 4x2^25", ops.transpose(w), w.t().contiguous())
    del w
    say(f"[cases] bf16 matadd and transpose at {tuple(ab.shape)}, f32 at "
        f"{tuple(r.shape)} and n {x.numel()}, matadd at (1, 2^25) and "
        f"transpose at (4, 2^25): agree")
    del a, b, t, xs, ab, tb
    torch.cuda.empty_cache()

    rows = {name: {} for name in kernels}
    for name, data in CASE_PATH:
        rows[name].update(case_leaf_rows(name, data, gen))
    for name, by_sig in shapes.items():
        for sig in by_sig:
            if sig not in rows[name]:          # the pick, timed above
                raise AssertionError(f"{name} {sig} was not timed")
            errs[name] = max(errs[name], rows[name][sig]["err"])
    torch.cuda.empty_cache()
    say(f"[cases] phase {time.perf_counter() - t0:.1f} s (the path itself "
        f"{1e3 * wall:.1f} ms)")
    return {"launches": launches, "shapes": shapes, "rows": rows,
            "errs": errs}


def _serve(cfg, params, prompts, device, **kw):
    from repro_torch.runtime import ServeEngine
    eng = ServeEngine(cfg, params, device=device, **kw)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r for r in eng.run_until_drained()}
    return eng, [done[r] for r in rids]


def phase_parity() -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model

    def to_cuda(node):
        if isinstance(node, dict):
            return {k: to_cuda(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cuda(v) for v in node]
        return node.to(DEV)

    for arch, _, _ in PATHS:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        params_cpu = init_model(cfg, seed=7, device="cpu")
        params_gpu = to_cuda(params_cpu)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 19, 11, 3, 26)]
        kw = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8,
                  warm_kernels=True)
        _, on_gpu = _serve(cfg, params_gpu, prompts, DEV, **kw)
        _, on_cpu = _serve(cfg, params_cpu, prompts, "cpu", **kw)
        gpu_toks = [r.out for r in on_gpu]
        cpu_toks = [r.out for r in on_cpu]
        say(f"[parity] {cfg.name} f32, cuda kernels: {gpu_toks}")
        say(f"[parity] {cfg.name} f32, cpu plain:    {cpu_toks}")
        if gpu_toks != cpu_toks or any(len(t) != MAX_NEW for t in gpu_toks):
            raise AssertionError(f"serve parity ({cfg.name}): tokens differ "
                                 "between the kernels on cuda and the plain "
                                 "versions on cpu")


def phase_serve(arch: str, serve_kw: dict, prompt_lens: tuple) -> dict:
    """One main path: ``arch`` at full width through ServeEngine; returns
    its name, wall time and each kernel's launches and launch shapes."""
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    from repro_torch.runtime import ServeEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    say(f"[serve] {cfg.name} full width: {cfg.layers} layers, {cfg.block} "
        f"block, d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; "
        f"weights {torch.cuda.memory_allocated() / 2**30:.2f} GiB made in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV, **serve_kw)
    stats = get_default_cache().stats
    cold0 = stats.cold_builds
    say(f"[serve] warm-up: {len(eng.kernel_plan)} kernel picks frozen in "
        f"{time.perf_counter() - t0:.1f} s; engine {serve_kw}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(*prompt_lens, 4)]

    kernels = _counters(SERVE_KERNELS)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    shapes = {n: dict(k.shapes) for n, k in kernels.items()}

    outs = [done[r] for r in rids]
    for r, p in zip(outs, prompts):
        say(f"[serve] request {r.rid}: prompt {len(p)} tokens -> {r.out}")
        if r.error is not None or len(r.out) != MAX_NEW or not all(
                0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.rid} did not return "
                                 f"{MAX_NEW} valid tokens")
    cold = stats.cold_builds - cold0
    st = eng.sched.stats
    ntok = sum(len(r.out) for r in outs)
    attn = cfg.block in ("attn_mlp", "hybrid")
    ssm = cfg.block in ("ssm", "hybrid")
    mlp = cfg.block == "attn_mlp" or cfg.d_ff > 0
    per_step_mm = cfg.layers * (4 * attn + 5 * ssm + 3 * mlp) + 1
    steps = st.prefill_chunks + st.decode_ticks
    say(f"[serve] {cfg.name}: {len(outs)} requests, {ntok} tokens in "
        f"{wall:.3f} s: {ntok / wall:.2f} tokens/s; {st.prefill_chunks} "
        f"prefill chunks, {st.decode_ticks} decode steps")
    say(f"[serve] {cfg.name} launches: {json.dumps(launches)}; matmul per "
        f"prefill chunk or decode step {per_step_mm}; cold dispatch builds "
        f"after warm-up: {cold}")
    used = ["matmul_h100"] + ["flash_attention_h100"] * attn \
        + ["ssd_scan_h100"] * ssm
    if any(launches[n] == 0 for n in used):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    if launches["matmul_h100"] != per_step_mm * steps:
        raise AssertionError("matmul launches do not match the steps run")
    if launches["ssd_scan_h100"] != cfg.layers * steps * ssm:
        raise AssertionError("SSD scan launches do not match the steps run")

    # one full-width forward through the kernels: finite logits of the
    # expected shape
    logits, _ = forward(params, cfg, prompts[0][None, :16])
    torch.cuda.synchronize()
    if logits.shape != (1, 16, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"full-width forward: logits "
                             f"{tuple(logits.shape)} not finite")
    say(f"[serve] {cfg.name} full-width forward: logits "
        f"{tuple(logits.shape)} finite")
    del eng, params, logits
    torch.cuda.empty_cache()
    return {"name": cfg.name, "wall_ms": 1e3 * wall, "launches": launches,
            "shapes": shapes}


def phase_shapes(shapes, gen):
    """Every launch signature of the main paths, checked and timed once;
    returns {name: {sig: row}}."""
    rows = {}
    for name, by_sig in shapes.items():
        rows[name] = {}
        for sig, n in sorted(by_sig.items(), key=lambda kv: str(kv[0])):
            row = CASES[name](sig, gen, timed=True)
            rows[name][sig] = row
            say(f"[shapes] {name} {sig[:-1]} x{n}: {fmt(row)}")
    return rows


def launch_sums(shapes, rows) -> dict:
    """{name: {key: sum over the launches in ``shapes`` of the key's time
    at each launch's signature}} (None where a signature has none)."""
    out = {}
    for name, by_sig in shapes.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0}
        for sig, n in by_sig.items():
            for key in tot:
                val = rows[name][sig][key]
                tot[key] = (None if tot[key] is None or val is None
                            else tot[key] + n * val)
        out[name] = tot
    return out


def _sums_line(sums) -> str:
    return "; ".join(f"{name} " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items() if v is not None)
        for name, tot in sums.items() if tot["ms"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({src / 'repro_torch'})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False     # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)

    phase_device()
    phase_build()
    errs = {"matmul_h100": phase_k1(gen),
            "flash_attention_h100": phase_k2(gen),
            "ssd_scan_h100": phase_k3(gen)}
    cases = phase_cases(gen)
    errs.update(cases["errs"])
    phase_parity()
    launches = {name: 0 for name in SERVE_KERNELS}
    shapes = {name: {} for name in SERVE_KERNELS}
    paths = []
    for arch, serve_kw, prompt_lens in PATHS:
        path = phase_serve(arch, serve_kw, prompt_lens)
        paths.append(path)
        for name in SERVE_KERNELS:
            launches[name] += path["launches"][name]
            for sig, n in path["shapes"][name].items():
                shapes[name][sig] = shapes[name].get(sig, 0) + n
    rows = phase_shapes(shapes, gen)
    for path in paths:
        say(f"[shapes] {path['name']} ({path['wall_ms']:.1f} ms wall), "
            f"kernel time over its launches: "
            f"{_sums_line(launch_sums(path['shapes'], rows))}")
    totals = launch_sums(shapes, rows)
    say(f"[shapes] all main paths: {_sums_line(totals)}")
    case_sums = launch_sums(cases["shapes"], cases["rows"])
    say(f"[cases] kernel time over the case-study path's launches: "
        f"{_sums_line(case_sums)}")
    launches.update(cases["launches"])
    shapes.update(cases["shapes"])
    rows.update(cases["rows"])
    totals.update(case_sums)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        err = max([errs[name]] + [r["err"] for r in rows[name].values()])
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": "bytes" if _bytes_bound(name, shapes)
                        else "operations",
                        "library_ms": t["library_ms"]})
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _bytes_bound(name, shapes) -> bool:
    """Whether bytes, not operations, bound the kernel's launches on the
    main paths, summed over them."""
    byte_ms = op_ms = 0.0
    for sig, n in shapes[name].items():
        b_ms, o_ms = bound_terms_ms(name, sig)
        byte_ms += n * b_ms
        op_ms += n * o_ms
    return byte_ms >= op_ms


if __name__ == "__main__":
    sys.exit(main())
