#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases print on their own lines; any failure raises and exits non-zero, and
no phase is caught.

1. device: torch and CUDA versions, the card's name and power limit.
2. build: ``nvcc`` builds the six kernels (``csrc/*.cu``), one process
   each, all started together; the build time.
3. K1 ``matmul_h100`` against its plain version: in bf16 at every matmul
   triple of the full llama3-8b serve path at M = 4 and 32 through the leaf
   the dispatch picks; through the pick at N = 25 in f32 and N = 32001 in
   bf16 at M = 1 and 4, and with both operands one element past a 16-byte
   boundary, all of which take the masked loads; five launches of one
   split-K pick compared bit for bit; and at the six signatures of
   ``MM_SIGNATURES``, twelve feasible leaves of different (bm, bn, bk, s,
   kb, stages, cached) each (the pick, the leaves one step from it, the
   napkin's two worst and its best others), each held against the plain
   version (the paper's code soundness, Def. 2 ii) and timed, eagerly and
   as device time, with the napkin's rank beside the card's.
4. K2 ``flash_attention_h100`` against its plain version in bf16, through
   the leaf the dispatch picks: with one KV head a query head, a prefill
   chunk, decode over a ragged cache, non-causal sk = 200, window 128; GQA
   at the llama3-8b (32/8) and hymba-1.5b (25/5, window 1024) groupings;
   and at sk 4096 a llama decode, a 256-row causal llama prefill chunk and
   a hymba decode (its window reads 1024 of the 4096 keys).  A pick with
   more than one key split is launched three times, bit for bit.  Each
   row is timed eagerly and as device time beside SDPA (``enable_gqa`` where
   the installed PyTorch takes it), and under ``torch.profiler`` each
   kernel's device time a call (K2's attention and split combine, SDPA's
   own).  Then at four llama3-8b signatures and the hymba decode at sk
   4096 (``K2_LEAF_ROWS``) ten feasible leaves of different (bq, bkv,
   kv_chunk, stages) each, held against the plain version and timed, with
   the napkin's rank beside the card's.  Then the paged entry (one launch
   for every row, through the block tables, lengths on the device) against
   its plain version on a bf16 pool (``K2_PAGED_ROWS``): decode over 4 rows
   of ragged lengths, one of them 0 (all zeros), at the llama and hymba
   groupings over a 4096-key pool, launched three times bit for bit over
   its several splits; a prefill chunk at each grouping; f32 q on the bf16
   pool.  Each row timed eagerly and as device time beside SDPA over the
   K/V gathered out of the pool beforehand (SDPA's time leaves out the
   gather).
5. K3 ``ssd_scan_h100`` against its plain version in bf16 with an f32
   state, updated in place as the serve path does, at the mamba2-130m (24
   heads of 64, state 128) and hymba-1.5b (25 heads of 64, state 16)
   signatures: a decode step of 4 rows at seq 1 with a mask of every row,
   and again with row 2 masked out (its state must stay bit for bit),
   every chunk length 1..256 with the state in, seq 200 (no multiple of
   any chunk) with and without a state, and a prefill chunk's launch (the
   whole 4-slot state, ``state_rows`` picking slot 3 on the device; the
   other slots' states bit for bit) in the step body (4 steps) and the
   chunk body (256 steps for mamba, 32 for hymba), through the leaf the
   dispatch picks; each row also held by relative error (``SSD_REL``)
   against a planted fault; and every feasible leaf (chunk, bd) at a one-row
   256-step mamba chunk, timed eagerly and as device time, with the
   napkin's rank beside the card's and the pick's time as a multiple of
   the fastest leaf's.
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
   2^22 x 8 and transpose at 4 x 2^25, the last two with more than 65,535
   blocks on the grid's y; matadd's pick timed at 8192² in bf16 and in f32 one element off
   the 16-byte boundary; and at each of the four sizes up to eight leaves
   of different
   formats, each held against the plain version and timed, with the
   napkin's rank beside the card's (a Jacobi sweep also as device time):
   the leaves live under ``H100_SXM``
   (matadd: grain 2; transpose and Jacobi: cached, case 1, grains 1-8) and
   the leaves the tree keeps for a smaller machine (matadd's grain-1 case
   C2 at G = 12; the uncached case 3 of transpose and Jacobi at V = 0),
   which ``H100_SXM`` never picks.
7. serve parity: the llama3, mamba2 and hymba SMOKE configs in f32, each
   served on ``cuda`` (the kernels, the decode tick and every prefill
   chunk replayed from their CUDA graphs, at ``async_depth`` 1 and 2) and
   on ``cpu`` (their plain versions) from the same weights; the greedy
   tokens are equal, the decode graph replays once a decode tick, the
   prefill graphs once a chunk, and no prefill body runs eagerly.
8. serve, the main paths, each through ``init_model`` (bf16, random weights
   from a seeded ``torch.Generator`` on the card) and
   ``ServeEngine(warm_kernels=True)``, 4 requests of 8 new tokens, every
   launch counter set to 0 just before and read just after each path:
   mamba2-130m at full width (24 layers; prompts of 200-500 tokens,
   ``prefill_chunk`` 256, ``max_len`` 1024), hymba-1.5b at full width (32
   layers) and llama3-8b at full width (32 layers), the last two with
   prompts of 16-64 tokens, ``prefill_chunk`` 32, ``max_len`` 256.  Each
   engine captures its decode tick and one prefill graph for each
   quantized chunk length (nine for mamba2's 256: 256 down to 1; six for
   32) at construction, all sharing one memory pool (each graph's capture
   time printed).  Every request returns ``max_new`` tokens, each kernel
   of the path launched (K1 and K3; K1, K2 and K3; K1 and K2), the decode
   graph replayed once a decode tick and the prefill graphs once a chunk
   with no eager prefill body, the launch counts (a replay counting its
   captured launches) match the steps run — K1 per projection, K2 and K3
   one a layer, for every prefill chunk and decode step — no dispatch
   resolved cold after warm-up, and a full-width forward gives finite
   logits.  The host time of a decode tick (over the ticks that ran no
   prefill chunk) and of a prefill chunk (by its length), from
   ``step()`` to the replay's return, is printed beside its device time
   (CUDA events around the replay), medians.  llama3-8b then serves the
   same prompts at ``async_depth`` 2: its tokens equal those at depth 1.
   Then it serves them four times more on its engine, untraced, under
   ``obs.tracing()`` twice, untraced (the walls with and without the
   trace; a ``TickSpan`` each tick, nothing but tick spans and admission
   decisions after warm-up), and once traced under ``torch.profiler``:
   the device's idle share, 1 − (the device time of every kernel and copy
   the profiler lists) / the run's wall.
9. main-path shapes: every launch signature of phase 8 is run again on
   fresh inputs of its shape, held against the plain version, and timed:
   kernel, plain version, the library call, and the bound.  A paged K2
   signature runs through the paged entry over a pool and tables at the
   served lengths: a decode step's rows each halfway through its request's
   new tokens, a prefill chunk at the mean prompt length (the lengths on
   the device during the run are not read back).  Then the host
   cost a launch: the host clock over 1000 launches with no synchronise
   inside the loop, of K1 at M = 1, N = 32, K = 32 through the wrapper,
   ``ops.matmul`` and, beside them, ``torch.matmul``, and of K3 at
   mamba2-130m's decode signature (4, 1, 24, 64, 128), in place with a
   mask as the decode step calls it, through the wrapper, ``ops.ssd_scan``
   and the C entry alone.
10. the engine options: (b) the port's dispatch tables for ``h100_sxm``
   (``--quick``) and a llama3-8b serve plan at phase 8's settings, built
   into a temporary directory by ``python -m
   repro_torch.launch.compile_artifacts`` and ``plan_artifacts`` (called
   in-process); an online-warmed and a plan-backed llama3-8b engine
   (full width, bf16), each start's warm and capture seconds; the
   plan-backed start makes 0 cold builds and 0 online enumerations
   (``core.select.STATS``), every pick equals the online pick, and both
   engines give the same tokens bit for bit on phase 8's prompts; then
   one table rewritten: the start warns (``StalePlanWarning``) and warms
   online, and ``strict_plans`` raises ``StalePlanError``.  (a) prefix
   sharing at full width: eight requests of 8 new tokens whose prompts
   share a 48-token prefix (three full blocks) and have 8-24 tokens of
   their own, two of them diverging mid-block (so CoW copies run), served
   with the leader first, sharing on and off, on the same weights, every
   launch counter set to 0 just before each run and read just after:
   prefix hits, tokens saved, CoW copies, prefill chunks, launches and
   walls; every request returns 8 tokens, the pool's invariants hold, the
   prefill tokens computed equal the prompt tokens less the tokens saved,
   a prefill graph replays once a chunk, and the launches match the steps
   run; bf16 tokens with and without sharing are printed as an agreement
   count, not held (a tail chunk has another M).  (c) the plan-backed
   llama3-8b engine, given ``degrade``, takes a ``serve.decode`` fault
   mid-run: one K1 triple demoted, the steps that launch it captured
   again (seconds printed), every request finishes, tokens printed as an
   agreement count.  Then the degrade drill on phase 7's f32 smoke
   configs at ``async_depth`` 1 and 2, each engine warmed and with
   ``degrade``: schedule A (a ``serve.prefill`` error at tick 1, a
   ``serve.decode`` error at tick 6) demotes and recaptures exactly the
   steps whose recorded triples hold the demoted one (printed by key with
   seconds), the KV pool, SSM state and ``last_tok`` bit for bit across
   each recapture, tokens equal to the fault-free run; schedule B (two
   ``serve.decode`` errors at one tick) poisons and recomputes with equal
   tokens; schedule C (a fatal fault) propagates, then the engine drains.
   The pool's invariants are proved every tick.

Times are medians over 5 CUDA-event batches of repeated launches after one
warm-up launch, printed with their spread (the slowest batch less the
fastest): one mean over one batch let a single slow batch set a row.  A
launch whose host cost exceeds its device time reads its host cost this
way, so K1-K6, ``torch.matmul`` and SDPA also print ``device_ms``
(``library_device_ms`` for the library call): 20 launches (K4's 1 GB
transposes 5) captured in one CUDA graph, replayed in 5 batches, the
median over them.  A
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
peak of the H100 SXM data sheet for the unit that does the arithmetic (989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32: a bf16 SSD chunk of more
than one step runs its products on the tensor cores, a step or f32 on the
CUDA cores, and ``bound_f32_ms`` gives a chunk's bound with every flop at
the f32 rate beside it), a sum or a Jacobi point in f32, a transpose
none.  The
library call is a yardstick timed only here: ``torch.matmul`` (its output
is bf16, the kernel's f32), ``scaled_dot_product_attention``, ``torch.add``
for matadd and ``a.t().contiguous()`` for transpose (the plain versions of
K5 and K4 are those very calls), and for a Jacobi sweep ``avg_pool1d(x, 3,
stride=1)``, the sweep's interior as a new vector (its largest difference
from the plain sweep is printed, not held); no single PyTorch call computes
the SSD scan, so K3 has none.

The line before the last is the kernels' JSON record (its ``ms`` are the
eager times above, as in every earlier run).  For K1-K3
``launches`` is phase 8's count over the three serve paths; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over those
launches, each timed at its own signature in phase 9.  For K4-K6 the same
numbers come from phase 6's case-study path (1, 1 and 8 launches), each
signature timed in phase 6.  ``max_abs_err`` is the largest error against
the plain version over phases 3-6 and 9.  The last line is the device
record.

Tolerances, kernel against plain version on the same inputs:

- matmul (bf16 or f32 in, f32 out), rtol 1e-4 / atol 1e-3: a bf16 product
  is exact in f32, so the two differ only in the order of K f32 additions
  inside a k tile (tensor cores or FMA against cuBLAS); both add the tiles
  of a split in order and the split-K partials in split order 0..kb-1, so
  split-K changes only which sums are grouped; with B scaled by
  1/sqrt(K), as the model's weights are, outputs are O(1) and K <= 14336
  additions drift by at most K * 2^-24 ~ 1e-3.
- attention in bf16, rtol = atol = 1e-2 (the paged entry alike): both
  compute in f32 and round the
  output to bf16 once; the two may round apart by one bf16 step (2^-7);
  the kernel also rounds P to bf16 for the tensor cores (2^-9 relative,
  averaged over the keys), and combines the key splits in the same order.
  At sk 4096 an output element is about 0.02, so 1e-2 barely tells a
  dropped split from rounding: a launch over more than one split is also
  held to ||got - want|| / ||want|| <= 2^-6 (rounding gives a few 2^-9),
  and the same check must refuse a planted fault, the reference computed
  without the first split some query sees.
- SSD scan: rtol = atol = 1e-3 on the f32 state, which both compute in f32
  by the same recurrence in another order of sums (at most 256 + state
  terms of O(1)) and with ``expf``/``logf`` against ``torch.exp``/``log``;
  rtol = atol = 1e-2 on the bf16 y, one bf16 step as for attention.  The
  bf16 chunk body feeds G, the state and w⊙b to the tensor cores as a high
  and a low bf16 part (~16 bits; one rounding of G would break the 1e-2),
  and every bf16 launch is also held to ||got - want|| / ||want|| <= 2^-6
  (the split gives ~1e-4), a check that must refuse a planted fault: the
  plain version with one step's decay set to 1.
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
FA_REL = 2.0 ** -6                    # relative Frobenius error, split rows
SSD_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
SSD_Y_TOL = dict(rtol=1e-2, atol=1e-2)
SSD_REL = 2.0 ** -6                   # relative Frobenius error, bf16 y
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
#: {paged K2 signature: the rows' lengths it is timed and bound at}: phase
#: 4's own, and for phase 9 the lengths phase 8 served at it.
PAGED_LENS = {}


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time a launch: ``reps`` launches captured in one CUDA graph,
    replayed in ``BATCHES`` CUDA-event batches, the median over ``reps``.
    The host enqueues one graph, so a launch's host cost drops out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ms = time_ms(g.replay, 1)[0] / reps
    del g
    return ms


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
    head) at the rate of the unit that does them (the bf16 tensor cores
    for a bf16 chunk, f32 for a step or f32; :func:`ssd_f32_bound_ms`
    gives a bf16 chunk's bound at the f32 rate), attention's K/V bytes over
    its hk KV heads and
    only the keys some query can see (a window's), matadd one f32 add an element, a Jacobi sweep
    two adds and a division a point, a transpose none.  A paged K2 launch
    counts each row at its length in ``PAGED_LENS`` (its q and output, and
    the pool's bytes of the keys it can see)."""
    esz = torch.empty((), dtype=sig[-2 if sig[0] == "paged" else -1]
                      ).element_size()
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
        R, S, H, hd, n, _, _, with_state, masked, srows, dtype = sig
        state_bytes = 4 * R * H * n * hd          # the R rows read, written
        # a bf16 chunk runs its products on the tensor cores; the step body
        # and f32 run on the CUDA cores in f32
        peak = PEAK_FLOPS[dtype if S > 1 else torch.float32]
        return (2 * R * S * H * hd * esz + 4 * R * S * H + 2 * R * S * n * esz
                + R * masked + 4 * R * (srows > 0)
                + state_bytes * (2 if with_state else 1),
                5.0 * R * S * H * n * hd, peak)
    if sig[0] == "paged":
        _, rows, h, hk, sq, _, d, _, _, _, _, _, causal, window, dtype, kv = sig
        kv_esz = torch.empty((), dtype=kv).element_size()
        nbytes, flops = 0, 0.0
        for n in PAGED_LENS[sig]:            # each row at its own length
            mask = _visible(sq, n, causal, window) if n else None
            keys = int(mask.any(0).sum()) if n else 0
            pairs = int(mask.sum()) if n else 0
            nbytes += 2 * h * sq * d * esz + 2 * hk * keys * d * kv_esz
            flops += 4.0 * h * pairs * d
        return nbytes, flops, PEAK_FLOPS[dtype]
    h, hk, sq, sk, d = sig[:5]
    causal, window = sig[9:11]
    mask = _visible(sq, sk, causal, window)
    keys = int(mask.any(0).sum())           # keys some query can see
    pairs = int(mask.sum())
    return (2 * (h * sq * d + hk * keys * d) * esz, 4.0 * h * pairs * d,
            PEAK_FLOPS[sig[-1]])


def bound_terms_ms(name: str, sig) -> tuple:
    nbytes, flops, peak = work(name, sig)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak


def ssd_f32_bound_ms(sig) -> float:
    """K3's bound at ``sig`` with every flop at the f32 rate, as the
    parent's kernel (all on the CUDA cores) was bound."""
    nbytes, flops, _ = work("ssd_scan_h100", sig)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     flops / PEAK_FLOPS[torch.float32])


# ---------------------------------------------------------------------------
# K1, K2 and K3 at one signature: check against plain, time, bound
# ---------------------------------------------------------------------------

def matmul_case(sig, gen, *, timed: bool, leaf_only: bool = False,
                a=None, b=None):
    """K1 at (M, N, K, bm, bn, bk, s, kb, stages, cached, dtype), the
    wrapper's ``shapes`` key, on fresh inputs (or ``a``, ``b``): held
    against the plain version; timed when ``timed`` (the kernel alone when
    ``leaf_only``)."""
    from repro_torch.kernels.matmul import matmul_h100, matmul_plain
    M, N, K, bm, bn, bk, s, kb, stages, cached, dtype = sig
    if a is None:
        a = torch.randn((M, K), generator=gen, device=DEV).to(dtype)
        b = (torch.randn((K, N), generator=gen, device=DEV)
             / math.sqrt(K)).to(dtype)
    kw = dict(bm=bm, bn=bn, bk=bk, s=s, kb=kb, stages=stages, cached=cached)
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
        row["device_ms"] = graph_ms(lambda: matmul_h100(a, next(bs), **kw))
        if not leaf_only:
            time_into(row, "plain_ms",
                      lambda: matmul_plain(a, next(bs), **kw), 2)
            time_into(row, "library_ms",
                      lambda: torch.matmul(a, next(bs)), 10)
            row["library_device_ms"] = graph_ms(
                lambda: torch.matmul(a, next(bs)))
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


_SDPA_GQA = []


def sdpa_gqa() -> bool:
    """Whether the installed ``scaled_dot_product_attention`` takes
    ``enable_gqa`` (K/V with fewer heads than q); else phase 4 and 9 time it
    on K/V broadcast outside the timed loop."""
    if not _SDPA_GQA:
        q = torch.zeros((1, 2, 1, 8), device=DEV)
        try:
            F.scaled_dot_product_attention(q, q[:, :1], q[:, :1],
                                           enable_gqa=True)
            _SDPA_GQA.append(True)
        except TypeError:
            _SDPA_GQA.append(False)
    return _SDPA_GQA[0]


def _masked_attention(q, k, v, mask) -> torch.Tensor:
    """f32 attention of q [h, sq, d] over the keys ``mask`` [sq, sk] leaves,
    K/V broadcast to q's heads; a row that sees no key gives 0."""
    group = q.shape[0] // k.shape[0]
    s = (q.float() @ k.float().repeat_interleave(group, 0).transpose(1, 2)
         / math.sqrt(q.shape[-1])).masked_fill(~mask, -math.inf)
    p = torch.softmax(s, -1).nan_to_num(0.0)
    return p @ v.float().repeat_interleave(group, 0)


def split_held(name, q, k, v, got, want, kv_chunk, causal, window) -> tuple:
    """(relative error, planted fault's relative error) of a launch over
    more than one key split: ||got - want|| / ||want|| within ``FA_REL``,
    and the same check refusing the reference computed without the first
    split some query sees."""
    def rel(x):
        return float((x.float() - want.float()).norm()
                     / want.float().norm())
    err = rel(got)
    if err > FA_REL:
        raise AssertionError(f"{name}: relative error {err:.3e} > {FA_REL}")
    sq, sk = q.shape[1], k.shape[1]
    mask = _visible(sq, sk, causal, window)
    z0 = int(mask.any(0).nonzero()[0]) // kv_chunk * kv_chunk
    keys = torch.arange(sk, device=DEV)
    fault = rel(_masked_attention(
        q, k, v, mask & ((keys < z0) | (keys >= z0 + kv_chunk))).to(q.dtype))
    if fault <= FA_REL:
        raise AssertionError(f"{name}: the relative check passes a launch "
                             f"without split {z0 // kv_chunk} ({fault:.3e})")
    return err, fault


def kernel_us(fn, calls: int = 20) -> dict:
    """{kernel name: device µs a call} of ``fn`` under ``torch.profiler``,
    over ``calls`` calls after 3 warm-up calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if e.count and t:
            out[e.key] = out.get(e.key, 0.0) + t / calls
    return out


def flash_case(sig, gen, *, timed: bool, launches: int = 1,
               leaf_only: bool = False, profiled: bool = False):
    """K2 at (h, hk, sq, sk, d, bq, bkv, kv_chunk, stages, causal, window,
    dtype), the wrapper's ``shapes`` key, on fresh inputs: held against the
    plain version (and ``launches`` launches equal bit for bit; over more
    than one split also by ``split_held``); timed eagerly and as device
    time beside SDPA when ``timed`` (the kernel alone when ``leaf_only``),
    each kernel's device time under the profiler when ``profiled``."""
    from repro_torch.kernels.flash_attention import (flash_attention_h100,
                                                     flash_attention_plain)
    if sig[0] == "paged":
        return paged_case(sig, gen, timed=timed, launches=launches)
    h, hk, sq, sk, d, bq, bkv, kv_chunk, stages, causal, window, dtype = sig
    q = torch.randn((h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((hk, sk, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((hk, sk, d), generator=gen, device=DEV).to(dtype)
    kw = dict(bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
              causal=causal, window=window)
    got = flash_attention_h100(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    row = {"err": held(f"flash {sig}", got, want, FA_TOL)}
    if sk > kv_chunk:
        row["rel"], row["fault_rel"] = split_held(
            f"flash {sig}", q, k, v, got, want, kv_chunk, causal, window)
    for _ in range(launches - 1):
        if not torch.equal(got, flash_attention_h100(q, k, v, **kw)):
            raise AssertionError(f"flash {sig}: two launches differ")
    if timed:
        mask = _visible(sq, sk, causal, window)
        sdpa_mask = None if bool(mask.all()) else mask
        if sdpa_gqa():
            ks, vs, extra = k[None], v[None], {"enable_gqa": h != hk}
        else:
            ks = k.repeat_interleave(h // hk, 0)[None]
            vs = v.repeat_interleave(h // hk, 0)[None]
            extra = {}
        def sdpa():
            return F.scaled_dot_product_attention(
                q[None], ks, vs, attn_mask=sdpa_mask, **extra)
        time_into(row, "ms",
                  lambda: flash_attention_h100(q, k, v, **kw), 10)
        row["device_ms"] = graph_ms(
            lambda: flash_attention_h100(q, k, v, **kw))
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
        if leaf_only:
            return row
        time_into(row, "plain_ms",
                  lambda: flash_attention_plain(q, k, v, **kw), 2)
        time_into(row, "library_ms", sdpa, 10)
        row["library_device_ms"] = graph_ms(sdpa)
    if profiled:
        row["k2_us"] = kernel_us(lambda: flash_attention_h100(q, k, v, **kw))
        row["sdpa_us"] = kernel_us(sdpa)
    return row


def paged_case(sig, gen, *, timed: bool, launches: int = 1):
    """K2's paged entry at ("paged", rows, h, hk, sq, nblk·page, d, page,
    bq, bkv, kv_chunk, stages, causal, window, dtype, pool dtype), its
    ``shapes`` key, each row at its length in ``PAGED_LENS``: a pool of
    rows · nblk + 1 blocks, each row's table a random draw of them.  Held
    against the paged plain version (a row of length 0 all zeros; each row
    over more than one split also by ``split_held`` on its gathered keys;
    ``launches`` launches bit for bit); timed eagerly and as device time
    beside SDPA over the gathered K/V with each row's mask (SDPA's time
    leaves out the gather) when ``timed``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_h100_paged, flash_attention_paged_plain)
    (_, rows, h, hk, sq, keys, d, page, bq, bkv, kv_chunk, stages, causal,
     window, dtype, kv_dtype) = sig
    lens = PAGED_LENS[sig]
    nblk = keys // page
    nb = rows * nblk + 1
    q = torch.randn((rows, h, sq, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((nb, page, hk, d), generator=gen, device=DEV).to(kv_dtype)
    v = torch.randn((nb, page, hk, d), generator=gen, device=DEV).to(kv_dtype)
    tables = (torch.randperm(nb - 1, generator=gen, device=DEV) + 1).view(
        rows, nblk).to(torch.int32)
    tl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    kw = dict(bq=bq, bkv=bkv, kv_chunk=kv_chunk, stages=stages,
              causal=causal, window=window)

    def launch():
        return flash_attention_h100_paged(q, k, v, tables, tl, **kw)

    got = launch()
    torch.cuda.synchronize()
    want = flash_attention_paged_plain(q, k, v, tables, tl, **kw)
    row = {"err": held(f"paged flash {sig[:-2]} lens {lens}", got, want,
                       FA_TOL)}

    def gathered(pool, b, n):
        return pool[tables[b].long()].reshape(-1, hk, d)[:n].permute(
            1, 0, 2).contiguous()

    rels = []
    for b, n in enumerate(lens):
        if n == 0:
            exact(f"paged flash {sig[:-2]} row {b} of length 0", got[b],
                  torch.zeros_like(got[b]))
        elif n > kv_chunk:
            rels.append(split_held(
                f"paged flash {sig[:-2]} row {b}", q[b], gathered(k, b, n),
                gathered(v, b, n), got[b], want[b], kv_chunk, causal,
                window))
    if rels:
        row["rel"] = max(r[0] for r in rels)
        row["fault_rel"] = min(r[1] for r in rels)
    for _ in range(launches - 1):
        if not torch.equal(got, launch()):
            raise AssertionError(f"paged flash {sig[:-2]}: two launches "
                                 "differ")
    if timed:
        kpos = torch.arange(keys, device=DEV)
        qpos = (torch.arange(sq, device=DEV)[None, :, None]
                + tl[:, None, None] - sq)                 # [rows, sq, 1]
        mask = (kpos < tl[:, None, None]) & (kpos <= qpos)
        if window is not None:
            mask &= kpos > qpos - window
        kg = k[tables.long()].reshape(rows, keys, hk, d).permute(0, 2, 1, 3)
        vg = v[tables.long()].reshape(rows, keys, hk, d).permute(0, 2, 1, 3)
        kg, vg = kg.to(dtype).contiguous(), vg.to(dtype).contiguous()
        if sdpa_gqa():
            extra = {"enable_gqa": h != hk}
        else:
            kg = kg.repeat_interleave(h // hk, 1)
            vg = vg.repeat_interleave(h // hk, 1)
            extra = {}

        def sdpa():
            return F.scaled_dot_product_attention(q, kg, vg,
                                                  attn_mask=mask[:, None],
                                                  **extra)
        time_into(row, "ms", launch, 10)
        row["device_ms"] = graph_ms(launch)
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
        time_into(row, "plain_ms", lambda: flash_attention_paged_plain(
            q, k, v, tables, tl, **kw), 2)
        time_into(row, "library_ms", sdpa, 10)
        row["library_device_ms"] = graph_ms(sdpa)
    return row


def ssd_rel_held(name, y, want, fault) -> tuple:
    """(relative error, planted fault's relative error) of a bf16 launch:
    ||y - want|| / ||want|| within ``SSD_REL``, and the same check refusing
    ``fault``, the plain version's y with one step's decay set to 1."""
    def rel(t):
        return float((t.float() - want.float()).norm()
                     / want.float().norm())
    err, bad = rel(y), rel(fault)
    if err > SSD_REL:
        raise AssertionError(f"{name}: relative error {err:.3e} > {SSD_REL}")
    if bad <= SSD_REL:
        raise AssertionError(f"{name}: the relative check passes a launch "
                             f"with one step's decay set to 1 ({bad:.3e})")
    return err, bad


def ssd_case(sig, gen, *, timed: bool, leaf_only: bool = False,
             drop: int = -1):
    """K3 at (rows, seq, heads, hd, state, chunk, bd, state given, masked,
    state rows, dtype), the wrapper's ``shapes`` key, on inputs shaped as
    the model makes them: x, b, c in the compute type, b and c one [rows,
    seq, state] projection shared across heads, the decay in (0.05, 0.95)
    and the state in f32, updated in place as the serve path does, with a
    mask of every row but ``drop`` (none when -1) when masked.  With state
    rows > 0 the state has that many rows and ``state_rows`` sends row r to
    state row (state rows − 1 − r), as a prefill chunk of slot 3 of 4 is
    sent; the state rows no index names must stay bit for bit.  Held
    against the plain version (a row left out bit for bit; a bf16 launch
    also by relative error, against a planted fault); timed eagerly and as
    device time when ``timed`` (the kernel alone when ``leaf_only``)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_h100, ssd_scan_plain
    R, S, H, hd, n, chunk, bd, with_state, masked, srows, dtype = sig
    x = torch.randn((R, S, H, hd), generator=gen, device=DEV).to(dtype)
    a = torch.sigmoid(torch.randn((R, S, H), generator=gen,
                                  device=DEV)) * 0.9 + 0.05
    b = torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
    c = torch.randn((R, S, n), generator=gen, device=DEV).to(dtype)
    s0 = (torch.randn((srows or R, H, n, hd), generator=gen, device=DEV)
          if with_state or srows else None)
    mask = (torch.arange(R, device=DEV) != drop) if masked else None
    rows = (srows - 1 - torch.arange(R, device=DEV)).int() if srows else None
    kw = dict(chunk=chunk, bd=bd, mask=mask, state_rows=rows)

    def state():                             # a copy to update in place
        return s0.clone() if s0 is not None else None

    def start(st):                           # state0 is None: no state in
        return st if with_state else None

    st = state()
    y, s1 = ssd_scan_h100(x, a, b, c, start(st), out_state=st, **kw)
    torch.cuda.synchronize()
    ws = state()
    wy, ws = ssd_scan_plain(x, a, b, c, start(ws), out_state=ws, **kw)
    row = {"err": max(held(f"ssd state {sig}", s1, ws, SSD_STATE_TOL),
                      held(f"ssd y {sig}", y, wy, SSD_Y_TOL))}
    if drop >= 0:
        kept = int(rows[drop]) if srows else drop
        exact(f"ssd state of masked row {drop} {sig}", s1[kept], s0[kept])
    if srows:
        named = set(rows.tolist())
        for r in range(srows):
            if r not in named:
                exact(f"ssd state row {r} no index names {sig}", s1[r],
                      s0[r])
    if dtype == torch.bfloat16:
        af = a.clone()
        af[:, S // 2] = 1.0                  # step S // 2 forgets no state
        fs = state()
        fault, _ = ssd_scan_plain(x, af, b, c, start(fs), out_state=fs, **kw)
        row["rel"], row["fault_rel"] = ssd_rel_held(f"ssd {sig}", y, wy,
                                                    fault)
        row["fault"] = "one decay set to 1"
    if timed:
        def launch():
            return ssd_scan_h100(x, a, b, c, start(st), out_state=st, **kw)
        time_into(row, "ms", launch, 10)
        row["device_ms"] = graph_ms(launch)
        row["bound_ms"] = max(bound_terms_ms("ssd_scan_h100", sig))
        row["bound_f32_ms"] = ssd_f32_bound_ms(sig)
        if not leaf_only:
            ps = state()
            time_into(row, "plain_ms", lambda: ssd_scan_plain(
                x, a, b, c, start(ps), out_state=ps, **kw), 2)
            row["library_ms"] = None
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


def matadd_case(sig, gen, *, timed: bool, shift: int = 0):
    """K5 at (M, N, bm, bn, s, dtype); ``shift`` 1 puts A and B one element
    into their buffers, off the 16-byte boundary the vector loads need."""
    from repro_torch.kernels.matadd import matadd_h100, matadd_plain
    M, N, bm, bn, s, dtype = sig
    a, b = (torch.randn((M * N + shift,), generator=gen, device=DEV).to(
        dtype)[shift:].view(M, N) for _ in range(2))
    kw = dict(bm=bm, bn=bn, s=s)
    got = matadd_h100(a, b, **kw)
    torch.cuda.synchronize()
    row = {"err": exact(f"matadd {sig}", got, matadd_plain(a, b, **kw))}
    if timed:
        time_into(row, "ms", lambda: matadd_h100(a, b, **kw), 10)
        row["device_ms"] = graph_ms(lambda: matadd_h100(a, b, **kw))
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
        row["device_ms"] = graph_ms(lambda: transpose_h100(a, **kw), 5)
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
        row["device_ms"] = graph_ms(lambda: sweep(*next(bufs), **kw))
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
    for key in ("ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_f32_ms"):
        if row.get(key) is not None:
            out += f" {key} {row[key]:.4f}"
            if key + "_spread" in row:
                out += f" (spread {row[key + '_spread']:.4f})"
    if "library_err" in row:
        out += f" library_err {row['library_err']:.3e}"
    if "rel" in row:
        fault = row.get("fault", "without a split")
        out += f" rel_err {row['rel']:.3e} ({fault} {row['fault_rel']:.3e})"
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


#: The K1 signatures PERF.md follows (M, N, K), bf16: decode and prefill
#: projections of the three models, each timed at the pick and eleven
#: other leaves.
MM_SIGNATURES = (
    ("llama decode q/o proj", (4, 4096, 4096)),
    ("llama decode lm_head", (4, 128256, 4096)),
    ("llama prefill MLP down", (1, 4096, 14336)),
    ("hymba decode B/C proj", (4, 16, 1600)),
    ("hymba decode MLP up", (4, 5504, 1600)),
    ("mamba prefill x proj", (256, 1536, 768)),
)
MM_PARAMS = ("bm", "bn", "bk", "s", "kb", "stages")


def _mm_sig(data, cand, dtype) -> tuple:
    """The launch signature of candidate ``cand`` (an uncached leaf runs
    one stage)."""
    from repro_torch.kernels.matmul import FAMILY
    fn = FAMILY.instantiate(cand.plan, cand.assignment, "cuda",
                            leaf_index=cand.leaf_index)
    return (data["M"], data["N"], data["K"],
            *(fn.keywords[n] for n in MM_PARAMS), fn.keywords["cached"],
            dtype)


def _mm_leaves(data, want: int = 12) -> list:
    """The pick, then the feasible leaves one step from it (kb, stages, bn,
    bm, s or bk changed), then the napkin's two worst, then its best others:
    ``want`` candidates of different (bm, bn, bk, s, kb, stages, cached)."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels.matmul import FAMILY
    ranked = rank_candidates(FAMILY, H100_SXM, data)
    key = lambda c: (*(c.assignment[n] for n in MM_PARAMS),
                     c.plan.flags["smem_cache"])
    by_key = {}
    for c in ranked:
        by_key.setdefault(key(c), c)
    pick = ranked[0]
    order = [pick]
    p = dict(pick.assignment)
    steps = [("kb", 2), ("kb", 0.5), ("stages", None), ("bn", 2),
             ("bn", 0.5), ("bm", 2), ("s", None), ("bk", None)]
    for name, f in steps:
        near = dict(p)
        if f is None:
            dom = sorted({c.assignment[name] for c in ranked})
            others = [x for x in dom if x != p[name]]
            if not others:
                continue
            near[name] = others[0]
        else:
            near[name] = int(p[name] * f)
        c = by_key.get((*(near[n] for n in MM_PARAMS), True))
        if c is not None:
            order.append(c)
    order += ranked[:-3:-1] + ranked[1:]
    out, seen = [], set()
    for c in order:
        if key(c) not in seen:
            seen.add(key(c))
            out.append(c)
        if len(out) == want:
            break
    return out


def phase_k1(gen) -> float:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config("llama3_8b")
    d, hd = cfg.d_model, cfg.hd
    err = 0.0
    for M in (4, 32):
        triples = [(cfg.heads * hd, d), (cfg.kv_heads * hd, d),
                   (cfg.d_ff, d), (d, cfg.d_ff), (cfg.vocab, d)]
        for N, K in triples:                  # q and out proj are 4096²
            m = 1 if (N == cfg.vocab and M == 32) else M  # prefill lm_head
            data = {"M": m, "N": N, "K": K}
            cand = ops.select("matmul_h100", data)
            row = matmul_case(_mm_sig(data, cand, torch.bfloat16), gen,
                              timed=False)
            err = max(err, row["err"])
            say(f"[K1] M{m} N{N} K{K} leaf {dict(cand.assignment)} cached "
                f"{cand.plan.flags['smem_cache']}: {fmt(row)}")

    # ragged and misaligned: N = 25 (f32, the decay projection) and N =
    # 32001 (bf16, hymba's lm_head) take the masked load of B; M = 1; a
    # storage offset of one element takes the masked load of A and B
    for (M, N, K), dtype in [((4, 25, 1600), torch.float32),
                             ((1, 25, 1600), torch.float32),
                             ((4, 32001, 1600), torch.bfloat16),
                             ((1, 32001, 1600), torch.bfloat16)]:
        data = {"M": M, "N": N, "K": K}
        cand = ops.select("matmul_h100", data)
        row = matmul_case(_mm_sig(data, cand, dtype), gen, timed=False)
        err = max(err, row["err"])
        say(f"[K1] ragged {dtype} M{M} N{N} K{K} leaf "
            f"{dict(cand.assignment)}: {fmt(row)}")
    for dtype in (torch.float32, torch.bfloat16):
        M, N, K = 5, 4096, 1000
        a = torch.randn((M * K + 1,), generator=gen, device=DEV).to(dtype)
        b = (torch.randn((K * N + 1,), generator=gen, device=DEV)
             / math.sqrt(K)).to(dtype)
        a, b = a[1:].view(M, K), b[1:].view(K, N)
        sig = (M, N, K, 16, 128, 32, 1, 8, 4, True, dtype)
        row = matmul_case(sig, gen, timed=False, a=a, b=b)
        err = max(err, row["err"])
        say(f"[K1] misaligned {dtype} (storage offset 1) {sig[:-1]}: "
            f"{fmt(row)}")

    # two launches bit for bit, through the split-K combine
    data = dict(zip("MNK", MM_SIGNATURES[0][1]))
    cand = ops.select("matmul_h100", data)
    a = torch.randn((data["M"], data["K"]), generator=gen, device=DEV
                    ).bfloat16()
    b = torch.randn((data["K"], data["N"]), generator=gen, device=DEV
                    ).bfloat16()
    fn = ops.FAMILIES["matmul_h100"].instantiate(cand.plan, cand.assignment,
                                                 "cuda")
    first = fn(a, b)
    same = all(torch.equal(first, fn(a, b)) for _ in range(4))
    say(f"[K1] five launches of {dict(cand.assignment)} at {data}: bit for "
        f"bit equal {same}")
    if not same:
        raise AssertionError("K1: two launches on the same inputs differ")

    # leaves of the tree at each signature: napkin rank, card rank
    for name, (M, N, K) in MM_SIGNATURES:
        data = {"M": M, "N": N, "K": K}
        leaves = _mm_leaves(data)
        if len(leaves) < 8:
            raise AssertionError(f"{name}: only {len(leaves)} leaves")
        a = torch.randn((M, K), generator=gen, device=DEV).bfloat16()
        b = (torch.randn((K, N), generator=gen, device=DEV)
             / math.sqrt(K)).bfloat16()
        rows = {}
        for cand in leaves:
            sig = _mm_sig(data, cand, torch.bfloat16)
            rows[sig] = dict(matmul_case(sig, gen, timed=True,
                                         leaf_only=True, a=a, b=b),
                             score=cand.score)
            err = max(err, rows[sig]["err"])
        del a, b
        torch.cuda.empty_cache()
        rank = {key: sorted(rows, key=lambda k: rows[k][key])
                for key in ("ms", "device_ms")}
        by_score = sorted(rows, key=lambda k: -rows[k]["score"])
        for i, (sig, row) in enumerate(rows.items()):
            leaf = dict(zip(MM_PARAMS + ("cached",), sig[3:10]))
            say(f"[K1] leaf {name} M{M} N{N} K{K} {leaf}"
                f"{' (pick)' if i == 0 else ''}: {fmt(row)}; napkin score "
                f"{row['score']:.4g} rank {by_score.index(sig) + 1}, card "
                f"rank {rank['ms'].index(sig) + 1} (device "
                f"{rank['device_ms'].index(sig) + 1}) of {len(rows)}")
        pick = rows[next(iter(rows))]
        for key in ("ms", "device_ms"):
            best = rows[rank[key][0]][key]
            say(f"[K1] {name}: {key} pick {pick[key]:.4f}, fastest of "
                f"{len(rows)} leaves {best:.4f} ({pick[key] / best:.2f}x)")
    return err


#: Phase 4's rows: (name, h, hk, sq, sk, d, causal, window).  One KV head
#: a query head (the old contract), GQA at the llama3-8b (32/8) and
#: hymba-1.5b (25/5, d 64, window 1024) groupings, and the long-context
#: rows at sk 4096 the serve path's short prompts never reach.
K2_ROWS = (
    ("prefill chunk", 32, 32, 32, 96, 128, True, None),
    ("decode", 32, 32, 1, 77, 128, True, None),
    ("non-causal sk 200", 32, 32, 32, 200, 128, False, None),
    ("window 128", 32, 32, 32, 300, 128, True, 128),
    ("llama GQA prefill chunk", 32, 8, 32, 96, 128, True, None),
    ("llama GQA decode", 32, 8, 1, 77, 128, True, None),
    ("hymba GQA prefill chunk", 25, 5, 32, 96, 64, True, 1024),
    ("hymba GQA decode", 25, 5, 1, 77, 64, True, 1024),
    ("llama decode sk 4096", 32, 8, 1, 4096, 128, True, None),
    ("llama 256-row prefill sk 4096", 32, 8, 256, 4096, 128, True, None),
    ("hymba decode sk 4096, window 1024", 25, 5, 1, 4096, 64, True, 1024),
)


def _fa_sig(h, hk, sq, sk, d, causal, window, dtype=torch.bfloat16):
    """The launch signature of the dispatch's pick for these shapes."""
    from repro_torch.kernels import ops
    a = ops.select("flash_attention_h100",
                   {"SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk}
                   ).assignment
    return (h, hk, sq, sk, d, a["bq"], a["bkv"], a["kv_chunk"], a["stages"],
            causal, window, dtype)


#: The K2 signatures whose leaves phase 4 times (name, h, hk, sq, sk, d,
#: causal, window): a serve decode step and prefill chunk of llama3-8b,
#: the two llama rows at sk 4096 and hymba-1.5b's windowed decode there.
K2_LEAF_ROWS = (
    ("llama decode sk 64", 32, 8, 1, 64, 128, True, None),
    ("llama prefill chunk sq 32 sk 64", 32, 8, 32, 64, 128, True, None),
    ("llama decode sk 4096", 32, 8, 1, 4096, 128, True, None),
    ("llama 256-row prefill sk 4096", 32, 8, 256, 4096, 128, True, None),
    ("hymba decode sk 4096, window 1024", 25, 5, 1, 4096, 64, True, 1024),
)
FA_PARAMS = ("bq", "bkv", "kv_chunk", "stages")
#: Phase 4's paged rows: (name, h, hk, d, window, rows, sq, lengths, nblk,
#: page, q dtype), on a bf16 pool: decode over 4 rows of ragged lengths,
#: one of them 0, at both groupings over a 4096-key pool (more than one
#: split), a prefill chunk at the served pool of 256 keys, and f32 q on the
#: bf16 pool (the f32 models of phase 7).
K2_PAGED_ROWS = (
    ("llama paged decode", 32, 8, 128, None, 4, 1, (77, 0, 1000, 4096), 256,
     16, torch.bfloat16),
    ("hymba paged decode", 25, 5, 64, 1024, 4, 1, (77, 0, 1500, 4096), 256,
     16, torch.bfloat16),
    ("llama paged prefill chunk", 32, 8, 128, None, 1, 32, (96,), 16, 16,
     torch.bfloat16),
    ("hymba paged prefill chunk", 25, 5, 64, 1024, 1, 32, (200,), 16, 16,
     torch.bfloat16),
    ("llama paged decode, f32 q on the bf16 pool", 32, 8, 128, None, 4, 1,
     (77, 0, 150, 256), 16, 16, torch.float32),
)


def _paged_sig(h, hk, d, window, rows, sq, nblk, page, dtype) -> tuple:
    """The paged launch signature of the dispatch's pick for these shapes
    (a bf16 pool)."""
    from repro_torch.kernels import ops
    a = ops.select("flash_attention_h100",
                   {"SQ": sq, "HD": d, "GROUP": h // hk, "HK": hk}
                   ).assignment
    return ("paged", rows, h, hk, sq, nblk * page, d, page,
            *(a[n] for n in FA_PARAMS), True, window, dtype, torch.bfloat16)


def _fa_leaves(data, want: int = 10) -> list:
    """The pick, then the feasible leaves one step from it (bq, kv_chunk
    doubled and halved, the other bkv and stages), then the napkin's two
    worst, then its best others: ``want`` candidates of different formats."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels.flash_attention import FAMILY
    ranked = rank_candidates(FAMILY, H100_SXM, data)
    key = lambda c: tuple(c.assignment[n] for n in FA_PARAMS)
    by_key = {}
    for c in ranked:
        by_key.setdefault(key(c), c)
    pick = ranked[0]
    p = dict(pick.assignment)
    order = [pick]
    for name, vals in (("bq", (2 * p["bq"], p["bq"] // 2)),
                       ("kv_chunk", (2 * p["kv_chunk"], p["kv_chunk"] // 2)),
                       ("bkv", (96 - p["bkv"],)),
                       ("stages", (2, 3, 4))):
        for val in vals:
            c = by_key.get(tuple({**p, name: val}[n] for n in FA_PARAMS))
            if c is not None:
                order.append(c)
    order += ranked[:-3:-1] + ranked[1:]
    out, seen = [], set()
    for c in order:
        if key(c) not in seen:
            seen.add(key(c))
            out.append(c)
        if len(out) == want:
            break
    return out


def _profile_line(times: dict) -> str:
    """'total: kernel t; ...' of ``kernel_us``, longest first, K2's two
    kernels by their short names."""
    def short(name):
        return next((k for k in ("combine_kernel", "flash_kernel")
                     if k in name), name[:48])
    parts = "; ".join(f"{short(n)} {t:.2f}" for n, t in
                      sorted(times.items(), key=lambda kv: -kv[1]))
    return f"{sum(times.values()):.2f} ({parts})"


def phase_k2(gen) -> float:
    err = 0.0
    for name, h, hk, sq, sk, d, causal, window in K2_ROWS:
        sig = _fa_sig(h, hk, sq, sk, d, causal, window)
        # a split pick (sk past kv_chunk) is launched three times, bit for bit
        splits = -(-sk // sig[7])
        row = flash_case(sig, gen, timed=True,
                         launches=3 if splits > 1 else 1, profiled=True)
        err = max(err, row["err"])
        leaf = dict(zip(("bq", "bkv", "kv_chunk", "stages"), sig[5:9]))
        say(f"[K2] {name}: h{h} hk{hk} sq{sq} sk{sk} d{d} window {window} "
            f"leaf {leaf}, {splits} split(s)"
            f"{', three launches bit for bit equal' if splits > 1 else ''}: "
            f"{fmt(row)}")
        say(f"[K2] {name}: device us a call (profiler): K2 "
            f"{_profile_line(row['k2_us'])}; SDPA "
            f"{_profile_line(row['sdpa_us'])}")
    say(f"[K2] SDPA timed with enable_gqa: {sdpa_gqa()}")

    # the paged entry: every row of a layer in one launch, through the
    # tables, at the lengths on the device
    for name, h, hk, d, window, rows, sq, lens, nblk, page, dtype in \
            K2_PAGED_ROWS:
        sig = _paged_sig(h, hk, d, window, rows, sq, nblk, page, dtype)
        PAGED_LENS[sig] = lens
        nsplit = -(-nblk * page // sig[10])
        row = paged_case(sig, gen, timed=True,
                         launches=3 if nsplit > 1 else 1)
        err = max(err, row["err"])
        leaf = dict(zip(FA_PARAMS, sig[8:12]))
        say(f"[K2] {name}: rows {rows} h{h} hk{hk} sq{sq} d{d} window "
            f"{window} lengths {list(lens)}, pool {nblk} x {page} keys, "
            f"{dtype} q, leaf {leaf}, {nsplit} split(s)"
            f"{', three launches bit for bit equal' if nsplit > 1 else ''}"
            f", row of length 0 all zeros: {fmt(row)} (SDPA over K/V "
            f"gathered beforehand: its time leaves out the gather)")

    # leaves of the tree at each signature: napkin rank, card rank
    for name, h, hk, sq, sk, d, causal, window in K2_LEAF_ROWS:
        rows = {}
        for cand in _fa_leaves({"SQ": sq, "HD": d, "GROUP": h // hk,
                                "HK": hk}):
            sig = (h, hk, sq, sk, d,
                   *(cand.assignment[n] for n in FA_PARAMS), causal, window,
                   torch.bfloat16)
            rows[sig] = dict(flash_case(sig, gen, timed=True,
                                        leaf_only=True), score=cand.score)
            err = max(err, rows[sig]["err"])
        rank = {k: sorted(rows, key=lambda s: rows[s][k])
                for k in ("ms", "device_ms")}
        by_score = sorted(rows, key=lambda s: -rows[s]["score"])
        for i, (sig, row) in enumerate(rows.items()):
            leaf = dict(zip(FA_PARAMS, sig[5:9]))
            say(f"[K2] leaf {name} {leaf}{' (pick)' if i == 0 else ''}: "
                f"{fmt(row)}; napkin score {row['score']:.4g} rank "
                f"{by_score.index(sig) + 1}, card rank "
                f"{rank['ms'].index(sig) + 1} (device "
                f"{rank['device_ms'].index(sig) + 1}) of {len(rows)}")
        pick = rows[next(iter(rows))]
        for k in ("ms", "device_ms"):
            best = rows[rank[k][0]][k]
            say(f"[K2] {name}: {k} pick {pick[k]:.4f}, fastest of "
                f"{len(rows)} leaves {best:.4f} ({pick[k] / best:.2f}x)")
    return err


#: Phase 5's leaf rows: a one-row 256-step mamba2-130m prefill chunk.
K3_LEAF_SIG = (1, 256, 24, 64, 128)
K3_PARAMS = ("chunk", "bd")


def phase_k3(gen) -> float:
    from repro_torch.configs import get_config
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import FAMILY as SSD
    err = 0.0
    for arch in ("mamba2_130m", "hymba_1p5b"):
        s = get_config(arch).ssm
        cases = [("decode, 4 rows, in place", 4, 1, True, True, -1),
                 ("decode, 4 rows, in place, row 2 masked out", 4, 1, True,
                  True, 2)]
        cases += [(f"chunk {n}", 1, n, True, False, -1) for n in
                  (1, 2, 4, 8, 16, 32, 64, 128, 256)]
        cases += [("seq 200, no state", 1, 200, False, False, -1),
                  ("seq 200, state in", 1, 200, True, False, -1)]
        # a prefill chunk's launch: the whole 4-slot state, slot 3 picked
        # on the device, in the step body and in the chunk body
        cases += [(f"chunk {n}, state row 3 of 4 by state_rows", 1, n, True,
                   False, -1, 4) for n in (4, 32 if s.state < 64 else 256)]
        for name, rows, seq, with_state, masked, drop, *srows in cases:
            a = ops.select("ssd_scan_h100", {"SQ": seq, "HD": s.head_dim,
                                             "STATE": s.state}).assignment
            sig = (rows, seq, s.heads, s.head_dim, s.state, a["chunk"],
                   a["bd"], with_state, masked, srows[0] if srows else 0,
                   torch.bfloat16)
            row = ssd_case(sig, gen, timed=False, drop=drop)
            err = max(err, row["err"])
            say(f"[K3] {arch} {name}: heads {s.heads} hd {s.head_dim} state "
                f"{s.state} leaf {dict(a)}: {fmt(row)}"
                f"{'; the masked row kept its state bit for bit' if drop >= 0 else ''}"
                f"{'; the other state rows kept theirs bit for bit' if srows else ''}")

    # every feasible leaf at one 256-step mamba chunk: napkin rank, card rank
    R, S, H, hd, n = K3_LEAF_SIG
    data = {"SQ": S, "HD": hd, "STATE": n}
    ranked = rank_candidates(SSD, H100_SXM, data)
    leaves, seen = [], set()
    for cand in ranked:
        key = tuple(cand.assignment[k] for k in K3_PARAMS)
        if key not in seen:
            seen.add(key)
            leaves.append(cand)
    if len(leaves) < 5:
        raise AssertionError(f"only {len(leaves)} K3 leaves at {data}")
    rows = {}
    for cand in leaves:
        sig = (R, S, H, hd, n, cand.assignment["chunk"],
               cand.assignment["bd"], True, False, 0, torch.bfloat16)
        rows[sig] = dict(ssd_case(sig, gen, timed=True, leaf_only=True),
                         score=cand.score)
        err = max(err, rows[sig]["err"])
    rank = {k: sorted(rows, key=lambda g: rows[g][k])
            for k in ("ms", "device_ms")}
    by_score = sorted(rows, key=lambda g: -rows[g]["score"])
    for i, (sig, row) in enumerate(rows.items()):
        leaf = dict(zip(K3_PARAMS, sig[5:7]))
        say(f"[K3] leaf {leaf}{' (pick)' if i == 0 else ''} at rows {R} seq "
            f"{S} heads {H} hd {hd} state {n}: {fmt(row)}; napkin score "
            f"{row['score']:.4g} rank {by_score.index(sig) + 1}, card rank "
            f"{rank['ms'].index(sig) + 1} (device "
            f"{rank['device_ms'].index(sig) + 1}) of {len(rows)}")
    pick = rows[next(iter(rows))]
    for k in ("ms", "device_ms"):
        best = rows[rank[k][0]][k]
        say(f"[K3] seq {S} chunk: {k} pick {pick[k]:.4f}, fastest of "
            f"{len(rows)} leaves {best:.4f} ({pick[k] / best:.2f}x)")
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
    # thin operands: matadd's (1, 2^25) has 16,384 column blocks (on the
    # grid's x), its (2^22, 8) and transpose's (4, 2^25) more than 65,535
    # blocks on the grid's y (one launch a 65,535)
    w = torch.randn((1 << 25,), generator=gen, device=DEV)
    exact("ops.matadd 1x2^25", ops.matadd(w[None], w.flip(0)[None]),
          w[None] + w.flip(0)[None])
    t8 = w.view(1 << 22, 8)
    exact("ops.matadd 2^22x8", ops.matadd(t8, t8.flip(0)), t8 + t8.flip(0))
    w = w.repeat(4).view(4, 1 << 25)
    exact("ops.transpose 4x2^25", ops.transpose(w), w.t().contiguous())
    del w, t8
    say(f"[cases] bf16 matadd and transpose at {tuple(ab.shape)}, f32 at "
        f"{tuple(r.shape)} and n {x.numel()}, matadd at (1, 2^25) and "
        f"(2^22, 8) and transpose at (4, 2^25): agree")
    del a, b, t, xs, ab, tb
    torch.cuda.empty_cache()

    rows = {name: {} for name in kernels}
    for name, data in CASE_PATH:
        rows[name].update(case_leaf_rows(name, data, gen))
    # K5's pick at 8192² in bf16, and in f32 with A and B one element into
    # their buffers (the masked scalar path), bit for bit and timed
    pick = _format(ops.FAMILIES["matadd_h100"],
                   ops.select("matadd_h100", add_d))
    for dtype, shift in ((torch.bfloat16, 0), (torch.float32, 1)):
        sig = _sig("matadd_h100", add_d, pick, dtype)
        row = matadd_case(sig, gen, timed=True, shift=shift)
        if not shift:
            rows["matadd_h100"][sig] = row
        say(f"[cases] matadd pick {sig[:-1]} {dtype}"
            f"{', misaligned by one element' if shift else ''}: {fmt(row)}")
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
        _, on_cpu = _serve(cfg, params_cpu, prompts, "cpu", **kw)
        cpu_toks = [r.out for r in on_cpu]
        say(f"[parity] {cfg.name} f32, cpu plain:    {cpu_toks}")
        for depth in (1, 2):
            eng, on_gpu = _serve(cfg, params_gpu, prompts, DEV,
                                 async_depth=depth, **kw)
            gpu_toks = [r.out for r in on_gpu]
            st = eng.sched.stats
            prefills = sum(g.replays for g in eng.prefill_graphs.values())
            say(f"[parity] {cfg.name} f32, cuda kernels, decode graph "
                f"replayed {eng.graph.replays} times, prefill graphs "
                f"{prefills} times for {st.prefill_chunks} chunks, eager "
                f"prefill bodies {eng.eager_prefills}, async_depth {depth}: "
                f"{gpu_toks}")
            if eng.graph.replays != st.decode_ticks:
                raise AssertionError(f"{cfg.name}: {eng.graph.replays} "
                                     "graph replays, "
                                     f"{st.decode_ticks} decode ticks")
            if prefills != st.prefill_chunks or eng.eager_prefills:
                raise AssertionError(f"{cfg.name}: {prefills} prefill graph "
                                     f"replays and {eng.eager_prefills} eager"
                                     f" prefills for {st.prefill_chunks} "
                                     "chunks")
            eng.close()
            if gpu_toks != cpu_toks or any(len(t) != MAX_NEW
                                           for t in gpu_toks):
                raise AssertionError(
                    f"serve parity ({cfg.name}, async_depth {depth}): "
                    "tokens differ between the kernels on cuda and the "
                    "plain versions on cpu")


class _TickClock:
    """Times an engine's steps: the host clock from ``step()``'s start to a
    graph replay's return, and CUDA events around the replay (its device
    time), for each prefill chunk (by its length) and for each decode tick
    that ran no prefill chunk."""

    def __init__(self, eng):
        self.eng, self.decode_graph = eng, eng.graph
        self.host, self.events = {}, {}
        self._t0 = self._chunks = None
        step = eng.step

        def timed_step():
            self._t0 = time.perf_counter()
            self._chunks = eng.sched.stats.prefill_chunks
            return step()
        eng.step = timed_step
        eng.graph = _Timed(self, "decode", eng.graph)
        eng.prefill_graphs = {C: _Timed(self, C, g)
                              for C, g in eng.prefill_graphs.items()}

    def profile(self) -> str:
        """The decode tick's device time by kernel under ``torch.profiler``
        (20 replays of the graph on the last tick's inputs, uncounted):
        K1-K3 and the rest, with the rest's largest kernels."""
        times = kernel_us(self.decode_graph.graph.replay)
        groups = {"K1": ("matmul_kernel",),
                  "K2": ("flash_kernel", "combine_kernel"),
                  "K3": ("ssd_",)}
        sums = {g: 0.0 for g in list(groups) + ["other"]}
        other = {}
        for name, t in times.items():
            g = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), "other")
            sums[g] += t
            if g == "other":
                other[name[:60]] = t
        top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
        return (f"decode tick device us by kernel (profiler, a replay): "
                f"total {sum(sums.values()):.1f}; "
                + ", ".join(f"{g} {t:.1f}" for g, t in sums.items())
                + "; largest other: "
                + "; ".join(f"{n} {t:.1f}" for n, t in top))

    def lines(self) -> list:
        """One line for the decode ticks, one a prefill chunk length:
        host and device medians (and ranges) in ms."""
        torch.cuda.synchronize()
        out = []
        for key in sorted(self.events, key=lambda k: (k != "decode", k)):
            dev = sorted(s.elapsed_time(e) for s, e in self.events[key])
            host = sorted(1e3 * t for t in self.host[key])
            what = ("decode tick (no prefill chunk in it" if key == "decode"
                    else f"prefill chunk of {key} tokens (one graph replay")
            out.append(
                f"{what}, {len(dev)} of them): host {host[len(host) // 2]:.3f}"
                f" ms median (from step() to the replay's return; "
                f"{host[0]:.3f}-{host[-1]:.3f}), device "
                f"{dev[len(dev) // 2]:.3f} ms median (CUDA events around the "
                f"replay; {dev[0]:.3f}-{dev[-1]:.3f})")
        return out or ["no step timed"]


class _Timed:
    """One captured step of an engine, timed by ``clock`` under ``key`` at
    each replay."""

    def __init__(self, clock: _TickClock, key, step):
        self.clock, self.key, self.step = clock, key, step

    def __call__(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.step()
        end.record()
        c = self.clock
        if self.key != "decode" or \
                c.eng.sched.stats.prefill_chunks == c._chunks:
            c.host.setdefault(self.key, []).append(
                time.perf_counter() - c._t0)
            c.events.setdefault(self.key, []).append((start, end))

    def __getattr__(self, name):               # replays, graph, delta
        return getattr(self.step, name)


def _serve_wall(eng, prompts) -> tuple:
    """Serve ``prompts`` on ``eng``; (wall s, outputs, ticks)."""
    ticks = eng.sched.ticks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r.out for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, [done[r] for r in rids],
            eng.sched.ticks - ticks)


def phase_trace(eng, prompts, outs) -> None:
    """llama3-8b served again on its engine under ``obs.tracing()``: the
    tick count against the ``TickSpan`` count, the wall with and without
    the trace (alternated, two runs each), and the device's idle share
    over a traced run under ``torch.profiler``: 1 − (the device time of
    every kernel and copy it lists) / that run's wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    walls = {False: [], True: []}
    for traced in (False, True, True, False):
        if traced:
            with obs.tracing() as rec:
                wall, toks, ticks = _serve_wall(eng, prompts)
            spans = [r for r in rec.records() if r["etype"] == "tick_span"]
            bad = [r for r in rec.records() if r["etype"] not in (
                "tick_span", "admission_decision")]
            say(f"[trace] {eng.cfg.name}: {ticks} ticks, {len(spans)} "
                f"TickSpan records, {len(rec)} records in all "
                f"({rec.dropped} dropped); median span "
                f"{sorted(r['duration_us'] for r in spans)[len(spans) // 2]:.1f}"
                f" us on the engine's clock; other records: {len(bad)}")
            if len(spans) != ticks or rec.dropped:
                raise AssertionError(f"{ticks} ticks, {len(spans)} spans")
            if bad:
                raise AssertionError(f"records past warm-up: {bad[:2]}")
        else:
            wall, toks, ticks = _serve_wall(eng, prompts)
        walls[traced].append(wall)
        if toks != outs:
            raise AssertionError("tokens of a repeated run differ")
    say(f"[trace] {eng.cfg.name} wall s untraced "
        f"{', '.join(f'{w:.3f}' for w in walls[False])}, traced "
        f"{', '.join(f'{w:.3f}' for w in walls[True])} (runs in the order "
        "untraced, traced, traced, untraced)")
    with obs.tracing(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, toks, _ = _serve_wall(eng, prompts)
    busy_us = 0.0                     # self times: nothing counted twice
    for e in prof.key_averages():
        busy_us += (getattr(e, "self_device_time_total", 0)
                    or getattr(e, "self_cuda_time_total", 0) or 0)
    if not busy_us or toks != outs:
        raise AssertionError("the profiler saw no device time, or the "
                             "profiled run's tokens differ")
    idle = 1.0 - busy_us / 1e6 / wall
    say(f"[trace] {eng.cfg.name} device idle share over a traced run under "
        f"torch.profiler: {idle:.4f} (device busy {busy_us / 1e3:.3f} ms of "
        f"{1e3 * wall:.3f} ms wall; against the faster traced wall without "
        f"the profiler {1.0 - busy_us / 1e6 / min(walls[True]):.4f})")


def phase_serve(arch: str, serve_kw: dict, prompt_lens: tuple,
                depths: tuple = (1,), traced: bool = False) -> dict:
    """One main path: ``arch`` at full width through ServeEngine; returns
    its name, wall time and each kernel's launches and launch shapes.  Each
    depth of ``depths`` past the first serves the same prompts once more at
    that ``async_depth``: its tokens must equal the first run's.  With
    ``traced``, :func:`phase_trace` serves them again on the engine."""
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
    say(f"[serve] warm-up: {len(eng.kernel_plan)} kernel picks frozen and "
        f"{1 + len(eng.prefill_graphs)} steps captured in "
        f"{time.perf_counter() - t0:.1f} s (workspaces, eager runs and "
        f"captures {eng.capture_s:.3f} s); engine {serve_kw}")
    say(f"[serve] {cfg.name} capture s a graph (its eager run and capture): "
        + ", ".join(f"{k} {t:.3f}" for k, t in eng.capture_times.items()))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(*prompt_lens, 4)]

    kernels = _counters(SERVE_KERNELS)
    clock = _TickClock(eng)
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
    replays = eng.graph.replays
    prefill_replays = {C: g.replays for C, g in eng.prefill_graphs.items()}

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
        f"prefill chunks, {st.decode_ticks} decode steps, {replays} decode "
        f"graph replays, prefill graph replays by chunk length "
        f"{prefill_replays}, eager prefill bodies {eng.eager_prefills}")
    for line in clock.lines():
        say(f"[serve] {cfg.name} {line}")
    say(f"[serve] {cfg.name} {clock.profile()}")
    say(f"[serve] {cfg.name} launches: {json.dumps(launches)}; matmul per "
        f"prefill chunk or decode step {per_step_mm}, K2 and K3 one a layer "
        f"each; cold dispatch builds after warm-up: {cold}")
    used = ["matmul_h100"] + ["flash_attention_h100"] * attn \
        + ["ssd_scan_h100"] * ssm
    if any(launches[n] == 0 for n in used):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    if replays != st.decode_ticks:
        raise AssertionError(f"{replays} graph replays for {st.decode_ticks}"
                             " decode ticks")
    if sum(prefill_replays.values()) != st.prefill_chunks \
            or eng.eager_prefills:
        raise AssertionError(f"prefill graph replays {prefill_replays} and "
                             f"{eng.eager_prefills} eager prefill bodies for"
                             f" {st.prefill_chunks} chunks")
    if launches["matmul_h100"] != per_step_mm * steps:
        raise AssertionError("matmul launches do not match the steps run")
    if launches["flash_attention_h100"] != cfg.layers * steps * attn:
        raise AssertionError("attention launches do not match the steps run")
    if launches["ssd_scan_h100"] != cfg.layers * steps * ssm:
        raise AssertionError("SSD scan launches do not match the steps run")
    # the lengths phase 9 times each paged signature at: a decode step's
    # rows halfway through their new tokens, a prefill chunk at the mean
    # prompt length (the served lengths; the device's own are not read)
    for sig in shapes["flash_attention_h100"]:
        rows, sq = sig[1], sig[4]
        PAGED_LENS[sig] = (
            tuple(len(p) + MAX_NEW // 2 for p in prompts)[:rows]
            if sq == 1 and rows == len(prompts)
            else (max(sq, round(np.mean([len(p) for p in prompts]))),))
    if traced:
        phase_trace(eng, prompts, [r.out for r in outs])
    eng.close()

    for depth in depths[1:]:
        again = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                            async_depth=depth, **serve_kw)
        t0 = time.perf_counter()
        rids = [again.submit(p, max_new=MAX_NEW) for p in prompts]
        redo = {r.rid: r.out for r in again.run_until_drained()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = [redo[r] for r in rids]
        say(f"[serve] {cfg.name} at async_depth {depth}: {ntok} tokens in "
            f"{dt:.3f} s: {ntok / dt:.2f} tokens/s; tokens equal to "
            f"async_depth {depths[0]}: {toks == [r.out for r in outs]}")
        if toks != [r.out for r in outs]:
            raise AssertionError(f"{cfg.name}: async_depth {depth} tokens "
                                 "differ")
        again.close()
        del again

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


def phase_host_cost(gen) -> None:
    """Host clock over 1000 launches at M = 1, N = 32, K = 32 with no
    synchronise inside the loop: what a launch costs the host through the
    wrapper, through ``ops.matmul`` (dispatch and wrapper) and, beside
    them, ``torch.matmul``; then two parts of the wrapper alone, the C
    entry point (checks and the launch) and the output's ``torch.empty``."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    a = torch.randn((1, 32), generator=gen, device=DEV).bfloat16()
    b = torch.randn((32, 32), generator=gen, device=DEV).bfloat16()
    cand = ops.select("matmul_h100", {"M": 1, "N": 32, "K": 32})
    fn = ops.FAMILIES["matmul_h100"].instantiate(cand.plan, cand.assignment,
                                                 "cuda")
    c = torch.empty((1, 32), device=DEV)
    kw = fn.keywords
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), None, None, 1, 32, 32,
            kw["bm"], kw["bn"], kw["bk"], kw["s"], 1, kw["stages"],
            int(kw["cached"]), 1, torch.cuda.current_stream().cuda_stream)
    for label, call in (("wrapper", lambda: fn(a, b)),
                        ("ops.matmul", lambda: ops.matmul(a, b)),
                        ("torch.matmul", lambda: torch.matmul(a, b)),
                        ("of which the C entry alone",
                         lambda: mm._entry()(*args)),
                        ("of which torch.empty", lambda: torch.empty(
                            (1, 32), dtype=torch.float32, device=DEV))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        host = (time.perf_counter() - t0) / 1000
        torch.cuda.synchronize()
        say(f"[shapes] K1 host cost a launch, {label}, M1 N32 K32 (leaf "
            f"{dict(cand.assignment)}): {1e3 * host:.4f} ms")

    # K3 at mamba2-130m's decode signature (4, 1, 24, 64, 128), as the
    # decode step calls it: in place, with a device mask of the rows
    from repro_torch.kernels import ssd_scan as ssd
    R, S, H, hd, N = 4, 1, 24, 64, 128
    x = torch.randn((R, S, H, hd), generator=gen, device=DEV).bfloat16()
    av = torch.full((R, S, H), 0.5, device=DEV)
    bc = torch.randn((R, S, N), generator=gen, device=DEV).bfloat16()
    st = torch.randn((R, H, N, hd), generator=gen, device=DEV)
    mask = torch.ones((R,), dtype=torch.bool, device=DEV)
    cand = ops.select("ssd_scan_h100", {"SQ": S, "HD": hd, "STATE": N})
    fn = ops.FAMILIES["ssd_scan_h100"].instantiate(cand.plan,
                                                   cand.assignment, "cuda")
    y = torch.empty_like(x)
    bx = bc[:, :, None, :].expand(R, S, H, N)
    args = (x.data_ptr(), av.data_ptr(), bc.data_ptr(), bc.data_ptr(),
            st.data_ptr(), y.data_ptr(), st.data_ptr(), mask.data_ptr(),
            None, R, 0, S, H, hd, N, 1, fn.keywords["bd"], *bx.stride()[:3],
            *bx.stride()[:3], 1, torch.cuda.current_stream().cuda_stream)
    for label, call in (("wrapper",
                         lambda: fn(x, av, bc, bc, st, out_state=st,
                                    mask=mask)),
                        ("ops.ssd_scan",
                         lambda: ops.ssd_scan(x, av, bc, bc, st,
                                              out_state=st, mask=mask)),
                        ("of which the C entry alone",
                         lambda: ssd._entry()(*args))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        host = (time.perf_counter() - t0) / 1000
        torch.cuda.synchronize()
        say(f"[shapes] K3 host cost a launch, {label}, rows {R} seq {S} "
            f"heads {H} hd {hd} state {N}, in place, masked (leaf "
            f"{dict(cand.assignment)}): {1e3 * host:.4f} ms")


def launch_sums(shapes, rows) -> dict:
    """{name: {key: sum over the launches in ``shapes`` of the key's time
    at each launch's signature}} (None where a signature has none)."""
    out = {}
    for name, by_sig in shapes.items():
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "library_device_ms": 0.0,
               "bound_ms": 0.0, "bound_f32_ms": 0.0}
        for sig, n in by_sig.items():
            for key in tot:
                val = rows[name][sig].get(key)
                tot[key] = (None if tot[key] is None or val is None
                            else tot[key] + n * val)
        out[name] = tot
    return out


def _sums_line(sums) -> str:
    return "; ".join(f"{name} " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items() if v is not None)
        for name, tot in sums.items() if tot["ms"])


# ---------------------------------------------------------------------------
# Phase 10: the engine options on the card
# ---------------------------------------------------------------------------

#: Phase 8's llama3-8b engine settings, which phase 10 serves at, and the
#: three of them a serve plan is traced for.
LLAMA_KW = dict(PATHS[2][1])
LLAMA_SIZES = {k: LLAMA_KW[k] for k in ("max_len", "max_batch",
                                        "prefill_chunk")}
#: Phase 7's smoke engine settings and prompt lengths, for the drill.
DRILL_KW = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8)
DRILL_LENS = (5, 19, 11, 3, 26)


def _fresh_cache(root=None):
    """A new process-wide dispatch cache (on the tables under ``root``)."""
    from repro_torch.artifacts import ArtifactStore, DispatchCache
    from repro_torch.artifacts.dispatch import set_default_cache
    cache = DispatchCache(store=ArtifactStore(root) if root else None)
    set_default_cache(cache)
    return cache


def _serve_timed(eng, prompts, staged: bool = False) -> tuple:
    """Serve ``prompts`` on ``eng`` (``staged``: the first to completion,
    then the rest); (wall s, outputs in submit order)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids, outs = [], {}
    batches = [prompts[:1], prompts[1:]] if staged else [prompts]
    for batch in batches:
        rids += [eng.submit(p, max_new=MAX_NEW) for p in batch]
        for r in eng.run_until_drained():
            if r.error is not None:
                raise AssertionError(f"request {r.rid}: {r.error}")
            outs[r.rid] = r.out
    torch.cuda.synchronize()
    return time.perf_counter() - t0, [outs[r] for r in rids]


def _agree(a, b) -> str:
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    return f"{same} of {sum(len(p) for p in a)} tokens agree"


def _shared_prompts(vocab: int) -> list:
    """Eight prompts: a 48-token prefix (three full 16-token blocks) and
    8-24 tokens of their own; the leader's own 16 fill block 3, and two
    followers take its first 8 of them before they diverge, mid-block, so
    they map block 3 and copy it on write."""
    rng = np.random.default_rng(10)
    prefix = rng.integers(0, vocab, 48)
    lead_tail = rng.integers(0, vocab, 16)
    prompts = [np.concatenate([prefix, lead_tail])]
    for i in range(7):
        own = rng.integers(0, vocab, int(rng.integers(8, 25)))
        head = lead_tail[:8] if i < 2 else own[:0]
        prompts.append(np.concatenate([prefix, head, own]))
    return prompts


def _check_pool(eng) -> None:
    eng.pool.check_invariants([s.blocks for s in eng.sched.running()])


def phase_options() -> None:
    """The engine options of this slice on the card: (a) prefix sharing at
    full width, (b) a plan-backed start, (c) the degrade drill."""
    import tempfile
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.core import select as tselect
    from repro_torch.launch import compile_artifacts, plan_artifacts
    from repro_torch.models import init_model
    from repro_torch.plans import PlanStore, StalePlanError, StalePlanWarning
    from repro_torch.runtime import ServeEngine
    from repro_torch.runtime.serving import warm_kernel_dispatch

    cfg = get_config("llama3_8b")
    params = init_model(cfg, seed=0, device=DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(*PATHS[2][2], 4)]
    kernels = _counters(("matmul_h100", "flash_attention_h100"))
    with tempfile.TemporaryDirectory() as root:
        # (b) the disk tier and a serve plan, built by the two CLIs
        t0 = time.perf_counter()
        if compile_artifacts.main(["--machine", "h100_sxm", "--out", root,
                                   "--quick"]) != 0:
            raise AssertionError("compile_artifacts failed")
        t_tables = time.perf_counter() - t0
        t0 = time.perf_counter()
        if plan_artifacts.main([
                "--config", "llama3_8b", "--out", root,
                "--max-len", str(LLAMA_KW["max_len"]),
                "--max-batch", str(LLAMA_KW["max_batch"]),
                "--prefill-chunk", str(LLAMA_KW["prefill_chunk"])]) != 0:
            raise AssertionError("plan_artifacts failed")
        say(f"[options] (b) tables for h100_sxm (--quick) in {t_tables:.3f}"
            f" s, llama3-8b serve plan in {time.perf_counter() - t0:.3f} s")
        starts = {}
        engines = {}
        for how in ("online", "plan"):
            cache = _fresh_cache(root)
            calls = tselect.STATS.enumerate_calls
            t0 = time.perf_counter()
            eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                              plan_store=(PlanStore(root) if how == "plan"
                                          else False), **LLAMA_KW)
            total = time.perf_counter() - t0
            starts[how] = (total - eng.capture_s, eng.capture_s,
                           cache.stats.cold_builds,
                           tselect.STATS.enumerate_calls - calls)
            engines[how] = (eng, cache)
            say(f"[options] (b) {how} start: warm {starts[how][0]:.3f} s, "
                f"capture {eng.capture_s:.3f} s ({len(eng.capture_times)} "
                f"graphs); cold builds {starts[how][2]}, online "
                f"enumerations {starts[how][3]}; sources "
                f"{sorted({p['rank_source'] for p in eng.kernel_plan.values()})}")
        online, plan = engines["online"][0], engines["plan"][0]
        if starts["plan"][2:] != (0, 0):
            raise AssertionError(f"plan-backed start resolved: {starts}")
        diff = [k for k, p in plan.kernel_plan.items()
                if p["candidate"] != online.kernel_plan[k]["candidate"]]
        if diff or plan.kernel_plan.keys() != online.kernel_plan.keys():
            raise AssertionError(f"plan picks differ from online: {diff}")
        w_on, t_on = _serve_timed(online, prompts)
        w_plan, t_plan = _serve_timed(plan, prompts)
        say(f"[options] (b) {len(plan.kernel_plan)} picks equal; tokens "
            f"bit for bit: {t_plan == t_on} ({_agree(t_on, t_plan)}); "
            f"walls online {w_on:.3f} s, plan-backed {w_plan:.3f} s; cold "
            f"builds while serving {engines['plan'][1].stats.cold_builds}")
        if t_plan != t_on or engines["plan"][1].stats.cold_builds:
            raise AssertionError("plan-backed tokens differ, or it "
                                 "resolved cold while serving")
        # a rewritten table: the start warns and warms online; strict
        # refuses
        from repro_torch.artifacts import ArtifactStore
        store = ArtifactStore(root)
        table = store.load_dispatch("matmul_h100", "h100_sxm")
        bucket = next(iter(table["buckets"]))
        table["buckets"][bucket][0]["score"] += 1.0
        store.save_dispatch(table)
        _fresh_cache(root)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            picks = warm_kernel_dispatch(cfg, plan_store=PlanStore(root),
                                         **LLAMA_SIZES)
        stale = [w for w in caught
                 if issubclass(w.category, StalePlanWarning)]
        _fresh_cache(root)
        try:
            warm_kernel_dispatch(cfg, plan_store=PlanStore(root),
                                 strict_plans=True, **LLAMA_SIZES)
            refused = False
        except StalePlanError:
            refused = True
        say(f"[options] (b) stale table: {len(stale)} StalePlanWarning, "
            f"{len(picks)} picks warmed online "
            f"({sorted({p['rank_source'] for p in picks.values()})}); "
            f"strict_plans raised StalePlanError: {refused}")
        if len(stale) != 1 or not picks or not refused:
            raise AssertionError("the stale plan was not refused")
        online.close()

        # (a) prefix sharing at full width, on and off, the same weights
        shared = _shared_prompts(cfg.vocab)
        runs = {}
        for share in (False, True):
            _fresh_cache(root)
            eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV,
                              prefix_sharing=share, plan_store=False,
                              **LLAMA_KW)
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            wall, toks = _serve_timed(eng, shared, staged=True)
            launches = {n: k.launches for n, k in kernels.items()}
            _check_pool(eng)
            runs[share] = (eng, wall, toks, launches)
        for share, (eng, wall, toks, launches) in runs.items():
            st, ps = eng.sched.stats, eng.pool.stats
            replays = sum(g.replays for g in eng.prefill_graphs.values())
            steps = st.prefill_chunks + st.decode_ticks
            say(f"[options] (a) llama3-8b sharing "
                f"{'on ' if share else 'off'}: {len(toks)} requests, wall "
                f"{wall:.3f} s; prefill chunks {st.prefill_chunks} (graph "
                f"replays {replays}), prefill tokens {st.prefill_tokens} of "
                f"{sum(map(len, shared))}, decode steps {st.decode_ticks}; "
                f"prefix_hits {ps.prefix_hits}, prefix_tokens_saved "
                f"{ps.prefix_tokens_saved}, cow_copies {ps.cow_copies}; "
                f"launches {json.dumps(launches)}")
            if any(len(t) != MAX_NEW for t in toks):
                raise AssertionError("a shared-prefix request came back "
                                     "short")
            if st.prefill_tokens != sum(map(len, shared)) \
                    - ps.prefix_tokens_saved:
                raise AssertionError("prefill tokens computed != prompt "
                                     "tokens - tokens saved")
            if replays != st.prefill_chunks or eng.eager_prefills:
                raise AssertionError("a prefill chunk did not replay once")
            if launches["matmul_h100"] != (cfg.layers * 7 + 1) * steps or \
                    launches["flash_attention_h100"] != cfg.layers * steps:
                raise AssertionError(f"launches {launches} do not match "
                                     f"{steps} steps")
        on, off = runs[True], runs[False]
        ps = on[0].pool.stats
        if not (on[0].sched.stats.prefill_chunks
                < off[0].sched.stats.prefill_chunks
                and ps.cow_copies > 0 and ps.prefix_hits > 0):
            raise AssertionError("sharing saved no chunk or copied nothing")
        say(f"[options] (a) sharing saved "
            f"{off[0].sched.stats.prefill_chunks - on[0].sched.stats.prefill_chunks}"
            f" prefill chunks and {off[1] - on[1]:.3f} s of wall; bf16 "
            f"tokens on against off: {_agree(off[2], on[2])} (not held: a "
            f"tail chunk has another M, so K1 may pick another split)")
        for eng, *_ in runs.values():
            eng.close()

        # (c) full width: one K1 triple demoted mid-run, the graphs that
        # launch it captured again (the model dispatches through the
        # process-wide cache: the engine's own again)
        from repro_torch.artifacts.dispatch import set_default_cache
        from repro_torch.runtime import faults
        from repro_torch.runtime.faults import FaultSpec
        eng, cache = engines["plan"]
        set_default_cache(cache)
        eng.degrade = True
        with faults.inject([FaultSpec("serve.decode",
                                      eng.sched.ticks + 6, "error")]) as inj:
            wall, toks = _serve_timed(eng, prompts)
        (ev,) = eng.degrade_events
        (rec,) = eng.recapture_log
        say(f"[options] (c) llama3-8b bf16 full width: {len(inj.fired)} "
            f"fault, {ev.describe()}; recaptured "
            f"{', '.join(f'{k} {s:.3f} s' for k, s in rec.seconds.items())}"
            f" (grew workspaces: {rec.grew}; all 7 graphs took "
            f"{eng.capture_s:.3f} s at start); wall {wall:.3f} s; tokens "
            f"against the run before: {_agree(t_plan, toks)}")
        if ev.family != "matmul_h100" or not rec.seconds or any(
                len(t) != MAX_NEW for t in toks):
            raise AssertionError("the full-width demotion did not recapture "
                                 "a K1 step or a request came back short")
        eng.close()
    del params, engines, online, plan, eng, runs, on, off
    torch.cuda.empty_cache()
    _fresh_cache()
    phase_drill()


def _drill_engine(cfg, params, depth, **kw):
    from repro_torch.runtime import ServeEngine
    _fresh_cache()
    return ServeEngine(cfg, params, device=DEV, warm_kernels=True,
                       degrade=True, async_depth=depth, **DRILL_KW, **kw)


def _drill_serve(eng, prompts, schedule=()):
    """Serve under ``schedule`` with the pool's invariants proved every
    tick; a recapture's live state (KV pool, SSM state, ``last_tok``) is
    held bit for bit.  Returns the outputs in submit order."""
    from repro_torch.runtime import faults
    real = eng._recapture

    def held(triple):
        torch.cuda.synchronize()
        before = ({k: v.clone() for k, v in eng.cache.items()},
                  eng.last_tok.clone())
        steps = {k: s.triples for k, s in eng._graphs.steps.items()}
        rec = real(triple)
        for k, v in before[0].items():
            if not torch.equal(eng.cache[k], v):
                raise AssertionError(f"a recapture moved the live {k}")
        if not torch.equal(eng.last_tok, before[1]):
            raise AssertionError("a recapture moved last_tok")
        want = list(steps) if rec.grew else [
            k for k, t in steps.items() if triple in t]
        if list(rec.seconds) != want:
            raise AssertionError(f"recaptured {list(rec.seconds)}, the "
                                 f"steps that launch it are {want}")
        return rec
    eng._recapture = held
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    outs = {}
    with faults.inject(list(schedule)) as inj:
        for _ in range(500):
            for r in eng.step():
                outs[r.rid] = r.out
            _check_pool(eng)
            if not eng.sched.has_work():
                break
    for r in eng.run_until_drained():
        outs[r.rid] = r.out
    return [outs[r] for r in rids], inj


def phase_drill() -> None:
    """(c) The degrade drill on the f32 smoke configs of phase 7, at
    ``async_depth`` 1 and 2: schedule A (a prefill error at tick 1, a
    decode error at tick 6) demotes and recaptures, schedule B (two decode
    errors at one tick) poisons and recomputes, both with the fault-free
    tokens; schedule C (a fatal fault) propagates and the engine drains."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.runtime.faults import ANY_TICK, FatalFault, FaultSpec
    sched_a = [FaultSpec("serve.prefill", 1, "error"),
               FaultSpec("serve.decode", 6, "error")]
    sched_b = [FaultSpec("serve.decode", 6, "error")] * 2
    for arch, _, _ in PATHS:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        params = init_model(cfg, seed=7, device=DEV)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab, n) for n in DRILL_LENS]
        for depth in (1, 2):
            eng = _drill_engine(cfg, params, depth)
            ref, _ = _drill_serve(eng, prompts)
            eng.close()
            eng = _drill_engine(cfg, params, depth)
            got_a, inj = _drill_serve(eng, prompts, sched_a)
            recs = "; ".join(
                f"tick {r.tick} {r.triple[0]}{dict(r.triple[2])}: "
                + ", ".join(f"{k} {s * 1e3:.1f} ms"
                            for k, s in r.seconds.items())
                for r in eng.recapture_log)
            say(f"[drill] {cfg.name} f32 async_depth {depth} A: "
                f"{len(inj.fired)} faults, {len(eng.degrade_events)} "
                f"demotions, recaptured {recs}; tokens equal to the "
                f"fault-free run: {got_a == ref}")
            if got_a != ref or not eng.degrade_events or not \
                    eng.recapture_log:
                raise AssertionError(f"{cfg.name} schedule A")
            eng.close()
            eng = _drill_engine(cfg, params, depth)
            got_b, inj = _drill_serve(eng, prompts, sched_b)
            say(f"[drill] {cfg.name} f32 async_depth {depth} B: "
                f"{len(inj.fired)} faults, poisoned "
                f"{eng.sched.stats.poisoned}, {len(eng.degrade_events)} "
                f"demotions, {eng.recaptures} steps recaptured; tokens "
                f"equal to the fault-free run: {got_b == ref}")
            if got_b != ref or len(inj.fired) != 2 or \
                    not eng.sched.stats.poisoned:
                raise AssertionError(f"{cfg.name} schedule B")
            eng.close()
            eng = _drill_engine(cfg, params, depth)
            try:
                _drill_serve(eng, prompts,
                             [FaultSpec("serve.decode", ANY_TICK, "fatal")])
                raise AssertionError(f"{cfg.name}: the fatal fault did "
                                     "not propagate")
            except FatalFault:
                pass
            done = eng.run_until_drained()
            say(f"[drill] {cfg.name} f32 async_depth {depth} C: FatalFault "
                f"propagated; drained {len(done)} requests, "
                f"{sum(len(r.out) for r in done)} tokens")
            if len(done) != len(prompts) or any(len(r.out) != MAX_NEW
                                                for r in done):
                raise AssertionError(f"{cfg.name} schedule C: not drained")
            eng.close()
    _fresh_cache()


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
        path = phase_serve(arch, serve_kw, prompt_lens,
                           depths=(1, 2) if arch == "llama3_8b" else (1,),
                           traced=arch == "llama3_8b")
        paths.append(path)
        for name in SERVE_KERNELS:
            launches[name] += path["launches"][name]
            for sig, n in path["shapes"][name].items():
                shapes[name][sig] = shapes[name].get(sig, 0) + n
    rows = phase_shapes(shapes, gen)
    phase_host_cost(gen)
    phase_options()
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
