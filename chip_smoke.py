#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases print on their own lines; any failure raises and exits non-zero, and
no phase is caught.

1. device: torch and CUDA versions, the card's name and power limit.
2. build: ``nvcc`` builds both kernels (``csrc/*.cu``), one process each,
   all started together; the build time.
3. K1 ``matmul_h100`` against its plain version in bf16, at every matmul
   triple of the full llama3-8b serve path at M = 4 and 32 through the leaf
   the dispatch picks, and at six feasible leaves of the tree of different
   (bm, bn, bk, s, cached) at one shape (the paper's code soundness,
   Def. 2 ii).
4. K2 ``flash_attention_h100`` against its plain version in bf16: prefill
   chunk, decode over a ragged cache, non-causal sk = 200, window 128.
5. serve parity: the llama3 SMOKE config in f32 served on ``cuda`` (the
   kernels) and on ``cpu`` (their plain versions) from the same weights;
   the greedy tokens are equal.
6. serve, the main path: llama3-8b at full width (32 layers, bf16, random
   weights from a seeded ``torch.Generator`` on the card) through
   ``init_model`` and ``ServeEngine(warm_kernels=True)``, 4 requests.  Both
   launch counters are set to 0 just before and read just after.  Every
   request returns ``max_new`` tokens, both kernels launched, and no
   dispatch resolved cold after warm-up.
7. main-path shapes: every launch signature of phase 6 is run again on
   fresh inputs of its shape, held against the plain version, and timed:
   kernel, plain version, the library call, and the bound.

Times are CUDA-event means over repeated launches after one warm-up; a
matmul cycles through copies of its weight operand so that each launch
reads it from device memory, as the serve path does (attention reads K/V
that the serve path has just gathered, so repeated launches on the same
K/V stand for it).  The
bound of a launch is max(bytes / 3.35 TB/s, flops / peak), with each input
read once and each output written once, the flops of the keys the masks
leave visible, and the peak of the H100 SXM data sheet for the input type
(989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32).  The library call
is a yardstick timed only here: ``torch.matmul`` (its output is bf16, the
kernel's f32) and ``scaled_dot_product_attention``.

The line before the last is the kernels' JSON record.  For each kernel
``launches`` is phase 6's count; ``ms``, ``plain_ms``, ``library_ms`` and
``bound_ms`` are sums over phase 6's launches, each timed at its own
signature in phase 7; ``max_abs_err`` is the largest error against the
plain version over phases 3, 4 and 7.  The last line is the device record.

Tolerances, kernel against plain version on the same inputs:

- matmul (bf16 in, f32 out), rtol 1e-4 / atol 1e-3: a bf16 product is
  exact in f32, so the two differ only in the order of K f32 additions;
  with B scaled by 1/sqrt(K), as the model's weights are, outputs are O(1)
  and K <= 14336 additions drift by at most K * 2^-24 ~ 1e-3.
- attention in bf16, rtol = atol = 1e-2: both compute in f32 and round the
  output to bf16 once; the two may round apart by one bf16 step (2^-7).

TF32 is off for the plain versions (``allow_tf32 = False``), so their f32
products on the card are full f32.
"""
from __future__ import annotations

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
SERVE = dict(max_batch=4, max_len=256, page_size=16, prefill_chunk=32)
MAX_NEW = 8


def say(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    """(bytes, flops) one launch of ``name`` at ``sig`` must move and do:
    each input read once, each output written once; attention counts the
    query-key pairs its masks leave visible."""
    esz = torch.empty((), dtype=sig[-1]).element_size()
    if name == "matmul_h100":
        M, N, K = sig[:3]
        return (M * K + K * N) * esz + M * N * 4, 2.0 * M * N * K
    h, sq, sk, d, _, _, causal, window, _ = sig
    pairs = int(_visible(sq, sk, causal, window).sum())
    return 2 * (h * sq * d + h * sk * d) * esz, 4.0 * h * pairs * d


def bound_terms_ms(name: str, sig) -> tuple:
    nbytes, flops = work(name, sig)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[sig[-1]]


# ---------------------------------------------------------------------------
# K1 and K2 at one signature: check against plain, time, bound
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
        row["ms"] = time_ms(lambda: matmul_h100(a, next(bs), **kw), 10)
        row["plain_ms"] = time_ms(lambda: matmul_plain(a, next(bs), **kw), 3)
        row["library_ms"] = time_ms(lambda: torch.matmul(a, next(bs)), 10)
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
        row["ms"] = time_ms(lambda: flash_attention_h100(q, k, v, **kw), 10)
        row["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v,
                                                                **kw), 3)
        row["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=sdpa_mask), 10)
        row["bound_ms"] = max(bound_terms_ms("flash_attention_h100", sig))
    return row


def fmt(row) -> str:
    out = f"max_abs_err {row['err']:.3e}"
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        if key in row:
            out += f" {key} {row[key]:.4f}"
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


def _serve(cfg, params, prompts, device, **kw):
    from repro_torch.runtime import ServeEngine
    eng = ServeEngine(cfg, params, device=device, **kw)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r for r in eng.run_until_drained()}
    return eng, [done[r] for r in rids]


def phase_parity() -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    cfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    params_cpu = init_model(cfg, seed=7, device="cpu")

    def to_cuda(node):
        if isinstance(node, dict):
            return {k: to_cuda(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cuda(v) for v in node]
        return node.to(DEV)
    params_gpu = to_cuda(params_cpu)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 19, 11, 3, 26)]
    kw = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8,
              warm_kernels=True)
    _, on_gpu = _serve(cfg, params_gpu, prompts, DEV, **kw)
    _, on_cpu = _serve(cfg, params_cpu, prompts, "cpu", **kw)
    gpu_toks = [r.out for r in on_gpu]
    cpu_toks = [r.out for r in on_cpu]
    say(f"[parity] f32 smoke, cuda kernels: {gpu_toks}")
    say(f"[parity] f32 smoke, cpu plain:    {cpu_toks}")
    if gpu_toks != cpu_toks or any(len(t) != MAX_NEW for t in gpu_toks):
        raise AssertionError("serve parity: tokens differ between the "
                             "kernels on cuda and the plain versions on cpu")


def phase_serve():
    from repro_torch.artifacts.dispatch import get_default_cache
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_h100
    from repro_torch.kernels.matmul import matmul_h100
    from repro_torch.models import forward, init_model
    from repro_torch.runtime import ServeEngine

    cfg = get_config("llama3_8b")                     # bf16, 32 layers
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    say(f"[serve] llama3-8b full width: {cfg.layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB made in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, warm_kernels=True, device=DEV, **SERVE)
    stats = get_default_cache().stats
    cold0 = stats.cold_builds
    say(f"[serve] warm-up: {len(eng.kernel_plan)} kernel picks frozen in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n))
               for n in rng.integers(16, 65, 4)]

    torch.cuda.synchronize()
    matmul_h100.launches = flash_attention_h100.launches = 0
    matmul_h100.shapes.clear()
    flash_attention_h100.shapes.clear()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {r.rid: r for r in eng.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"matmul_h100": matmul_h100.launches,
                "flash_attention_h100": flash_attention_h100.launches}
    shapes = {"matmul_h100": dict(matmul_h100.shapes),
              "flash_attention_h100": dict(flash_attention_h100.shapes)}

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
    per_step_mm = 7 * cfg.layers + 1
    say(f"[serve] {len(outs)} requests, {ntok} tokens in {wall:.3f} s: "
        f"{ntok / wall:.2f} tokens/s; {st.prefill_chunks} prefill chunks, "
        f"{st.decode_ticks} decode steps")
    say(f"[serve] launches: {json.dumps(launches)}; matmul per prefill chunk "
        f"or decode step {per_step_mm}; attention per chunk {cfg.layers}, "
        f"per decode step {cfg.layers} x decoding rows; cold dispatch builds "
        f"after warm-up: {cold}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if cold:
        raise AssertionError(f"{cold} dispatches resolved cold after warm-up")
    if launches["matmul_h100"] != per_step_mm * (st.prefill_chunks
                                                 + st.decode_ticks):
        raise AssertionError("matmul launches do not match the steps run")

    # one full-width forward through the kernels: finite logits of the
    # expected shape
    logits, _ = forward(params, cfg, prompts[0][None, :16])
    torch.cuda.synchronize()
    if logits.shape != (1, 16, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"full-width forward: logits "
                             f"{tuple(logits.shape)} not finite")
    say(f"[serve] full-width forward: logits {tuple(logits.shape)} finite")
    del eng, params, logits
    torch.cuda.empty_cache()
    return launches, shapes


def phase_shapes(shapes, gen, errs):
    cases = {"matmul_h100": matmul_case, "flash_attention_h100": flash_case}
    totals = {}
    for name, by_sig in shapes.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0}
        err = errs[name]
        for sig, n in sorted(by_sig.items(), key=lambda kv: str(kv[0])):
            row = cases[name](sig, gen, timed=True)
            err = max(err, row["err"])
            for key in tot:
                tot[key] += n * row[key]
            say(f"[shapes] {name} {sig[:-1]} x{n}: {fmt(row)}")
        totals[name] = dict(tot, max_abs_err=err)
        say(f"[shapes] {name} over the main path's launches: "
            + ", ".join(f"{k} {v:.3f}" for k, v in totals[name].items()))
    return totals


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
            "flash_attention_h100": phase_k2(gen)}
    phase_parity()
    launches, shapes = phase_serve()
    totals = phase_shapes(shapes, gen, errs)

    sources = {"matmul_h100": ("src/repro_torch/csrc/matmul.cu",
                               "src/repro/kernels/matmul.py:73"),
               "flash_attention_h100": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:75")}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = totals[name]
        ms, bound = t["ms"], t["bound_ms"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": ms,
                        "plain_ms": t["plain_ms"], "bound_ms": bound,
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
    main path, summed over them."""
    byte_ms = op_ms = 0.0
    for sig, n in shapes[name].items():
        b_ms, o_ms = bound_terms_ms(name, sig)
        byte_ms += n * b_ms
        op_ms += n * o_ms
    return byte_ms >= op_ms


if __name__ == "__main__":
    sys.exit(main())
