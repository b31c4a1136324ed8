"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* **The copies against the originals.** ``comm_analysis.op_bytes`` is
  ``hlo_analysis._op_bytes`` for every op and group of 1-8 ranks;
  ``DTYPE_BYTES`` agrees with the JAX table on every dtype both name (and
  with torch's element sizes); ``specs.skip_reason`` and
  ``specs.probe_config`` are JAX's for every config and shape.
* **The collective report** counts each distinct call once
  (``flat_bytes``, ``counts``) and every call (``weighted_bytes``), by
  call site (``by_comp``), by the ring model.
* **The walk with counts** (``plans.trace.trace_train_launches``) gives
  the launches a step ``chip_smoke.py``'s reckoning gives, with and
  without ``remat="full"``, and the requests of the CPU step's dispatch
  record, key by key; ``trace_serve_launches`` those of the non-paged
  prefill and decode steps.
* **One count of the work**: ``roofline.visible_counts`` equals the mask's
  keys and pairs.
* **The CLI** writes a SKIP record and an OK smoke record with the JAX
  record's keys, plus ``roofline`` and ``cost``'s ``by_family``.

The prediction against real gloo ranks (the collective record, the
requests and ``argument_bytes`` at 4 ranks) is in
``tests/test_torch_tensor_parallel.py``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro.launch import hlo_analysis
from repro.models.config import SHAPES as JSHAPES
from repro_torch.artifacts.dispatch import get_default_cache
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.comm import Collective
from repro_torch.launch import comm_analysis, dryrun, roofline
from repro_torch.launch import specs as tspecs
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import init_cache
from repro_torch.plans.trace import (trace_serve_launches,
                                     trace_train_launches)

#: torch's dtype name -> the HLO name of the JAX table
HLO_NAMES = {"bool": "pred", "int8": "s8", "uint8": "u8", "int16": "s16",
             "uint16": "u16", "float16": "f16", "bfloat16": "bf16",
             "int32": "s32", "uint32": "u32", "float32": "f32",
             "int64": "s64", "uint64": "u64", "float64": "f64",
             "complex64": "c64", "complex128": "c128",
             "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2"}


@pytest.mark.parametrize("op", hlo_analysis.COLLECTIVE_OPS)
def test_op_bytes_is_the_ring_model_of_hlo_analysis(op):
    for n in range(1, 9):
        for size in (0, 1, 7, 4096, 3 * 2**20 + 5):
            assert comm_analysis.op_bytes(op, size, n) == \
                hlo_analysis._op_bytes(op, size, n), (op, n, size)


def test_dtype_bytes_agree_with_hlo_analysis_and_torch():
    assert set(comm_analysis.DTYPE_BYTES) == set(HLO_NAMES)
    for name, hlo in HLO_NAMES.items():
        assert comm_analysis.DTYPE_BYTES[name] == \
            hlo_analysis.DTYPE_BYTES[hlo], name
        assert comm_analysis.DTYPE_BYTES[name] == torch.empty(
            (), dtype=getattr(torch, name)).element_size(), name
        assert comm_analysis.dtype_bytes(getattr(torch, name)) == \
            comm_analysis.DTYPE_BYTES[name]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_skip_reason_and_probe_config_are_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), get_config(arch)
    for js, ts in zip(JSHAPES, TSHAPES):
        assert tspecs.skip_reason(tcfg, ts) == jspecs.skip_reason(jcfg, js)
    for n in (1, 2, 4):
        jp, tp = jspecs.probe_config(jcfg, n), tspecs.probe_config(tcfg, n)
        assert tp.layers == jp.layers == n
        assert (tp.encoder.layers if tp.encoder else None) == \
            (jp.encoder.layers if jp.encoder else None)
        assert dataclasses.replace(tp, layers=tcfg.layers,
                                   encoder=tcfg.encoder) == tcfg


def test_collective_report_counts_calls_by_the_ring_model():
    rec = [Collective("all-reduce", "a.py:1 (f)", 1000, "float32", 4),
           Collective("all-reduce", "a.py:1 (f)", 1000, "float32", 4),
           Collective("all-gather", "b.py:2 (g)", 800, "bfloat16", 2),
           Collective("reduce-scatter", "b.py:2 (g) (backward)", 400,
                      "bfloat16", 2),
           Collective("all-to-all", "c.py:3 (h)", 640, "float32", 1)]
    rep = comm_analysis.collective_report(rec)
    assert rep.summary() == {
        "flat_bytes": 1500 + 400 + 400,
        "weighted_bytes": 2 * 1500 + 400 + 400,
        "counts": {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
                   "all-to-all": 1},
        "weighted_counts": {"all-reduce": 2.0, "all-gather": 1.0,
                            "reduce-scatter": 1.0, "all-to-all": 1.0}}
    assert rep.by_comp == {"a.py:1 (f)": 3000, "b.py:2 (g)": 400,
                           "b.py:2 (g) (backward)": 400, "c.py:3 (h)": 0}
    assert comm_analysis.by_op_bytes(rec) == {
        "all-reduce": 3000, "all-gather": 400, "reduce-scatter": 400,
        "all-to-all": 0}


def test_visible_counts_are_the_masks():
    for sq, sk, causal, window in [(1, 1, True, None), (7, 16, True, 4),
                                   (16, 16, True, None), (20, 5, True, 3),
                                   (16, 33, False, 8), (3, 40, False, None)]:
        mask = roofline.visible(sq, sk, causal, window)
        assert roofline.visible_counts(sq, sk, causal, window) == (
            int(mask.any(0).sum()), int(mask.sum()))


def _chip_counts(cfg, mb):
    """``chip_smoke.py``'s ``_train_counts``: the launches a train step
    makes on the card, each wrapper's counter."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    return {k: v for k, v in chip_smoke._train_counts(cfg, mb).items() if v}


@pytest.mark.parametrize("arch,layers", [
    ("llama3_8b", 4), ("mamba2_130m", None), ("hymba_1p5b", 4),
    ("whisper_large_v3", 4), ("llama4_scout_17b_a16e", 1)])
def test_walk_counts_every_launch_of_a_step(arch, layers):
    """The walk at full width, phase 13's runs' depths: each wrapper's
    launches a step equal ``chip_smoke.py``'s reckoning (the counters the
    card checks every step), under ``remat="full"`` too, whose forward of
    each block runs twice."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.scaled(layers=layers)
        if cfg.encoder is not None:
            cfg = cfg.scaled(encoder=dataclasses.replace(cfg.encoder,
                                                         layers=layers))
    for remat in ("none", "full"):
        c = cfg.scaled(remat=remat)
        got = {}
        for ln in trace_train_launches(c, global_batch=8, seq=64,
                                       microbatches=2):
            got[ln.wrapper] = got.get(ln.wrapper, 0) + ln.launches
        assert got == _chip_counts(c, 2), remat


def _requests(rec):
    return {(f, items): n for (f, _, items), n in rec.counts.items()}


def _walked(launches):
    out = {}
    for ln in launches:
        out[(ln.family, ln.key)] = out.get((ln.family, ln.key), 0) + ln.calls
    return out


@pytest.mark.parametrize("arch,remat", [
    ("llama3_8b", "none"), ("llama3_8b", "full"), ("mamba2_130m", "none"),
    ("hymba_1p5b", "none"), ("whisper_large_v3", "full"),
    ("llama4_scout_17b_a16e", "none")])
def test_walk_calls_are_the_cpu_steps_requests(arch, remat):
    """One f32 step of the smoke config on the CPU, two microbatches of
    40 tokens: the dispatch requests it makes, key by key and counted,
    are the walk's calls."""
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, constant
    from repro_torch.runtime import build_train_step
    cfg = get_smoke_config(arch).scaled(dtype="float32",
                                        param_dtype="float32", remat=remat)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 40)).astype(
        np.int32)) for k in ("tokens", "labels")}
    if cfg.encoder is not None:
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
    params = init_train_state(cfg, device="cpu")
    opt = adamw(constant(1e-3))
    step = build_train_step(cfg, opt, microbatches=2)
    with get_default_cache().record() as rec:
        step(params, opt.init(params), batch, 0)
    assert _requests(rec) == _walked(trace_train_launches(
        cfg, global_batch=4, seq=40, microbatches=2))


@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1p5b",
                                  "whisper_large_v3",
                                  "llama4_scout_17b_a16e"])
def test_serve_walk_calls_are_the_cpu_steps_requests(arch):
    """The non-paged prefill of 3 prompts of 12 tokens into a cache of 12,
    then a decode step at its last index: each step's requests are
    ``trace_serve_launches``' calls."""
    from repro_torch.models import init_train_state
    from repro_torch.runtime import build_serve_steps
    cfg = get_smoke_config(arch).scaled(dtype="float32",
                                        param_dtype="float32")
    params = init_train_state(cfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 12)).astype(
        np.int32))
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
    pre, dec = build_serve_steps(cfg)
    cache = init_cache(cfg, 3, 12, device="cpu")
    with torch.no_grad(), get_default_cache().record() as rec:
        logits, cache = pre(params, tokens, cache, **kw)
    assert _requests(rec) == _walked(trace_serve_launches(
        cfg, batch=3, prompt_len=12, max_len=12, part="prefill"))
    with torch.no_grad(), get_default_cache().record() as rec:
        dec(params, tokens[:, -1:], cache, 11)
    assert _requests(rec) == _walked(trace_serve_launches(
        cfg, batch=3, prompt_len=12, max_len=12, part="decode"))


#: the keys of ``repro/launch/dryrun.py``'s records: every status's, an OK
#: cell's (its XLA timings, ``lower_s`` and ``compile_s``, have no
#: counterpart), a SKIP's; ``cost``'s
JAX_KEYS = {"arch", "shape", "mesh", "probe_layers", "status"}
JAX_OK = JAX_KEYS | {"microbatches", "devices", "memory", "cost",
                     "collectives", "kernel_dispatch"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
              "generated_code_bytes"}
JAX_COST = {"flops", "bytes_accessed", "transcendentals"}
JAX_COLLECTIVES = {"flat_bytes", "weighted_bytes", "counts",
                   "weighted_counts"}


def test_cli_writes_a_skip_and_an_ok_cell_with_the_jax_keys(tmp_path):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "llama3_8b", "--shape", "long_500k",
                        "--out", out]) == 0
    with open(os.path.join(out, "llama3_8b_long_500k_16x16.json")) as f:
        skip = json.load(f)
    assert skip["status"] == "SKIP"
    assert set(skip) == JAX_KEYS | {"skip_reason"}
    assert dryrun.main(["--arch", "llama4_scout_17b_a16e", "--shape",
                        "train_4k", "--mesh", "2,2,1", "--smoke",
                        "--perf-flags", "moe_a2a", "--kernel-table",
                        "--tag", "t", "--out", out]) == 0
    with open(os.path.join(
            out, "llama4_scout_17b_a16e_train_4k_2x2x1_t.json")) as f:
        ok = json.load(f)
    assert ok["status"] == "OK", ok.get("traceback")
    assert set(ok) == JAX_OK | {"roofline", "overrides"}
    assert set(ok["memory"]) == JAX_MEMORY | {"note"}
    assert ok["memory"]["peak_bytes"] is None
    assert set(ok["cost"]) == JAX_COST | {"by_family"}
    assert set(ok["collectives"]) == JAX_COLLECTIVES
    r = ok["roofline"]
    assert r["machine"] == "h100_sxm"
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"]) > 0
    assert r["rates"] == {"hbm_bytes_per_s": 3.35e12,
                          "link_bytes_per_s": 450e9,
                          "bf16_flops": 989e12, "f32_flops": 67e12}
    assert ok["devices"] == 4 and ok["mesh"] == "2x2x1"
    assert ok["collectives"]["counts"]["all-to-all"] >= 1
    assert ok["cost"]["by_family"]["matmul_h100_batched"]["launches"] > 0


def test_probe_extension_is_the_full_depth_record():
    """The record at depth 6 and 3 microbatches extended from the probes
    (depths 2 and 4, one and two microbatches) equals the record of the
    full step: a step's collectives are linear in each."""
    cfg = get_smoke_config("llama4_scout_17b_a16e").scaled(
        layers=6, dtype="float32", name="llama4-scout-17b-a16e")
    shape = ShapeConfig("t", 16, 24, "train")
    mesh = dryrun.mesh_of((2, 2))
    got, how, detail = dryrun.collectives(cfg, mesh, shape, 3)
    assert "probes" in how and "microbatches" in how
    rep = comm_analysis.collective_report(
        dryrun.record_train_step(cfg, mesh, shape, 3))
    assert got == rep.summary()
    assert detail["by_site"] == rep.by_comp
