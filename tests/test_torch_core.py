"""The port's copy of the symbolic core is the JAX package's core, the
port's families build non-trivial trees that resolve the whole serve warm
sets of llama3-8b, mamba2-130m and hymba-1.5b on an H100, and the case-study
families show the paper's case discussions in the port's symbols."""
import dataclasses
import itertools
import math

import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.comprehensive import comprehensive_optimization as j_opt
from repro_torch.artifacts.dispatch import DispatchCache
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comprehensive import comprehensive_optimization as t_opt
from repro_torch.core.constraints import Verdict
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import jacobi1d as jacobi_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import transpose as transpose_mod
from repro_torch.kernels.flash_attention import FAMILY as FLASH
from repro_torch.kernels.instantiate_cache import grain
from repro_torch.kernels.jacobi1d import FAMILY as JACOBI
from repro_torch.kernels.matadd import FAMILY as MATADD
from repro_torch.kernels.matmul import FAMILY as MATMUL
from repro_torch.kernels.ops import FAMILIES
from repro_torch.kernels.ssd_scan import FAMILY as SSD
from repro_torch.kernels.ssd_scan import smem_bytes
from repro_torch.kernels.transpose import FAMILY as TRANSPOSE
from repro_torch.plans.trace import chunk_lengths, trace_warm_set


def make_family(ns):
    """A small paper-style family (grain s, block b, cached staging) written
    once over a core namespace, so both packages build the same thing."""
    V, Poly, ParamDomain = ns.V, ns.Poly, ns.ParamDomain
    KernelPlan, Strategy = ns.KernelPlan, ns.Strategy

    class Fam:
        name = "toy_family_" + ns.__name__.replace(".", "_")

        def initial_plan(self):
            return KernelPlan(family=self.name,
                              flags={"cache": True, "gran": 0},
                              program_params={
                                  "b": ParamDomain("b", (32, 64, 128, 256)),
                                  "s": ParamDomain("s", (1, 2, 4, 8))})

        def counters(self):
            return [ns.resource("smem", "V", ("reduce", "uncache")),
                    ns.resource("regs", "G", ("reduce",)),
                    ns.performance("occ", "P_occ", ("reduce",))]

        def strategies(self):
            def reduce(plan):
                if plan.flags["gran"]:
                    return None
                p = plan.with_flag("gran", 1, "reduce")
                p.program_params["s"] = ParamDomain("s", (1, 2))
                return p

            def uncache(plan):
                if not plan.flags["cache"]:
                    return None
                return plan.with_flag("cache", False, "uncache")
            return [Strategy("reduce", reduce), Strategy("uncache", uncache)]

        def counter_value(self, plan, counter):
            b, s, one = V("b"), V("s"), Poly.const(1)
            if counter == "smem":
                return ((4 * b * s * 8) if plan.flags["cache"]
                        else Poly.const(0)), one
            if counter == "regs":
                return 2 * s + Poly.const(20), one
            return V("CORES") * b * s, V("N")
    return Fam()


DATA = [{"N": 1024}, {"N": 4096}, {"N": 16384}, {"N": 65536}]
MM_PARAMS = ("bm", "bn", "bk", "s", "kb", "stages")


def _mm_threads(a):
    """K1's threads a block: 32·(bm/16)·(bn/(8·s))."""
    return 32 * (a["bm"] // 16) * (a["bn"] // (8 * a["s"]))


def _mm_smem(a):
    """K1's ring as the counter takes it: stages·(bm·bk + bk·bn)·4 B."""
    return a["stages"] * (a["bm"] * a["bk"] + a["bk"] * a["bn"]) * 4


def test_core_copy_builds_identical_trees_and_picks():
    jf, tf = make_family(jcore), make_family(tcore)
    jl, tl = j_opt(jf), t_opt(tf)
    assert len(jl) == len(tl) > 1
    for a, b in zip(jl, tl):
        assert a.applied == b.applied
        assert a.plan.flags == b.plan.flags
        assert [str(x) for x in a.constraints.atoms] == \
            [str(x) for x in b.constraints.atoms]
    for data in DATA:
        jc = jcore.select.rank_candidates(jf, jcore.PAPER_M2050, data,
                                          leaves=jl)[0]
        tc = tcore.select.rank_candidates(tf, tcore.PAPER_M2050, data,
                                          leaves=tl)[0]
        assert (jc.leaf_index, jc.assignment) == (tc.leaf_index,
                                                   tc.assignment)


def test_h100_machine_binds_the_papers_gpu_limits():
    b = tcore.H100_SXM.bindings()
    assert (b["V"], b["G"], b["T"], b["CORES"], b["LANE"]) == (
        232_448, 255, 1024, 132, 32)
    assert tcore.H100_SXM.hbm_bw == 3.35e12
    assert tcore.H100_SXM.peak_flops_bf16 == 989e12
    # the JAX package's machines keep their bindings (plus T)
    for name in ("tpu_v5e", "paper_m2050"):
        jb = jcore.MACHINES[name].bindings()
        tb = tcore.MACHINES[name].bindings()
        assert {k: tb[k] for k in jb} == jb


@pytest.mark.parametrize("family", [MATMUL, FLASH, SSD, MATADD, TRANSPOSE,
                                    JACOBI], ids=lambda f: f.name)
def test_port_trees_are_non_trivial(family):
    leaves = tcore.comprehensive_tree(family)
    assert len(leaves) > 1
    assert len({l.applied for l in leaves}) > 1


@pytest.mark.parametrize("arch_cfg", ["full", "smoke"])
def test_llama3_warm_set_resolves_within_gpu_limits(arch_cfg):
    cfg = (get_config("llama3_8b") if arch_cfg == "full"
           else get_smoke_config("llama3_8b"))
    cache = DispatchCache()
    ops = trace_warm_set(cfg, max_len=256, max_batch=4, prefill_chunk=32)
    fams = {op.family for op in ops}
    assert fams == {"matmul_h100", "flash_attention_h100"}
    for op in ops:
        cand = cache.best_variant(FAMILIES[op.family], tcore.H100_SXM,
                                  op.data_dict())
        a = cand.assignment
        if op.family == "matmul_h100":
            assert _mm_threads(a) <= 1024                           # T
            if cand.plan.flags["smem_cache"]:
                assert _mm_smem(a) <= 232_448                       # V
            d = op.data_dict()
            for dtype in (torch.float32, torch.bfloat16):
                assert mm_mod.format_error(
                    d["M"], d["N"], d["K"], *(a[n] for n in MM_PARAMS),
                    cand.plan.flags["smem_cache"], dtype) is None
        else:
            d = op.data_dict()
            assert fa_mod.threads(a["bq"], a["bkv"]) <= 1024        # T
            for dtype in (torch.float32, torch.bfloat16):
                assert fa_mod.smem_bytes(a["bq"], a["bkv"], a["stages"],
                                         d["HD"], dtype) <= 232_448  # V
                assert fa_mod.format_error(
                    cfg.heads, cfg.kv_heads, d["SQ"], 256, d["HD"],
                    *(a[n] for n in FA_PARAMS), dtype) is None


def test_trace_holds_exactly_the_dispatched_shapes():
    cfg = get_config("llama3_8b")
    ops = trace_warm_set(cfg, max_len=256, max_batch=4, prefill_chunk=32)
    assert chunk_lengths(32, 256) == [32, 16, 8, 4, 2, 1]
    mm_m = {dict(o.data)["M"] for o in ops if o.family == "matmul_h100"}
    fa_sq = {dict(o.data)["SQ"] for o in ops
             if o.family == "flash_attention_h100"}
    assert mm_m == {32, 16, 8, 4, 2, 1}          # chunks, batch 4, lm_head 1
    assert fa_sq == {32, 16, 8, 4, 2, 1}
    lm = {dict(o.data)["M"] for o in ops
          if o.family == "matmul_h100" and dict(o.data)["N"] == cfg.vocab}
    assert lm == {1, 4}


def test_binding_constraints_prune_somewhere():
    """T and Z_B each rule out part of the matmul domain, and Z_B part of
    the attention domain (its blocks have at most 256 threads)."""
    from repro_torch.core.select import enumerate_candidates
    mm = enumerate_candidates(MATMUL, tcore.H100_SXM,
                              {"M": 32, "N": 4096, "K": 4096})
    assert all(_mm_threads(c.assignment) <= 1024 for c in mm)
    assert any(_mm_threads(c.assignment) == 1024 for c in mm)
    cached = {tuple(c.assignment[n] for n in MM_PARAMS) for c in mm
              if c.plan.flags["smem_cache"]}
    assert all(_mm_smem(dict(zip(MM_PARAMS, p))) <= 232_448 for p in cached)
    # 1024 threads either way; a 4-stage ring of 32 x 64 and 64 x 256 f32
    # tiles (288 KB) exceeds V, a 2-stage one (144 KB) fits
    assert (32, 256, 64, 2, 1, 4) not in cached
    assert (32, 256, 64, 2, 1, 2) in cached
    fa = enumerate_candidates(FLASH, tcore.H100_SXM,
                              {"SQ": 32, "HD": 128, "GROUP": 4, "HK": 8})
    kept = {tuple(c.assignment[n] for n in FA_PARAMS) for c in fa}
    # f32 tiles at HD 128: 128 rows with a 3-stage ring of 64-key tiles
    # (328 KB) exceed V, with a 2-stage one (231 KB) they fit
    assert not any(k[:2] == (128, 64) and k[3] == 3 for k in kept)
    assert any(k[:2] == (128, 64) and k[3] == 2 for k in kept)
    assert {k[0] for k in kept} == {16, 32, 64, 128}   # T never binds
    for c in fa:
        a = c.assignment
        assert fa_mod.smem_bytes(a["bq"], a["bkv"], a["stages"], 128,
                                 torch.float32) <= 232_448


def test_instantiate_is_memoized_per_device():
    """A warm resolution hands back the same callable object; the device
    type is part of the key ("cuda": kernel wrapper, "cpu": plain)."""
    from repro_torch.kernels.matmul import _launch, matmul_plain
    cand = DispatchCache().best_variant(MATMUL, tcore.H100_SXM,
                                        {"M": 8, "N": 256, "K": 128})
    get = lambda dev: MATMUL.instantiate(cand.plan, cand.assignment, dev,
                                         leaf_index=cand.leaf_index)
    assert get("cuda") is get("cuda") and get("cpu") is get("cpu")
    assert get("cuda").func is _launch and get("cpu").func is matmul_plain


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1p5b"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_ssm_warm_sets_resolve_within_gpu_limits(arch, size):
    """Every triple of the SSM and hybrid serve warm sets (the served
    sizes: prefill chunks up to 256) resolves to a leaf whose shared
    memory fits V."""
    cfg = get_config(arch) if size == "full" else get_smoke_config(arch)
    cache = DispatchCache()
    ops = trace_warm_set(cfg, max_len=1024, max_batch=4, prefill_chunk=256)
    fams = {op.family for op in ops}
    assert "ssd_scan_h100" in fams
    assert ("flash_attention_h100" in fams) == (cfg.block == "hybrid")
    for op in ops:
        if op.family != "ssd_scan_h100":
            continue
        a = cache.best_variant(SSD, tcore.H100_SXM, op.data_dict()).assignment
        assert smem_bytes(a["chunk"], a["bd"], cfg.ssm.state) <= 232_448
    assert {dict(o.data)["SQ"] for o in ops
            if o.family == "ssd_scan_h100"} == set(chunk_lengths(256, 1024))


@pytest.mark.parametrize("state", [128, 16])
def test_ssd_shared_memory_cuts_the_domain(state):
    """V rules out part of the SSD scan's domain (paper Z_B), through the
    two bodies' smem counters: at state 128 a 128-step chunk fits only with
    hd tiles of 32 columns (at bd 64 the tensor-core body's padded tiles
    and the FMA body's 128² f32 scores both pass V), and at hymba-1.5b's
    state 16 every leaf fits."""
    from repro_torch.core.select import enumerate_candidates
    from repro_torch.kernels.ssd_scan import fma_smem_bytes
    got = {(c.assignment["chunk"], c.assignment["bd"])
           for c in enumerate_candidates(SSD, tcore.H100_SXM,
                                         {"SQ": 256, "HD": 64,
                                          "STATE": state})}
    domain = {(c, b) for c in (16, 32, 64, 128) for b in (32, 64)}
    want = {(c, b) for c, b in domain
            if smem_bytes(c, b, state + 15) <= 232_448
            and fma_smem_bytes(c, b, state) <= 232_448}
    assert got == want
    if state == 128:
        assert (128, 32) in got and (128, 64) not in got
        assert smem_bytes(128, 64, 128) > 232_448
        assert fma_smem_bytes(128, 64, 128) > 232_448
    else:
        assert got == domain


def test_ssd_counters_are_the_kernels_own():
    """The FMA body's Z_B is ``fma_smem_bytes`` and the tensor-core body's
    bounds ``smem_bytes`` at the kernel's np = STATE rounded up to 16 (equal
    when STATE is a multiple of 16), at every point of the domain."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    plan = SSD.initial_plan()
    tc, tc_den = SSD.counter_value(plan, "smem_bytes")
    fma, fma_den = SSD.counter_value(plan, "fma_smem_bytes")
    for chunk, bd, state in itertools.product((16, 32, 64, 128), (32, 64),
                                              (8, 16, 20, 128)):
        pt = {"chunk": chunk, "bd": bd, "STATE": state}
        kernel_tc = ssd_mod.smem_bytes(chunk, bd, -(-state // 16) * 16)
        assert kernel_tc <= tc.eval(pt) / tc_den.eval(pt), pt
        if state % 16 == 0:
            assert tc.eval(pt) / tc_den.eval(pt) == ssd_mod.smem_bytes(
                chunk, bd, state + 15), pt
        assert fma.eval(pt) / fma_den.eval(pt) == ssd_mod.fma_smem_bytes(
            chunk, bd, state), pt


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1p5b"])
def test_ssd_feasible_leaves_and_picks_at_served_signatures(arch):
    """At every K3 key of the full-width serve warm set, every feasible leaf
    passes the C entry point's checks for both types, and the pick runs
    the step body at up to 8 steps (bd 32: twice the blocks, half the state
    each) and, at a 256-step chunk, chunk 128 with bd 32 (the fastest of
    the seven leaves on the card, PERF.md)."""
    from repro_torch.core.select import enumerate_candidates
    from repro_torch.kernels import ssd_scan as ssd_mod
    cfg = get_config(arch)
    kw = dict(max_len=1024, max_batch=4, prefill_chunk=256) \
        if arch == "mamba2_130m" else dict(max_len=256, max_batch=4,
                                           prefill_chunk=32)
    keys = {tuple(sorted(op.data_dict().items()))
            for op in trace_warm_set(cfg, **kw)
            if op.family == "ssd_scan_h100"}
    assert {dict(k)["SQ"] for k in keys} == set(
        chunk_lengths(kw["prefill_chunk"], kw["max_len"]))
    for key in keys:
        data = dict(key)
        sq = data["SQ"]
        leaves = enumerate_candidates(SSD, tcore.H100_SXM, data)
        assert leaves
        for c in leaves:
            for rows in (1, 4):
                for dtype in (torch.float32, torch.bfloat16):
                    assert ssd_mod.format_error(
                        rows, sq, cfg.ssm.heads, data["HD"], data["STATE"],
                        min(c.assignment["chunk"], sq), c.assignment["bd"],
                        dtype) is None, (data, c.assignment)
        pick = DispatchCache().best_variant(SSD, tcore.H100_SXM,
                                            data).assignment
        if sq <= ssd_mod.STEP_SEQ:
            assert ssd_mod.step_body(sq, data["STATE"], pick["bd"])
            assert pick["bd"] == 32, (data, pick)
        if sq == 256:
            assert (pick["chunk"], pick["bd"]) == (128, 32), pick


# ---------------------------------------------------------------------------
# The paper's case studies (K4-K6) and the F6 repair
# ---------------------------------------------------------------------------

def _live(family, machine, data, point):
    """The indices of the leaves whose constraint systems the machine, the
    data and the program point leave consistent."""
    binding = {**machine.bindings(), **data, **point}
    return {i for i, leaf in enumerate(tcore.comprehensive_tree(family))
            if leaf.constraints.subs(binding).check()
            is not Verdict.INCONSISTENT}


def _kinds(family, idx):
    """(cached, grain reduced) of each leaf in ``idx``."""
    leaves = tcore.comprehensive_tree(family)
    return {(leaves[i].plan.flags["smem_cache"],
             leaves[i].plan.flags["granularity_level"] == 1) for i in idx}


@pytest.mark.parametrize("case", ["matadd_G", "transpose_V", "jacobi_V"])
def test_case_discussions_of_the_paper(case):
    """matadd: two cases on R = G (grain 2 at the estimate 14, grain 1 at
    10 <= G < 14; paper Fig. 2).  transpose and jacobi: for one program
    point, three values of Z_B = V leave live in turn cached grain s, cached
    grain 1 but not grain s, and uncached only (paper Figs. 7 and 8)."""
    from repro_torch.core.select import enumerate_candidates
    if case == "matadd_G":
        data = {"M": 1024, "N": 1024}
        for G, grains in ((12, {1}), (14, {2}), (255, {2})):
            machine = dataclasses.replace(tcore.H100_SXM, vreg_budget=G)
            got = enumerate_candidates(MATADD, machine, data)
            assert got and {c.assignment["s"] for c in got} == grains, G
        return
    if case == "transpose_V":
        family, point, data = TRANSPOSE, {"bm": 32, "bn": 32, "s": 4}, \
            {"M": 16384, "N": 16384}
        z = lambda g: transpose_mod.smem_bytes(32, 32, g)
    else:
        family, point, data = JACOBI, {"B": 256, "s": 4}, {"N": 32770}
        z = lambda g: jacobi_mod.smem_bytes(256, g)
    want = {z(4): {(True, False)},              # case 1: grain s fits
            z(4) - 1: {(True, True)},           # case 2: only grain 1
            z(1): {(True, True)},
            z(1) - 1: {(False, True)}}          # case 3: nothing staged
    for V, kinds in want.items():
        machine = dataclasses.replace(tcore.H100_SXM, vmem_bytes=V)
        assert _kinds(family, _live(family, machine, data, point)) == kinds, V
    # on both real machines a whole tile fits: only case 1 is live
    for machine in (tcore.H100_SXM, tcore.PAPER_M2050):
        assert _kinds(family, _live(family, machine, data, point)) == {
            (True, False)}


@pytest.mark.parametrize("family,data", [
    (MATADD, {"M": 1 << 13, "N": 1 << 13}), (MATADD, {"M": 300, "N": 700}),
    (TRANSPOSE, {"M": 1 << 14, "N": 1 << 14}),
    (TRANSPOSE, {"M": 300, "N": 700}), (JACOBI, {"N": (1 << 15) + 2}),
    (JACOBI, {"N": (1 << 21) + 2}), (JACOBI, {"N": 1026})],
    ids=lambda v: getattr(v, "name", None) or "-".join(map(str, v.values())))
def test_table_picks_fit_the_h100(family, data):
    """Every pick under H100_SXM at the paper's Table sizes (and a ragged
    shape) has at most 1024 threads a block and stages what fits V."""
    cand = DispatchCache().best_variant(family, tcore.H100_SXM, data)
    a, flags = cand.assignment, cand.plan.flags
    threads = a["B"] if family is JACOBI else a["bm"] * a["bn"]
    assert threads <= 1024
    if family is TRANSPOSE and flags["smem_cache"]:
        g = grain(cand.plan, a["s"])
        assert transpose_mod.smem_bytes(a["bm"], a["bn"], g) <= 232_448
    if family is JACOBI and flags["smem_cache"]:
        g = grain(cand.plan, a["s"])
        assert jacobi_mod.smem_bytes(a["B"], g) <= 232_448


@pytest.mark.parametrize("family,point", [
    (TRANSPOSE, {"bm": 32, "bn": 32}), (JACOBI, {"B": 256})],
    ids=lambda v: getattr(v, "name", None) or "point")
def test_phantom_grain_is_built_once(family, point):
    """Once reduce_granularity applied, s only names the source grain that
    did not fit and the kernel runs grain 1: the candidates that differ in
    s alone are keyed and built once, with s = 1.  At the source plan each
    s is its own kernel."""
    leaves = tcore.comprehensive_tree(family)
    for i, leaf in enumerate(leaves):
        fns = {family.instantiate(leaf.plan, {**point, "s": s}, "cpu",
                                  leaf_index=i) for s in (1, 2, 4, 8)}
        if leaf.plan.flags["granularity_level"]:
            (fn,) = fns
            assert fn.keywords["s"] == 1
        else:
            assert sorted(f.keywords["s"] for f in fns) == [1, 2, 4, 8]


@pytest.mark.parametrize("how", ["select", "best_variant", "rank",
                                 "cache"])
def test_data_key_naming_a_machine_symbol_raises(how):
    """F6: a data key that names a machine symbol ("T", threads a block) is
    refused by name instead of silently replacing the machine's value; the
    same data without it picks a leaf."""
    from repro_torch.core.select import best_variant, rank_candidates
    from repro_torch.kernels import ops
    bad, good = {"N": 32770, "T": 4}, {"N": 32770}
    call = {"select": lambda d: ops.select("jacobi1d_h100", d),
            "best_variant": lambda d: best_variant(JACOBI, tcore.H100_SXM, d),
            "rank": lambda d: rank_candidates(JACOBI, tcore.H100_SXM, d)[0],
            "cache": lambda d: DispatchCache().best_variant(
                JACOBI, tcore.H100_SXM, d)}[how]
    with pytest.raises(ValueError, match="'T'"):
        call(bad)
    assert call(good).assignment["B"] <= 1024
    with pytest.raises(ValueError, match="'T'"):
        best_variant(MATMUL, tcore.H100_SXM,
                     {"M": 1024, "N": 1024, "K": 1024, "T": 4})


def test_case_study_launcher_names_every_family():
    """``python -m repro_torch.launch.case_study`` runs on the CPU: each of
    the four families with its case count and a pick under both machines."""
    from repro_torch.launch import case_study
    lines = case_study.report()
    text = "\n".join(lines)
    for family in (MATADD, MATMUL, JACOBI, TRANSPOSE):
        n = len(tcore.comprehensive_tree(family))
        assert f"{family.name}: {n} cases in the comprehensive tree" in text
        for machine in ("h100_sxm", "paper_m2050"):
            assert any(l.startswith(f"  {machine} input")
                       and f"-> {family.name}[" in l for l in lines), \
                (family.name, machine)
    assert "Paper Table-1 analogue" in text


# ---------------------------------------------------------------------------
# K1's domains, napkin and leaves at the serve triples
# ---------------------------------------------------------------------------

SERVE_SETS = {
    "llama3_8b": dict(max_len=256, max_batch=4, prefill_chunk=32),
    "hymba_1p5b": dict(max_len=256, max_batch=4, prefill_chunk=32),
    "mamba2_130m": dict(max_len=1024, max_batch=4, prefill_chunk=256),
}


def test_matmul_domains_fit_the_select_cap():
    """``select`` enumerates at most 512 candidates a leaf, in the order of
    the domain product: every leaf's product stays within it, so the
    napkin ranks the whole domain."""
    for leaf in tcore.comprehensive_tree(MATMUL):
        sizes = [len(d.feasible()) for d in leaf.plan.program_params.values()]
        assert set(leaf.plan.program_params) == set(MM_PARAMS)
        assert math.prod(sizes) <= 512, (leaf.applied, sizes)
    source = tcore.comprehensive_tree(MATMUL)[0].plan.program_params
    assert math.prod(len(d.feasible()) for d in source.values()) == 480


@pytest.mark.parametrize("arch", sorted(SERVE_SETS))
def test_matmul_pick_equals_the_uncapped_pick(arch):
    """For every K1 triple of the full-width serve warm set, the pick under
    select's default cap is the pick over the whole domain."""
    from repro_torch.core.select import rank_candidates
    for op in trace_warm_set(get_config(arch), **SERVE_SETS[arch]):
        if op.family != "matmul_h100":
            continue
        data = op.data_dict()
        capped = rank_candidates(MATMUL, tcore.H100_SXM, data)[0]
        whole = rank_candidates(MATMUL, tcore.H100_SXM, data,
                                max_per_leaf=10 ** 9)[0]
        assert (capped.leaf_index, capped.assignment) == (
            whole.leaf_index, whole.assignment), data


@pytest.mark.parametrize("data,check", [
    ({"M": 4, "N": 4096, "K": 4096}, "blocks"),
    ({"M": 1, "N": 4096, "K": 14336}, "blocks"),
    ({"M": 4, "N": 16, "K": 1600}, "columns"),
    ({"M": 4, "N": 25, "K": 1600}, "columns")],
    ids=["q_proj", "down_proj_m1", "bc_proj", "decay_proj"])
def test_matmul_napkin_at_decode(data, check):
    """At a decode projection the pick splits K until the grid covers the
    132 SMs; at the SSM's narrow projections it takes no block wider than
    32 columns (no 240 of 256 columns idle)."""
    a = DispatchCache().best_variant(MATMUL, tcore.H100_SXM, data).assignment
    if check == "blocks":
        blocks = (-(-data["M"] // a["bm"]) * -(-data["N"] // a["bn"])
                  * a["kb"])
        assert blocks >= 132, a
    else:
        assert a["bn"] <= 32, a


FA_PARAMS = ("bq", "bkv", "kv_chunk", "stages")


def test_flash_domains_fit_the_select_cap():
    """Every K2 leaf's domain product stays within select's cap of 512, so
    the napkin ranks the whole domain."""
    for leaf in tcore.comprehensive_tree(FLASH):
        sizes = [len(d.feasible()) for d in leaf.plan.program_params.values()]
        assert set(leaf.plan.program_params) == set(FA_PARAMS)
        assert math.prod(sizes) <= 512, (leaf.applied, sizes)


@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1p5b"])
def test_flash_pick_equals_the_uncapped_pick(arch):
    """At every K2 key of the full-width serve warm set the pick under
    select's default cap is the pick over the whole domain, and a format
    the C entry point takes for both types at the smoke path's contexts and
    at sk 4096."""
    from repro_torch.core.select import rank_candidates
    cfg = get_config(arch)
    keys = [op.data_dict() for op in trace_warm_set(cfg, **SERVE_SETS[arch])
            if op.family == "flash_attention_h100"]
    assert {d["GROUP"] for d in keys} == {cfg.heads // cfg.kv_heads}
    assert {d["HK"] for d in keys} == {cfg.kv_heads}
    assert {d["SQ"] for d in keys} == {32, 16, 8, 4, 2, 1}
    for data in keys:
        capped = rank_candidates(FLASH, tcore.H100_SXM, data)[0]
        whole = rank_candidates(FLASH, tcore.H100_SXM, data,
                                max_per_leaf=10 ** 9)[0]
        assert (capped.leaf_index, capped.assignment) == (
            whole.leaf_index, whole.assignment), data
        a = capped.assignment
        for sk in (data["SQ"] + 15, 4096):
            for dtype in (torch.float32, torch.bfloat16):
                assert fa_mod.format_error(
                    cfg.heads, cfg.kv_heads, data["SQ"], sk, data["HD"],
                    *(a[n] for n in FA_PARAMS), dtype) is None, (data, a)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_counters_are_the_kernels_own(hd):
    """Z_B is ``smem_bytes`` in f32 and T is ``threads`` at every point of
    the domain where bq >= 32; at bq 16, where the kernel's warps hold 32 or
    64 rows, the counters' polynomial counts 72, so they bound it."""
    plan = FLASH.initial_plan()
    smem, den = FLASH.counter_value(plan, "smem_bytes")
    thr, thr_den = FLASH.counter_value(plan, "threads")
    for bq, bkv, stages in itertools.product(fa_mod.BQ, fa_mod.BKV,
                                             fa_mod.STAGES):
        pt = {"bq": bq, "bkv": bkv, "stages": stages, "HD": hd, "LANE": 32}
        z_b = smem.eval(pt) / den.eval(pt)
        t = thr.eval(pt) / thr_den.eval(pt)
        kernel = fa_mod.smem_bytes(bq, bkv, stages, hd, torch.float32)
        if bq >= 32:
            assert (z_b, t) == (kernel, fa_mod.threads(bq, bkv)), pt
        else:
            assert kernel <= z_b <= kernel + 4 * 40 * (bkv + 4), pt
            assert fa_mod.threads(bq, bkv) <= t == 144, pt


def test_flash_napkin_at_decode():
    """At a decode step (SQ 1) the group's few packed rows take one row
    warp (bq 16, its key warps reading slices of each tile), and the keys
    are split so that a long cache covers the SMs."""
    for group, hd, hk in ((4, 128, 8), (5, 64, 5)):
        a = DispatchCache().best_variant(
            FLASH, tcore.H100_SXM,
            {"SQ": 1, "HD": hd, "GROUP": group, "HK": hk}).assignment
        assert a["bq"] == 16 and fa_mod.key_warps(a["bq"], a["bkv"]) > 1, a
        assert a["kv_chunk"] <= 1024, a


def test_matmul_every_feasible_leaf_launches():
    """Every feasible leaf at a serve triple (hymba's B/C projection) passes
    the C entry point's checks for both types, and its ``instantiate`` on
    the CPU gives the product within rtol 1e-4 / atol 1e-3."""
    import numpy as np
    from repro_torch.core.select import enumerate_candidates
    data = {"M": 4, "N": 16, "K": 1600}
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((4, 1600)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((1600, 16))
                          / 40).astype(np.float32))
    want = a.double() @ b.double()
    cands = enumerate_candidates(MATMUL, tcore.H100_SXM, data)
    assert len(cands) >= 100
    assert {c.plan.flags["smem_cache"] for c in cands} == {True, False}
    for c in cands:
        asg, cached = c.assignment, c.plan.flags["smem_cache"]
        for dtype in (torch.float32, torch.bfloat16):
            assert mm_mod.format_error(4, 16, 1600, *(asg[n] for n in
                                                       MM_PARAMS),
                                       cached, dtype) is None, asg
        fn = MATMUL.instantiate(c.plan, asg, "cpu", leaf_index=c.leaf_index)
        if not cached:
            assert fn.keywords["stages"] == 1
        torch.testing.assert_close(fn(a, b).double(), want, rtol=1e-4,
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# Pure-Python copies: the originals' code, imports aside
# ---------------------------------------------------------------------------

COPIES = ("runtime/ft", "runtime/faults", "runtime/kv_pool",
          "runtime/scheduler", "artifacts/serde", "artifacts/store",
          "plans/store")


def _code(path) -> str:
    """The module's AST with docstrings and imports taken out: what a copy
    must keep of the original (every import of these modules is relative,
    so the imports are equal as well; comments are not in the AST)."""
    import ast
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list):
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                body = body[1:]
            node.body = [n for n in body if not isinstance(
                n, (ast.Import, ast.ImportFrom))] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIES)
def test_pure_python_copies_equal_the_originals(module):
    import pathlib
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    orig = src / "repro" / f"{module}.py"
    copy = src / "repro_torch" / f"{module}.py"
    assert _code(copy) == _code(orig)
    imports = {l for l in orig.read_text().splitlines()
               if l.startswith(("from ", "import "))}
    assert imports == {l for l in copy.read_text().splitlines()
                       if l.startswith(("from ", "import "))}


def test_dispatch_cache_keeps_the_jax_caches_surface():
    """The port's ``DispatchCache`` has every public method and property of
    the JAX package's (the disk tier, demotion and the frozen lane's
    republish among them); ``warm_callable`` keys on the device type."""
    import inspect
    from repro.artifacts.dispatch import DispatchCache as JCache
    public = {n for n in dir(JCache) if not n.startswith("_")}
    assert public <= {n for n in dir(DispatchCache) if not n.startswith("_")}
    for name in ("demote", "freeze_resolved", "unfreeze", "frozen_entry",
                 "rank_source", "attach_store", "clear"):
        assert name in public
    assert "device" in inspect.signature(
        DispatchCache.warm_callable).parameters
