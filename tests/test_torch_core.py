"""The port's copy of the symbolic core is the JAX package's core, the
port's families build non-trivial trees that resolve the whole serve warm
sets of llama3-8b, mamba2-130m and hymba-1.5b on an H100, and the case-study
families show the paper's case discussions in the port's symbols."""
import dataclasses

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.comprehensive import comprehensive_optimization as j_opt
from repro_torch.artifacts.dispatch import DispatchCache
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comprehensive import comprehensive_optimization as t_opt
from repro_torch.core.constraints import Verdict
from repro_torch.kernels import jacobi1d as jacobi_mod
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
            assert a["bm"] * a["bn"] <= 1024                       # T
            if cand.plan.flags["smem_cache"]:
                assert 4 * (a["bm"] * a["bk"]
                            + a["bk"] * a["bn"] * a["s"]) <= 232_448  # V
        else:
            hd = dict(op.data)["HD"]
            assert 32 * a["bq"] <= 1024
            assert 4 * (a["bq"] * hd + a["bkv"] * (2 * hd + 1)
                        + a["bq"] * a["bkv"]) <= 232_448


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
    """T and Z_B each rule out part of the matmul and attention domains."""
    from repro_torch.core.select import enumerate_candidates
    mm = enumerate_candidates(MATMUL, tcore.H100_SXM,
                              {"M": 32, "N": 4096, "K": 4096})
    assert all(c.assignment["bm"] * c.assignment["bn"] <= 1024 for c in mm)
    assert any(c.assignment["bm"] * c.assignment["bn"] == 1024 for c in mm)
    fa = enumerate_candidates(FLASH, tcore.H100_SXM, {"SQ": 32, "HD": 128})
    # a 256-key tile at HD 128 needs >= 264 KB of shared memory: V binds
    assert {c.assignment["bkv"] for c in fa} == {32, 64, 128}
    assert max(c.assignment["bq"] for c in fa) == 32   # 64 warps > T


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


def test_ssd_shared_memory_cuts_the_domain():
    """V rules out part of the SSD scan's domain (paper Z_B): at state 128
    a 128-step chunk fits only with hd tiles of at most 32 columns, and a
    256-step chunk (its 256² f32 scores alone are 256 KB) never fits."""
    from repro_torch.core.select import enumerate_candidates
    got = {(c.assignment["chunk"], c.assignment["bd"])
           for c in enumerate_candidates(SSD, tcore.H100_SXM,
                                         {"SQ": 256, "HD": 64, "STATE": 128})}
    domain = {(c, b) for c in (16, 32, 64, 128, 256) for b in (8, 16, 32, 64)}
    want = {(c, b) for c, b in domain if smem_bytes(c, b, 128) <= 232_448}
    assert got == want
    assert (128, 32) in got and (128, 64) not in got
    assert not any(c == 256 for c, _ in got)


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
