"""The port's kernel monitor and hot-swap on the CPU, held as
``tests/test_adaptive.py`` holds the JAX package's, on the port's K1 family
and ``H100_SXM``, and against the JAX monitor under the same skew pattern.

Every test fabricates a workload where measured reality disagrees with the
frozen kernel pick through the deterministic ``SkewedTimer`` fixture
(``conftest.py``), never a real clock, except where the CPU's default timer
runs the plain versions as a smoke of the probe path.  On top of the JAX
properties the port has CUDA graphs: a graph keeps the kernel it captured,
so the engine must capture again exactly the steps whose recorded dispatch
triples hold a swapped triple (every step when a workspace grows).  The
graphs here are ``test_torch_faults.py``'s stand-ins: a capture records the
step's dispatches and writes no live state, a replay runs the step.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from conftest import TEST_SEED, SkewedTimer
from repro.artifacts import DispatchCache as JCache
from repro.artifacts.dispatch import set_default_cache as j_set_default_cache
from repro.core import TPU_V5E
from repro.core.select import rank_candidates as j_rank
from repro.kernels.ops import FAMILIES as JFAMILIES
from repro.models import init_model as j_init
from repro.runtime import ServeEngine as JEngine
from repro.runtime.monitor import KernelMonitor as JMonitor
from repro_torch.artifacts import DispatchCache
from repro_torch.artifacts.dispatch import set_default_cache
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.params import H100_SXM
from repro_torch.core.select import Candidate, rank_candidates
from repro_torch.kernels.ops import FAMILIES
from repro_torch.obs import tracing
from repro_torch.runtime import (KernelMonitor, MonitorStats, ServeEngine,
                                 SwapEvent, cand_key, faults)
from repro_torch.runtime.faults import FaultSpec
from test_torch_faults import _drain_checked, _graphed

MATMUL = FAMILIES["matmul_h100"]
DATA = {"M": 4, "N": 256, "K": 512}

SLOW, MID, FAST = 8e-3, 4e-3, 1e-3


@pytest.fixture(autouse=True)
def _isolate_default_cache():
    set_default_cache(DispatchCache())
    yield
    set_default_cache(None)
    faults.install(None)


def _freeze_wrong_pick(cache, family=MATMUL, machine=H100_SXM, data=DATA,
                       ranker=rank_candidates):
    """Fabricate the drift scenario: freeze a non-best candidate as the
    incumbent and return (incumbent, true_best) — 'wrong' by measurement,
    which the skewed timer will make manifest."""
    ranked = ranker(family, machine, data)
    incumbent, best = ranked[1], ranked[0]
    cache.freeze_resolved([(family, machine, data, incumbent, "symbolic")])
    return incumbent, best


def _monitor(cache, timer, **kw):
    defaults = dict(machine=H100_SXM, window=2, patience=2, probe_every=1,
                    top_k=2, seed=0)
    defaults.update(kw)
    mon = KernelMonitor(cache, timer=timer, **defaults)
    mon.track(MATMUL, DATA)
    return mon


# ---------------------------------------------------------------------------
# bounded detection + the swap itself
# ---------------------------------------------------------------------------

def test_wrong_pick_detected_and_swapped_within_bound(skewed_timer):
    cache = DispatchCache()
    incumbent, best = _freeze_wrong_pick(cache)
    skewed_timer.default = MID
    skewed_timer.skews[cand_key(incumbent)] = SLOW
    skewed_timer.skews[cand_key(best)] = FAST
    mon = _monitor(cache, skewed_timer)

    # probe_every=1 and one tracked triple: tick t runs probe t.  The
    # detection bound is window x patience probes — not one more.
    bound = mon.window * mon.patience
    for t in range(bound):
        assert mon.stats.swaps == 0
        mon.on_tick(t)
    assert mon.stats.swaps == 1
    assert mon.stats.windows == mon.patience
    assert mon.stats.disagreements == mon.patience

    ent = cache.frozen_entry("matmul_h100", H100_SXM.name, DATA)
    assert cand_key(ent.candidate) == cand_key(best)
    assert ent.source == "measured"               # live measurement decided
    (ev,) = mon.events
    assert isinstance(ev, SwapEvent)
    assert ev.old == cand_key(incumbent) and ev.new == cand_key(best)
    assert ev.challenger_us < ev.incumbent_us
    assert ev.family == "matmul_h100" and ev.tick == bound - 1
    assert "->" in ev.describe()


def test_agreement_never_swaps(skewed_timer):
    """Measurement confirming the frozen pick leaves it alone forever."""
    cache = DispatchCache()
    incumbent, best = _freeze_wrong_pick(cache)
    skewed_timer.default = MID
    skewed_timer.skews[cand_key(incumbent)] = FAST   # incumbent really is best
    mon = _monitor(cache, skewed_timer)
    for t in range(8 * mon.window * mon.patience):
        mon.on_tick(t)
    assert mon.stats.windows > 2 * mon.patience      # plenty of decisions
    assert mon.stats.disagreements == 0
    assert mon.stats.swaps == 0 and not mon.events
    ent = cache.frozen_entry("matmul_h100", H100_SXM.name, DATA)
    assert cand_key(ent.candidate) == cand_key(incumbent)


def test_nonconsecutive_disagreement_resets_streak(skewed_timer):
    """patience counts CONSECUTIVE disagreeing windows: one agreeing
    window in between resets the streak, so alternating windows never
    swap."""
    cache = DispatchCache()
    incumbent, best = _freeze_wrong_pick(cache)
    skewed_timer.default = MID
    mon = _monitor(cache, skewed_timer, patience=2)
    ik, bk = cand_key(incumbent), cand_key(best)
    for w in range(6):                               # alternate per window
        skewed_timer.skews[ik] = SLOW if w % 2 == 0 else FAST
        skewed_timer.skews[bk] = FAST if w % 2 == 0 else SLOW
        for st in mon._triples.values():
            st.reservoirs.clear()
        for t in range(mon.window):
            mon.on_tick(w * mon.window + t)
    assert mon.stats.disagreements >= 2              # drift windows did land
    assert mon.stats.swaps == 0                      # but never consecutively


def test_probe_failure_is_data_not_error():
    """A timer that raises (a launch refused, an injected fault) is counted
    and otherwise ignored — the frozen path keeps serving."""
    cache = DispatchCache()
    incumbent, _ = _freeze_wrong_pick(cache)

    def exploding_timer(family, plan, assignment, data, cfg):
        raise RuntimeError("boom")

    mon = _monitor(cache, exploding_timer)
    for t in range(4 * mon.window):
        mon.on_tick(t)
    assert mon.stats.probe_failures > 0
    assert mon.stats.samples == 0 and mon.stats.swaps == 0
    ent = cache.frozen_entry("matmul_h100", H100_SXM.name, DATA)
    assert cand_key(ent.candidate) == cand_key(incumbent)


def test_a_cuda_runtime_error_in_a_probe_propagates():
    """An error of the CUDA runtime (an illegal address, a launch failure)
    is not data: the context may be lost, so the probe raises it rather
    than count it and serve on."""
    cache = DispatchCache()
    _freeze_wrong_pick(cache)

    def lost_context_timer(family, plan, assignment, data, cfg):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    mon = _monitor(cache, lost_context_timer)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mon.on_tick(0)
    assert mon.stats.probe_failures == 0 and mon.stats.swaps == 0


def test_the_monitor_probe_fault_site_is_data_fatal_propagates(
        skewed_timer):
    """The ``monitor.probe`` fault site: an injected error (one spec fires
    once) is a probe failure and the probe's other sample is taken; a
    fatal fault propagates."""
    cache = DispatchCache()
    _freeze_wrong_pick(cache)
    mon = _monitor(cache, skewed_timer)
    with faults.inject([FaultSpec("monitor.probe", faults.ANY_TICK,
                                  "error")]):
        mon.on_tick(0)
    assert mon.stats.probe_failures == 1 and mon.stats.samples == 1
    with faults.inject([FaultSpec("monitor.probe", faults.ANY_TICK,
                                  "fatal")]):
        with pytest.raises(faults.FatalFault):
            mon.on_tick(1)


def test_untracked_or_unfrozen_triples_are_noops(skewed_timer):
    """No tracked triples, or a tracked triple that is not frozen: on_tick
    must do nothing (the monitor guards the frozen lane only)."""
    mon = KernelMonitor(DispatchCache(), timer=skewed_timer)
    assert mon.machine is H100_SXM                   # the port's default
    mon.on_tick(0)
    assert mon.stats.probes == 0
    cache = DispatchCache()                          # nothing frozen
    mon2 = _monitor(cache, skewed_timer)
    for t in range(4):
        mon2.on_tick(t)
    assert mon2.stats.probes == 0 and mon2.stats.swaps == 0


class _RacingCache(DispatchCache):
    """Deterministic race: an unfreeze lands exactly between the monitor's
    generation capture and its publish."""

    @property
    def unfreeze_generation(self):
        gen = DispatchCache.unfreeze_generation.fget(self)
        self.unfreeze()                              # the concurrent drop
        return gen


def test_concurrent_unfreeze_blocks_swap(skewed_timer):
    cache = _RacingCache()
    incumbent, best = _freeze_wrong_pick(cache)
    skewed_timer.default = MID
    skewed_timer.skews[cand_key(incumbent)] = SLOW
    skewed_timer.skews[cand_key(best)] = FAST
    mon = _monitor(cache, skewed_timer)
    for t in range(mon.window * mon.patience):
        mon.on_tick(t)
    assert mon.stats.swap_blocked_gen == 1
    assert mon.stats.swaps == 0 and not mon.events
    assert cache.frozen_plan is None                 # the explicit drop won


# ---------------------------------------------------------------------------
# no timing sequence swaps in an infeasible candidate (parametrised cases:
# a seeded sweep stands in for hypothesis)
# ---------------------------------------------------------------------------

def _bogus_candidate(base):
    """Looks like a stellar candidate (absurd score, real plan/leaf) but
    its assignment violates the constraint system: bm blown past every
    thread and shared-memory bound."""
    return Candidate(leaf_index=base.leaf_index, plan=base.plan,
                     assignment={**base.assignment, "bm": 1 << 20},
                     score=999.0)


def _check_no_infeasible_swap(timings):
    cache = DispatchCache()
    ranked = rank_candidates(MATMUL, H100_SXM, DATA)
    incumbent, bogus = ranked[0], _bogus_candidate(ranked[0])
    cache.freeze_resolved([(MATMUL, H100_SXM, DATA, incumbent, "symbolic")])

    calls = {"n": 0}

    def seq_timer(family, plan, assignment, data, cfg):
        t = timings[calls["n"] % len(timings)]
        calls["n"] += 1
        return [t]

    mon = KernelMonitor(cache, machine=H100_SXM, window=1, patience=1,
                        probe_every=1, top_k=2, timer=seq_timer,
                        ranker=lambda *a: [incumbent, bogus], seed=0)
    assert mon._infeasible(MATMUL, DATA, bogus)      # the scenario is real
    mon.track(MATMUL, DATA)
    for t in range(2 * len(timings)):
        mon.on_tick(t)

    ent = cache.frozen_entry("matmul_h100", H100_SXM.name, DATA)
    assert cand_key(ent.candidate) != cand_key(bogus)   # THE property
    assert cand_key(ent.candidate) == cand_key(incumbent)
    assert mon.stats.swaps == 0
    if mon.stats.swap_blocked_infeasible:
        assert mon.stats.swap_blocked_infeasible == 1
        key = ("matmul_h100", tuple(sorted(DATA.items())))
        pool_keys = [cand_key(c) for c in mon._triples[key].pool]
        assert cand_key(bogus) not in pool_keys
    return mon.stats.swap_blocked_infeasible


@pytest.mark.parametrize("case", range(12))
def test_no_timing_sequence_swaps_in_infeasible_candidate(case):
    """Hand-picked adversarial extremes plus a seeded sweep (TEST_SEED +
    case) over random timing sequences."""
    if case == 0:
        seq = [1e-6]                     # bogus always measures instant
    elif case == 1:
        seq = [1e-1]                     # everything identical and slow
    elif case == 2:
        seq = [1e-1, 1e-6] * 6           # incumbent slow / bogus fast
    else:
        g = np.random.default_rng(TEST_SEED + case)
        seq = list(g.uniform(1e-6, 1e-1, int(g.integers(1, 24))))
    blocked = _check_no_infeasible_swap(seq)
    if case == 2:                        # the crafted nomination must land
        assert blocked == 1


# ---------------------------------------------------------------------------
# parity with the JAX monitor under the same skew pattern
# ---------------------------------------------------------------------------

J_DATA = {"M": 256, "N": 256, "K": 256}


def _run_pattern(mon_cls, cache, family, machine, data, ranker, *,
                 window, patience, probe_every, flip, ticks):
    """One skew pattern through one package's monitor: the incumbent slow
    and the best fast (``flip`` > 0: the other way round up to that tick,
    then the drift), every other candidate MID.  Returns (the swap ticks,
    the stats)."""
    incumbent, best = _freeze_wrong_pick(cache, family, machine, data,
                                         ranker)
    timer = SkewedTimer(default=MID)
    mon = mon_cls(cache, machine=machine, window=window, patience=patience,
                  probe_every=probe_every, top_k=2, timer=timer, seed=0)
    mon.track(family, data)
    for t in range(ticks):
        drifted = t >= flip
        timer.skews[cand_key(incumbent)] = SLOW if drifted else FAST
        timer.skews[cand_key(best)] = FAST if drifted else SLOW
        mon.on_tick(t)
    return [e.tick for e in mon.events], vars(mon.stats)


@pytest.mark.parametrize("window,patience,probe_every,flip", [
    (2, 2, 1, 0), (1, 1, 1, 0), (4, 2, 2, 0), (2, 3, 1, 9), (3, 1, 4, 20)])
def test_monitor_swaps_at_the_jax_monitors_tick(window, patience,
                                                probe_every, flip):
    """Under the same skew pattern (and drift), the port's monitor and the
    JAX one swap at the same tick with equal ``MonitorStats``."""
    kw = dict(window=window, patience=patience, probe_every=probe_every,
              flip=flip, ticks=flip + 3 * window * patience * probe_every)
    j_set_default_cache(JCache())
    try:
        want = _run_pattern(JMonitor, JCache(), JFAMILIES["matmul"],
                            TPU_V5E, J_DATA, j_rank, **kw)
    finally:
        j_set_default_cache(None)
    got = _run_pattern(KernelMonitor, DispatchCache(), MATMUL,
                       H100_SXM, DATA, rank_candidates, **kw)
    assert got == want
    assert got[0], "the pattern must swap"
    assert set(got[1]) == set(vars(MonitorStats()))


# ---------------------------------------------------------------------------
# engine level: the hot swap is token-exact, recaptures what launches it
# ---------------------------------------------------------------------------

SERVE = dict(max_batch=4, max_len=128, page_size=16)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab):
    g = np.random.default_rng(TEST_SEED)
    return [g.integers(0, vocab, int(n)) for n in (12, 20, 7)]


def _narrowed(eng, cache, op_index=0, **kw):
    """Narrow ``eng``'s monitor to one K1 triple it dispatches (the
    ``op_index``-th) and skew its frozen incumbent slow, so the swap
    deterministically fires mid-run; returns the triple."""
    op = [o for o in eng._warm_ops if o.family == "matmul_h100"][op_index]
    opts = dict(window=1, patience=1, probe_every=1, top_k=2, seed=0)
    opts.update(kw)
    mon = KernelMonitor(cache, machine=H100_SXM, timer=eng.monitor.timer,
                        **opts)
    mon.track(MATMUL, op.data_dict())
    ent = cache.frozen_entry("matmul_h100", H100_SXM.name, op.data_dict())
    mon.timer.skews[cand_key(ent.candidate)] = SLOW
    eng.monitor = mon
    return ("matmul_h100", H100_SXM.name, op.data)


def _serve(tcfg, tp, prompts, monitored, graphed=False, **kw):
    cache = DispatchCache()
    set_default_cache(cache)
    eng = ServeEngine(tcfg, tp, device="cpu", warm_kernels=True,
                      plan_store=False, monitor=monitored, monitor_window=1,
                      monitor_every=1, swap_patience=1,
                      monitor_timer=SkewedTimer(default=MID), **SERVE)
    log = _graphed(eng) if graphed else None
    triple = _narrowed(eng, cache, **kw) if monitored else None
    for p in prompts:
        eng.submit(p, max_new=8)
    out = {r.rid: list(r.out) for r in _drain_checked(eng)}
    return eng, out, triple, log


def test_engine_hot_swap_is_token_exact(weights):
    """An engine whose monitor hot-swaps a kernel pick mid-traffic emits
    exactly the tokens of an unmonitored engine and of the JAX engine on
    the same weights; each ``SwapEvent`` lands in the trace at its tick."""
    jcfg, jparams, tcfg, tp = weights
    prompts = _prompts(tcfg.vocab)
    ref_eng, ref_out, _, _ = _serve(tcfg, tp, prompts, monitored=False)
    with tracing(capacity=1 << 14) as rec:
        mon_eng, mon_out, _, _ = _serve(tcfg, tp, prompts, monitored=True)
    assert mon_eng.monitor.stats.swaps >= 1          # the swap really fired
    assert mon_out == ref_out                        # token-exact across it
    assert ref_eng.monitor is None
    traced = [(r["family"], r["tick"]) for r in rec.records()
              if r["etype"] == "swap"]
    assert traced == [(e.family, e.tick) for e in mon_eng.monitor.events]
    assert mon_eng.registry().snapshot()["monitor"]["swaps"] >= 1
    jeng = JEngine(jcfg, jparams, prefill_chunk=32, **SERVE)
    for p in prompts:
        jeng.submit(p, max_new=8)
    jout = {r.rid: list(r.out) for r in jeng.run_until_drained()}
    assert mon_out == jout


def test_a_swap_recaptures_only_the_steps_that_launch_the_triple(weights):
    """On stand-in graphs: the swap captures again exactly the steps whose
    recorded triples hold the swapped one (not every step), counted as a
    demotion's recapture is, and the tokens equal the graphed run without
    a monitor."""
    _, _, tcfg, tp = weights
    prompts = _prompts(tcfg.vocab)
    _, ref, _, _ = _serve(tcfg, tp, prompts, monitored=False, graphed=True)
    eng, out, triple, log = _serve(tcfg, tp, prompts, monitored=True,
                                   graphed=True)
    assert out == ref
    steps = {k: s.triples for k, s in eng._graphs.steps.items()}
    ev = eng.monitor.events[0]
    (rec,) = [r for r in eng.recapture_log if r.tick == ev.tick]
    assert rec.triple == triple == (ev.family, H100_SXM.name, ev.data)
    want = [k for k, t in steps.items() if triple in t]
    assert want and len(want) < len(steps) and not rec.grew
    assert list(rec.seconds) == want
    assert log == [k for r in eng.recapture_log for k in r.seconds]
    assert eng.recaptures == len(log)
    assert len(eng.recapture_log) == eng.monitor.stats.swaps


def test_a_swap_that_grows_a_workspace_recaptures_every_step(weights,
                                                             monkeypatch):
    """If the challenger needs more of a split workspace than the graphs
    hold (a larger K1 ``kb``, a smaller K2 ``kv_chunk``), every graph is
    dropped, the workspaces grow, and every step is captured again."""
    from repro_torch.kernels.workspace import WORKSPACES, Workspace
    _, _, tcfg, tp = weights
    ws = Workspace("test", torch.float32, 8)
    try:
        cache = DispatchCache()
        set_default_cache(cache)
        eng = ServeEngine(tcfg, tp, device="cpu", warm_kernels=True,
                          plan_store=False, monitor=True,
                          monitor_timer=SkewedTimer(default=MID), **SERVE)
        log = _graphed(eng)
        _narrowed(eng, cache)
        needs = eng._workspace_needs()
        monkeypatch.setattr(eng, "_workspace_needs",
                            lambda: needs + [(ws, 64)])
        eng.submit(_prompts(tcfg.vocab)[0], max_new=2)
        _drain_checked(eng)
        rec = eng.recapture_log[0]
        assert rec.grew and sorted(map(str, rec.seconds)) == sorted(
            map(str, eng._graphs.steps))
        assert sorted(map(str, log[:len(rec.seconds)])) == sorted(
            map(str, eng._graphs.steps))
        assert ws.size(eng.device) == 64
        eng.close()
    finally:
        WORKSPACES.remove(ws)


def test_monitor_at_its_defaults_probes_with_the_cpu_timer(weights):
    """``monitor=True`` alone (the launcher's ``--monitor``): the monitor
    tracks every frozen triple of the engine and probes with the default
    timer on the engine's device (the plain versions on the CPU: no
    failure), one probe every 4 ticks; the tokens are the unmonitored
    engine's."""
    _, _, tcfg, tp = weights
    prompts = _prompts(tcfg.vocab)
    set_default_cache(DispatchCache())
    ref = ServeEngine(tcfg, tp, device="cpu", warm_kernels=True,
                      plan_store=False, **SERVE)
    want = {r.rid: list(r.out) for r in _drain_checked_after(ref, prompts)}
    set_default_cache(DispatchCache())
    eng = ServeEngine(tcfg, tp, device="cpu", warm_kernels=True,
                      plan_store=False, monitor=True, **SERVE)
    mon = eng.monitor
    assert (mon.window, mon.probe_every, mon.threshold, mon.patience) == (
        8, 4, 1.25, 2)
    assert mon.measure.device == "cpu" and mon.measure.max_dim == 64
    assert len(mon._triples) == len(eng._warm_keys)
    got = {r.rid: list(r.out) for r in _drain_checked_after(eng, prompts)}
    assert got == want
    assert 0 < mon.stats.probes <= -(-eng.sched.ticks // 4)
    assert mon.stats.samples == 2 * mon.stats.probes
    assert mon.stats.probe_failures == 0
    assert "monitor probes=" in eng.registry().summary_line()


def _drain_checked_after(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=8)
    return _drain_checked(eng)


def test_monitor_needs_warm_kernels(weights):
    """As in the JAX engine: without a frozen plan there is nothing to
    guard, so no monitor is built (and the option is not refused)."""
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", monitor=True, **SERVE)
    assert eng.monitor is None and eng.kernel_plan is None
    assert eng.registry().snapshot()["monitor"] == {}
