"""The port's fault harness and graceful degradation on the CPU.

The acceptance property is the JAX package's **chaos parity**
(``tests/test_faults.py``), held on the port's engine: for every seeded
recoverable fault schedule, ``run_until_drained`` commits the port's
fault-free tokens, which themselves equal the JAX engine's, with the
KV-pool invariants proved every tick.  On top of the JAX drills the port
has CUDA graphs: a demotion republishes a frozen pick, and the engine must
capture again exactly the steps whose recorded dispatch triples hold it,
leaving the KV pool, the SSM state and ``last_tok`` bit for bit.  The
graphs here are stand-ins that behave as CUDA graphs do: a capture records
the step's dispatches and writes no live state, a replay runs the step.

The llama3 smoke config (``attn_mlp``, f32) takes the place of the JAX
tests' yi-6b smoke config; weights are made in JAX and converted.  Every
schedule is seeded and no test reads the wall clock (deadlines and the
watchdog run on injected clocks).
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import init_model as j_init
from repro.runtime import ServeEngine as JEngine
from repro_torch.artifacts import DispatchCache
from repro_torch.artifacts.dispatch import cand_key, set_default_cache
from repro_torch.artifacts.store import (ArtifactStore, atomic_write_text,
                                         read_json_dict)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.params import H100_SXM
from repro_torch.core.select import Candidate, rank_candidates
from repro_torch.kernels.ops import FAMILIES
from repro_torch.models import init_model
from repro_torch.runtime import ServeEngine, faults
from repro_torch.runtime.faults import (ANY_TICK, FatalFault, FaultInjector,
                                        FaultSchedule, FaultSpec,
                                        InjectedIOFault)
from repro_torch.runtime.graph import StepGraphs
from repro_torch.runtime.serving import device_error

MATMUL = FAMILIES["matmul_h100"]
DATA = {"M": 4, "N": 256, "K": 512}
ENGINE_SITES = ("pool.alloc", "serve.cow", "serve.prefill", "serve.decode",
                "serve.tick")


@pytest.fixture(autouse=True)
def _isolate_default_cache():
    set_default_cache(DispatchCache())
    yield
    set_default_cache(None)
    faults.install(None)


# ---------------------------------------------------------------------------
# the injector (a copy of the JAX package's: replay and tick gating)
# ---------------------------------------------------------------------------

def test_random_schedules_replay_byte_exactly():
    for seed in range(8):
        a, b = FaultSchedule.random(seed), FaultSchedule.random(seed)
        assert a == b and list(a) == list(b)
    assert FaultSchedule.random(1) != FaultSchedule.random(2)
    inj = FaultInjector([FaultSpec("pool.alloc", 3, "exhaust", arg=1),
                         FaultSpec("pool.alloc", 3, "exhaust", arg=2)])
    assert inj.fire("pool.alloc") is None          # tick 0: no match
    inj.tick = 3
    assert [inj.fire("pool.alloc").arg, inj.fire("pool.alloc").arg] == [1, 2]
    assert inj.pending() == []


# ---------------------------------------------------------------------------
# the stores: torn or garbled bytes at every offset are a silent miss
# ---------------------------------------------------------------------------

def _torn_sweep(read_fn, path, site):
    intact = read_fn()
    assert intact is not None
    n = len(path.read_text())
    for kind in ("torn", "garble"):
        for off in range(n):
            with faults.inject([FaultSpec(site, ANY_TICK, kind, off)]):
                got = read_fn()
            if kind == "garble":
                assert got is None, (kind, off)
            else:
                assert got is None or got == intact, (kind, off)


def test_torn_dispatch_table_and_serve_plan_read_as_misses(tmp_path):
    from repro_torch.plans import serde as plan_serde
    from repro_torch.plans.store import PlanStore
    store = ArtifactStore(tmp_path)
    path = store.dispatch_path("matmul_h100", H100_SXM.name)
    atomic_write_text(path, json.dumps(
        {"format": 2, "kind": "dispatch", "family": "matmul_h100",
         "machine": H100_SXM.name, "buckets": {"K512|M4|N256": []}}))
    _torn_sweep(lambda: read_json_dict(path), path, "artifact.read")
    pstore = PlanStore(tmp_path)
    plan = plan_serde.ServePlan(
        config="torn-drill", machine=H100_SXM.name,
        machine_bindings=dict(H100_SXM.bindings()), max_len=64,
        max_batch=4, prefill_chunk=8, entries=(), table_digests=())
    ppath = pstore.save_plan(plan)
    _torn_sweep(lambda: pstore.load_plan("torn-drill", H100_SXM.name),
                ppath, "plan.read")


def test_io_fault_is_a_miss_and_fatal_propagates(tmp_path):
    path = tmp_path / "x.json"
    path.write_text("{}")
    with faults.inject([FaultSpec("artifact.read", ANY_TICK, "io")]):
        assert read_json_dict(path) is None
    assert read_json_dict(path) == {}
    with faults.inject([FaultSpec("artifact.read", ANY_TICK, "fatal")]):
        with pytest.raises(FatalFault):
            read_json_dict(path)
    with pytest.raises(InjectedIOFault):
        with faults.inject([FaultSpec("x", ANY_TICK, "io")]):
            faults.maybe_fault("x")


# ---------------------------------------------------------------------------
# DispatchCache.demote on the port's families
# ---------------------------------------------------------------------------

def test_demote_falls_down_the_ranking_and_republishes_frozen():
    cache = DispatchCache()
    ranked = rank_candidates(MATMUL, H100_SXM, DATA)
    cache.freeze([(MATMUL, H100_SXM, DATA)])
    before = cache.frozen_entry(MATMUL.name, H100_SXM.name, DATA)
    assert cand_key(before.candidate) == cand_key(ranked[0])
    nxt = cache.demote(MATMUL, H100_SXM, DATA,
                       error=RuntimeError("kernel exploded"), tick=7)
    assert cand_key(nxt) == cand_key(ranked[1])
    after = cache.frozen_entry(MATMUL.name, H100_SXM.name, DATA)
    assert cand_key(after.candidate) == cand_key(ranked[1])
    # the republished entry pins a callable for each device type
    assert set(after.fns) == {"cuda", "cpu"}
    assert cand_key(cache.best_variant(MATMUL, H100_SXM, DATA)) == \
        cand_key(ranked[1])
    (ev,) = cache.degrade_events
    assert ev.tick == 7 and ev.family == "matmul_h100" and not ev.exhausted
    assert "kernel exploded" in ev.error and "demoted" in ev.describe()
    # promotion (a republish of the old pick) clears its mark
    cache.freeze_resolved([(MATMUL, H100_SXM, DATA, ranked[0], "cold")])
    assert cache.demoted_keys(MATMUL.name, H100_SXM.name, DATA) == \
        frozenset()


def test_demotion_exhaustion_wraps_to_the_top(monkeypatch):
    import repro_torch.artifacts.dispatch as dispatch_mod
    cands = [Candidate(leaf_index=i, plan=None,
                       assignment={"bm": 16 << i}, score=-float(i))
             for i in range(3)]
    monkeypatch.setattr(dispatch_mod, "rank_candidates",
                        lambda *a, **k: list(cands))
    cache = DispatchCache()
    cache.best_variant(MATMUL, H100_SXM, DATA)
    got = [cand_key(cache.demote(MATMUL, H100_SXM, DATA,
                                 error=RuntimeError(str(i))))
           for i in range(4)]
    assert got == [cand_key(c) for c in (cands[1], cands[2], cands[0],
                                         cands[1])]
    assert [e.exhausted for e in cache.degrade_events] == [False, False,
                                                           True, False]


def test_device_errors_are_told_apart():
    assert device_error(RuntimeError("CUDA error: an illegal memory access "
                                     "was encountered"))
    assert not device_error(RuntimeError("injected error fault"))
    assert not device_error(ValueError("bad block format"))
    assert not device_error(faults.InjectedFault("serve.decode", "error", 1))


# ---------------------------------------------------------------------------
# the engine: parity against the JAX engine, then chaos
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    cfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(0), cfg)
    tcfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _engine(tcfg, tp, **kw):
    for k, v in dict(max_batch=3, max_len=64, page_size=4,
                     prefill_chunk=8).items():
        kw.setdefault(k, v)
    return ServeEngine(tcfg, tp, device="cpu", **kw)


def _drain_checked(eng, max_ticks=300):
    """run_until_drained with the pool invariants proved every tick."""
    done = []
    for _ in range(max_ticks):
        done.extend(eng.step())
        eng.pool.check_invariants(
            block_tables=[s.blocks for s in eng.sched.running()])
        if not eng.sched.has_work():
            break
    while eng._inflight:
        done.extend(eng._commit(eng._inflight.popleft()))
    return done


def _chaos_prompts(vocab):
    """A leader plus followers sharing its first 22 tokens: 22 % 4 != 0
    diverges mid-block, so followers map a partial tail block and CoW."""
    rng = np.random.default_rng(1234)
    lead = rng.integers(0, vocab, 24).astype(np.int32)
    follows = [np.concatenate([lead[:22], rng.integers(0, vocab, 6)]
                              ).astype(np.int32) for _ in range(2)]
    return [lead] + follows


def _staged_run(eng, prompts, *, max_new=5):
    outs = {}
    eng.submit(prompts[0], max_new=max_new)
    for r in _drain_checked(eng):
        outs[r.rid] = list(r.out)
    for p in prompts[1:]:
        eng.submit(p, max_new=max_new)
    for r in _drain_checked(eng):
        outs[r.rid] = list(r.out)
    return outs


def _all_at_once(eng, prompts, *, max_new=5):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return {r.rid: list(r.out) for r in _drain_checked(eng)}


@pytest.fixture(scope="module")
def reference(weights):
    """The port's fault-free staged run with sharing, checked against the
    JAX engine's on the same weights."""
    cfg, jp, tcfg, tp = weights
    prompts = _chaos_prompts(cfg.vocab)
    jeng = JEngine(cfg, jp, max_batch=3, max_len=64, page_size=4,
                   prefill_chunk=8, prefix_sharing=True)
    jref = _staged_run(jeng, prompts)
    set_default_cache(DispatchCache())
    eng = _engine(tcfg, tp, prefix_sharing=True)
    ref = _staged_run(eng, prompts)
    set_default_cache(None)
    assert ref == jref
    assert eng.pool.stats.cow_copies >= 2 and eng.pool.stats.prefix_hits
    return prompts, ref


def test_chaos_parity_sweep(weights, reference):
    """Twelve seeded schedules over the engine's sites, sharing and degrade
    on and the kernels frozen (so demotions really move picks): every
    drained run commits the fault-free tokens, with clean pool invariants
    every tick."""
    _, _, tcfg, tp = weights
    prompts, ref = reference
    fired = demotions = 0
    for seed in range(12):
        set_default_cache(DispatchCache())
        schedule = FaultSchedule.random(seed, sites=ENGINE_SITES,
                                        max_tick=24, n=4)
        eng = _engine(tcfg, tp, prefix_sharing=True, degrade=True,
                      warm_kernels=True)
        with faults.inject(schedule) as inj:
            got = _staged_run(eng, prompts)
        assert got == ref, (seed, list(schedule), inj.fired)
        fired += len(inj.fired)
        demotions += eng._cache.stats.demotions
    assert fired > 0 and demotions > 0


class _StandInGraph:
    """A CUDA graph's behaviour on the CPU: a capture resolves the step's
    dispatches (its wrappers pick their kernels) and writes no live state —
    here by running it on the engine's scratch state — and a replay runs
    the step.  ``log`` records the keys captured, in order."""

    def __init__(self, eng, log, key_of):
        self.eng, self.log, self.key_of = eng, log, key_of
        self.fn = None

    def capture(self, fn):
        self.fn = fn
        self.log.append(self.key_of(fn))
        with self.eng._scratch_state():
            fn()

    def replay(self):
        self.fn()


def _graphed(eng):
    """Capture ``eng``'s steps in stand-in graphs; returns the capture log."""
    log = []

    def key_of(fn):                 # decode: a bound method; C: a partial
        return getattr(fn, "args", ("decode",))[0]
    eng._capture(StepGraphs(lambda: _StandInGraph(eng, log, key_of)))
    log.clear()
    return log


def test_degrade_recaptures_only_the_steps_that_launch_the_demoted_pick(
        weights):
    """Schedule A of the chip drill on stand-in graphs: a ``serve.prefill``
    error at tick 1 and a ``serve.decode`` error at tick 6 demote two
    frozen picks; each demotion captures again exactly the steps whose
    recorded triples hold the demoted triple, none other, and the tokens
    equal the fault-free graphed run's."""
    _, _, tcfg, tp = weights
    prompts = _chaos_prompts(tcfg.vocab)[:2]
    ref_eng = _engine(tcfg, tp, warm_kernels=True)
    _graphed(ref_eng)
    ref = _all_at_once(ref_eng, prompts)

    set_default_cache(DispatchCache())
    eng = _engine(tcfg, tp, warm_kernels=True, degrade=True)
    log = _graphed(eng)
    triples = {k: s.triples for k, s in eng._graphs.steps.items()}
    sched = [FaultSpec("serve.prefill", 1, "error"),
             FaultSpec("serve.decode", 6, "error")]
    with faults.inject(sched) as inj:
        got = _all_at_once(eng, prompts)
    assert got == ref
    assert len(inj.fired) == 2
    assert len(eng.degrade_events) == 2 == eng._cache.stats.demotions
    assert len(eng.recapture_log) == 2
    for rec, ev in zip(eng.recapture_log, eng.degrade_events):
        assert (rec.tick, rec.triple) == (ev.tick, (ev.family, ev.machine,
                                                    ev.data))
        want = [k for k, t in triples.items() if rec.triple in t]
        assert want and not rec.grew
        assert list(rec.seconds) == want
        assert len(want) < len(triples)            # not every step
    assert log == [k for r in eng.recapture_log for k in r.seconds]
    assert eng.recaptures == len(log)
    assert "demotions=2" in eng.robustness_line()
    assert "recaptures=" in eng.robustness_line()


def test_a_demotion_that_grows_a_workspace_recaptures_every_step(
        weights, monkeypatch):
    """If the new picks need more of a split workspace than the graphs
    hold, every graph is dropped, the workspaces grow, and every step is
    captured again."""
    from repro_torch.kernels.workspace import WORKSPACES, Workspace
    _, _, tcfg, tp = weights
    ws = Workspace("test", torch.float32, 8)      # held by this engine only
    try:
        eng = _engine(tcfg, tp, warm_kernels=True, degrade=True)
        log = _graphed(eng)
        needs = eng._workspace_needs()
        monkeypatch.setattr(eng, "_workspace_needs",
                            lambda: needs + [(ws, 64)])
        with faults.inject([FaultSpec("serve.prefill", 0, "error")]):
            _all_at_once(eng, _chaos_prompts(tcfg.vocab)[:1], max_new=2)
        (rec,) = eng.recapture_log
        assert rec.grew and sorted(map(str, rec.seconds)) == sorted(
            map(str, eng._graphs.steps))
        assert sorted(map(str, log)) == sorted(map(str, eng._graphs.steps))
        assert ws.size(eng.device) == 64
        eng.close()
    finally:
        WORKSPACES.remove(ws)


ARCHS = ("llama3_8b", "mamba2_130m", "hymba_1p5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_recapture_leaves_the_live_state_bit_for_bit(arch):
    """Mid-serve, a recapture of every step (each after its warm run)
    leaves the KV pool, every slot's SSM state and ``last_tok`` as they
    were, bit for bit, and the run then commits the uninterrupted run's
    tokens."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = init_model(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 14, 5)]
    ref = _all_at_once(_engine(cfg, params, warm_kernels=True), prompts)
    eng = _engine(cfg, params, warm_kernels=True)
    _graphed(eng)
    for p in prompts:
        eng.submit(p, max_new=5)
    for _ in range(4):
        eng.step()
    before = ({k: v.clone() for k, v in eng.cache.items()},
              eng.last_tok.clone())
    op = next(o for o in eng._warm_ops if o.family == "matmul_h100")
    rec = eng._recapture((op.family, H100_SXM.name, op.data))
    assert rec.seconds
    for k, v in before[0].items():
        assert torch.equal(eng.cache[k], v), k
    assert torch.equal(eng.last_tok, before[1])
    done = {r.rid: list(r.out) for r in _drain_checked(eng)}
    assert done == ref


def test_double_fault_poisons_and_recomputes(weights):
    _, _, tcfg, tp = weights
    prompts = _chaos_prompts(tcfg.vocab)
    ref = _all_at_once(_engine(tcfg, tp), prompts)
    eng = _engine(tcfg, tp, degrade=True)
    sched = [FaultSpec("serve.decode", 6, "error"),
             FaultSpec("serve.decode", 6, "error")]
    with faults.inject(sched) as inj:
        got = _all_at_once(eng, prompts)
    assert len(inj.fired) == 2
    assert eng.sched.stats.poisoned >= 1
    assert got == ref


def test_fatal_fault_fails_loudly_engine_stays_drainable(weights):
    _, _, tcfg, tp = weights
    eng = _engine(tcfg, tp, degrade=True)
    for p in _chaos_prompts(tcfg.vocab):
        eng.submit(p, max_new=4)
    with faults.inject([FaultSpec("serve.decode", ANY_TICK, "fatal")]):
        with pytest.raises(FatalFault):
            for _ in range(100):
                eng.step()
                if not eng.sched.has_work():
                    break
    done = _drain_checked(eng)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)


def test_a_cuda_error_is_never_demoted(weights, monkeypatch):
    """An error of the CUDA runtime in a stage propagates even under
    ``degrade``: no demotion, no retry."""
    _, _, tcfg, tp = weights
    eng = _engine(tcfg, tp, degrade=True, warm_kernels=True)

    def lost(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(eng, "_decode_stage", lost)
    eng.submit(np.arange(4), max_new=3)
    with pytest.raises(RuntimeError, match="CUDA error"):
        for _ in range(10):
            eng.step()
    assert eng._cache.stats.demotions == 0 and not eng.degrade_events


def test_pool_exhaust_fault_forces_recovery(weights):
    _, _, tcfg, tp = weights
    prompts = _chaos_prompts(tcfg.vocab)
    ref = _all_at_once(_engine(tcfg, tp), prompts)
    eng = _engine(tcfg, tp)
    sched = [FaultSpec("pool.alloc", t, "exhaust") for t in (1, 3, 5, 8)]
    with faults.inject(sched) as inj:
        got = _all_at_once(eng, prompts)
    assert len(inj.fired) >= 1 and eng.pool.stats.alloc_failures >= 1
    assert got == ref


def test_engine_deadline_and_shed_surface_as_done(weights, fake_clock):
    _, _, tcfg, tp = weights
    prompts = _chaos_prompts(tcfg.vocab) + [_chaos_prompts(tcfg.vocab)[0]]
    eng = _engine(tcfg, tp, max_queue=2, deadline_ms=1000.0,
                  clock=fake_clock)
    assert [eng.submit(p, max_new=4) for p in prompts] == [1, 2, 3, 4]
    done = list(eng.step())
    fake_clock.advance(10.0)
    done += _drain_checked(eng)
    codes = sorted(r.error.code if r.error else "ok" for r in done)
    assert codes == ["deadline", "deadline", "queue_full", "queue_full"]
    assert "shed=2" in eng.robustness_line()
    eng.pool.check_invariants(block_tables=[])


def test_watchdog_flags_the_injected_slow_tick_on_a_counting_clock(weights):
    """Every tick reads the engine's clock the same number of times, so on
    a counting clock every tick lasts the same and only the tick with the
    injected 10-second hang is flagged — deterministically."""
    import itertools
    _, _, tcfg, tp = weights
    ticks = itertools.count()
    eng = _engine(tcfg, tp, clock=lambda: float(next(ticks)))
    eng.submit(np.arange(2, 10), max_new=24)
    with faults.inject([FaultSpec("serve.tick", 16, "slow",
                                  arg=10_000_000)]) as inj:
        _drain_checked(eng)
    assert len(inj.fired) == 1
    st = eng.watchdog.stats
    assert (st.slow_ticks, st.last_slow_tick) == (1, 16)
    assert st.worst_ratio == 11.0                  # (1 + 10 s) / 1
    assert "watchdog ticks=" in eng.robustness_line()
    assert eng.registry().snapshot()["watchdog"]["slow_ticks"] == 1
