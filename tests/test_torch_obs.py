"""The port's ``repro_torch.obs`` against the JAX package's ``repro.obs``.

The copies are the originals' code; the port's engine, scheduler and
dispatch cache emit the JAX package's records; under a counting clock the
port engine's trace equals the JAX engine's, ``AdmissionDecision`` and
``TickSpan`` field for field, on a run with EOS, a preemption, a shed
submit, a deadline cancel and ``async_depth`` 2; the registry's pool and
scheduler parts equal the JAX engine's; ``scripts/trace_report.py`` reads
the port's JSONL.
"""
import ast
import functools
import importlib.util
import itertools
import json
import pathlib

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.obs as jobs
from repro.models import init_model as j_init
from repro.runtime import ServeEngine as JEngine
from repro_torch import obs
from repro_torch.artifacts.dispatch import DispatchCache, set_default_cache
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.params import H100_SXM
from repro_torch.kernels.matmul import FAMILY as MATMUL
from repro_torch.runtime import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = ("__init__", "events", "recorder", "registry")
# a tight pool (6 usable blocks of 4) for two slots, a queue bound of 4
ENGINE = dict(max_batch=2, max_len=24, page_size=4, prefill_chunk=8,
              watermark_blocks=0, num_blocks=7, max_queue=4)


def _code(path: pathlib.Path) -> str:
    """The module's AST with every docstring taken out (comments are not in
    it): what the copy must keep of the original."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", MODULES)
def test_obs_copies_equal_the_originals(name):
    """Every import in ``repro.obs`` is relative, so a copy with its imports
    rewritten is the original's code: only docstrings may differ."""
    orig = ROOT / "src" / "repro" / "obs" / f"{name}.py"
    copy = ROOT / "src" / "repro_torch" / "obs" / f"{name}.py"
    assert _code(copy) == _code(orig)


@pytest.fixture(scope="module")
def weights():
    cfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(21), cfg)
    tcfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


@pytest.fixture
def fresh_cache():
    cache = DispatchCache()
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


def _prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (8, 8, 8, 6, 5)]


def _traced(make, tracing, prompts, eos):
    """Serve the five requests on an engine under a counting clock and a
    fresh recorder: the first stops at ``eos``, the fourth has a deadline
    that passes while it waits, the fifth is shed by the queue bound, and
    the pool is too small for the second and third to grow together.
    Returns (outputs by submit order, records, engine)."""
    eng = make(functools.partial(next, itertools.count()))
    with tracing() as rec:
        rids = [eng.submit(prompts[0], max_new=12, eos=eos),
                eng.submit(prompts[1], max_new=12),
                eng.submit(prompts[2], max_new=12),
                eng.submit(prompts[3], max_new=6, deadline_ms=15000),
                eng.submit(prompts[4], max_new=4)]
        done = {r.rid: (r.out, r.error.code if r.error else None)
                for r in eng.run_until_drained()}
    return [done[r] for r in rids], rec.records(), eng


@pytest.fixture(scope="module")
def both_traces(weights):
    cfg, jp, tcfg, tp = weights
    prompts = _prompts(cfg.vocab)
    probe = JEngine(cfg, jp, **ENGINE)
    probe.submit(prompts[0], max_new=12)
    eos = probe.run_until_drained()[0].out[3]
    set_default_cache(DispatchCache())
    try:
        port = _traced(lambda clock: ServeEngine(
            tcfg, tp, device="cpu", async_depth=2, clock=clock, **ENGINE),
            obs.tracing, prompts, eos)
    finally:
        set_default_cache(None)
    ref = _traced(lambda clock: JEngine(cfg, jp, async_depth=2, clock=clock,
                                        **ENGINE), jobs.tracing, prompts, eos)
    return ref, port, eos


def _kept(records, etypes=("admission_decision", "tick_span")):
    """The records of ``etypes``, without the recorder's seq ids (the port
    also traces the dispatch resolutions its model makes, ROADMAP F3)."""
    return [{k: v for k, v in r.items() if k != "seq"} for r in records
            if r["etype"] in etypes]


def test_engine_trace_equals_jax_engine(both_traces):
    (jout, jrec, _), (tout, trec, teng), eos = both_traces
    assert tout == jout
    assert tout[0][0][-1] == eos and len(tout[0][0]) < 12      # EOS
    assert [code for _, code in tout[3:]] == ["deadline", "queue_full"]
    actions = {r["action"] for r in trec
               if r["etype"] == "admission_decision"}
    assert {"admit", "wait", "shed", "preempt", "cancel"} <= actions
    spans = [r for r in trec if r["etype"] == "tick_span"]
    assert len(spans) == teng.sched.ticks
    assert _kept(trec) == _kept(jrec)
    assert any(r["etype"] == "dispatch_decision" for r in trec)


def test_every_port_record_validates_in_both_packages(both_traces):
    _, (_, trec, _), _ = both_traces
    assert {r["etype"] for r in trec} == {
        "admission_decision", "tick_span", "dispatch_decision"}
    for r in trec:
        obs.validate_record(r)
        jobs.validate_record(r)


def test_registry_pool_and_sched_equal_jax_engine(both_traces):
    (_, _, jeng), (_, _, teng), _ = both_traces
    jsnap, tsnap = jeng.registry().snapshot(), teng.registry().snapshot()
    assert tsnap["pool"] == jsnap["pool"]
    assert tsnap["sched"] == jsnap["sched"]
    assert tsnap["dispatch"]["cold_builds"] > 0
    assert teng.registry().summary_line().startswith("obs ticks=")


def test_trace_report_reads_the_port_jsonl(both_traces, tmp_path):
    (_, jrec, _), (_, trec, teng), _ = both_traces
    spec = importlib.util.spec_from_file_location(
        "trace_report", ROOT / "scripts" / "trace_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    path = tmp_path / "trace.jsonl"
    path.write_text("".join(json.dumps(r, sort_keys=True) + "\n"
                            for r in trec))
    rep = report.aggregate(report.load_records(str(path)))
    ref = report.aggregate(jrec)
    assert rep["ticks"] == ref["ticks"]
    assert rep["sched"] == ref["sched"] == {
        k: v for k, v in {
            "admit": teng.sched.stats.admissions,
            "wait": teng.sched.stats.admission_waits,
            "shed": teng.sched.stats.shed,
            "preempt": teng.sched.stats.preemptions,
            "cancel": teng.sched.stats.cancelled}.items() if v}
    assert set(rep["dispatch"]) == {"matmul_h100", "flash_attention_h100"}


def test_dispatch_traces_resolves_frozen_hits_and_sampled_warm_lane(
        fresh_cache):
    data = {"M": 64, "N": 64, "K": 64}
    items = tuple(data.items())
    with obs.tracing(sample_frozen_every=2) as rec:
        fresh_cache.best_variant(MATMUL, H100_SXM, data)       # cold
        fresh_cache.best_variant(MATMUL, H100_SXM, data)       # memory
        fresh_cache.freeze([(MATMUL, H100_SXM, data)])         # memory
        fresh_cache.best_variant(MATMUL, H100_SXM, data)       # frozen
        for _ in range(4):
            fresh_cache.warm_callable(MATMUL, H100_SXM, items, "cpu")
    got = [(r["source"], r["surface"]) for r in rec.records()]
    assert got == [("cold", "resolve"), ("cold", "resolve"),
                   ("cold", "resolve"), ("cold", "frozen"),
                   ("frozen", "warm_sampled"), ("frozen", "warm_sampled")]
    assert all(r["rank"] == 0 and r["demoted"] == 0 and r["leaf"] >= 0
               for r in rec.records()[:4])
    for r in rec.records():
        jobs.validate_record(r)
    with obs.tracing() as rec:                 # default: the lane uncounted
        fresh_cache.warm_callable(MATMUL, H100_SXM, items, "cpu")
    assert len(rec) == 0


def test_launcher_writes_the_trace(monkeypatch, capsys, tmp_path,
                                   fresh_cache):
    from repro_torch.launch import serve
    from repro_torch.obs import recorder
    monkeypatch.setattr(recorder, "_recorder", None)   # restored after
    path = tmp_path / "t.jsonl"
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "mamba2-130m", "--device", "cpu", "--requests",
        "2", "--max-new", "2", "--warm-kernels", "--trace", str(path)])
    serve.main()
    out = capsys.readouterr().out
    assert "obs ticks=" in out and f"-> {path}" in out
    records = [json.loads(line) for line in path.read_text().splitlines()]
    spans = [r for r in records if r["etype"] == "tick_span"]
    assert spans and sum(r["finished"] for r in spans) == 2
    assert any(r["etype"] == "dispatch_decision" for r in records)
