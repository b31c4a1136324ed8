"""The port's ServeEngine against the JAX ServeEngine on the CPU.

f32 llama3, mamba2 and hymba smoke configs, the same weights (JAX init ->
numpy -> port), the same prompts; ``prefill_chunk`` below some prompt
lengths and more requests than slots, so chunked prefill, slot reuse (and
with it the SSM state reset) and mid-prefill decode all run.  The greedy
tokens must be equal.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import init_model as j_init
from repro.runtime import ServeEngine as JEngine
from repro_torch.artifacts.dispatch import DispatchCache, set_default_cache
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import init_model
from repro_torch.plans.trace import chunk_lengths
from repro_torch.runtime import ServeEngine, warm_kernel_dispatch

ENGINE = dict(max_batch=3, max_len=48, page_size=8, prefill_chunk=8)


@pytest.fixture
def fresh_cache():
    cache = DispatchCache()
    set_default_cache(cache)
    yield cache
    set_default_cache(None)


@pytest.fixture(scope="module")
def weights():
    cfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(11), cfg)
    tcfg = get_smoke_config("llama3_8b").scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(vocab):
    rng = np.random.default_rng(12)
    return [rng.integers(0, vocab, n) for n in (5, 19, 11, 3, 26)]


def test_engine_tokens_equal_jax_engine(weights, fresh_cache):
    cfg, jp, tcfg, tp = weights
    prompts = _prompts(cfg.vocab)
    jeng = JEngine(cfg, jp, **ENGINE)
    jr = [jeng.submit(p, max_new=6) for p in prompts]
    jdone = {r.rid: r.out for r in jeng.run_until_drained()}

    teng = ServeEngine(tcfg, tp, warm_kernels=True, device="cpu", **ENGINE)
    cold = fresh_cache.stats.cold_builds
    tr = [teng.submit(p, max_new=6) for p in prompts]
    tdone = {r.rid: r.out for r in teng.run_until_drained()}
    assert fresh_cache.stats.cold_builds == cold       # warm set exhaustive
    assert teng.sched.stats.prefill_chunks > len(prompts)  # chunked prefill
    assert [tdone[r] for r in tr] == [jdone[r] for r in jr]
    assert all(len(tdone[r]) == 6 for r in tr)


def test_warm_set_freezes_every_dispatched_triple(weights, fresh_cache):
    _, _, tcfg, _ = weights
    picks = warm_kernel_dispatch(tcfg, max_len=48, max_batch=3,
                                 prefill_chunk=8)
    assert len(picks) == len(fresh_cache.frozen_plan)
    assert {p["rank_source"] for p in picks.values()} == {"cold"}


def test_traced_warm_set_holds_what_the_engine_dispatches(weights,
                                                          fresh_cache):
    """Fidelity of the port's trace (ROADMAP F5): every (family, data) the
    engine's model asks the dispatch cache for during a run is in the
    traced warm set."""
    from repro_torch.plans.trace import trace_warm_set
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    with fresh_cache.record() as rec:
        for p in _prompts(tcfg.vocab):
            eng.submit(p, max_new=4)
        eng.run_until_drained()
    traced = {(op.family, op.data) for op in trace_warm_set(
        tcfg, max_len=ENGINE["max_len"], max_batch=ENGINE["max_batch"],
        prefill_chunk=ENGINE["prefill_chunk"])}
    seen = {(f, items) for f, _, items in rec.requests}
    assert {f for f, _ in seen} == {"matmul_h100", "flash_attention_h100"}
    assert seen <= traced, seen - traced


def test_engine_without_warmup_resolves_cold_once_per_shape(weights,
                                                            fresh_cache):
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    for p in _prompts(tcfg.vocab)[:2]:
        eng.submit(p, max_new=3)
    eng.run_until_drained()
    first = fresh_cache.stats.cold_builds
    assert first > 0
    for p in _prompts(tcfg.vocab)[:2]:
        eng.submit(p, max_new=3)
    eng.run_until_drained()
    assert fresh_cache.stats.cold_builds == first      # LRU serves repeats


@pytest.mark.parametrize("kw", [dict(monitor=True)])
def test_later_slices_are_refused_by_name(weights, kw, monkeypatch):
    """The engine takes every option of the JAX engine, the kernel monitor
    (the last one ported) included; what it refuses, it refuses as the JAX
    package does: whisper-large-v3, an encoder-decoder, which the engine
    (``ValueError``), the paged cache and trace, and the launcher
    (``SystemExit``) turn away; it is served through the non-paged
    steps."""
    import sys
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_paged_cache
    from repro_torch.plans.trace import trace_warm_set
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", warm_kernels=True,
                      plan_store=False, **ENGINE, **kw)
    assert eng.monitor is not None and eng.monitor.stats.probes == 0
    wcfg = get_smoke_config("whisper-large-v3").scaled(dtype="float32")
    assert get_config("whisper-large-v3").encoder.seq_len == 1500
    with pytest.raises(ValueError, match="ServeEngine does not serve "
                                         "encoder-decoder configs"):
        ServeEngine(wcfg, init_model(wcfg, device="cpu"), device="cpu",
                    **ENGINE, **kw)
    with pytest.raises(ValueError, match="encoder-decoder"):
        init_paged_cache(wcfg, 4, 8, 2, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        trace_warm_set(wcfg)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper-large-v3",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="enc-dec serving"):
        launcher.main()


def test_async_depth_below_one_raises(weights):
    """As in the JAX engine: a pipeline needs at least the tick it runs."""
    _, _, tcfg, tp = weights
    with pytest.raises(ValueError, match="async_depth"):
        ServeEngine(tcfg, tp, device="cpu", async_depth=0)


def test_engine_needs_cuda_unless_cpu_is_asked(weights):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    _, _, tcfg, tp = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, tp)


def test_queue_bound_and_validation_pass_through(weights):
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", max_queue=1, **ENGINE)
    with pytest.raises(ValueError):
        eng.submit(np.arange(60), max_new=4)          # over max_len
    eng.submit(np.arange(4), max_new=2)
    eng.submit(np.arange(4), max_new=2)               # shed: queue full
    done = eng.run_until_drained()
    codes = sorted(r.error.code if r.error else "ok" for r in done)
    assert codes == ["ok", "queue_full"]


def test_launcher_serves_smoke_on_cpu(monkeypatch, capsys, fresh_cache):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama3-8b", "--device", "cpu", "--requests", "3",
        "--max-new", "2", "--warm-kernels"])
    serve.main()
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out
    assert "cold dispatch builds during the run: 0" in out


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "kimi-k2-1t-a32b"])
def test_launcher_serves_new_configs_on_cpu(arch, monkeypatch, capsys,
                                            fresh_cache):
    """``--arch`` takes the new ids (a dense config with q/k/v biases, a MoE
    config); the launcher counts K1b (the experts' wrapper) and K1's
    batched entry beside K1."""
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--device", "cpu", "--requests", "3",
        "--max-new", "2", "--warm-kernels"])
    serve.main()
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out
    assert "matmul_experts_h100=0" in out
    assert "matmul_h100_batched=0" in out
    assert "cold dispatch builds during the run: 0" in out


# ---------------------------------------------------------------------------
# SSM (mamba2) and hybrid (hymba)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mamba2_130m", "hymba_1p5b"])
def ssm_weights(request):
    cfg = jconfigs.get_smoke_config(request.param).scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(13), cfg)
    tcfg = get_smoke_config(request.param).scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def test_ssm_engine_tokens_equal_jax_engine(ssm_weights, fresh_cache):
    """Five requests through three slots: two slots are reused, so a stale
    SSM state would change the later requests' tokens.  The warmed engine
    resolves nothing cold during the run."""
    cfg, jp, tcfg, tp = ssm_weights
    prompts = _prompts(cfg.vocab)
    jeng = JEngine(cfg, jp, **ENGINE)
    jr = [jeng.submit(p, max_new=6) for p in prompts]
    jdone = {r.rid: r.out for r in jeng.run_until_drained()}

    teng = ServeEngine(tcfg, tp, warm_kernels=True, device="cpu", **ENGINE)
    cold = fresh_cache.stats.cold_builds
    tr = [teng.submit(p, max_new=6) for p in prompts]
    tdone = {r.rid: r.out for r in teng.run_until_drained()}
    assert fresh_cache.stats.cold_builds == cold
    assert teng.sched.stats.prefill_chunks > len(prompts)
    assert [tdone[r] for r in tr] == [jdone[r] for r in jr]
    assert all(len(tdone[r]) == 6 for r in tr)


def test_ssm_traced_warm_set_holds_what_the_engine_dispatches(ssm_weights,
                                                              fresh_cache):
    """The trace covers every (family, data) the SSM and hybrid models ask
    for, the f32 decay projection and the SSD scan included (ROADMAP F5)."""
    from repro_torch.plans.trace import trace_warm_set
    _, _, tcfg, tp = ssm_weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    with fresh_cache.record() as rec:
        for p in _prompts(tcfg.vocab):
            eng.submit(p, max_new=4)
        eng.run_until_drained()
    traced = {(op.family, op.data) for op in trace_warm_set(
        tcfg, max_len=ENGINE["max_len"], max_batch=ENGINE["max_batch"],
        prefill_chunk=ENGINE["prefill_chunk"])}
    seen = {(f, items) for f, _, items in rec.requests}
    want = {"matmul_h100", "ssd_scan_h100"} | (
        {"flash_attention_h100"} if tcfg.block == "hybrid" else set())
    assert {f for f, _ in seen} == want
    assert ("matmul_h100", (("K", tcfg.d_model), ("M", ENGINE["max_batch"]),
                            ("N", tcfg.ssm.heads))) in seen
    assert seen <= traced, seen - traced


def test_admission_zeroes_the_slot_state(ssm_weights):
    """A sequence admitted to a slot starts from a zero SSM state: the same
    prompt gives the same tokens in a slot another sequence used before."""
    _, _, tcfg, tp = ssm_weights
    eng = ServeEngine(tcfg, tp, device="cpu", **dict(ENGINE, max_batch=1))
    prompt = _prompts(tcfg.vocab)[0]
    first = eng.submit(prompt, max_new=4)
    eng.submit(_prompts(tcfg.vocab)[1], max_new=4)
    again = eng.submit(prompt, max_new=4)
    out = {r.rid: r.out for r in eng.run_until_drained()}
    assert out[first] == out[again]


# ---------------------------------------------------------------------------
# The compiled decode tick and async_depth
# ---------------------------------------------------------------------------

def _serve_both(cfg, jp, tcfg, tp, prompts, *, max_new, eos=None, **kw):
    """The JAX engine and the port's on the CPU, the same prompts submitted
    at once; outputs in submit order and the port's engine."""
    outs = []
    for make in (lambda: JEngine(cfg, jp, **kw),
                 lambda: ServeEngine(tcfg, tp, device="cpu", **kw)):
        eng = make()
        rids = [eng.submit(p, max_new=max_new, eos=eos) for p in prompts]
        done = {r.rid: r.out for r in eng.run_until_drained()}
        outs.append([done[r] for r in rids])
    return outs[0], outs[1], eng


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_async_depth_equals_jax_engine_with_eos_and_preemption(weights,
                                                               depth):
    """At ``async_depth`` 1, 2 and 3 the port commits the JAX engine's
    tokens at the same depth, as ``tests/test_prefix_sharing.py`` sweeps
    the JAX engine: EOS found at a commit truncates the speculative tokens
    dispatched past it, and under a tight pool the in-flight tokens of a
    preempted sequence are dropped and regenerated."""
    cfg, jp, tcfg, tp = weights
    probe = ServeEngine(tcfg, tp, device="cpu", max_batch=2, max_len=48)
    probe.submit(np.arange(6), max_new=1)
    first = probe.run_until_drained()[0].out[0]
    want, got, _ = _serve_both(cfg, jp, tcfg, tp, [np.arange(6)],
                               max_new=16, eos=first, max_batch=2,
                               max_len=48, async_depth=depth)
    assert want == got == [[first]]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
               for _ in range(2)]
    want, got, eng = _serve_both(cfg, jp, tcfg, tp, prompts, max_new=12,
                                 max_batch=2, max_len=24, page_size=4,
                                 prefill_chunk=8, watermark_blocks=0,
                                 num_blocks=7, async_depth=depth)
    assert eng.sched.stats.preemptions > 0
    assert got == want and all(len(o) == 12 for o in got)
    assert not eng._inflight


def _refuse_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host sync or upload inside the step")

    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)


def test_decode_step_makes_no_host_sync_or_upload(weights, monkeypatch):
    """The captured function reads and writes device buffers only: while it
    runs, every way of reading a tensor on the host or making one from host
    data raises."""
    _, _, tcfg, tp = weights
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    eng._active[:2] = True
    eng._idx[:2] = torch.tensor([3, 5], dtype=torch.int32)
    eng._bts[:2, :1] = torch.tensor([[1], [2]], dtype=torch.int32)
    before = eng.last_tok.clone()
    _refuse_host_reads(monkeypatch)
    eng._decode_body()
    monkeypatch.undo()
    assert not torch.equal(eng.last_tok[:2], before[:2])
    assert torch.equal(eng.last_tok[2:], before[2:])


class _StandInGraph:
    """A CUDA graph's behaviour on the CPU: the capture runs the step once
    (its wrappers count there), a replay runs nothing in Python."""

    def capture(self, fn):
        fn()

    def replay(self):
        pass


def test_launch_counters_advance_per_replay():
    """Under a graph a wrapper counts its launch once, at the capture, and
    the launch runs at every replay: the captured step takes the capture's
    counts back out and adds them at each replay.  A stand-in graph runs
    the step's counting at the capture and nothing at a replay, as a CUDA
    graph would."""
    from repro_torch.kernels.flash_attention import flash_attention_h100
    from repro_torch.kernels.matmul import matmul_h100
    from repro_torch.kernels.ssd_scan import ssd_scan_h100
    from repro_torch.runtime.graph import CapturedStep

    def step():                         # what the wrappers count at capture
        matmul_h100.launches += 3
        matmul_h100.shapes[("mm", 4)] += 3
        flash_attention_h100.launches += 2
        flash_attention_h100.shapes[("paged", 4)] += 2

    kernels = (matmul_h100, flash_attention_h100, ssd_scan_h100)
    before = [(k.launches, dict(k.shapes)) for k in kernels]
    cs = CapturedStep(step, _StandInGraph())
    assert [(k.launches, dict(k.shapes)) for k in kernels] == before
    for _ in range(5):
        cs()
    assert cs.replays == 5
    assert matmul_h100.launches == before[0][0] + 15
    assert flash_attention_h100.launches == before[1][0] + 10
    assert ssd_scan_h100.launches == before[2][0]
    assert matmul_h100.shapes[("mm", 4)] == before[0][1].get(("mm", 4),
                                                             0) + 15
    for k in kernels:
        k.shapes.pop(("mm", 4), None)
        k.shapes.pop(("paged", 4), None)
    cs.release()


def test_a_held_workspace_refuses_to_grow():
    """While an engine's captured steps hold the split workspaces (once for
    all of them), a launch that would need more raises instead of moving
    the buffer under a graph; released, it grows again."""
    from repro_torch.kernels.workspace import WORKSPACES, Workspace
    from repro_torch.runtime.graph import StepGraphs

    ws = Workspace("test", torch.float32, 8)
    dev = torch.device("cpu")
    buf = ws.get(dev, 4)
    graphs = StepGraphs(_StandInGraph)
    for key in ("decode", 4, 2):
        graphs.capture(key, lambda: ws.get(dev, 8))
    assert ws.get(dev, 8) is buf
    with pytest.raises(RuntimeError, match="size it before the capture"):
        ws.get(dev, 9)
    graphs.release()
    assert ws.get(dev, 9).numel() == 9
    WORKSPACES.remove(ws)


def test_free_unheld_drops_only_what_no_graph_holds():
    """``free_unheld`` drops the buffers of the workspaces no captured step
    holds (they grow again on demand) and keeps a held one's."""
    from repro_torch.kernels.workspace import (WORKSPACES, Workspace,
                                               free_unheld, scratch)

    class Holder:
        pass

    dev = torch.device("cpu")
    with scratch():
        free, held = (Workspace(n, torch.float32, 8) for n in ("a", "b"))
        try:
            free.get(dev, 16)
            kept = held.get(dev, 4)
            holder = Holder()
            held.hold(holder)
            assert free_unheld() == 16 * 4
            assert free.size(dev) == 0 and held.get(dev, 8) is kept
            assert free.get(dev, 4).numel() == 8     # grows again
            held.release(holder)
        finally:
            for ws in (free, held):
                WORKSPACES.remove(ws)


# ---------------------------------------------------------------------------
# Prefill chunks on device inputs, one captured step a chunk length
# ---------------------------------------------------------------------------

ARCHS = ("llama3_8b", "mamba2_130m", "hymba_1p5b")


@pytest.fixture(scope="module", params=ARCHS)
def smoke_model(request):
    cfg = get_smoke_config(request.param).scaled(dtype="float32")
    return cfg, init_model(cfg, seed=5, device="cpu")


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("chunk", chunk_lengths(8, 48))
def test_device_prefill_equals_host_int_path(smoke_model, chunk):
    """A chunk at ``start`` > 0 for the sequence in slot 2 of 3: the step on
    device tensors gives the host-int path's logits and cache bit for bit,
    and both equal the same chunk run on a one-slot SSM state cut out of
    the cache at that slot (K3's device state row against slicing), the
    other slots' states untouched."""
    from repro_torch.models import (init_paged_cache, paged_prefill_chunk,
                                    paged_prefill_step)
    cfg, params = smoke_model
    rng = np.random.default_rng(chunk)
    start, slot = 5, 2
    toks = rng.integers(0, cfg.vocab, (1, start + chunk))
    table = np.array([[3, 1, 4, 0, 0, 0]], np.int32)
    base = init_paged_cache(cfg, 7, 4, 3, dtype=torch.float32, device="cpu")
    paged_prefill_chunk(params, cfg, toks[:, :start], base, 0, table, slot)
    if "ssm" in base:
        base["ssm"][:, [0, 1]] = torch.randn(base["ssm"][:, :2].shape)
    host, dev, one = _clone(base), _clone(base), _clone(base)
    want, _ = paged_prefill_chunk(params, cfg, toks[:, start:], host, start,
                                  table, slot)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    got, _ = paged_prefill_step(params, cfg, i32(toks[:, start:]), dev,
                                i32([start]), i32(table), i32([slot]))
    assert torch.equal(got, want)
    for k in base:
        assert torch.equal(dev[k], host[k]), k
    if "ssm" in one:
        one["ssm"] = one["ssm"][:, slot:slot + 1].clone()
        cut, _ = paged_prefill_chunk(params, cfg, toks[:, start:], one,
                                     start, table, 0)
        assert torch.equal(cut, want)
        assert torch.equal(one["ssm"][:, 0], dev["ssm"][:, slot])
        assert torch.equal(dev["ssm"][:, :slot], base["ssm"][:, :slot])
        assert not torch.equal(dev["ssm"][:, slot], base["ssm"][:, slot])


def _stage_prefill(eng, seq_blocks, toks, start, slot, final):
    """What ``_dispatch`` stages for a chunk, written straight into the
    engine's device buffers (the CPU's)."""
    eng._pbt.fill_(0)
    eng._pbt[0, :len(seq_blocks)] = torch.tensor(seq_blocks)
    eng._ptoks[0, :len(toks)] = torch.tensor(toks)
    eng._pstart.fill_(start)
    eng._pslot.fill_(slot)
    eng._pfinal.fill_(int(final))


@pytest.mark.parametrize("final", [False, True])
def test_prefill_body_makes_no_host_sync_or_upload(smoke_model, monkeypatch,
                                                   final):
    """The prefill body reads its tokens, start, slot, block table and
    final flag on the device, as ``test_decode_step_makes_no_host_sync_or_
    upload`` holds the decode step: while it runs every way of reading a
    tensor on the host or making one from host data raises.  Only the
    chunk that ends the prompt sets ``last_tok[slot]``."""
    cfg, params = smoke_model
    eng = ServeEngine(cfg, params, device="cpu", **ENGINE)
    _stage_prefill(eng, [1, 2], [3, 1, 4, 1], start=3, slot=1, final=final)
    eng.last_tok.fill_(-1)
    before = eng.last_tok.clone()
    _refuse_host_reads(monkeypatch)
    eng._prefill_body(4)
    monkeypatch.undo()
    assert torch.equal(eng.last_tok[1:2], eng._pseed) == final
    assert torch.equal(eng.last_tok[[0, 2]], before[[0, 2]])
    assert 0 <= int(eng._pseed) < cfg.vocab


def test_prefill_graphs_one_a_chunk_length_and_replays_count(
        weights, monkeypatch):
    """With stand-in graphs on the CPU the engine captures the decode step
    and one prefill step for each chunk length the scheduler can return;
    every prefill chunk is one replay of its length's step (none runs
    eagerly), every decode tick one replay of the decode step, and the
    launch counters (bumped here at each K1, K2 and K3 call, as the
    wrappers count a launch on the card) move by one replay's launches a
    replay: K1 a projection, K2 one a layer, per chunk and step.  A chunk
    length with no step raises."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_h100
    from repro_torch.kernels.matmul import matmul_h100
    from repro_torch.runtime.graph import StepGraphs
    _, _, tcfg, tp = weights

    def counting(name, kernel):
        real = getattr(ops, name)

        def call(*a, **k):
            kernel.launches += 1
            return real(*a, **k)
        monkeypatch.setattr(ops, name, call)

    counting("matmul", matmul_h100)
    counting("paged_attention", flash_attention_h100)
    eng = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    eng._capture(StepGraphs(_StandInGraph))
    assert sorted(eng.prefill_graphs) == sorted(
        chunk_lengths(ENGINE["prefill_chunk"], ENGINE["max_len"]))
    assert set(eng.capture_times) == {"decode", *eng.prefill_graphs}
    for k in (matmul_h100, flash_attention_h100):
        k.launches = 0
    for p in _prompts(tcfg.vocab):
        eng.submit(p, max_new=3)
    eng.run_until_drained()
    st = eng.sched.stats
    assert eng.eager_prefills == 0
    assert sum(g.replays for g in eng.prefill_graphs.values()) \
        == st.prefill_chunks > len(_prompts(tcfg.vocab))
    assert eng.graph.replays == st.decode_ticks
    steps = st.prefill_chunks + st.decode_ticks
    assert matmul_h100.launches == (tcfg.layers * 7 + 1) * steps
    assert flash_attention_h100.launches == tcfg.layers * steps
    del eng.prefill_graphs[2]
    eng.submit(np.arange(2), max_new=1)
    with pytest.raises(RuntimeError, match="no prefill graph for a chunk "
                                           "of 2 tokens"):
        eng.run_until_drained()
    eng.close()


def test_ssm_engine_async_depth_2_equals_jax_engine(ssm_weights):
    """At ``async_depth`` 2 the SSM and hybrid engines commit the JAX
    engine's tokens, every prefill chunk run through ``_prefill_body``."""
    cfg, jp, tcfg, tp = ssm_weights
    want, got, eng = _serve_both(cfg, jp, tcfg, tp, _prompts(cfg.vocab),
                                 max_new=6, async_depth=2, **ENGINE)
    assert got == want and all(len(o) == 6 for o in got)
    assert eng.eager_prefills == eng.sched.stats.prefill_chunks


# ---------------------------------------------------------------------------
# Prefix sharing (the sweep of tests/test_prefix_sharing.py, against the
# JAX engine with sharing on)
# ---------------------------------------------------------------------------

SHARE = dict(max_batch=4, max_len=64, page_size=4, prefill_chunk=8)


def _serve_shared(make, prompts, *, max_new=6, eos=None, staged=True):
    """Drive one engine over ``prompts``; ``staged`` drains the leader
    first, so followers admit against a populated prefix index.  Returns
    (outputs in submit order, engine); the pool's invariants hold at the
    end."""
    eng = make()
    outs = {}
    rids = [eng.submit(prompts[0], max_new=max_new, eos=eos)]
    if staged:
        for r in eng.run_until_drained():
            outs[r.rid] = r.out
    for p in prompts[1:]:
        rids.append(eng.submit(p, max_new=max_new, eos=eos))
    for r in eng.run_until_drained():
        outs[r.rid] = r.out
    eng.pool.check_invariants([s.blocks for s in eng.sched.running()])
    assert set(outs) == set(rids)
    return [outs[r] for r in rids], eng


def _both_shared(w, prompts, **kw):
    """The JAX engine's and the port's outputs with ``kw``, and the port's
    engine."""
    cfg, jp, tcfg, tp = w
    opts = {k: kw.pop(k) for k in ("max_new", "eos", "staged") if k in kw}
    want, _ = _serve_shared(lambda: JEngine(cfg, jp, **kw), prompts, **opts)
    got, eng = _serve_shared(
        lambda: ServeEngine(tcfg, tp, device="cpu", **kw), prompts, **opts)
    return want, got, eng


def _shared_prefix_prompts(vocab, rng, *, n=3, shared=22, tail=6):
    """A leader plus ``n`` followers sharing its first ``shared`` tokens;
    22 % page_size (4) != 0 diverges mid-block, so followers map a partial
    tail block and must copy it on write."""
    lead = rng.integers(0, vocab, shared + 2).astype(np.int32)
    return [lead] + [np.concatenate(
        [lead[:shared], rng.integers(0, vocab, tail)]).astype(np.int32)
        for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2])
def test_shared_prefix_parity_and_cow(weights, depth):
    """With sharing on the port commits the JAX engine's tokens (and the
    sharing-off engine's) with real prefix hits and CoW copies; the
    prefill tokens computed are the prompts' less the tokens saved."""
    prompts = _shared_prefix_prompts(weights[0].vocab,
                                     np.random.default_rng(0))
    want, got, eng = _both_shared(weights, prompts, prefix_sharing=True,
                                  async_depth=depth, **SHARE)
    off, _, _ = _both_shared(weights, prompts, **SHARE)
    assert got == want == off
    ps, st = eng.pool.stats, eng.sched.stats
    assert ps.prefix_hits > 0 and ps.cow_copies >= len(prompts) - 1
    assert st.prefill_tokens == sum(map(len, prompts)) \
        - ps.prefix_tokens_saved


def test_divergence_after_shared_prefix_leaves_sibling_intact(weights):
    """Two concurrent followers diverge mid-block, each copies its own
    partial tail block; a third, later follower still maps a pristine
    prefix."""
    rng = np.random.default_rng(2)
    prompts = _shared_prefix_prompts(weights[0].vocab, rng, n=2)
    late = np.concatenate([prompts[0][:22],
                           rng.integers(0, weights[0].vocab, 7)])
    want, got, eng = _both_shared(weights, prompts + [late.astype(np.int32)],
                                  prefix_sharing=True, **SHARE)
    assert got == want
    assert eng.pool.stats.cow_copies >= 3


def test_preempting_shared_block_holder_keeps_survivor_intact(weights):
    """A pool too tight for both preempts the younger sequence while it
    maps the survivor's prefix blocks; both still produce the JAX engine's
    (and a roomy pool's) tokens."""
    vocab = weights[0].vocab
    rng = np.random.default_rng(3)
    lead = rng.integers(0, vocab, 10).astype(np.int32)
    follow = np.concatenate([lead[:8], rng.integers(0, vocab, 2)]
                            ).astype(np.int32)
    kw = dict(max_batch=2, max_len=28, page_size=4, prefill_chunk=8,
              prefix_sharing=True, watermark_blocks=0, max_new=14,
              staged=False)
    want, got, eng = _both_shared(weights, [lead, follow], num_blocks=9,
                                  **kw)
    roomy, _, _ = _both_shared(weights, [lead, follow], num_blocks=100,
                               **kw)
    assert eng.sched.stats.preemptions > 0
    assert got == want == roomy
    assert eng.pool.num_live == eng.pool.num_reclaimable


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_shared_prefix_async_depth_with_eos_and_preemption(weights, depth):
    """Sharing on at ``async_depth`` 1-3: EOS at a commit truncates the
    speculative tokens past it, and under a tight pool a preempted
    sequence's in-flight tokens are dropped and regenerated — the JAX
    engine's tokens at the same depth."""
    cfg, _, tcfg, tp = weights
    probe = ServeEngine(tcfg, tp, device="cpu", max_batch=2, max_len=48)
    probe.submit(np.arange(6), max_new=1)
    first = probe.run_until_drained()[0].out[0]
    want, got, _ = _both_shared(weights, [np.arange(6), np.arange(6)],
                                eos=first, max_new=16, max_batch=2,
                                max_len=48, prefix_sharing=True,
                                async_depth=depth)
    assert want == got == [[first], [first]]
    rng = np.random.default_rng(4)
    lead = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    prompts = [lead, np.concatenate([lead[:4], rng.integers(0, cfg.vocab,
                                                            4)])]
    want, got, eng = _both_shared(
        weights, prompts, max_new=12, staged=False, max_batch=2, max_len=24,
        page_size=4, prefill_chunk=8, watermark_blocks=0, num_blocks=7,
        prefix_sharing=True, async_depth=depth)
    assert eng.sched.stats.preemptions > 0
    assert got == want and all(len(o) == 12 for o in got)


def test_ssm_blocks_serve_with_sharing_forced_off(ssm_weights):
    """An SSM state must see every prompt token: asked for sharing, the
    SSM and hybrid engines turn it off, as the JAX engine does, and commit
    its tokens."""
    prompts = _shared_prefix_prompts(ssm_weights[0].vocab,
                                     np.random.default_rng(1), n=2)
    want, got, eng = _both_shared(ssm_weights, prompts, prefix_sharing=True,
                                  async_depth=2, **SHARE)
    assert got == want
    assert not eng.prefix_sharing and eng.pool.stats.prefix_hits == 0


def test_launcher_takes_the_engine_options(monkeypatch, capsys, fresh_cache,
                                           tmp_path):
    """``--prefix-sharing``, ``--degrade`` and ``--plan-dir`` reach the
    engine, and so do ``--monitor`` and its knobs (each swap printed)."""
    from repro_torch.launch import plan_artifacts, serve
    assert plan_artifacts.main([
        "--config", "llama3_8b", "--smoke", "--max-len", "128",
        "--max-batch", "4", "--prefill-chunk", "32", "--out",
        str(tmp_path)]) == 0
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama3-8b", "--device", "cpu", "--requests", "3",
        "--max-new", "2", "--warm-kernels", "--prefix-sharing", "--degrade",
        "--plan-dir", str(tmp_path)])
    cold = fresh_cache.stats.cold_builds
    serve.main()
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "prefix sharing: hits=" in out
    assert "robustness shed=0" in out
    assert fresh_cache.stats.cold_builds == cold          # from the plan
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama3-8b", "--device", "cpu", "--requests", "2",
        "--max-new", "3", "--warm-kernels", "--monitor", "--monitor-every",
        "1", "--monitor-window", "2", "--swap-patience", "3",
        "--swap-threshold", "1.5"])
    seen = {}
    real = ServeEngine.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen["monitor"] = self.monitor
    monkeypatch.setattr(ServeEngine, "__init__", spy)
    serve.main()
    out = capsys.readouterr().out
    mon = seen["monitor"]
    assert (mon.probe_every, mon.window, mon.patience, mon.threshold) == (
        1, 2, 3, 1.5)
    assert mon.stats.probes > 0 and "monitor probes=" in out
    assert out.count("swap ") == mon.stats.swaps


# ---------------------------------------------------------------------------
# The four dense configs and the attn_moe block (llama4-scout, kimi-k2)
# ---------------------------------------------------------------------------

NEW_ARCHS = ["granite_3_8b", "yi_6b", "qwen1p5_4b", "chameleon_34b",
             "llama4_scout_17b_a16e", "kimi_k2_1t_a32b"]


def _new_weights(arch, seed=17):
    """The f32 smoke model in JAX and converted; qwen's q/k/v biases
    planted non-zero in the JAX tree first."""
    cfg = jconfigs.get_smoke_config(arch).scaled(dtype="float32")
    jparams, _ = j_init(jax.random.PRNGKey(seed), cfg)
    if cfg.qkv_bias:
        import jax.numpy as jnp
        rng = np.random.default_rng(seed)
        attn = jparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape),
                                     jnp.float32)
    tcfg = get_smoke_config(arch).scaled(dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_config_engine_tokens_equal_jax_engine(arch, fresh_cache):
    """Five requests through three slots, chunked prefill (a chunk of 8 is
    one routing group, where capacity binds for the MoE configs) and
    mid-prefill decode: the greedy tokens equal the JAX engine's, the
    warmed engine resolves nothing cold, and every dispatched (family,
    data) is in the traced warm set (ROADMAP F5)."""
    from repro_torch.plans.trace import trace_warm_set
    cfg, jp, tcfg, tp = _new_weights(arch)
    prompts = _prompts(cfg.vocab)
    jeng = JEngine(cfg, jp, **ENGINE)
    jr = [jeng.submit(p, max_new=6) for p in prompts]
    jdone = {r.rid: r.out for r in jeng.run_until_drained()}

    teng = ServeEngine(tcfg, tp, warm_kernels=True, device="cpu", **ENGINE)
    cold = fresh_cache.stats.cold_builds
    with fresh_cache.record() as rec:
        tr = [teng.submit(p, max_new=6) for p in prompts]
        tdone = {r.rid: r.out for r in teng.run_until_drained()}
    assert fresh_cache.stats.cold_builds == cold
    assert [tdone[r] for r in tr] == [jdone[r] for r in jr]
    assert all(len(tdone[r]) == 6 for r in tr)
    traced = {(op.family, op.data) for op in trace_warm_set(
        tcfg, max_len=ENGINE["max_len"], max_batch=ENGINE["max_batch"],
        prefill_chunk=ENGINE["prefill_chunk"])}
    seen = {(f, items) for f, _, items in rec.requests}
    assert seen <= traced, seen - traced


@pytest.mark.parametrize("how", ["async_depth_2", "prefix_sharing"])
def test_moe_engine_options_equal_jax_engine(how):
    """kimi-k2's smoke config (top-2 of 8 experts) at ``async_depth`` 2, and
    with prefix sharing over prompts that share a 22-token prefix: the
    tokens equal the JAX engine's with the same option (sharing changes
    which tokens share a chunk, and with it what capacity drops, so it is
    held against the JAX engine with sharing on, not against sharing
    off)."""
    w = _new_weights("kimi_k2_1t_a32b")
    if how == "async_depth_2":
        cfg, jp, tcfg, tp = w
        prompts = _prompts(cfg.vocab)
        want, got, eng = _serve_both(cfg, jp, tcfg, tp, prompts, max_new=6,
                                     async_depth=2, **ENGINE)
        assert not eng._inflight
    else:
        prompts = _shared_prefix_prompts(w[0].vocab,
                                         np.random.default_rng(0))
        want, got, eng = _both_shared(w, prompts, prefix_sharing=True,
                                      **SHARE)
        assert eng.pool.stats.prefix_hits > 0
    assert got == want and all(len(o) == 6 for o in got)


def test_moe_trace_keys_and_expert_workspaces():
    """The MoE layer's traced keys: the router at the step's rows, the
    experts at the per-expert capacity of one routing group (a prefill
    chunk of C tokens, or the decode step's max_batch rows), the JAX
    trace's keys.  In f32 the experts run K1's batched entry at the
    per-expert key and the engine sizes K1's split-K workspace for all E
    experts of a batched launch; in bf16 (the config's type) K1b at (E,
    M, N, K), which needs no workspace (``experts()`` 1)."""
    from repro_torch.models.moe import capacity
    from repro_torch.plans.trace import trace_warm_set
    for dtype in ("float32", "bfloat16"):
        cfg = get_smoke_config("kimi_k2_1t_a32b").scaled(dtype=dtype)
        m = cfg.moe
        E = {"E": m.num_experts} if dtype == "bfloat16" else {}
        ops = trace_warm_set(cfg, max_len=48, max_batch=3, prefill_chunk=8)
        by_site = {}
        for op in ops:
            for site in op.sites:
                by_site[site] = op
        for C in chunk_lengths(8, 48):
            cap = capacity(C, m.num_experts, m.top_k, m.capacity_factor)
            up = by_site[f"serve.prefill@{C}.moe.expert_up"].data_dict()
            assert up == {"M": cap, "N": m.d_ff_expert, "K": cfg.d_model,
                          **E}
            assert by_site[f"serve.prefill@{C}.moe.router"].data_dict() \
                == {"M": C, "N": m.num_experts, "K": cfg.d_model}
        down = by_site["serve.decode.moe.expert_down"]
        assert down.data_dict() == {"M": capacity(3, m.num_experts,
                                                  m.top_k,
                                                  m.capacity_factor),
                                    "N": cfg.d_model, "K": m.d_ff_expert,
                                    **E}
        assert down.family == ("matmul_experts_h100" if E
                               else "matmul_h100")
        assert down.experts(cfg) == (1 if E else m.num_experts)
        assert by_site["serve.decode.moe.router"].experts(cfg) == 1
