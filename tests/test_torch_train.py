"""The port's training path against the JAX package's, on the CPU.

f32 ``SMOKE`` configs; the JAX training tree (``repro.models.init_model``)
carried through numpy into ``repro_torch.convert.train_params_from_jax``
(the same stacked tree, f32 masters); batches from numpy.  The port runs
every projection through K1 and every attention core through K2, and their
gradients through K1, K4 and K2b (``kernels/autograd.py``), each in its
plain version on the CPU; the JAX step is ``jax.value_and_grad`` of einsum
math (ROADMAP F3).  Tolerances:

- the loss, ``rtol 1e-5``, and every gradient leaf, ``rtol 1e-4`` with
  ``atol 1e-5`` times the leaf's largest gradient: the same f32 math
  summed in another order (K1's k tiles, K2's online softmax, K2b's
  recomputed probabilities) over 2 + 2 layers; the measured worst is about
  2e-6 of the leaf's largest;
- the MoE configs (llama4-scout's top-1 and kimi-k2's top-2 smoke shapes)
  at the same tolerances, once the JAX run shows that every token's top
  k + 1 router probabilities lie more than 1e-5 apart: the routing, the
  capacity's drops and the gates' order are then a property of the
  inputs, not of the last bits of two libraries' sums;
- a whole train step (AdamW, microbatches 2): the metrics at ``rtol 1e-5``;
  the parameters at ``atol 1e-6``, except that an element may differ by up
  to 2·lr a step where its gradient is within the gradients' rounding of 0:
  AdamW's first steps move every element by about ±lr whatever its
  gradient's size, so such an element can take the other sign.  At most
  one element in a thousand may do so.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
import repro.models.transformer as jtransformer
import repro.optim as jopt
from repro.runtime import steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.models as tm
import repro_torch.optim as topt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import train_params_from_jax
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import specs as tspecs
from repro_torch.plans.trace import trace_train_warm_set
from repro_torch.runtime import (TrainController, build_eval_step,
                                 build_train_step, loss_fn)

DENSE = ["llama3_8b", "granite_3_8b", "yi_6b", "qwen1p5_4b", "chameleon_34b"]
WHISPER = "whisper_large_v3"
SSM = ["mamba2_130m", "hymba_1p5b"]
MOE = ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"]
B, S = 4, 16
#: The SSM and hybrid configs' sequence: longer than their chunk (16) and
#: hymba's window (32), so that the scan carries a state between chunks
#: and the window binds.
S_SSM = 40
LR = 1e-3


def _setup(arch, seed=0, **replace):
    """(JAX config, JAX params, port config, port training state) from one
    JAX init; qwen's q/k/v biases (zeros at init) are planted so that they
    move the forward."""
    cfg = jconfigs.get_smoke_config(arch).scaled(dtype="float32", **replace)
    tcfg = tconfigs.get_smoke_config(arch).scaled(dtype="float32", **replace)
    jp, _ = jm.init_model(jax.random.PRNGKey(seed), cfg)
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = jp["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(0.1 * rng.standard_normal(
                attn[name].shape), jnp.float32)
    tp = train_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    return cfg, jp, tcfg, tp


def _seq(cfg):
    return S_SSM if cfg.ssm is not None else S


def _batch(cfg, seed=1, rows=B):
    rng = np.random.default_rng(seed)
    seq = _seq(cfg)
    b = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)}
    if cfg.encoder is not None:
        b["enc_embeds"] = rng.standard_normal(
            (rows, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return b


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(tcfg, tp, batch):
    for p in topt.tree_leaves(tp):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = loss_fn(tp, tcfg, batch)
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in topt.tree_leaves(tp)]


def _router_gap(monkeypatch, cfg, jp, batch) -> float:
    """The least gap, over every MoE layer and token of the JAX forward,
    between neighbours among the token's k + 1 largest router
    probabilities (the JAX layer's own logits and softmax)."""
    gaps = []
    k = cfg.moe.top_k

    def spy(p, x, cfg_, **kw):
        logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(x.dtype),
                            preferred_element_type=jnp.float32)
        top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k + 1)[0]
        gaps.append(float(jnp.min(top[..., :-1] - top[..., 1:])))
        return jm.moe.moe_block(p, x, cfg_, **kw)

    monkeypatch.setattr(jtransformer, "moe_block", spy)
    jm.forward(jp, cfg, jnp.asarray(batch["tokens"]), unroll=True)
    monkeypatch.undo()
    assert len(gaps) == cfg.layers
    return min(gaps)


@pytest.mark.parametrize("arch,remat", [(a, "none") for a in DENSE + SSM]
                         + [("chameleon_34b", "full"), (WHISPER, "none")]
                         + [(a, "none") for a in MOE])
def test_loss_and_gradients_match_jax(arch, remat, monkeypatch):
    cfg, jp, tcfg, tp = _setup(arch, remat=remat)
    batch = _batch(cfg)
    if cfg.moe is not None:
        assert _router_gap(monkeypatch, cfg, jp, batch) > 1e-5
    (jl, _), jg = jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, cfg, _jbatch(batch)), has_aux=True)(jp)
    tl, tg = _grads(tcfg, tp, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(tg)
    for (path, j), t in zip(jleaves, tg):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                   atol=1e-5 * np.abs(j).max(),
                                   err_msg=str(path))


def test_remat_full_gives_the_same_gradients_as_none():
    """Chameleon's ``remat="full"`` recomputes each block in the backward
    through the same kernels: the gradients equal ``"none"``'s bit for
    bit."""
    cfg, _, tcfg, tp = _setup("chameleon_34b")
    batch = _batch(cfg)
    want = _grads(tcfg, tp, batch)
    got = _grads(dataclasses.replace(tcfg, remat="full"), tp, batch)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("arch", MOE)
def test_remat_full_routes_the_moe_the_same_bit_for_bit(arch):
    """The MoE configs' ``remat="full"`` (both full configs') runs each
    block's router, top-k and capacity again in the backward: the
    recomputed forward routes the same tokens, so the gradients equal
    ``"none"``'s bit for bit."""
    cfg, _, tcfg, tp = _setup(arch)
    batch = _batch(cfg)
    want = _grads(dataclasses.replace(tcfg, remat="none"), tp, batch)
    got = _grads(dataclasses.replace(tcfg, remat="full"), tp, batch)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_remat_full_gives_mambas_gradients_bit_for_bit():
    """mamba's ``remat="full"`` runs K3 again in the backward before K3b:
    the gradients equal ``"none"``'s bit for bit."""
    cfg, _, tcfg, tp = _setup("mamba2_130m")
    batch = _batch(cfg)
    want = _grads(tcfg, tp, batch)
    got = _grads(dataclasses.replace(tcfg, remat="full"), tp, batch)
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def _jax_steps(cfg, jp, batches, microbatches=2, optimizer="adamw", **kw):
    opt = jopt.make_optimizer(optimizer, jopt.constant(LR))
    step_fn = jax.jit(jsteps.build_train_step(
        cfg, opt, microbatches=microbatches, **kw))
    state = opt.init(jp)
    out = []
    for i, b in enumerate(batches):
        jp, state, m = step_fn(jp, state, _jbatch(b), jnp.asarray(i))
        out.append(({k: float(v) for k, v in m.items()}, jp))
    return out


def _port_steps(tcfg, tp, batches, microbatches=2, optimizer="adamw",
                **kw):
    opt = topt.make_optimizer(optimizer, topt.constant(LR))
    step_fn = build_train_step(tcfg, opt, microbatches=microbatches, **kw)
    state = opt.init(tp)
    out = []
    for i, b in enumerate(batches):
        tp, state, m = step_fn(tp, state, b, i)
        out.append(({k: float(v) for k, v in m.items()},
                    [p.detach().clone() for p in topt.tree_leaves(tp)]))
    return out


def _params_close(got, want, steps):
    """The whole-step tolerance of the module docstring."""
    flips = total = 0
    for t, j in zip(got, jax.tree.leaves(want)):
        d = np.abs(t.numpy() - np.asarray(j))
        assert d.max() <= 2 * LR * steps + 1e-6
        flips += int((d > 1e-6).sum())
        total += d.size
    assert flips <= total / 1000, (flips, total)


@pytest.mark.parametrize("arch", ["llama3_8b", "qwen1p5_4b", WHISPER] + SSM
                         + MOE)
@pytest.mark.parametrize("steps", [1, 2])
def test_train_step_matches_the_jitted_jax_step(arch, steps):
    cfg, jp, tcfg, tp = _setup(arch)
    batches = [_batch(cfg, seed=10 + i) for i in range(steps)]
    want = _jax_steps(cfg, jp, batches)
    got = _port_steps(tcfg, tp, batches)
    for (gm, gp), (wm, wp) in zip(got, want):
        for key in ("loss", "nll", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(gm[key], wm[key], rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    _params_close(got[-1][1], want[-1][1], steps)


def test_train_step_with_bf16_accumulators_matches_jax():
    """``grad_dtype`` bf16 (the 1T MoE's accumulators, here on a dense
    config): each microbatch's gradients rounded to bf16 and summed in
    bf16, as the JAX step sums them.  The metrics at rtol 1e-5 but the
    grad norm, which reads the bf16-rounded gradients, at 1e-2 (a gradient
    within the two packages' f32 difference of a bf16 rounding boundary
    rounds to a neighbour: 2^-8 of it); the parameters as for the f32
    step."""
    cfg, jp, tcfg, tp = _setup("llama3_8b")
    batches = [_batch(cfg, seed=20)]
    want = _jax_steps(cfg, jp, batches, grad_dtype=jnp.bfloat16)
    got = _port_steps(tcfg, tp, batches, grad_dtype=torch.bfloat16)
    (gm, gp), (wm, wp) = got[0], want[0]
    for key in ("loss", "nll", "moe_aux"):
        np.testing.assert_allclose(gm[key], wm[key], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=1e-2)
    _params_close(gp, wp, 1)


def test_moe_train_step_with_adafactor_and_bf16_accumulators_matches_jax():
    """kimi-k2's own optimizer (Adafactor) and accumulators (bf16) on its
    smoke MoE config, the optimizer passed to both packages by the full
    config's name: the tolerances of
    :func:`test_train_step_with_bf16_accumulators_matches_jax`."""
    optimizer = jconfigs.get_config("kimi_k2_1t_a32b").optimizer
    assert optimizer == "adafactor" == tconfigs.get_config(
        "kimi_k2_1t_a32b").optimizer
    cfg, jp, tcfg, tp = _setup("kimi_k2_1t_a32b")
    batches = [_batch(cfg, seed=20)]
    want = _jax_steps(cfg, jp, batches, optimizer=optimizer,
                      grad_dtype=jnp.bfloat16)
    got = _port_steps(tcfg, tp, batches, optimizer=optimizer,
                      grad_dtype=torch.bfloat16)
    (gm, gp), (wm, wp) = got[0], want[0]
    for key in ("loss", "nll", "moe_aux"):
        np.testing.assert_allclose(gm[key], wm[key], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=1e-2)
    _params_close(gp, wp, 1)


def test_train_step_updates_in_place():
    cfg, _, tcfg, tp = _setup("llama3_8b")
    opt = topt.adamw(topt.constant(LR))
    state = opt.init(tp)
    leaves = topt.tree_leaves((tp, state))
    before = [t.detach().clone() for t in leaves]
    tp2, state2, _ = build_train_step(tcfg, opt, microbatches=2)(
        tp, state, _batch(cfg), 0)
    assert tp2 is tp and state2 is state
    after = topt.tree_leaves((tp, state))
    assert all(a is b for a, b in zip(after, leaves))
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    assert all(p.grad is None for p in topt.tree_leaves(tp))


@pytest.mark.parametrize("cuda, conf, asked", [
    (True, None, ["expandable_segments:True"]),
    (True, "max_split_size_mb:512", ["expandable_segments:True"]),
    (True, "expandable_segments:False", []),
    (False, None, [])])
def test_train_step_lets_cuda_segments_grow_in_place(cuda, conf, asked,
                                                     monkeypatch):
    """Building a train step turns on the allocator's expandable segments
    where there is CUDA, unless PYTORCH_CUDA_ALLOC_CONF already sets them."""
    got = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda.memory, "_set_allocator_settings",
                        got.append)
    if conf is None:
        monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    else:
        monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    tcfg = tconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    build_train_step(tcfg, topt.adamw(topt.constant(LR)))
    assert got == asked


@pytest.mark.parametrize("arch", ["llama3_8b", WHISPER])
def test_eval_step_matches_jax(arch):
    cfg, jp, tcfg, tp = _setup(arch)
    batch = _batch(cfg, seed=3)
    want = jsteps.build_eval_step(cfg)(jp, _jbatch(batch))
    got = build_eval_step(tcfg)(tp, batch)
    for key in ("loss", "nll", "moe_aux", "z"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert not got["loss"].requires_grad


@pytest.mark.parametrize("arch", MOE)
def test_train_refuses_the_moe_a2a_schedule(arch):
    """The schedule itself needs a mesh: ``moe_block_a2a`` refuses a call
    without one.  Without a mesh a config with ``perf_flags=("moe_a2a",)``
    trains through the dense layer (its storage unpadded at E < 256), the
    step, the warm set and the loss bit for bit those of the config
    without the flag; ``tests/test_torch_distributed.py`` holds the
    schedule over a mesh against JAX's."""
    from repro_torch.models.moe_a2a import moe_block_a2a
    base = tconfigs.get_smoke_config(arch).scaled(dtype="float32")
    tcfg = base.scaled(perf_flags=("moe_a2a",))
    params = tm.init_train_state(tcfg, device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    with pytest.raises(ValueError, match="needs a current mesh"):
        moe_block_a2a(lp, torch.zeros(1, 4, tcfg.d_model), tcfg)
    assert [op.label for op in trace_train_warm_set(
        tcfg, global_batch=2, seq=8)] == [
        op.label for op in trace_train_warm_set(base, global_batch=2, seq=8)]
    batch = _batch(tcfg, rows=2)
    outs = []
    for cfg in (base, tcfg):
        p = tm.init_train_state(cfg, device="cpu")
        opt = topt.adamw(topt.constant(LR))
        st = opt.init(p)
        p, st, m = build_train_step(cfg, opt)(p, st, batch, 0)
        outs.append((float(m["loss"]), topt.tree_leaves(p)))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_remat_dots_is_refused():
    tcfg = tconfigs.get_smoke_config("llama3_8b").scaled(remat="dots")
    with pytest.raises(NotImplementedError, match="remat 'dots'"):
        build_train_step(tcfg, topt.adamw(topt.constant(LR)))


def _data_step(tcfg, ds, step_fn):
    def run_step(state, step):
        params, opt_state = state
        params, opt_state, m = step_fn(params, opt_state, ds.batch_at(step),
                                       step)
        return (params, opt_state), {k: float(v) for k, v in m.items()}
    return run_step


def test_loss_falls_over_30_steps_on_synthetic_lm():
    tcfg = tconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    ds = SyntheticLM(DataConfig(tcfg.vocab, 32, 8, seed=0))
    opt = topt.adamw(topt.warmup_cosine(3e-3, 5, 30))
    run = _data_step(tcfg, ds, build_train_step(tcfg, opt, microbatches=2))
    params = tm.init_train_state(tcfg, seed=0, device="cpu")
    state = (params, opt.init(params))
    losses = []
    for step in range(30):
        state, m = run(state, step)
        losses.append(m["loss"])
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.5, losses


class _FaultOnce:
    def __init__(self, at):
        self.at, self.fired = at, False

    def __call__(self, step):
        if step == self.at and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected fault at step {step}")


def _controller_run(tmp_path, ckpt_every, fault_hook=None, steps=6):
    tcfg = tconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    ds = SyntheticLM(DataConfig(tcfg.vocab, 16, 4, seed=2))
    opt = topt.adamw(topt.warmup_cosine(1e-3, 2, steps))
    run = _data_step(tcfg, ds, build_train_step(tcfg, opt, microbatches=2))
    params = tm.init_train_state(tcfg, seed=1, device="cpu")
    ctl = TrainController(run, CheckpointManager(str(tmp_path)),
                          ckpt_every=ckpt_every, fault_hook=fault_hook)
    (params, state), hist = ctl.run((params, opt.init(params)),
                                    start_step=0, num_steps=steps)
    return topt.tree_leaves((params, state)), hist


@pytest.mark.parametrize("ckpt_every,fault_at", [(2, 3), (10, 2)])
def test_restart_is_bit_exact_through_the_controller(tmp_path, ckpt_every,
                                                     fault_at):
    """A fault after a checkpoint replays from it; one before the first
    checkpoint replays from the host copy of the initial state (the step
    updates the state in place, so the state object itself is no longer
    the initial one).  Either way the final state and every step's loss
    equal the uninterrupted run's bit for bit."""
    want, want_hist = _controller_run(tmp_path / "ref", ckpt_every)
    got, hist = _controller_run(tmp_path / "fault", ckpt_every,
                                _FaultOnce(fault_at))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    by_step = {h["step"]: h["loss"] for h in hist}
    assert by_step == {h["step"]: h["loss"] for h in want_hist}
    assert len(hist) == len(want_hist) + (fault_at - (
        fault_at // ckpt_every) * ckpt_every)


def test_controller_drops_its_initial_copy_before_the_final_save(
        tmp_path, monkeypatch):
    """The controller's host copy of the initial state (for a restart
    before the first checkpoint) is freed before the final save makes its
    own: a full-width state (llama4-scout at one layer, 50 GB of
    parameters and AdamW moments) has room for one host copy, not two."""
    import gc
    import weakref
    from repro_torch.checkpoint import manager

    class Snapshot(dict):
        pass

    copies = []
    real = manager.host_copy

    def host_copy(tree):
        out = Snapshot(real(tree))
        copies.append(weakref.ref(out))
        return out

    monkeypatch.setattr(manager, "host_copy", host_copy)
    ckpt = CheckpointManager(str(tmp_path))
    seen = []
    save = ckpt.save

    def checked_save(step, tree):
        gc.collect()
        seen.append([r() is None for r in copies])
        save(step, tree)

    ckpt.save = checked_save

    def run_step(state, step):
        return {"w": state["w"] + 1}, {"loss": 0.0}

    state, hist = TrainController(run_step, ckpt).run(
        {"w": torch.zeros(2)}, start_step=0, num_steps=2)
    assert len(copies) == 1 and seen == [[True]]
    assert torch.equal(state["w"], torch.full((2,), 2.0)) and len(hist) == 2


def test_controller_reraises_a_cuda_error(tmp_path):
    """A CUDA runtime error is fatal: the controller re-raises it at once,
    with no restore and no retry."""
    calls = []

    def run_step(state, step):
        calls.append(step)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    ckpt = CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA error"):
        TrainController(run_step, ckpt).run(
            {"w": torch.zeros(2)}, start_step=0, num_steps=3)
    assert calls == [0]


def test_train_launcher_cli_at_smoke_size(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "llama3-8b", "--smoke", "--steps", "4", "--seq-len",
            "16", "--global-batch", "4", "--microbatches", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "2", "--device", "cpu"]
    train.main(args)
    out = capsys.readouterr().out
    assert "done: 4 steps on cpu" in out
    assert CheckpointManager(str(tmp_path)).available_steps() == [2, 4]
    train.main(args[:4] + ["6"] + args[5:])
    assert "resumed from step 4" in capsys.readouterr().out


def test_train_launcher_trains_a_moe_smoke_config(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", "kimi-k2-1t-a32b", "--smoke", "--steps", "2",
                "--seq-len", "16", "--global-batch", "4", "--microbatches",
                "2", "--ckpt-dir", str(tmp_path), "--log-every", "1",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 2 steps on cpu" in out
    assert "nan" not in out


def test_abstract_state_allocates_nothing_and_matches_jax_shapes():
    from repro.launch import specs as jspecs
    cfg = jconfigs.get_config("llama3_8b")
    tcfg = tconfigs.get_config("llama3_8b")
    jsds, _, jopt_sds = jspecs.abstract_state(cfg, jopt.adamw(
        jopt.constant(LR)))
    params, opt_state = tspecs.abstract_state(tcfg, topt.adamw(
        topt.constant(LR)))
    leaves = topt.tree_leaves((params, opt_state))
    assert all(t.device.type == "meta" for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [
        tuple(x.shape) for x in jax.tree.leaves((jsds, jopt_sds))]
    # the analytic count leaves out the norm scales
    assert sum(t.numel() for t in topt.tree_leaves(params)) == \
        tcfg.param_count() + (2 * tcfg.layers + 1) * tcfg.d_model
    assert tspecs.grad_dtype_for(tcfg) == torch.float32
    assert tspecs.grad_dtype_for(tconfigs.get_config(
        "kimi_k2_1t_a32b")) == torch.bfloat16
