"""The port's optimizers, schedules and clipping against the JAX package's,
on the CPU.

The same trees, drawn with numpy from a seed, go through ``repro.optim``
and ``repro_torch.optim``: the JAX training layout, stacked [L, ...]
leaves included, so Adafactor factors a stacked norm scale [L, d] and takes
its update's RMS over all L layers in both.  Tolerances: schedules and the
norm ``rtol 1e-6`` (f32 scalars computed by the same formulas, ``pow`` and
``cos`` of two libraries); the updates ``rtol 1e-5`` on the parameters and
state after three steps on identical gradients (the same f32 element-wise
arithmetic, where either compiler may fuse a multiply and an add into one
rounding; the sum of squares of the RMS clip and the factored means over
up to 64 elements in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt

RTOL = 1e-5


def _tree(seed, L=3, d=16, f=24):
    """A stacked training-layout tree: a matrix stack [L, d, f], a norm
    scale stack [L, d], a vector [d] and a lone matrix [f, d]."""
    rng = np.random.default_rng(seed)
    return {"layers": {"mlp": {"wi": rng.standard_normal((L, d, f))},
                       "ln": {"scale": 1 + 0.1 * rng.standard_normal((L, d))}},
            "ln_f": {"scale": rng.standard_normal((d,))},
            "out": rng.standard_normal((f, d))}


def _as(tree, to):
    if isinstance(tree, dict):
        return {k: _as(v, to) for k, v in tree.items()}
    return to(np.asarray(tree, np.float32))


def _jax(tree):
    return _as(tree, jnp.asarray)


def _torch(tree):
    return _as(tree, lambda a: torch.from_numpy(a.copy()))


def _close(t_tree, j_tree, rtol=RTOL, atol=1e-7):
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(j_tree),
                            topt.tree_leaves(t_tree)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol, err_msg=str(path))


def test_tree_leaves_follow_jax_order():
    tree = _tree(0)
    got = [t.shape for t in topt.tree_leaves(_torch(tree))]
    assert got == [tuple(x.shape) for x in jax.tree.leaves(_jax(tree))]


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 40, 99, 100, 150])
def test_schedules_match_jax(step):
    for make in (lambda m: m.constant(3e-4),
                 lambda m: m.warmup_cosine(1e-3, 10, 100),
                 lambda m: m.warmup_cosine(2e-3, 0, 50, floor=0.0)):
        want = float(make(jopt)(jnp.asarray(step, jnp.int32)))
        got = make(topt)(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1e3, 1.0, 0.05])
def test_global_norm_and_clip_match_jax(max_norm):
    g = _tree(1)
    jg, tg = _jax(g), _torch(g)
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)
    jclipped, jnorm = jopt.clip_by_global_norm(jg, max_norm)
    leaves = topt.tree_leaves(tg)
    tclipped, tnorm = topt.clip_by_global_norm(tg, max_norm)
    assert topt.tree_leaves(tclipped)[0] is leaves[0]     # in place
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    _close(tclipped, jclipped, rtol=1e-6)


def _run(name, steps=3, **kw):
    """Three updates of both optimizers on identical gradients; returns
    ((torch params, state), (jax params, state))."""
    p = _tree(2)
    jp, tp = _jax(p), _torch(p)
    jo = jopt.make_optimizer(name, jopt.warmup_cosine(1e-2, 2, 10), **kw)
    to = topt.make_optimizer(name, topt.warmup_cosine(1e-2, 2, 10), **kw)
    js, ts = jo.init(jp), to.init(tp)
    assert [tuple(x.shape) for x in jax.tree.leaves(js)] == \
        [tuple(x.shape) for x in topt.tree_leaves(ts)]
    ids = [id(t) for t in topt.tree_leaves((tp, ts))]
    for step in range(steps):
        g = _tree(10 + step)
        jp, js = jo.update(_jax(g), js, jp, jnp.asarray(step, jnp.int32))
        tp2, ts2 = to.update(_torch(g), ts, tp, step)
        assert tp2 is tp and ts2 is ts
    # every parameter and state leaf was updated in place
    assert [id(t) for t in topt.tree_leaves((tp, ts))] == ids
    return (tp, ts), (jp, js)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_jax_on_identical_gradients(wd):
    (tp, ts), (jp, js) = _run("adamw", weight_decay=wd)
    _close(tp, jp)
    _close(ts["m"], js["m"])
    _close(ts["v"], js["v"])


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adafactor_matches_jax_on_stacked_trees(wd):
    (tp, ts), (jp, js) = _run("adafactor", weight_decay=wd)
    _close(tp, jp)
    _close(ts, js)
    # the stacked norm scale [L, d] is factored, as in the JAX tree
    scale = ts["f"]["layers"]["ln"]["scale"]
    assert set(scale) == {"vr", "vc"}
    assert tuple(scale["vr"].shape) == (3,) and tuple(scale["vc"].shape) == (16,)
    assert set(ts["f"]["ln_f"]["scale"]) == {"v"}


def test_adafactor_rms_clip_spans_the_whole_stacked_leaf():
    """Two layers of a stack, the second's gradient jumping a thousandfold
    at the second step: its update's RMS is above 1, and the clip over the
    whole leaf scales the first layer's update too (a per-layer clip would
    leave it at 1), in both packages alike."""
    p = {"w": np.zeros((2, 4, 4), np.float32)}
    small = np.full((2, 4, 4), 1e-3, np.float32)
    jump = small.copy()
    jump[1] = 1.0
    jo = jopt.adafactor(jopt.constant(1.0))
    to = topt.adafactor(topt.constant(1.0))
    jp, js = _jax(p), jo.init(_jax(p))
    tp = _torch(p)
    ts = to.init(tp)
    moved = []
    for step, g in enumerate(({"w": small}, {"w": jump})):
        before = tp["w"].clone()
        jp, js = jo.update(_jax(g), js, jp, jnp.asarray(step))
        to.update(_torch(g), ts, tp, step)
        _close(tp, jp)
        moved.append(float((before - tp["w"])[0].abs().max()))
    assert moved[0] == pytest.approx(1.0, rel=1e-3)
    assert moved[1] < 0.95


def test_make_optimizer_refuses_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("sgd", topt.constant(1.0))
