"""The port's data pipeline and checkpoint manager against the JAX
package's, on the CPU.

``batch_at`` is a numpy copy and must give JAX's tokens bit for bit; the
checkpoint manager keeps the JAX on-disk format (``step_*`` dirs,
``MANIFEST.h<k>.json``, CRC32, ``LATEST``, leaf names joined by ``::`` in
``jax.tree_util``'s order), so each package restores the other's
checkpoints; every comparison here is exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
import repro.optim as jopt
from repro.checkpoint import CheckpointManager as JManager
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
import repro_torch.configs as tconfigs
import repro_torch.optim as topt
from repro_torch.checkpoint import CheckpointManager, host_copy, restore_like
from repro_torch.convert import train_params_from_jax
from repro_torch.data import (DataConfig, PrefetchIterator, SyntheticLM,
                              make_pipeline)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 4, 0),
                                                  (50, 17, 3, 7)])
def test_batch_at_is_bit_equal_to_jax(vocab, seq, batch, seed):
    t = SyntheticLM(DataConfig(vocab, seq, batch, seed=seed))
    j = JSyntheticLM(JDataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 1, 5, 123):
        got, want = t.batch_at(step), j.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(
        t.batch_at(3, host_slice=slice(1, 3))["tokens"],
        j.batch_at(3, host_slice=slice(1, 3))["tokens"])


def test_prefetch_yields_batch_at_in_order():
    ds = SyntheticLM(DataConfig(128, 16, 4, seed=3))
    it = PrefetchIterator(ds, step0=5, prefetch=2)
    try:
        for want_step in range(5, 9):
            step, b = next(it)
            assert step == want_step
            np.testing.assert_array_equal(b["tokens"],
                                          ds.batch_at(step)["tokens"])
    finally:
        it.close()
    assert not it.t.is_alive()


def test_make_pipeline_slices_rows_by_host():
    it = make_pipeline(128, 16, 4, seed=1, host_index=1, host_count=2)
    try:
        step, b = next(it)
    finally:
        it.close()
    full = SyntheticLM(DataConfig(128, 16, 4, seed=1)).batch_at(step)
    np.testing.assert_array_equal(b["tokens"], full["tokens"][2:4])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"layers": {"w": torch.randn((2, 3, 4), generator=g)},
              "ln_f": {"scale": torch.randn((4,), generator=g)}}
    opt = {"m": {"layers": {"w": torch.randn((2, 3, 4), generator=g)},
                 "ln_f": {"scale": torch.zeros(4)}},
           "count": torch.arange(3, dtype=torch.int32)}
    return params, opt


def _equal(a, b):
    ta, tb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip_names_and_format(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    state = _state()
    ckpt.save(7, state)
    assert (tmp_path / "LATEST").read_text() == "step_000000007"
    names = set(__import__("json").loads(
        (tmp_path / "step_000000007" / "MANIFEST.h0.json").read_text()
    )["leaves"])
    assert names == {"0::layers::w", "0::ln_f::scale", "1::count",
                     "1::m::layers::w", "1::m::ln_f::scale"}
    step, got = ckpt.restore_latest(_state(seed=1))
    assert step == 7 and isinstance(got, tuple)
    _equal(got, state)


def test_checkpoint_restores_onto_the_templates_type():
    """``restore_like`` gives new leaves in each template leaf's type and
    on its device."""
    snap = host_copy({"a": torch.ones(2, dtype=torch.float32)})
    got = restore_like(snap, {"a": torch.zeros(2, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64 and torch.equal(
        got["a"], torch.ones(2, dtype=torch.float64))


def test_checkpoint_async_and_gc(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ckpt.save_async(step, _state(step))
    ckpt.wait()
    assert ckpt.available_steps() == [2, 3]
    step, got = ckpt.restore_latest(_state())
    assert step == 3
    _equal(got, _state(3))


def test_async_snapshot_does_not_alias_a_later_in_place_step(tmp_path):
    """``save_async`` copies every leaf before it returns: an in-place
    update of the (CPU) state right after it, while the writer may still
    run, does not reach the checkpoint."""
    ckpt = CheckpointManager(str(tmp_path))
    state = _state()
    want = host_copy(state)
    ckpt.save_async(1, state)
    for t in topt.tree_leaves(state):
        t.add_(1)
    ckpt.wait()
    _, got = ckpt.restore_latest(_state(5))
    _equal(got, want)


def test_checkpoint_falls_back_past_a_corrupt_step(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    ckpt.save(1, _state(1))
    ckpt.save(2, _state(2))
    leaf = tmp_path / "step_000000002" / "0::layers::w.h0.npy"
    arr = np.load(leaf)
    arr[0, 0, 0] += 1.0
    np.save(leaf, arr)
    step, got = ckpt.restore_latest(_state())
    assert step == 1
    _equal(got, _state(1))


def test_checkpoint_shape_mismatch_is_refused(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(4, _state())
    params, opt = _state()
    params["layers"]["w"] = torch.zeros((3, 3, 4))
    with pytest.raises(ValueError, match="checkpoint shape"):
        ckpt._load_step(4, (params, opt))
    assert ckpt.restore_latest((params, opt)) == (None, None)


def test_checkpoint_refuses_a_bf16_leaf(tmp_path):
    with pytest.raises(TypeError, match="bf16"):
        CheckpointManager(str(tmp_path)).save(
            1, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def _llama_state():
    cfg = jconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    tcfg = tconfigs.get_smoke_config("llama3_8b").scaled(dtype="float32")
    jp, _ = jm.init_model(jax.random.PRNGKey(4), cfg)
    jo = jopt.adamw(jopt.constant(1e-3))
    tparams = train_params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    to = topt.adamw(topt.constant(1e-3))
    topt_state = to.init(tparams)
    for t in topt.tree_leaves(topt_state):       # something to carry
        t.normal_()
    return (jp, jo.init(jp)), (tparams, topt_state)


def test_port_checkpoint_restores_in_the_jax_manager(tmp_path):
    (jp, jstate), tstate = _llama_state()
    CheckpointManager(str(tmp_path)).save(3, tstate)
    step, (rp, ro) = JManager(str(tmp_path)).restore_latest((jp, jstate))
    assert step == 3
    for (path, j), t in zip(
            jax.tree_util.tree_leaves_with_path((rp, ro)),
            topt.tree_leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                      err_msg=str(path))


def test_jax_checkpoint_restores_in_the_port_manager(tmp_path):
    (jp, jstate), tstate = _llama_state()
    JManager(str(tmp_path)).save(5, (jp, jstate))
    step, got = CheckpointManager(str(tmp_path)).restore_latest(tstate)
    assert step == 5
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(
            (jp, jstate)), topt.tree_leaves(got)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=str(path))
