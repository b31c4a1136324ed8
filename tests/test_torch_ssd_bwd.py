"""K3b ``ssd_scan_bwd_h100`` — the SSD scan's backward — on the CPU.

Inputs from numpy with a seed.  The plain version (the chunk formulas of
``kernels/ssd_scan_bwd.py``) is held against ``torch.autograd`` through the
port's own forwards (``ref.ssd_scan``, the step recurrence from a zero
state; K3's plain version where a state0 or a final state's gradient is
given) and against ``jax.vjp`` of ``repro.kernels.ref.ssd_scan``.
Tolerances, each a share of the gradient's largest element:

- f32, 1e-5 (``rtol`` and ``atol``): the same f32 function, summed chunk by
  chunk against step by step; the measured worst is about 2e-7;
- bf16 inputs, 1e-2: both sides sum in f32 from the same bf16 inputs and
  round each gradient once to bf16 (2^-8 of an element), so they differ
  by at most one bf16 step; da, f32 on both sides, at 1e-5 still.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan_bwd as sb
from repro_torch.kernels.autograd import SsdScanFn
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.kernels.ssd_scan_bwd import (ssd_scan_bwd_h100,
                                              ssd_scan_bwd_plain)

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _inputs(rows, seq, heads, hd, state, seed, *, shared, dtype,
            with_state=False, with_dsf=False):
    """x, a in (0.05, 0.95), b, c ([rows, seq, state] when shared), state0
    and dS_final or None, dy, from one numpy generator."""
    rng = np.random.default_rng(seed)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)

    x = t(rows, seq, heads, hd)
    a = torch.sigmoid(t(rows, seq, heads, dt=torch.float32)) * 0.9 + 0.05
    bc = (rows, seq, state) if shared else (rows, seq, heads, state)
    b, c = t(*bc), t(*bc)
    s0 = t(rows, heads, state, hd, dt=torch.float32) if with_state else None
    dsf = t(rows, heads, state, hd, dt=torch.float32) if with_dsf else None
    return x, a, b, c, s0, t(rows, seq, heads, hd), dsf


def _close(got, want, tol, what):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=tol,
                               atol=tol * float(want.abs().max()),
                               msg=what)


def _autograd(x, a, b, c, s0, dy, dsf, chunk):
    """Gradients of <dy, y> + <dS_final, S_final> by autograd: through
    ``ref.ssd_scan`` row by row (b and c expanded over the heads) from a
    zero state, else through K3's plain version."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, a, b, c) + ((s0,) if s0 is not None else ())]
    X, A, B, C = leaves[:4]
    R, S, H, _ = x.shape
    if s0 is None and dsf is None:
        def heads(t):
            return t if t.dim() == 4 else t[:, :, None, :].expand(
                R, S, H, t.shape[-1])
        Bh, Ch = heads(B), heads(C)
        y = torch.stack([ref.ssd_scan(X[r], A[r], Bh[r], Ch[r])
                         for r in range(R)])
        loss = (y.float() * dy.float()).sum()
    else:
        y, sf = ssd_scan_plain(X, A, B, C, leaves[4] if s0 is not None
                               else None, chunk=chunk, bd=32)
        loss = (y.float() * dy.float()).sum()
        if dsf is not None:
            loss = loss + (sf * dsf).sum()
    grads = torch.autograd.grad(loss, leaves)
    return list(grads) + ([None] if s0 is None else [])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,chunk,shared,with_state,with_dsf", [
    (1, 16, True, False, False),             # seq 1
    (16, 16, True, False, False),            # seq = chunk
    (40, 16, True, False, False),            # the last chunk cut
    (40, 16, False, False, False),           # b, c per head
    (40, 16, True, True, True),              # state0 and dS_final given
    (1, 16, False, True, True),              # one step from a state
    (33, 8, True, False, True),              # dS_final alone
    (200, 128, True, True, True),            # a chunk of 128, cut at 200
    (130, 64, False, False, True),           # chunks of 64, the last of 2
])
def test_ssd_bwd_plain_matches_autograd(dtype, seq, chunk, shared,
                                        with_state, with_dsf):
    x, a, b, c, s0, dy, dsf = _inputs(2, seq, 3, 8, 5, seq + 7,
                                      shared=shared, dtype=dtype,
                                      with_state=with_state,
                                      with_dsf=with_dsf)
    got = ssd_scan_bwd_plain(x, a, b, c, s0, dy, dsf, chunk=chunk)
    want = _autograd(x, a, b, c, s0, dy, dsf, chunk)
    names = ("dx", "da", "db", "dc", "dstate0")
    for name, g, w, t in zip(names, got, want, (x, a, b, c, s0)):
        if name == "dstate0" and w is None:
            assert g is None                 # no state0, no d(state0)
            continue
        assert g.shape == t.shape and g.dtype == t.dtype, name
        _close(g, w, TOL[torch.float32 if name == "da" else dtype], name)


@pytest.mark.parametrize("seq,chunk", [(1, 16), (16, 16), (40, 16),
                                       (37, 8), (150, 64), (300, 128)])
def test_ssd_bwd_matches_jax_vjp_of_the_oracle(seq, chunk):
    """The unbatched op form (b, c per head, zero state) against
    ``jax.vjp`` of the JAX package's sequential oracle."""
    x, a, b, c, _, dy, _ = _inputs(1, seq, 3, 8, 5, seq + 30, shared=False,
                                   dtype=torch.float32)
    x, a, b, c, dy = (t[0] for t in (x, a, b, c, dy))
    _, vjp = jax.vjp(jref.ssd_scan, *(jnp.asarray(t.numpy())
                                      for t in (x, a, b, c)))
    want = vjp(jnp.asarray(dy.numpy()))
    got = ssd_scan_bwd_plain(x[None], a[None], b[None], c[None], None,
                             dy[None], None, chunk=chunk)
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        _close(g[0], torch.from_numpy(np.array(w)), 1e-5, name)


def test_ops_ssd_scan_bwd_sums_a_shared_b_over_the_heads():
    """``ops.ssd_scan_bwd`` keyed on K3's key: a b and c shared across
    heads get the per-head form's gradients summed over the heads."""
    x, a, b, c, s0, dy, dsf = _inputs(1, 24, 4, 8, 6, 3, shared=False,
                                      dtype=torch.float32, with_state=True,
                                      with_dsf=True)
    b1, c1 = b[:, :, 0], c[:, :, 0]
    shared = ops.ssd_scan_bwd(x, a, b1, c1, s0, dy, dsf)
    per_head = ops.ssd_scan_bwd(x, a, b1[:, :, None].expand_as(b),
                                c1[:, :, None].expand_as(c), s0, dy, dsf)
    for i in (0, 1, 4):
        _close(shared[i], per_head[i], 1e-6, str(i))
    assert ops.ssd_scan_bwd(x, a, b1, c1, None, dy, dsf)[4] is None
    for i in (2, 3):
        assert shared[i].shape == b1.shape
        _close(shared[i], per_head[i].sum(2), 1e-6, str(i))


def test_ssd_scan_fn_backward_is_k3b_through_ops():
    """``SsdScanFn`` on CPU tensors: the forward is ``ops.ssd_scan``; the
    backward gives the bits of ``ops.ssd_scan_bwd`` on the saved inputs,
    with no final state's gradient when the state is not used, and d(state0)
    only for a state that needs it."""
    x, a, b, c, s0, dy, _ = _inputs(2, 40, 3, 8, 5, 11, shared=True,
                                    dtype=torch.float32, with_state=True)
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c, s0)]
    y, sf = SsdScanFn.apply(*leaves)
    want_y, want_s = ops.ssd_scan(x, a, b, c, s0)
    assert torch.equal(y, want_y) and torch.equal(sf, want_s)
    y.backward(dy)
    want = ops.ssd_scan_bwd(x, a, b, c, s0, dy, None)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    # a state that needs no gradient gets none; dS_final flows when used
    leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
    y, sf = SsdScanFn.apply(*leaves, s0)
    (y.sum() + sf.sum()).backward()
    want = ops.ssd_scan_bwd(x, a, b, c, s0, torch.ones_like(y),
                            torch.ones_like(sf))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("which", ["out_state", "mask", "state_rows"])
def test_ssd_scan_fn_refuses_the_serve_updates(which):
    x, a, b, c, s0, _, _ = _inputs(2, 8, 3, 8, 5, 12, shared=True,
                                   dtype=torch.float32, with_state=True)
    extra = {"out_state": (s0, None, None),
             "mask": (None, torch.ones(2, dtype=torch.bool), None),
             "state_rows": (None, None, torch.arange(2, dtype=torch.int32))}
    with pytest.raises(ValueError, match="no backward"):
        SsdScanFn.apply(x.requires_grad_(), a, b, c, s0, *extra[which])


def test_ssd_bwd_wrapper_counts_nothing_on_the_cpu():
    """CPU tensors run the plain version: the launch counter stays."""
    x, a, b, c, _, dy, _ = _inputs(1, 20, 2, 8, 4, 13, shared=True,
                                   dtype=torch.float32)
    n0 = ssd_scan_bwd_h100.launches
    got = ssd_scan_bwd_h100(x, a, b, c, None, dy, None, chunk=16)
    want = ssd_scan_bwd_plain(x, a, b, c, None, dy, None, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got[:4], want[:4]))
    assert got[4] is None and want[4] is None
    assert ssd_scan_bwd_h100.launches == n0


def test_ssd_bwd_counters_and_format_checks():
    """The family's shared-memory counter is the f32 chunk kernel's formula;
    ``format_error`` refuses what the C entry point refuses; the training
    keys of mamba2-130m and hymba-1.5b have feasible picks within both
    kernels' shared memory."""
    from repro_torch.core.params import H100_SXM
    fam = sb.FAMILY
    plan = fam.initial_plan()
    num, den = fam.counter_value(plan, "smem_bytes")
    for chunk, hd, state in ((16, 64, 128), (64, 64, 16), (32, 128, 128)):
        pt = {"chunk": chunk, "HD": hd, "STATE": state}
        assert num.eval(pt) / den.eval(pt) == sb.chunk_smem_bytes(
            chunk, hd, state)
    assert sb.chunk_smem_bytes(64, 64, 128) <= sb.MAX_SMEM
    assert sb.format_error(4, 1024, 24, 64, 128, 64, 24,
                           torch.bfloat16) is None
    f32, bf16 = torch.float32, torch.bfloat16
    bad = [((4, 1024, 24, 64, 128, 128, 24), f32, "ck not in"),
           ((4, 1024, 24, 64, 128, 256, 24), bf16, "ck not in"),
           ((4, 1024, 24, 256, 16, 64, 24), bf16, "hd over"),
           ((4, 2 ** 20, 24, 64, 16, 8, 24), bf16, "65,535 chunks"),
           ((4, 1024, 24, 64, 16, 64, 2), bf16, "heads summed"),
           ((4, 1024, 24, 128, 128, 64, 24), f32, "shared memory")]
    for args, dtype, why in bad:
        assert why in sb.format_error(*args, dtype)
    for key in ({"SQ": 1024, "HD": 64, "STATE": 128},
                {"SQ": 2048, "HD": 64, "STATE": 16}):
        pick = ops.select("ssd_scan_bwd_h100", key, H100_SXM).assignment
        assert sb.format_error(4, key["SQ"], 24, 64, key["STATE"],
                               pick["chunk"], 24, torch.bfloat16) is None
    assert sb.workspace_need(2, 40, 3, 8, 5, 16) == \
        2 * 2 * 3 * 3 * 5 * 8 + 2 * 2 * 40 * 3 * 5


def test_ssd_bwd_domains_of_the_two_bodies():
    """The bf16 body takes chunks up to 128 and a state up to 256, the f32
    FMA body chunks up to 64: ``format_error`` refuses a leaf the f32 body
    cannot take, and the family's tree, whose leaves must suit both bodies,
    holds the chunks of 16, 32 and 64 at the training keys."""
    from repro_torch.core.params import H100_SXM
    from repro_torch.core.select import rank_candidates
    assert sb.CHUNKS == (16, 32, 64)
    assert (sb.MAX_CHUNK, sb.MAX_CHUNK_TC) == (64, 128)
    f32, bf16 = torch.float32, torch.bfloat16
    for rows, seq, heads, state in ((4, 1024, 24, 128), (2, 2048, 25, 16),
                                    (2, 1000, 24, 128)):
        for ck in sb.CHUNKS + (128,):
            assert sb.format_error(rows, seq, heads, 64, state, ck, heads,
                                   bf16) is None
            why = sb.format_error(rows, seq, heads, 64, state, ck, heads,
                                  f32)
            assert (why is None) == (ck in sb.CHUNKS)
        assert "ck not in 1..min(seq, 64) (the f32 body)" == \
            sb.format_error(rows, seq, heads, 64, state, 128, heads, f32)
        leaves = rank_candidates(sb.FAMILY, H100_SXM, {
            "SQ": seq, "HD": 64, "STATE": state})
        assert sorted(c.assignment["chunk"] for c in leaves) == \
            list(sb.CHUNKS)
    # the wrapper cuts a chunk at seq: 128 over 40 steps is one chunk of
    # 40, which the f32 body takes
    assert sb.format_error(1, 40, 2, 64, 16, 40, 2, f32) is None
    assert "state over 256" in sb.format_error(1, 64, 2, 64, 272, 16, 2,
                                               bf16)
    assert "items a warp" in sb.format_error(1, 1024, 2, 64, 256, 128, 2,
                                             bf16)
    assert sb.format_error(1, 1024, 2, 64, 256, 64, 2, bf16) is None
    assert "shared memory" in sb.format_error(1, 1024, 2, 128, 128, 128, 2,
                                              bf16)


@pytest.mark.parametrize("key,want", [
    # mamba2-130m's training key, chunk 64: c16 = 64, np = 128, hp = 64
    ((64, 64, 128), {
        "chunk": 4 * (2 * 64 * 65 + 2 * 64 * 129 + 2 * 128 * 65
                      + 3 * 64 * 65 + 6 * 64 + 8),
        "states": 4 * (128 * 32 + 64 * 32 + 64 * 129 + 64),
        "tc": 2 * (2 * 64 * 72 + 2 * 64 * 136 + 128 * 72 + 2 * 64 * 72)
              + 4 * (6 * 64 + 2 * 4 * 64 + 2 * 8 * 64 + 8),
        "walk": 2 * (2 * 64 * 40 + 2 * 64 * 136) + 4 * (3 * 64 + 2)}),
    # hymba-1.5b's, chunk 32: c16 = 32, np = 16, hp = 64
    ((32, 64, 16), {
        "chunk": 4 * (2 * 32 * 65 + 2 * 32 * 17 + 2 * 16 * 65
                      + 3 * 32 * 33 + 6 * 32 + 8),
        "states": 4 * (16 * 32 + 32 * 32 + 32 * 17 + 32),
        "tc": 2 * (2 * 32 * 72 + 2 * 32 * 24 + 16 * 72 + 2 * 32 * 40)
              + 4 * (6 * 32 + 2 * 2 * 32 + 2 * 1 * 32 + 8),
        "walk": 2 * (2 * 32 * 40 + 2 * 32 * 24) + 4 * (3 * 32 + 2)}),
    # a chunk of 128 in bf16 at mamba2-130m's widths, and one of 1 step
    ((128, 64, 128), {
        "tc": 2 * (2 * 128 * 72 + 2 * 128 * 136 + 128 * 72
                   + 2 * 128 * 136)
              + 4 * (6 * 128 + 2 * 8 * 128 + 2 * 8 * 128 + 8),
        "walk": 2 * (2 * 128 * 40 + 2 * 128 * 136) + 4 * (3 * 128 + 2)}),
    ((1, 64, 128), {
        "tc": 2 * (2 * 16 * 72 + 2 * 16 * 136 + 128 * 72 + 2 * 16 * 24)
              + 4 * (6 * 16 + 2 * 1 * 16 + 2 * 8 * 16 + 8),
        "walk": 2 * (2 * 16 * 40 + 2 * 16 * 136) + 4 * (3 * 16 + 2)}),
])
def test_ssd_bwd_smem_counters_against_hand_sums(key, want):
    """Each kernel's shared bytes against a hand sum; the family's counters
    are the f32 kernels' formulas and, for the bf16 kernels, the same sums
    with every size rounded up by 15 instead of to 16 (a bound above)."""
    chunk, hd, state = key
    got = {"chunk": sb.chunk_smem_bytes(chunk, hd, state),
           "states": sb.states_smem_bytes(chunk, state),
           "tc": sb.tc_chunk_smem_bytes(chunk, hd, state),
           "walk": sb.walk_smem_bytes(chunk, state)}
    for name, value in want.items():
        assert got[name] == value, name
    fam, plan = sb.FAMILY, sb.FAMILY.initial_plan()
    pt = {"chunk": chunk, "HD": hd, "STATE": state}
    for counter, exact in (("smem_bytes", got["chunk"]),
                           ("states_smem_bytes", got["states"])):
        num, den = fam.counter_value(plan, counter)
        assert num.eval(pt) / den.eval(pt) == exact
    for counter, fn in (("tc_smem_bytes", sb.tc_chunk_smem_bytes),
                        ("walk_smem_bytes", sb.walk_smem_bytes)):
        num, den = fam.counter_value(plan, counter)
        bound = num.eval(pt) / den.eval(pt)
        exact = got["tc" if counter == "tc_smem_bytes" else "walk"]
        assert bound >= exact
        if chunk % 16 == hd % 16 == state % 16 == 1:
            assert bound == exact


#: The card's fastest chunk at each training key, of the leaves timed in
#: ``chip_smoke.py`` phase 13 (f) (H100 SXM, 700 W): the napkin's fit.
K3B_PICKS = {(1024, 64, 128): 64, (2048, 64, 16): 64}
#: The napkin's picks at keys held out of its fit (13 (f)'s
#: ``K3B_HELD_OUT``), each within 1.10x of the card's fastest leaf there.
K3B_HELD_OUT_PICKS = {(2048, 64, 128): 64, (1024, 64, 16): 64,
                      (1000, 64, 128): 64}


@pytest.mark.parametrize("sq,hd,state", sorted(K3B_PICKS))
def test_ssd_bwd_napkin_picks_the_cards_fastest_leaf(sq, hd, state):
    from repro_torch.core.params import H100_SXM
    pick = ops.select("ssd_scan_bwd_h100", {"SQ": sq, "HD": hd,
                                            "STATE": state}, H100_SXM)
    assert pick.assignment["chunk"] == K3B_PICKS[(sq, hd, state)]


@pytest.mark.parametrize("sq,hd,state", sorted(K3B_HELD_OUT_PICKS))
def test_ssd_bwd_napkin_picks_at_held_out_keys(sq, hd, state):
    from repro_torch.core.params import H100_SXM
    pick = ops.select("ssd_scan_bwd_h100", {"SQ": sq, "HD": hd,
                                            "STATE": state}, H100_SXM)
    assert pick.assignment["chunk"] == K3B_HELD_OUT_PICKS[(sq, hd, state)]


def test_ssd_bwd_tunes_on_the_cpu(tmp_path, capsys):
    """``tune_artifacts`` over K3b's family (``--device cpu``: the plain
    version timed, a smoke): its table compiles and every candidate
    measures."""
    from repro_torch.artifacts.store import ArtifactStore
    from repro_torch.launch import tune_artifacts
    assert tune_artifacts.main([
        "--family", "ssd_scan_bwd_h100", "--out", str(tmp_path), "--quick",
        "--device", "cpu", "--iters", "1", "--top-k", "2",
        "--max-dim", "64"]) == 0
    assert "[OK] ssd_scan_bwd_h100/h100_sxm: 2/2 candidates measured" in \
        capsys.readouterr().out
    table = ArtifactStore(tmp_path).load_dispatch("ssd_scan_bwd_h100",
                                                  "h100_sxm")
    assert table["measured_ranks"]


@pytest.mark.parametrize("arch,families", [
    ("mamba2_130m", {"matmul_h100", "transpose_h100", "ssd_scan_h100",
                     "ssd_scan_bwd_h100"}),
    ("hymba_1p5b", {"matmul_h100", "transpose_h100", "ssd_scan_h100",
                    "ssd_scan_bwd_h100", "flash_attention_h100",
                    "flash_attention_bwd_h100"})])
def test_train_warm_set_of_the_ssm_configs(arch, families):
    """A train step's warm set: K3b at exactly K3's keys, K2b at exactly
    K2's, and no K2b key where there is no attention."""
    from repro_torch.configs import get_config
    from repro_torch.plans.trace import trace_train_warm_set
    ops_ = trace_train_warm_set(get_config(arch), global_batch=8,
                                seq=1024, microbatches=2)
    assert {op.family for op in ops_} == families
    keys = {f: {op.data for op in ops_ if op.family == f} for f in families}
    assert keys["ssd_scan_bwd_h100"] == keys["ssd_scan_h100"] == {
        (("HD", 64), ("SQ", 1024), ("STATE", get_config(arch).ssm.state))}
    if "flash_attention_h100" in families:
        assert keys["flash_attention_bwd_h100"] == \
            keys["flash_attention_h100"]


def test_with_backward_raises_for_an_unknown_family():
    from repro_torch.plans.trace import _with_backward
    with pytest.raises(ValueError, match="no backward of family"):
        list(_with_backward(iter([("site", "matadd_h100",
                                   {"M": 4, "N": 4})])))


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1p5b"])
def test_ssm_train_warm_set_leaves_no_cold_build(arch):
    """After ``warm_train_dispatch`` an f32 train step of the smoke config
    (microbatches 2, 40 tokens: past the chunk of 16 and hymba's window of
    32) resolves nothing cold, and the (family, key) pairs it asks for are
    exactly the traced ones (F5): K1, K4, K3 and K3b, and K2 and K2b for
    hymba's attention half."""
    from repro_torch.artifacts.dispatch import DispatchCache, set_default_cache
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_train_state
    from repro_torch.optim import adamw, constant
    from repro_torch.plans.trace import trace_train_warm_set
    from repro_torch.runtime import build_train_step, warm_train_dispatch
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    cache = DispatchCache()
    set_default_cache(cache)
    try:
        warm_train_dispatch(cfg, global_batch=4, seq=40, microbatches=2)
        cold = cache.stats.cold_builds
        params = init_train_state(cfg, device="cpu")
        opt = adamw(constant(1e-3))
        step = build_train_step(cfg, opt, microbatches=2)
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 40)),
                 "labels": rng.integers(0, cfg.vocab, (4, 40))}
        with cache.record() as rec:
            step(params, opt.init(params), batch, 0)
        assert cache.stats.cold_builds == cold
        traced = {(op.family, op.data) for op in trace_train_warm_set(
            cfg, global_batch=4, seq=40, microbatches=2)}
        assert {(f, items) for f, _, items in rec.requests} == traced
    finally:
        set_default_cache(None)
