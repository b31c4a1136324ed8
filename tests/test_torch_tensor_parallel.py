"""The port's sharded train step against JAX's, on the CPU: tensor
parallelism over ``model``, FSDP over the batch axes, ZeRO-1, and the
dense MoE layer's expert parallelism.

* **The steps.** Two f32 steps in two microbatches on 4 gloo ranks, the
  metrics and every parameter against JAX's step jitted with
  ``state_shardings``' shardings (``in_shardings`` and ``out_shardings``,
  as the JAX launcher jits it) on the same mesh shape, 8 forced host
  devices with ``Auto`` axes, and against the port's single-process
  step, at ``tests/test_torch_train.py``'s tolerances: llama3-smoke on
  (2, 2) and (1, 4) (on (1, 4) a rank holds half a KV head), qwen-smoke
  (biases) on (1, 4), chameleon-smoke renamed ``chameleon-34b`` (FSDP)
  over 272 tokens with its 256 patch embeddings on (4, 1) and (2, 2),
  llama4-smoke renamed ``llama4-scout-17b-a16e`` with ``moe_a2a`` on (2,
  2) (FSDP, tensor-parallel attention, the all-to-all), kimi-smoke
  renamed ``kimi-k2-1t-a32b`` with ``moe_a2a`` and Adafactor on (4, 1)
  (its factored moments under ZeRO-1); mamba2-smoke and hymba-smoke on
  (2, 2), a hymba variant whose attention and SSD heads both cut on (1,
  4) (1.5 query heads, half a KV head and 1.5 SSD heads a rank, ``wa``
  whole), whisper-smoke on (2, 2) and a whisper variant of 6 heads of 16
  on (1, 4) (its encoder, decoder and cross-attention heads cut); the
  two MoE configs without ``moe_a2a`` (the dense layer, experts over
  ``data``): llama4 on (2, 2) over one routing group a microbatch, and
  over 8 rows of 512 tokens, two groups a microbatch, which shard over
  ``data`` (capacity factor 2: tokens drop), and kimi with Adafactor on
  (4, 1).  ``FSDP_ARCHS`` keys on the name, hence the renames on both
  sides; the accumulators are f32 on both.
* **What each rank holds.** Every leaf of every rank has the shape
  ``NamedSharding.shard_shape`` gives for JAX's spec (the ``moe_a2a``
  experts: the all-to-all's layout), and ``Layout.rank_bytes()`` is the
  sum of the rank's leaves.
* **The collectives.** ``gather`` (losses that add) and the Megatron pair
  ``copy_to`` / ``reduce_from`` (one loss) at 2 ranks against autograd of
  the same function on one process; attention over 4 ranks whose query
  and KV heads are cut and straddle KV groups, and the SSD block over 4
  ranks whose heads are cut (its b and c gathered, ``wa`` whole), against
  the single process.
* **The dense MoE layer.** Which experts keep each token (capacity drops
  at factor 0.5), the output and the aux loss at 2 and 4 ranks, over
  groups each rank routes and groups every rank routes whole, against
  JAX's ``moe_block`` on the whole batch.
* **A restart** through the controller on (2, 2) bit for bit, with FSDP
  leaves and ZeRO-1 optimizer state (kimi-smoke's Adafactor moments).
* **The warm set.** No cold build after ``warm_train_dispatch(mesh=)``
  on (2, 2) and (1, 4), and the keys asked for are the traced ones, for
  llama3 and for the SSD, hybrid, whisper and dense MoE cases.
* **The meshes.** Every config takes every single-pod mesh; ``moe_a2a``
  over two pods raises, naming ROADMAP item 4c.

Ranks are spawned once a world size (2 and 4) for the module
(``tests/torch_dist_workers.py``); JAX runs once, in one subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

import repro.configs as jconfigs
import repro.launch.specs as jspecs
import repro.models as jm
import repro.optim as jopt
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import init_train_state
from repro_torch.optim import constant, make_optimizer
from repro_torch.plans.trace import trace_train_warm_set
from repro_torch.runtime import build_train_step

import torch_dist_workers as W

ROOT = os.path.join(os.path.dirname(__file__), "..")
LR = 1e-3
B, MICRO, STEPS = 8, 2, 2
DROPLESS_CF = 64.0
AXES = ("data", "model")

#: name -> (the config's changes, the mesh); all on 4 ranks
CASES = {
    "llama3_2x2": (dict(arch="llama3_8b"), (2, 2)),
    "llama3_1x4": (dict(arch="llama3_8b"), (1, 4)),
    "qwen_1x4": (dict(arch="qwen1p5_4b"), (1, 4)),
    "chameleon_4x1": (dict(arch="chameleon_34b", name="chameleon-34b",
                           seq=272), (4, 1)),
    "chameleon_2x2": (dict(arch="chameleon_34b", name="chameleon-34b",
                           seq=272), (2, 2)),
    "llama4_2x2": (dict(arch="llama4_scout_17b_a16e",
                        name="llama4-scout-17b-a16e", flags=("moe_a2a",)),
                   (2, 2)),
    "kimi_4x1": (dict(arch="kimi_k2_1t_a32b", name="kimi-k2-1t-a32b",
                      flags=("moe_a2a",), optimizer="adafactor"), (4, 1)),
    "mamba2_2x2": (dict(arch="mamba2_130m"), (2, 2)),
    "hymba_2x2": (dict(arch="hymba_1p5b"), (2, 2)),
    # attention: 6 query heads over 2 KV heads of 8; SSD: 6 heads of 8
    "hymba_cut_1x4": (dict(arch="hymba_1p5b", dims=dict(
        heads=6, kv_heads=2, head_dim=8), ssm=(8, 6, 8, 16)), (1, 4)),
    "whisper_2x2": (dict(arch="whisper_large_v3"), (2, 2)),
    "whisper_cut_1x4": (dict(arch="whisper_large_v3", dims=dict(
        d_model=96, heads=6, kv_heads=6, head_dim=16)), (1, 4)),
    "llama4_dense_2x2": (dict(arch="llama4_scout_17b_a16e",
                              name="llama4-scout-17b-a16e"), (2, 2)),
    "llama4_groups_2x2": (dict(arch="llama4_scout_17b_a16e",
                               name="llama4-scout-17b-a16e", seq=512,
                               cf=2.0), (2, 2)),
    "kimi_dense_4x1": (dict(arch="kimi_k2_1t_a32b", name="kimi-k2-1t-a32b",
                            optimizer="adafactor"), (4, 1)),
}
#: the SSD, hybrid and whisper configs on a data-only mesh too
DATA_ONLY = {"mamba2_130m": 40, "hymba_1p5b": 40, "whisper_large_v3": 16}
#: the cases whose warm set is checked besides llama3's
WARM_CASES = ("mamba2_2x2", "hymba_cut_1x4", "whisper_cut_1x4",
              "llama4_dense_2x2", "llama4_groups_2x2", "kimi_dense_4x1")


def _job(change):
    """A case's changes with the capacity factor made explicit."""
    return dict({"cf": DROPLESS_CF}, **change)


def _jax_cfg(arch, flags=(), name=None, optimizer=None, dims=None, ssm=None,
             cf=DROPLESS_CF, **_):
    from repro.models.config import SSMConfig
    base = jconfigs.get_smoke_config(arch)
    cfg = base.scaled(dtype="float32", param_dtype="float32",
                      perf_flags=tuple(flags),
                      optimizer=optimizer or base.optimizer, **(dims or {}))
    if ssm:
        cfg = cfg.scaled(ssm=SSMConfig(*ssm))
    if cfg.moe is not None:
        m = cfg.moe
        cfg = cfg.scaled(moe=type(m)(m.num_experts, m.top_k, m.d_ff_expert,
                                     cf))
    return cfg.scaled(name=name) if name else cfg


def _named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {W.SEP.join(str(k.key) for k in path): leaf for path, leaf in flat}


def _inputs(change, seed=1):
    """The JAX init's parameters and every step's batch (``b{s}:key``)."""
    cfg = _jax_cfg(**change)
    p, _ = jm.init_model(jax.random.PRNGKey(0), cfg)
    out = {f"p:{k}": np.asarray(v, np.float32) for k, v in _named(p).items()}
    rng = np.random.default_rng(seed)
    S = change.get("seq", 16)
    for s in range(STEPS):
        for k in ("tokens", "labels"):
            out[f"b{s}:{k}"] = rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32)
        if cfg.frontend == "stub":
            out[f"b{s}:patch_embeds"] = rng.standard_normal(
                (B, 256, cfg.d_model)).astype(np.float32)
        if cfg.encoder is not None:
            out[f"b{s}:enc_embeds"] = rng.standard_normal(
                (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return out


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    # LLVM's backend optimisation off: the steps are tiny, their compile
    # is the subprocess's time
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from repro.distributed import sharding as dist
    from repro.launch import specs
    from repro.models.config import MoEConfig, SSMConfig
    from repro import configs, optim
    from repro.runtime import steps

    SEP = "::"

    def unflatten(flat):
        out = {}
        for name, v in flat.items():
            node = out
            keys = name.split(SEP)
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = v
        return out

    def flatten(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flatten(v, prefix + (k,)))
            else:
                out[SEP.join(prefix + (k,))] = np.asarray(v)
        return out

    for job in json.load(open(sys.argv[1])):
        inp = dict(np.load(job["inputs"]))
        shape = tuple(job["mesh"])
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        mesh = Mesh(devs, ("data", "model"),
                    axis_types=(AxisType.Auto, AxisType.Auto))
        base = configs.get_smoke_config(job["arch"])
        cfg = base.scaled(dtype="float32", param_dtype="float32",
                          perf_flags=tuple(job.get("flags", ())),
                          optimizer=job.get("optimizer", base.optimizer),
                          **job.get("dims", {}))
        if job.get("ssm"):
            cfg = cfg.scaled(ssm=SSMConfig(*job["ssm"]))
        if cfg.moe is not None:
            m = cfg.moe
            cfg = cfg.scaled(moe=MoEConfig(m.num_experts, m.top_k,
                                           m.d_ff_expert, job["cf"]))
        if job.get("name"):
            cfg = cfg.scaled(name=job["name"])
        opt = optim.make_optimizer(cfg.optimizer, optim.constant(job["lr"]))
        params = unflatten({k[2:]: jnp.asarray(v)
                            for k, v in inp.items() if k[:2] == "p:"})
        metrics = []
        with mesh, dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
            _, axes, _ = specs.abstract_state(cfg, opt)
            state = opt.init(params)
            p_sh, o_sh, _ = specs.state_shardings(cfg, mesh, params, axes,
                                                  state)
            params = jax.device_put(params, p_sh)
            state = jax.device_put(state, o_sh)
            fn = jax.jit(steps.build_train_step(
                cfg, opt, microbatches=job["microbatches"],
                grad_dtype=jnp.float32),
                in_shardings=(p_sh, o_sh, None, None),
                out_shardings=(p_sh, o_sh, None))
            for s in range(job["steps"]):
                batch = {k: jnp.asarray(inp[f"b{s}:{k}"])
                         for k in ("tokens", "labels", "patch_embeds",
                                   "enc_embeds") if f"b{s}:{k}" in inp}
                params, state, mt = fn(params, state, batch,
                                       jnp.asarray(s, jnp.int32))
                metrics.append([float(mt[k]) for k in
                                ("loss", "nll", "moe_aux", "grad_norm")])
        out = {f"p:{k}": v for k, v in flatten(params).items()}
        out["metrics"] = np.array(metrics, np.float64)
        np.savez(job["out"], **out)
    print("JAX_REF_OK")
""")


def _comm_inputs():
    rng = np.random.default_rng(5)
    out = {"x": rng.standard_normal((2, 3, 4)), "w": rng.standard_normal(
        (2, 3, 8)), "a": rng.standard_normal((5, 6)),
        "w1": rng.standard_normal((6, 8)), "w2": rng.standard_normal((8, 7)),
        "v": rng.standard_normal((5, 7))}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _attn_inputs():
    cfg = W.attn_config()
    rng = np.random.default_rng(6)
    d, nq, nk = cfg.d_model, cfg.heads * cfg.hd, cfg.kv_heads * cfg.hd
    out = {"x": rng.standard_normal((2, 12, d)),
           "wq": rng.standard_normal((d, nq)) / np.sqrt(d),
           "wk": rng.standard_normal((d, nk)) / np.sqrt(d),
           "wv": rng.standard_normal((d, nk)) / np.sqrt(d),
           "wo": rng.standard_normal((nq, d)) / np.sqrt(nq),
           "w": rng.standard_normal((2, 12, d))}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _ssm_inputs():
    cfg = W.ssm_config()
    s = cfg.ssm
    rng = np.random.default_rng(7)
    d, di = cfg.d_model, s.heads * s.head_dim
    out = {"x": rng.standard_normal((2, 20, d)),
           "wx": rng.standard_normal((d, di)) / np.sqrt(d),
           "wb": rng.standard_normal((d, s.state)) / np.sqrt(d),
           "wc": rng.standard_normal((d, s.state)) / np.sqrt(d),
           "wa": 0.1 * rng.standard_normal((d, s.heads)) / np.sqrt(d),
           "a_bias": np.full((s.heads,), 2.0),
           "wo": rng.standard_normal((di, d)) / np.sqrt(di),
           "w": rng.standard_normal((2, 20, d))}
    return {k: v.astype(np.float32) for k, v in out.items()}


#: (world size, routing) -> the dense MoE layer's block-level case: rows
#: over the batch axes; "local": each rank's rows are whole groups,
#: "whole": groups straddle the ranks (every rank routes them all); the
#: "pods" cases on (pod, data, model) = (2, 2, 1), the experts over
#: ``data`` within each pod; capacity factor 0.5, so tokens drop
MOE_CASES = {
    (2, "local"): dict(mesh=(2, 1), B=4, S=16, group_size=32),
    (2, "whole"): dict(mesh=(2, 1), B=4, S=16, group_size=24),
    (4, "local"): dict(mesh=(4, 1), B=8, S=8, group_size=16),
    (4, "whole"): dict(mesh=(2, 2), B=4, S=16, group_size=48),
    (4, "pods_local"): dict(mesh=(2, 2, 1), axes=("pod",) + AXES, B=4,
                            S=16, group_size=16),
    (4, "pods_whole"): dict(mesh=(2, 2, 1), axes=("pod",) + AXES, B=4,
                            S=16, group_size=24),
}
for _case in MOE_CASES.values():
    _case.update(d=32, f=32, E=4, k=2, cf=0.5)
    _case.setdefault("axes", AXES)


def _moe_inputs(case):
    rng = np.random.default_rng(8)
    d, f, E = case["d"], case["f"], case["E"]
    out = {"x": rng.standard_normal((case["B"], case["S"], d)),
           "router": rng.standard_normal((d, E)) / np.sqrt(d),
           "wi": rng.standard_normal((E, d, f)) / np.sqrt(d),
           "wg": rng.standard_normal((E, d, f)) / np.sqrt(d),
           "wo": rng.standard_normal((E, f, d)) / np.sqrt(f),
           "r": rng.standard_normal((d,))}
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write every input; run the JAX subprocess and the 2- and 4-rank
    spawns; return the output directory."""
    d = str(tmp_path_factory.mktemp("tp"))
    jax_jobs, rank_jobs = [], {2: [], 4: []}
    for name, (change, mesh) in CASES.items():
        inputs = os.path.join(d, f"in_{name}.npz")
        np.savez(inputs, **_inputs(change))
        common = dict(kind="train", **_job(change), lr=LR, steps=STEPS,
                      microbatches=MICRO, inputs=inputs, mesh=mesh)
        jax_jobs.append(dict(common, out=os.path.join(d, f"jax_{name}.npz")))
        rank_jobs[4].append(dict(common, axes=AXES, out=os.path.join(
            d, f"port_{name}.npz")))
        # the single-process step, on one rank of the 2-rank world
        rank_jobs[2].append(dict(common, kind="single",
                                 rank=len(jax_jobs) % 2,
                                 out=os.path.join(d, f"single_{name}.npz")))
    for arch, seq in DATA_ONLY.items():
        inputs = os.path.join(d, f"in_{arch}.npz")
        np.savez(inputs, **_inputs(dict(arch=arch, seq=seq)))
        rank_jobs[2].append(dict(kind="train", arch=arch, lr=LR,
                                 steps=STEPS, microbatches=MICRO,
                                 inputs=inputs, mesh=(2, 1), axes=AXES,
                                 out=os.path.join(d, f"port_{arch}.npz")))
    np.savez(os.path.join(d, "comm.npz"), **_comm_inputs())
    rank_jobs[2].append(dict(kind="comm", inputs=os.path.join(d, "comm.npz"),
                             out=os.path.join(d, "comm_out.npz")))
    np.savez(os.path.join(d, "attn.npz"), **_attn_inputs())
    rank_jobs[4].append(dict(kind="attn", inputs=os.path.join(d, "attn.npz"),
                             mesh=(1, 4), axes=AXES,
                             out=os.path.join(d, "attn_out.npz")))
    rank_jobs[4].append(dict(kind="restart", arch="kimi_k2_1t_a32b",
                             name="kimi-k2-1t-a32b", flags=("moe_a2a",),
                             optimizer="adafactor", cf=DROPLESS_CF, lr=LR,
                             steps=6, fault_at=3, mesh=(2, 2), axes=AXES,
                             dir=d, out=os.path.join(d, "restart.npz")))
    for mesh in ((2, 2), (1, 4)):
        rank_jobs[4].append(dict(kind="warm", arch="llama3_8b", batch=8,
                                 seq=64, mesh=mesh, axes=AXES,
                                 out=os.path.join(d, f"warm_{mesh[0]}x"
                                                  f"{mesh[1]}.npz")))
    for name in WARM_CASES:
        change, mesh = CASES[name]
        rank_jobs[4].append(dict(dict(kind="warm", batch=B, seq=16),
                                 **_job(change), mesh=mesh, axes=AXES,
                                 out=os.path.join(d, f"warm_{name}.npz")))
    np.savez(os.path.join(d, "ssm.npz"), **_ssm_inputs())
    rank_jobs[4].append(dict(kind="ssm", inputs=os.path.join(d, "ssm.npz"),
                             mesh=(1, 4), axes=AXES,
                             out=os.path.join(d, "ssm_out.npz")))
    for (ws, routing), case in MOE_CASES.items():
        inputs = os.path.join(d, f"moe_{ws}_{routing}.npz")
        np.savez(inputs, **_moe_inputs(case))
        rank_jobs[ws].append(dict(kind="moe", case=case, inputs=inputs,
                                  mesh=case["mesh"], axes=case["axes"],
                                  out=os.path.join(
                                      d, f"moe_{ws}_{routing}_out.npz")))
    spec = os.path.join(d, "jax_jobs.json")
    with open(spec, "w") as f:
        json.dump(jax_jobs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, spec],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        for ws, jobs in rank_jobs.items():
            W.spawn(ws, d, jobs, timeout=240)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert "JAX_REF_OK" in out, out + err
    return d


def _load(d, name):
    with np.load(os.path.join(d, name)) as f:
        return {k: f[k] for k in f.files}


def _single_process(runs, name):
    """The port's step on the whole batch, no mesh (one rank of the
    2-rank world ran it)."""
    return _load(runs, f"single_{name}.npz")


def _close(got, want):
    """``tests/test_torch_train.py``'s step tolerances: metrics at rtol
    1e-5; parameters at atol 1e-6, but one element in a thousand may
    differ by up to 2·lr a step (AdamW's sign flips)."""
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-5,
                               atol=1e-7)
    flips = total = 0
    keys = sorted(k for k in want if k.startswith("p:"))
    assert sorted(k for k in got if k.startswith("p:")) == keys
    for k in keys:
        d = np.abs(got[k] - want[k])
        assert d.max() <= 2 * LR * STEPS + 1e-6, k
        flips += int((d > 1e-6).sum())
        total += d.size
    assert flips <= total / 1000, (flips, total)


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax_and_single_process(runs, name):
    got = _load(runs, f"port_{name}.npz")
    _close(got, _load(runs, f"jax_{name}.npz"))
    _close(got, _single_process(runs, name))


def _jax_specs(change, shape):
    """{"0::path" / "1::path": JAX's PartitionSpec} of the parameters and
    the optimizer state, and their whole shapes, on an abstract mesh."""
    jcfg = _jax_cfg(**change)
    jmesh = AbstractMesh(shape, AXES)
    opt = jopt.make_optimizer(jcfg.optimizer, jopt.constant(LR))
    jps, jaxes, jos = jspecs.abstract_state(jcfg, opt)
    p_sh, o_sh, _ = jspecs.state_shardings(jcfg, jmesh, jps, jaxes, jos)
    out = {}
    for i, (sh, sds) in enumerate(((p_sh, jps), (o_sh, jos))):
        leaves = _named(sds)
        for k, v in _named(sh).items():
            out[f"{i}{W.SEP}{k}"] = (v.spec, tuple(leaves[k].shape))
    return jmesh, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_holds_its_jax_shard(runs, name):
    """Each leaf of each rank (parameters and optimizer state) has the
    shape ``NamedSharding.shard_shape`` gives for JAX's spec (the a2a
    experts: the all-to-all's layout), no leaf its spec shards is held
    whole, and ``Layout.rank_bytes()`` is the sum of the rank's bytes."""
    change, shape = CASES[name]
    tcfg = W.train_config(_job(change))
    opt = make_optimizer(tcfg.optimizer, constant(LR))
    p_meta, o_meta = tspecs.abstract_state(tcfg, opt)
    tmesh = abstract_mesh(shape, AXES)
    layout = tspecs.state_layout(tcfg, tmesh, p_meta, o_meta)
    jmesh, jax_specs = _jax_specs(change, shape)
    a2a = "moe_a2a" in tcfg.perf_flags
    out = _load(runs, f"port_{name}.npz")
    for r in range(int(np.prod(shape))):
        held = {k[len(f"held{r}:"):]: tuple(v) for k, v in out.items()
                if k.startswith(f"held{r}:")}
        assert held.keys() == jax_specs.keys()
        nbytes = 0
        for path in layout.specs:
            key = W.SEP.join(map(str, path))
            spec, whole = jax_specs[key]
            expert = a2a and "moe" in path and path[path.index("moe") + 1] \
                in ("wi", "wg", "wo")
            want = layout.shard_shape(path) if expert else \
                NamedSharding(jmesh, spec).shard_shape(whole)
            assert held[key] == tuple(want), (r, key)
            if any(tmesh.axis_size(tspecs.dist.entry_axes(e)) > 1
                   for e in layout.spec(path)):
                assert held[key] != whole, key
            nbytes += int(np.prod(want)) * layout.itemsizes[path]
        assert int(out[f"bytes{r}"]) == nbytes == int(out["rank_bytes"])


def test_rank_state_is_the_layout_of_init():
    """``rank_state`` builds leaf by leaf what sharding the whole init
    gives, bit for bit (rank 0 of an abstract (2, 2) mesh, FSDP and TP
    leaves), and zeros of each optimizer-state part."""
    cfg = W.train_config(dict(arch="chameleon_34b", name="chameleon-34b"))
    opt = make_optimizer("adamw", constant(LR))
    mesh = abstract_mesh((2, 2), AXES)
    params, opt_state, layout = tspecs.rank_state(cfg, mesh, opt, seed=3,
                                                  device="cpu")
    want = layout.part(0).shard(init_train_state(cfg, seed=3,
                                                 device="cpu"))
    got, exp = W.flatten(params), W.flatten(want)
    assert got.keys() == exp.keys()
    assert all(torch.equal(got[k], exp[k]) for k in got)
    assert any(got[k].shape != v.shape for k, v in W.flatten(
        init_train_state(cfg, device="meta")).items())
    for path, leaf in tspecs.dist.tree_items(opt_state):
        assert tuple(leaf.shape) == layout.shard_shape((1,) + path)
        assert not leaf.any()


# ---------------------------------------------------------------------------
# The collectives and the cut heads
# ---------------------------------------------------------------------------

def test_new_collectives_are_their_adjoints(runs):
    out = _load(runs, "comm_out.npz")
    inp = _comm_inputs()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = torch.cat(list(x), dim=1)              # every rank's y, gathered
    (torch.from_numpy(inp["w"]) * y).sum().backward()
    for r in range(2):
        np.testing.assert_array_equal(out["gather_y"][r], y.detach())
    np.testing.assert_allclose(out["gather_dx"], x.grad, rtol=1e-6)
    t = {k: torch.from_numpy(inp[k]).requires_grad_()
         for k in ("a", "w1", "w2")}
    z = torch.relu(t["a"] @ t["w1"]) @ t["w2"]
    (torch.from_numpy(inp["v"]) * z).sum().backward()
    h = inp["w1"].shape[1] // 2
    for r in range(2):
        np.testing.assert_allclose(out["mlp_z"][r], z.detach(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["mlp_da"][r], t["a"].grad,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["mlp_dw1"][r],
                                   t["w1"].grad[:, r * h:(r + 1) * h],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["mlp_dw2"][r],
                                   t["w2"].grad[r * h:(r + 1) * h],
                                   rtol=1e-5, atol=1e-6)


def test_attention_with_cut_heads_matches_one_process(runs):
    """On 4 ranks each rank's ``wq`` columns hold 2.5 query heads and its
    ``wk`` columns 1.25 KV heads; the projections' outputs are gathered,
    each rank computes the 3 query heads its ``wo`` rows need over their
    KV heads repeated a query head: y, dx and every weight's gradient
    equal one process's autograd."""
    from repro_torch.models.layers import attention, tp_heads
    cfg = W.attn_config()
    plans = [tp_heads(cfg, 4, j) for j in range(4)]
    assert all(p["group"] == 1 and p["h1"] - p["h0"] == 3 for p in plans)
    out = _load(runs, "attn_out.npz")
    inp = _attn_inputs()
    p = {k: torch.from_numpy(inp[k]).requires_grad_()
         for k in ("wq", "wk", "wv", "wo")}
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = attention(p, x, cfg, positions=torch.arange(x.shape[1]))
    (torch.from_numpy(inp["w"]) * y).sum().backward()
    np.testing.assert_allclose(out["y"], y.detach(), rtol=1e-5, atol=1e-6)
    for r in range(4):
        np.testing.assert_allclose(out["dx"][r], x.grad, rtol=1e-5,
                                   atol=1e-6)
    for k in p:
        np.testing.assert_allclose(out[f"d{k}"], p[k].grad, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Restart, warm set, refusals
# ---------------------------------------------------------------------------

def test_restart_with_fsdp_and_zero1_is_bit_for_bit(runs):
    """Six steps on (2, 2), a checkpoint every two; step 3 fails once on
    every rank and the controller restores step 2 (rank 0 gathered every
    FSDP, tensor-parallel, expert and ZeRO-1 leaf; scattered back): the
    whole state after step 6 equals the fault-free run's bit for bit."""
    cfg = W.train_config(dict(arch="kimi_k2_1t_a32b", name="kimi-k2-1t-a32b",
                              flags=("moe_a2a",), optimizer="adafactor"))
    opt = make_optimizer(cfg.optimizer, constant(LR))
    p_meta, o_meta = tspecs.abstract_state(cfg, opt)
    mesh = abstract_mesh((2, 2), AXES)
    layout = tspecs.state_layout(cfg, mesh, p_meta, o_meta)
    kinds = {tuple(tspecs.dist.entry_axes(e)) for s in layout.specs.values()
             for e in s}
    assert {("data",), ("model",), ("data", "model")} <= kinds
    zero1 = [p for p, s in layout.specs.items() if p[0] == 1 and "data" in
             {a for e in s for a in tspecs.dist.entry_axes(e)}
             and "moe" not in p and p[-1] in ("vr", "vc")]
    assert zero1
    out = _load(runs, "restart.npz")
    assert list(out["fault:fired"]) == [3]
    np.testing.assert_array_equal(out["fault:loss"][-3:],
                                  out["clean:loss"][-3:])
    names = [k[len("clean:"):] for k in out
             if k.startswith("clean:") and W.SEP in k]
    for name in names:
        assert np.array_equal(out[f"clean:{name}"], out[f"fault:{name}"]), \
            name


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_warm_set_leaves_no_cold_build(runs, mesh):
    """F5 on a ``model`` axis: after ``warm_train_dispatch(..., mesh=)``
    llama3-smoke's step resolves nothing cold, rank 0 asks for exactly
    the traced keys, and they are the rank's: q at 64 / model columns, the
    MLP's 192 / model, the lm_head's 512 / model."""
    out = _load(runs, f"warm_{mesh}.npz")
    assert int(out["cold"]) == 0
    assert list(out["seen"]) == list(out["traced"])
    t = int(mesh[-1])
    M = 8 * 64 // 2 // int(mesh[0])
    labels = set(out["traced"])
    assert f"matmul_h100@K64xM{M}xN{64 // t}" in labels
    assert f"matmul_h100@K64xM{M}xN{192 // t}" in labels
    assert f"matmul_h100@K{192 // t}xM{M}xN64" in labels
    assert f"matmul_h100@K64xM{M}xN{512 // t}" in labels


@pytest.mark.parametrize("name", WARM_CASES)
def test_sharded_warm_set_of_the_new_blocks_leaves_no_cold_build(runs,
                                                                 name):
    """F5 for the SSD, hybrid (heads cut), whisper (encoder, decoder and
    cross-attention heads cut) and dense MoE cases: after
    ``warm_train_dispatch(..., mesh=)`` the step resolves nothing cold and
    rank 0 asks for exactly the traced keys."""
    out = _load(runs, f"warm_{name}.npz")
    assert int(out["cold"]) == 0
    assert list(out["seen"]) == list(out["traced"])


def test_moe_a2a_over_two_pods_still_raises():
    """The one refusal left: the ``moe_a2a`` schedule on a mesh of two
    pods (item 4c, part 4); the dense layer takes the mesh."""
    from repro_torch.models.transformer import check_mesh
    change = dict(arch="llama4_scout_17b_a16e", name="llama4-scout-17b-a16e")
    mesh = abstract_mesh((2, 1, 2), ("pod", "data", "model"))
    cfg = W.train_config(dict(change, flags=("moe_a2a",)))
    opt = make_optimizer(cfg.optimizer, constant(LR))
    with pytest.raises(NotImplementedError, match="item 4c"):
        build_train_step(cfg, opt, microbatches=2, mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 4c"):
        trace_train_warm_set(cfg, global_batch=4, seq=16, mesh=mesh)
    dense = W.train_config(change)
    check_mesh(dense, mesh)
    assert trace_train_warm_set(dense, global_batch=4, seq=16, mesh=mesh)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_takes_every_single_pod_mesh(arch):
    """``check_mesh`` refuses nothing on a single-pod mesh, with or
    without ``moe_a2a``, and the rank's warm set traces on each."""
    from repro_torch.models.transformer import check_mesh
    base = W.train_config(dict(arch=arch))
    cfgs = [base] + ([base.scaled(perf_flags=("moe_a2a",))]
                     if base.moe is not None else [])
    for cfg in cfgs:
        for shape in ((2, 2), (1, 4), (4, 1), (1, 8), (8, 1)):
            mesh = abstract_mesh(shape, AXES)
            check_mesh(cfg, mesh)
            assert trace_train_warm_set(cfg, global_batch=16, seq=16,
                                        mesh=mesh)


def test_ssm_block_with_cut_heads_matches_one_process(runs):
    """On 4 ranks each rank's ``wx`` columns hold 1.5 SSD heads, its
    ``wb`` and ``wc`` columns a quarter of the state and ``wa``, ``a_bias``
    are whole (6 heads on 4): each rank scans the 2 heads its ``wo`` rows
    need over b and c gathered whole; y, dx and every weight's gradient
    (the gather's adjoint: the ranks' partial db and dc summed) equal one
    process's autograd."""
    from repro_torch.models.layers import ssm_block, ssm_tp_plan
    cfg = W.ssm_config()
    plans = [ssm_tp_plan(cfg, 4, j) for j in range(4)]
    assert all(p["h1"] - p["h0"] == 2 for p in plans)
    assert [p["c0"] for p in plans] == [0, 12, 24, 36]
    out = _load(runs, "ssm_out.npz")
    inp = _ssm_inputs()
    p = {k: torch.from_numpy(inp[k]).requires_grad_() for k in W.SSM_SPECS}
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y, _ = ssm_block(p, x, cfg)
    (torch.from_numpy(inp["w"]) * y).sum().backward()
    for r in range(4):
        np.testing.assert_allclose(out["y"][r], y.detach(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["dx"][r], x.grad, rtol=1e-5,
                                   atol=1e-6)
    for k in p:
        # a weight's gradient sums the ranks' partial sums (b and c's over
        # every head): f32 rounding at 1e-6 of the gradient's scale
        want = p[k].grad.numpy()
        np.testing.assert_allclose(out[f"d{k}"], want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)


def _kept(ys):
    """Which experts keep each token, from the outputs (E + 1, ..., d) of
    a layer with expert e's ``wo`` zeroed (e < E) and as given (E): e
    keeps t where zeroing e moves t's output (a token e does not keep
    meets e's outputs only through zero combine weights, so its output
    is the same to the bit)."""
    E = ys.shape[0] - 1
    return np.stack([(ys[e] != ys[E]).any(-1) for e in range(E)], -1)


def _jax_moe(case, inp):
    """JAX's ``moe_block`` on the whole batch, from one ``jax.vmap`` over
    the E + 1 scalings of ``wo`` :func:`_kept` reads: (y, aux, which
    experts keep each token)."""
    import jax.numpy as jnp
    from repro.models.config import ModelConfig, MoEConfig
    from repro.models.moe import moe_block
    E = case["E"]
    cfg = ModelConfig(
        name="ep-test", layers=1, d_model=case["d"], heads=4, kv_heads=2,
        d_ff=case["f"], vocab=64, block="attn_moe",
        moe=MoEConfig(E, case["k"], case["f"], case["cf"]),
        dtype="float32", param_dtype="float32")
    p = {k: jnp.asarray(inp[k]) for k in ("router", "wi", "wg", "wo")}
    x = jnp.asarray(inp["x"])

    def scaled(s):
        return moe_block(dict(p, wo=p["wo"] * s[:, None, None]), x, cfg,
                         group_size=case["group_size"])

    scales = np.ones((E + 1, E), np.float32)
    scales[np.arange(E), np.arange(E)] = 0.0
    ys, auxs = (np.asarray(v) for v in jax.vmap(scaled)(scales))
    return ys[E], float(auxs[E]), _kept(ys)


@pytest.mark.parametrize("ws, routing", sorted(MOE_CASES))
def test_dense_moe_drops_and_aux_match_jax(runs, ws, routing):
    """The dense MoE layer expert-parallel over ``data`` (and its experts'
    ``ff`` over ``model`` on (2, 2); over two pods, each holding every
    expert): which experts keep each token, with tokens dropped at
    capacity factor 0.5, the output, and every rank's aux loss equal
    JAX's ``moe_block`` over the whole batch, whether each rank routes its
    own groups or every rank routes them all."""
    case = MOE_CASES[(ws, routing)]
    out = _load(runs, f"moe_{ws}_{routing}_out.npz")
    y, aux, kept = _jax_moe(case, _moe_inputs(case))
    shape = dict(zip(case["axes"], case["mesh"]))
    T_l = case["B"] * case["S"] // shape["data"] // shape.get("pod", 1)
    assert (T_l % case["group_size"] == 0) == routing.endswith("local")
    assert int(out["held"]) == case["E"] // shape["data"]
    np.testing.assert_array_equal(_kept(out["y"]), kept)
    assert (kept.sum(-1) < case["k"]).any()           # capacity drops
    np.testing.assert_allclose(out["y"][-1], y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["aux"], np.full((ws, 1), aux),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", sorted(DATA_ONLY))
def test_ssm_hybrid_and_whisper_step_on_a_data_mesh(runs, arch):
    """On (2, 1) (ZeRO-1 of the state over data) the step equals the
    single process's."""
    got = _load(runs, f"port_{arch}.npz")
    want = W.job_train(dict(arch=arch, lr=LR, steps=STEPS,
                            microbatches=MICRO,
                            inputs=os.path.join(runs, f"in_{arch}.npz")))
    _close(got, want)
