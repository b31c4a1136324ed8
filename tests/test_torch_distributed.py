"""The port's multi-rank path against the JAX package's, on the CPU.

* **Specs.** The port's spec trees (``repro_torch.launch.specs``) equal the
  JAX ``PartitionSpec``s leaf for leaf for the ten configs' parameter,
  optimizer (ZeRO-1), batch and cache trees, on abstract meshes (1, 1),
  (2, 4), (16, 16) and (2, 16, 16).
* **The a2a block.** ``moe_block_a2a`` on 2, 4 and 8 gloo ranks (meshes
  (2, 1), (2, 2), (2, 4) over data x model) against JAX's
  ``moe_block_a2a`` on the same mesh shape (8 forced host devices,
  ``Auto`` axes, in a subprocess): y, aux and the gradients of router,
  wi, wg and wo of sum(y²) + 0.01·aux, dropless, with capacity binding
  (and E_pad > E), and at E = 260 with storage padded to 512.  Tolerance
  1e-5 (y, aux) and 1e-4 (gradients), relative and absolute: the same f32
  math summed in another order; ``tests/test_moe_a2a.py`` allows 2e-4 and
  2e-3.
* **The ring.** The int8 quantisation is bit for bit with JAX's on JAX's
  noise; the ring over a pod axis of 2 and 4 ranks has a mean relative
  error under 0.02, as ``tests/test_distributed.py`` asks.
* **The train step.** Two steps in two microbatches on 2 and 4 ranks,
  dense (llama3-8b's smoke shape) and ``moe_a2a`` (llama4-scout's,
  dropless; on 4 also under ``remat="full"``, whose backward runs the
  all-to-alls again), AdamW, and kimi-k2's smoke shape with its
  Adafactor on 4: the metrics and parameters against the single-process
  step on the whole batch and against JAX's jitted step (on the same
  mesh shape for the a2a), at the tolerances of
  ``tests/test_torch_train.py``.  After ``warm_train_dispatch(...,
  mesh=)`` a step resolves nothing cold (F5).
* **The controller.** A restart from a checkpoint written by rank 0 and
  scattered back is bit for bit with a run without a fault; the launcher
  runs under ``torch.distributed.run --nproc-per-node 2``.

The ranks are spawned once a world size for the whole module
(``tests/torch_dist_workers.py``, a ``file://`` store under the module's
temporary directory); the JAX side runs once, in one subprocess, beside
them.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

import repro.configs as jconfigs
import repro.launch.specs as jspecs
import repro.models as jm
import repro.optim as jopt
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jdist
from repro.models.config import SHAPES as JSHAPES
from repro.runtime import steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.launch.specs as tspecs
import repro_torch.optim as topt
from repro_torch.distributed import compression as tcomp
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.moe import capacity, route
from repro_torch.runtime import build_train_step

import torch_dist_workers as W

ROOT = os.path.join(os.path.dirname(__file__), "..")
LR = 1e-3
B, S, MICRO, STEPS = 8, 16, 2, 2

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _jax_named(tree):
    """{"a::b": spec entries} of a JAX tree of NamedSharding / tuples."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, (NamedSharding, tuple)))
    out = {}
    for path, leaf in flat:
        name = W.SEP.join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)
        out[name] = tuple(leaf.spec) if isinstance(leaf, NamedSharding) \
            else tuple(leaf)
    return out


def _port_named(tree):
    return {k: tuple(v) for k, v in W.flatten(tree).items()}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_spec_trees_equal_jax(arch):
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jps, jaxes, jos = jspecs.abstract_state(
        cfg, jopt.make_optimizer(cfg.optimizer, jopt.constant(LR)))
    tps, tos = tspecs.abstract_state(
        tcfg, topt.make_optimizer(tcfg.optimizer, topt.constant(LR)))
    taxes = tspecs.param_axes(tcfg)
    assert _port_named(taxes) == _jax_named(jaxes)
    for shape, axes in MESHES:
        jmesh, tmesh = AbstractMesh(shape, axes), abstract_mesh(shape, axes)
        jp, jo, jrules = jspecs.state_shardings(cfg, jmesh, jps, jaxes, jos)
        tp, to, trules = tspecs.state_shardings(tcfg, tmesh, tps, taxes, tos)
        assert trules == jrules
        assert _port_named(tp) == _jax_named(jp), shape
        assert _port_named(to) == _jax_named(jo), shape
        # what the ranks hold: JAX's p_sh and o_sh (no config has moe_a2a)
        lay = tspecs.state_layout(tcfg, tmesh, tps, tos)
        for i, want in enumerate((jp, jo)):
            held = {W.SEP.join(map(str, path)): tuple(spec) for path, spec
                    in lay.part(i).specs.items()}
            assert held == _jax_named(want), (shape, i)
        for js, ts in zip(JSHAPES, TSHAPES):
            assert tspecs.default_microbatches(tcfg, ts, tmesh) == \
                jspecs.default_microbatches(cfg, js, jmesh)
            assert tspecs.batch_entry(tmesh, ts.global_batch) == \
                jspecs.batch_entry(jmesh, js.global_batch)
            if js.kind != "train":
                continue
            jsds, jsh = jspecs.train_batch_specs(cfg, js, jmesh)
            tsds, tsh = tspecs.train_batch_specs(tcfg, ts, tmesh)
            assert {k: tuple(v.shape) for k, v in tsds.items()} == {
                k: tuple(v.shape) for k, v in jsds.items()}
            assert tsh == {k: tuple(v.spec) for k, v in jsh.items()}
        with jdist.use_mesh_rules(jmesh, jrules):
            jc, jcsh = jspecs.cache_specs(cfg, 4, 64, jmesh)
        tc, tcsh = tspecs.cache_specs(tcfg, 4, 64, tmesh)
        assert {k: tuple(v.shape) for k, v in tc.items()} == {
            k: tuple(v.shape) for k, v in jc.items()}
        assert tcsh == {k: tuple(v.spec) for k, v in jcsh.items()}


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_state_layout_under_moe_a2a_is_jax_bar_the_experts(arch):
    """With ``moe_a2a`` the layout holds JAX's specs but for the expert
    stacks and their state, held over the all-to-all's group
    (``expert_spec``), as the schedule's ``shard_map`` consumes them."""
    cfg = jconfigs.get_config(arch).scaled(perf_flags=("moe_a2a",))
    tcfg = tconfigs.get_config(arch).scaled(perf_flags=("moe_a2a",))
    jps, jaxes, jos = jspecs.abstract_state(
        cfg, jopt.make_optimizer(cfg.optimizer, jopt.constant(LR)))
    tps, tos = tspecs.abstract_state(
        tcfg, topt.make_optimizer(tcfg.optimizer, topt.constant(LR)))
    for shape, axes in MESHES[1:3]:
        jmesh, tmesh = AbstractMesh(shape, axes), abstract_mesh(shape, axes)
        jp, jo, _ = jspecs.state_shardings(cfg, jmesh, jps, jaxes, jos)
        lay = tspecs.state_layout(tcfg, tmesh, tps, tos)
        experts = 0
        for i, want in enumerate((_jax_named(jp), _jax_named(jo))):
            for path, spec in lay.part(i).specs.items():
                name = W.SEP.join(map(str, path))
                moe = "moe" in path and path[path.index("moe") + 1] in (
                    "wi", "wg", "wo")
                if moe:
                    experts += 1
                    assert tuple(spec) == tspecs.expert_spec(tmesh), name
                else:
                    assert tuple(spec) == want[name], name
        assert experts


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_dense_experts_are_held_by_jax_specs_and_never_gathered(arch, shape):
    """Without ``moe_a2a`` the layout holds JAX's ``p_sh`` and ``o_sh`` for
    every leaf, the dense layer's experts too (over ``data``, their ``ff``
    over ``model``); no expert dim is among the FSDP gathers (a rank runs
    its own experts); ``Layout.rank_bytes()`` sums every leaf's
    ``NamedSharding.shard_shape``."""
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jps, jaxes, jos = jspecs.abstract_state(
        cfg, jopt.make_optimizer(cfg.optimizer, jopt.constant(LR)))
    tps, tos = tspecs.abstract_state(
        tcfg, topt.make_optimizer(tcfg.optimizer, topt.constant(LR)))
    axes = ("data", "model")
    jmesh, tmesh = AbstractMesh(shape, axes), abstract_mesh(shape, axes)
    jp, jo, _ = jspecs.state_shardings(cfg, jmesh, jps, jaxes, jos)
    lay = tspecs.state_layout(tcfg, tmesh, tps, tos)
    nbytes = 0
    for i, want in enumerate((_jax_named(jp), _jax_named(jo))):
        part = lay.part(i)
        held = {W.SEP.join(map(str, path)): tuple(spec) for path, spec
                in part.specs.items()}
        assert held == want, (shape, i)
        for path, spec in part.specs.items():
            nbytes += int(np.prod(NamedSharding(
                jmesh, PartitionSpec(*spec)).shard_shape(
                    part.shapes[path]))) * part.itemsizes[path]
    assert lay.rank_bytes() == nbytes
    experts = [p for p in lay.specs if p[0] == 0 and "moe" in p
               and p[-1] in ("wi", "wg", "wo")]
    assert experts
    for path in experts:
        assert tspecs.dist.entry_axes(lay.spec(path)[1]) == ("data",)
        assert all(dim != 1 for dim, _ in lay.gathered.get(path, ()))


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_mesh_keeps_jax_device_order():
    """Rank r sits at the row-major coordinate of r over the axes, as
    ``jax.make_mesh`` lays devices out; a set of axes indexes its ranks
    row-major in the order given."""
    m = abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    jm_ = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    assert m.shape == dict(jm_.shape) and m.size == 16
    assert m.coords(13) == {"pod": 1, "data": 1, "model": 1}
    assert m.axis_index(("data", "model"), 13) == 5
    assert m.axis_index(("pod", "data"), 13) == 3
    assert m.ranks_along(("data", "model"), 13) == list(range(8, 16))
    assert m.ranks_along(("pod",), 6) == [6, 14]
    with pytest.raises(RuntimeError, match="no process groups"):
        m.group(("data",))


def test_meshes_over_a_process_group_of_one(tmp_path):
    """A world of one gloo rank: ``make_host_mesh`` is (1, 1), a mesh of
    another size and the production meshes (256 and 512 ranks) raise, as
    ``jax.make_mesh`` does on too few devices."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                         make_mesh, make_production_mesh)
    init_distributed(init_method=f"file://{tmp_path / 'init'}", rank=0,
                     world_size=1, backend="gloo")
    try:
        mesh = make_host_mesh()
        assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
        assert mesh.world is mesh.group(("data", "model"))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh((2, 1), ("data", "model"))
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="ranks"):
                make_production_mesh(multi_pod=multi_pod)
    finally:
        tdist.destroy_process_group()


def test_resolve_device_takes_the_local_rank_under_torchrun(monkeypatch):
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == torch.device("cuda:3")
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# The int8 quantisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale,seed", [((64, 64), 3.0, 0),
                                              ((17,), 1e-3, 1),
                                              ((8, 3, 5), 250.0, 2)])
def test_int8_quantisation_is_bit_for_bit_with_jax(shape, scale, seed):
    x = jax.random.normal(jax.random.PRNGKey(seed), shape) * scale
    key = jax.random.PRNGKey(seed + 7)
    q, s = jcomp._quantize(x, key)
    noise = jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5)
    tq, ts = tcomp._quantize(torch.from_numpy(np.asarray(x)),
                             torch.from_numpy(np.asarray(noise)))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(q))
    assert ts.numpy().tobytes() == np.asarray(s, np.float32).tobytes()
    np.testing.assert_array_equal(
        tcomp._dequantize(tq, ts).numpy(), np.asarray(jcomp._dequantize(q, s)))


# ---------------------------------------------------------------------------
# The module's ranks and its JAX subprocess
# ---------------------------------------------------------------------------

A2A_CASES = {
    # the JAX test's shape: dropless, E divides 2 but not 4 or 8
    "dropless": dict(E=6, k=2, d=32, f=48, cf=64.0, group_size=8,
                     skew=0.0),
    # a router skewed to expert 0 and half the capacity: drops everywhere
    "binding": dict(E=6, k=2, d=32, f=48, cf=0.5, group_size=32, skew=3.0),
    # E >= 256: storage padded to 512 under the flag, a tiny width
    "padded": dict(E=260, k=2, d=8, f=8, cf=2.0, group_size=8, skew=0.0),
}
A2A_MESHES = {2: (2, 1), 4: (2, 2), 8: (2, 4)}
TRAIN = {  # name -> the config's changes and {world size: mesh}
    "dense": (dict(arch="llama3_8b"), {2: (2, 1), 4: (2, 2)}),
    "a2a": (dict(arch="llama4_scout_17b_a16e", flags=("moe_a2a",)),
            {2: (2, 1), 4: (2, 2)}),
    # the backward recomputes each block, its all-to-alls included
    "a2a_remat": (dict(arch="llama4_scout_17b_a16e", flags=("moe_a2a",),
                       remat="full"), {4: (2, 2)}),
    # kimi-k2's own optimizer: the RMS of an expert shard's update is the
    # whole leaf's
    "adafactor": (dict(arch="kimi_k2_1t_a32b", flags=("moe_a2a",),
                       optimizer="adafactor"), {4: (2, 2)}),
}
DROPLESS_CF = 64.0


def _a2a_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    E, d, f = case["E"], case["d"], case["f"]
    Es = 512 if E >= 256 else E
    router = rng.standard_normal((d, E)) / np.sqrt(d)
    router[:, 0] += case["skew"] / np.sqrt(d)
    out = {"x": rng.standard_normal((4, 16, d)), "router": router,
           "wi": rng.standard_normal((Es, d, f)) / np.sqrt(d),
           "wg": rng.standard_normal((Es, d, f)) / np.sqrt(d),
           "wo": rng.standard_normal((Es, f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _jax_cfg(arch, flags=(), remat="none", optimizer=None):
    base = jconfigs.get_smoke_config(arch)
    cfg = base.scaled(dtype="float32", param_dtype="float32",
                      perf_flags=flags, remat=remat,
                      optimizer=optimizer or base.optimizer)
    if cfg.moe is not None:
        m = cfg.moe
        cfg = cfg.scaled(moe=type(m)(m.num_experts, m.top_k, m.d_ff_expert,
                                     DROPLESS_CF))
    return cfg


def _train_inputs(arch, flags=(), **_):
    cfg = _jax_cfg(arch, flags)
    p, _ = jm.init_model(jax.random.PRNGKey(0), cfg)
    out = {f"p:{k}": np.asarray(v, np.float32)
           for k, v in _jax_named_arrays(p).items()}
    rng = np.random.default_rng(1)
    for s in range(STEPS):
        for k in ("tokens", "labels"):
            out[f"b{s}:{k}"] = rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32)
    return out


def _jax_named_arrays(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {W.SEP.join(str(k.key) for k in path): leaf for path, leaf in flat}


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from repro.distributed import sharding as dist
    from repro.models.config import ModelConfig, MoEConfig
    from repro.models.moe_a2a import moe_block_a2a
    from repro import configs, optim
    from repro.runtime import steps

    SEP = "::"

    def mesh_of(shape):
        n = int(np.prod(shape))
        devs = np.array(jax.devices()[:n]).reshape(shape)
        return Mesh(devs, ("data", "model"),
                    axis_types=(AxisType.Auto, AxisType.Auto))

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
        mesh = mesh_of(tuple(job["mesh"]))
        if job["kind"] == "a2a":
            c = job["case"]
            cfg = ModelConfig(
                name="a2a-test", layers=1, d_model=c["d"], heads=4,
                kv_heads=2, d_ff=c["f"], vocab=64, block="attn_moe",
                moe=MoEConfig(num_experts=c["E"], top_k=c["k"],
                              d_ff_expert=c["f"], capacity_factor=c["cf"]),
                perf_flags=("moe_a2a",))
            p = {k: jnp.asarray(inp[k]) for k in ("router", "wi", "wg", "wo")}
            x = jnp.asarray(inp["x"])
            fn = lambda p: moe_block_a2a(p, x, cfg,
                                         group_size=c["group_size"])
            def loss(p):
                y, aux = fn(p)
                return jnp.sum(y * y) + 0.01 * aux
            with mesh, dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
                y, aux = jax.jit(fn)(p)
                g = jax.jit(jax.grad(loss))(p)
            out = {"y": np.asarray(y), "aux": np.float32(aux)}
            out.update({k: np.asarray(v) for k, v in g.items()})
        else:
            base = configs.get_smoke_config(job["arch"])
            m = base.moe
            cfg = base.scaled(dtype="float32", param_dtype="float32",
                              perf_flags=tuple(job["flags"]),
                              remat=job.get("remat", "none"),
                              optimizer=job.get("optimizer", base.optimizer),
                              moe=MoEConfig(m.num_experts, m.top_k,
                                            m.d_ff_expert, job["cf"]))
            opt = optim.make_optimizer(cfg.optimizer,
                                       optim.constant(job["lr"]))
            params = unflatten({k[2:]: jnp.asarray(v)
                                for k, v in inp.items() if k[:2] == "p:"})
            state = opt.init(params)
            metrics = []
            with mesh, dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
                fn = jax.jit(steps.build_train_step(
                    cfg, opt, microbatches=job["microbatches"]))
                for s in range(job["steps"]):
                    batch = {k: jnp.asarray(inp[f"b{s}:{k}"])
                             for k in ("tokens", "labels")}
                    params, state, mt = fn(params, state, batch,
                                           jnp.asarray(s))
                    metrics.append([float(mt[k]) for k in
                                    ("loss", "nll", "moe_aux", "grad_norm")])
            out = {f"p:{k}": v for k, v in flatten(params).items()}
            out["metrics"] = np.array(metrics, np.float64)
        np.savez(job["out"], **out)
    print("JAX_REF_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write every input; run the JAX subprocess and the 2-, 4- and 8-rank
    spawns; return the output directory."""
    d = str(tmp_path_factory.mktemp("dist"))
    jax_jobs = []
    rank_jobs = {2: [], 4: [], 8: []}
    for name, case in A2A_CASES.items():
        inputs = os.path.join(d, f"a2a_{name}.npz")
        np.savez(inputs, **_a2a_inputs(case))
        for ws, mesh in A2A_MESHES.items():
            common = dict(kind="a2a", case=case, mesh=mesh, inputs=inputs)
            jax_jobs.append(dict(common, out=os.path.join(
                d, f"jax_a2a_{name}_{ws}.npz")))
            rank_jobs[ws].append(dict(common, axes=("data", "model"),
                                      out=os.path.join(
                                          d, f"port_a2a_{name}_{ws}.npz")))
    ring_in = os.path.join(d, "ring.npz")
    rng = np.random.default_rng(3)
    np.savez(ring_in, w=rng.standard_normal((64, 64)).astype(np.float32),
             b=rng.standard_normal(17).astype(np.float32))
    for ws in (2, 4):
        rank_jobs[ws].append(dict(kind="ring", inputs=ring_in,
                                  mesh=(ws, 1, 1),
                                  axes=("pod", "data", "model"),
                                  out=os.path.join(d, f"ring_{ws}.npz")))
    for name, (change, meshes) in TRAIN.items():
        inputs = os.path.join(d, f"train_{name}.npz")
        np.savez(inputs, **_train_inputs(**change))
        for ws, mesh in meshes.items():
            common = dict(kind="train", **change, cf=DROPLESS_CF, lr=LR,
                          steps=STEPS, microbatches=MICRO, inputs=inputs,
                          mesh=mesh)
            rank_jobs[ws].append(dict(common, axes=("data", "model"),
                                      out=os.path.join(
                                          d, f"port_train_{name}_{ws}.npz")))
            if change.get("flags"):
                jax_jobs.append(dict(common, out=os.path.join(
                    d, f"jax_train_{name}_{ws}.npz")))
    for ws, mesh in ((2, (2, 1)), (4, (2, 2))):
        rank_jobs[ws].append(dict(kind="warm", arch="llama4_scout_17b_a16e",
                                  flags=("moe_a2a",), batch=8, seq=64,
                                  mesh=mesh, axes=("data", "model"),
                                  out=os.path.join(d, f"warm_{ws}.npz")))
    rank_jobs[2].append(dict(kind="restart", arch="llama4_scout_17b_a16e",
                             flags=("moe_a2a",), cf=DROPLESS_CF, lr=LR,
                             steps=6, fault_at=3, mesh=(2, 1),
                             axes=("data", "model"), dir=d,
                             out=os.path.join(d, "restart.npz")))
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


# ---------------------------------------------------------------------------
# The a2a block
# ---------------------------------------------------------------------------

def _drops(case, ws):
    """Dropped (token, choice) pairs of the routing at ``ws`` ranks."""
    inp = _a2a_inputs(case)
    T = inp["x"].shape[0] * inp["x"].shape[1]
    gsz = min(case["group_size"], T // ws)
    C = capacity(gsz, case["E"], case["k"], case["cf"])
    logits = torch.from_numpy(inp["x"].reshape(T, -1) @ inp["router"])
    dispatch, _, _, onehot = route(logits.reshape(T // gsz, gsz, -1),
                                   case["k"], C)
    return int(onehot.sum() - dispatch.sum())


@pytest.mark.parametrize("ws", sorted(A2A_MESHES))
@pytest.mark.parametrize("case", sorted(A2A_CASES))
def test_moe_block_a2a_matches_jax_on_the_same_mesh(runs, case, ws):
    got = _load(runs, f"port_a2a_{case}_{ws}.npz")
    want = _load(runs, f"jax_a2a_{case}_{ws}.npz")
    binds = _drops(A2A_CASES[case], ws) > 0
    assert binds == (case == "binding")
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
    for k in ("router", "wi", "wg", "wo"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [2, 4])
def test_int8_ring_over_the_pod_axis(runs, ws):
    got = _load(runs, f"ring_{ws}.npz")
    grads = _load(runs, "ring.npz")
    for k in grads:
        want = ws * grads[k]
        rel = np.abs(got[k] - want).mean() / (np.abs(want).mean() + 1e-9)
        assert rel < 0.02, (k, rel)
        assert not np.array_equal(got[k], want)     # it did quantise


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _single_process(runs, name):
    """The port's step on the whole batch, no mesh: (metrics, params)."""
    return W.job_train(dict(**TRAIN[name][0], cf=DROPLESS_CF, lr=LR,
                            steps=STEPS, microbatches=MICRO,
                            inputs=os.path.join(runs, f"train_{name}.npz")))


def _jax_dense(inputs):
    """JAX's jitted step on one device (the dense config)."""
    cfg = _jax_cfg(**TRAIN["dense"][0])
    opt = jopt.make_optimizer(cfg.optimizer, jopt.constant(LR))
    params = W.unflatten({k[2:]: jnp.asarray(v) for k, v in inputs.items()
                          if k.startswith("p:")})
    state = opt.init(params)
    fn = jax.jit(jsteps.build_train_step(cfg, opt, microbatches=MICRO))
    metrics = []
    for s in range(STEPS):
        batch = {k: jnp.asarray(inputs[f"b{s}:{k}"])
                 for k in ("tokens", "labels")}
        params, state, m = fn(params, state, batch, jnp.asarray(s))
        metrics.append([float(m[k]) for k in ("loss", "nll", "moe_aux",
                                              "grad_norm")])
    out = {f"p:{k}": np.asarray(v) for k, v in _jax_named_arrays(
        params).items()}
    out["metrics"] = np.array(metrics)
    return out


def _close(got, want):
    """Metrics at rtol 1e-5; parameters at atol 1e-6, but where AdamW's
    first steps may flip an element whose gradient is within rounding of
    0 (at most 2·lr a step, one element in a thousand), as in
    ``tests/test_torch_train.py``."""
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


@pytest.mark.parametrize("name,ws", [(n, ws) for n, (_, m) in TRAIN.items()
                                     for ws in m])
def test_data_parallel_step_equals_single_process_and_jax(runs, name, ws):
    got = _load(runs, f"port_train_{name}_{ws}.npz")
    _close(got, _single_process(runs, name))
    if name == "dense":
        want = _jax_dense(_load(runs, "train_dense.npz"))
    else:
        want = _load(runs, f"jax_train_{name}_{ws}.npz")
    _close(got, want)


def test_step_without_a_mesh_is_unchanged_bit_for_bit(tmp_path):
    """``mesh=None`` is the step of before: the same launches on the same
    numbers, so a step built with ``mesh=None`` agrees bit for bit with
    one built without the keyword."""
    arch = "llama4_scout_17b_a16e"
    tcfg = tconfigs.get_smoke_config(arch).scaled(dtype="float32")
    from repro_torch.models import init_train_state
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, tcfg.vocab, (4, 8)).astype(
        np.int32)) for k in ("tokens", "labels")}
    outs = []
    for kw in ({}, {"mesh": None}):
        p = init_train_state(tcfg, device="cpu")
        opt = topt.adamw(topt.constant(LR))
        st = opt.init(p)
        p, st, m = build_train_step(tcfg, opt, microbatches=2, **kw)(
            p, st, batch, 0)
        outs.append((m, topt.tree_leaves(p)))
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in outs[0][0])


def test_restart_through_the_controller_is_bit_for_bit(runs):
    """Six steps with a checkpoint every two; step 3 fails once on every
    rank, the controller restores step 2 (written whole by rank 0, the
    experts gathered; scattered back) and replays: the whole state after
    step 6 equals the run without the fault's, bit for bit."""
    out = _load(runs, "restart.npz")
    assert list(out["fault:fired"]) == [3]
    np.testing.assert_array_equal(out["fault:loss"][-3:],
                                  out["clean:loss"][-3:])
    names = [k[len("clean:"):] for k in out
             if k.startswith("clean:") and W.SEP in k]
    assert any("moe::wi" in n for n in names)
    for name in names:
        assert np.array_equal(out[f"clean:{name}"], out[f"fault:{name}"]), \
            name


@pytest.mark.parametrize("ws", [2, 4])
def test_mesh_warm_set_leaves_no_cold_build(runs, ws):
    """F5 under a mesh: after ``warm_train_dispatch(..., mesh=)`` a step of
    the ``moe_a2a`` config resolves nothing cold, and the (family, key)
    pairs rank 0 asks for are exactly the traced ones: the layers at the
    rank's rows, the router at its T / n tokens, the experts at every
    group's rows (8 x 64 tokens in 2 microbatches: T = 256 a microbatch;
    at 4 ranks 64 a rank, groups of 64, C 20 at top-1 over 4 experts,
    so M = G·C = 80)."""
    out = _load(runs, f"warm_{ws}.npz")
    assert int(out["cold"]) == 0
    assert list(out["seen"]) == list(out["traced"])
    n = ws
    gsz = min(1024, 256 // n)
    C = capacity(gsz, 4, 1, 1.25)
    labels = set(out["traced"])
    assert f"matmul_h100@K64xM{256 // n}xN4" in labels           # router
    assert f"matmul_h100@K64xM{(256 // gsz) * C}xN128" in labels  # experts


# ---------------------------------------------------------------------------
# The launcher under torchrun
# ---------------------------------------------------------------------------

def test_train_launcher_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2`` on the
    launcher at smoke size: two gloo ranks on a (2, 1) mesh, rank 0 alone
    printing and writing checkpoints; the losses (printed to 4 places) are
    the single process's to 1e-3 relative: the smoke config computes in
    bf16, and a rank's products over its own rows round otherwise than
    the single process's over both ranks' (the f32 step's agreement is
    the train-step tests' business)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    args = ["--arch", "llama3-8b", "--smoke", "--steps", "4",
            "--seq-len", "16", "--global-batch", "4", "--microbatches",
            "2", "--device", "cpu", "--log-every", "1", "--ckpt-every", "2"]
    runs = {}
    for tag, pre in (("one", []), ("two", [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"])):
        r = subprocess.run(
            [sys.executable, *pre, "-m", "repro_torch.launch.train", *args,
             "--ckpt-dir", str(tmp_path / tag)], env=env,
            capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stderr[-3000:]
        runs[tag] = r.stdout
    lines = [ln for ln in runs["two"].splitlines() if ln.startswith("step")]
    assert len(lines) == 4, runs["two"]          # rank 0 prints alone
    assert "on 2 ranks" in runs["two"]
    assert os.path.isfile(tmp_path / "two" / "LATEST")
    want = [float(ln.split()[3]) for ln in runs["one"].splitlines()
            if ln.startswith("step")]
    np.testing.assert_allclose([float(ln.split()[3]) for ln in lines],
                               want, rtol=1e-3)
