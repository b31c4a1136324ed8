"""Rank processes of ``tests/test_torch_distributed.py``: the port over
``torch.distributed`` with gloo on the CPU.

This module imports torch and the port only (no JAX): every rank of a
spawn imports it.  :func:`spawn` starts ``world`` ranks on a ``file://``
store, each running :func:`rank_main` over a list of jobs; a job reads its
inputs from an ``.npz`` the test wrote and rank 0 writes its outputs to
another.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist

SEP = "::"


def flatten(tree, prefix=()):
    """{"a::b::c": leaf} of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[SEP.join(prefix + (k,))] = v
    return out


def unflatten(flat):
    out = {}
    for name, v in flat.items():
        node = out
        keys = name.split(SEP)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def spawn(world, tmp_dir, jobs, timeout=240):
    """Run ``jobs`` on ``world`` gloo ranks; raises on a rank's failure or
    when the ranks outlive ``timeout`` seconds."""
    import torch.multiprocessing as mp
    init = os.path.join(tmp_dir, f"store_{world}_{time.monotonic_ns()}")
    ctx = mp.start_processes(rank_main, args=(world, init, jobs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{timeout} s")


def rank_main(rank, world, init, jobs):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init}",
                             rank=rank, world_size=world)
    try:
        for job in jobs:
            out = JOBS[job["kind"]](job)
            if rank == 0 and out is not None:
                np.savez(job["out"], **out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        tdist.destroy_process_group()


def _inputs(job):
    with np.load(job["inputs"]) as f:
        return {k: f[k] for k in f.files}


def _mesh(job):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(tuple(job["mesh"]), tuple(job["axes"]))


# ---------------------------------------------------------------------------
# moe_block_a2a: forward and gradients
# ---------------------------------------------------------------------------

def a2a_config(case):
    from repro_torch.models.config import ModelConfig, MoEConfig
    return ModelConfig(
        name="a2a-test", layers=1, d_model=case["d"], heads=4, kv_heads=2,
        d_ff=case["f"], vocab=64, block="attn_moe",
        moe=MoEConfig(num_experts=case["E"], top_k=case["k"],
                      d_ff_expert=case["f"],
                      capacity_factor=case["cf"]),
        perf_flags=("moe_a2a",))


def job_a2a(job):
    from repro_torch.distributed import sharding as dist
    from repro_torch.models.moe_a2a import a2a_axes, moe_block_a2a
    inp = _inputs(job)
    case = job["case"]
    cfg = a2a_config(case)
    mesh = _mesh(job)
    axes = a2a_axes(mesh)
    espec = (axes if len(axes) > 1 else axes[0],)
    n_data = mesh.shape["data"]
    x = dist.local_shard(torch.from_numpy(inp["x"]), ("data",), mesh)
    p = {"router": torch.from_numpy(inp["router"]).requires_grad_()}
    for k in ("wi", "wg", "wo"):
        p[k] = dist.local_shard(torch.from_numpy(inp[k]), espec,
                                mesh).requires_grad_()
    with dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
        y, aux = moe_block_a2a(p, x, cfg, group_size=case["group_size"])
        # the data shards' losses add; the ranks along model compute one
        # (the aux loss is the whole group's, in every shard's loss)
        loss = (y * y).sum() + 0.01 * aux / n_data
        loss.backward()
    g_router = p["router"].grad.clone()
    tdist.all_reduce(g_router, group=mesh.group(("data",)))
    out = {"y": dist.gather_shard(y.detach(), ("data",), mesh).numpy(),
           "aux": np.float32(aux.item()), "router": g_router.numpy()}
    for k in ("wi", "wg", "wo"):
        out[k] = dist.gather_shard(p[k].grad, espec, mesh,
                                   inp[k].shape).numpy()
    return out


# ---------------------------------------------------------------------------
# The int8 ring
# ---------------------------------------------------------------------------

def job_ring(job):
    from repro_torch.distributed import compressed_psum_pod
    inp = _inputs(job)
    mesh = _mesh(job)
    grads = {k: torch.from_numpy(inp[k]) for k in ("w", "b")}
    out = compressed_psum_pod(grads, mesh, seed=2)
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def train_config(job):
    """The smoke config of ``job["arch"]`` in f32, with the job's flags,
    remat, optimizer, widths (``dims``: the config's fields; ``ssm``:
    (state, heads, head_dim, chunk)), capacity factor and name."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import MoEConfig, SSMConfig
    base = get_smoke_config(job["arch"])
    cfg = base.scaled(
        dtype="float32", param_dtype="float32",
        perf_flags=tuple(job.get("flags", ())),
        remat=job.get("remat", "none"),
        optimizer=job.get("optimizer", base.optimizer),
        **job.get("dims", {}))
    if job.get("ssm"):
        cfg = cfg.scaled(ssm=SSMConfig(*job["ssm"]))
    if cfg.moe is not None and job.get("cf"):
        m = cfg.moe
        cfg = cfg.scaled(moe=MoEConfig(m.num_experts, m.top_k,
                                       m.d_ff_expert, job["cf"]))
    if job.get("name"):                 # FSDP_ARCHS keys on the name
        cfg = cfg.scaled(name=job["name"])
    return cfg


BATCH_KEYS = ("tokens", "labels", "patch_embeds", "enc_embeds")


def job_train(job):
    """``job["steps"]`` steps from the inputs' parameters: the whole
    parameters after them, each step's metrics, and (on a mesh) the shape
    of every leaf each rank holds and ``Layout.rank_bytes()``."""
    from repro_torch.distributed.sharding import tree_items
    from repro_torch.launch.specs import abstract_state, state_layout
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import build_train_step
    inp = _inputs(job)
    cfg = train_config(job)
    mesh = _mesh(job) if job.get("mesh") else None
    params = unflatten({k[2:]: torch.from_numpy(v.copy())
                        for k, v in inp.items() if k.startswith("p:")})
    opt = make_optimizer(cfg.optimizer, constant(job["lr"]))
    layout = None
    if mesh is not None:
        _, o_meta = abstract_state(cfg, opt)
        layout = state_layout(cfg, mesh, params, o_meta)
        params = layout.part(0).shard(params)
        opt_state = layout.part(1).zeros(o_meta, "cpu")
    else:
        opt_state = opt.init(params)
    step_fn = build_train_step(cfg, opt, microbatches=job["microbatches"],
                               grad_dtype=torch.float32, mesh=mesh)
    metrics = []
    for s in range(job["steps"]):
        batch = {k: torch.from_numpy(inp[f"b{s}:{k}"])
                 for k in BATCH_KEYS if f"b{s}:{k}" in inp}
        params, opt_state, m = step_fn(params, opt_state, batch, s)
        metrics.append([float(m[k]) for k in ("loss", "nll", "moe_aux",
                                              "grad_norm")])
    out = {}
    if layout is not None:
        held = {SEP.join(map(str, path)): tuple(leaf.shape)
                for path, leaf in tree_items((params, opt_state))}
        nbytes = sum(leaf.numel() * leaf.element_size()
                     for _, leaf in tree_items((params, opt_state)))
        every = [None] * mesh.size
        tdist.all_gather_object(every, (held, nbytes))
        for r, (h, n) in enumerate(every):
            out.update({f"held{r}:{k}": np.array(v) for k, v in h.items()})
            out[f"bytes{r}"] = np.int64(n)
        out["rank_bytes"] = np.int64(layout.rank_bytes())
        params = layout.part(0).gather(params)
    out.update({f"p:{k}": v.detach().numpy()
                for k, v in flatten(params).items()})
    out["metrics"] = np.array(metrics, np.float64)
    return out



# ---------------------------------------------------------------------------
# Restart through the controller, bit for bit
# ---------------------------------------------------------------------------

def job_restart(job):
    """Two controller runs of a ``moe_a2a`` config over the mesh from one
    initial state: one clean, one whose step ``fault_at`` fails on every
    rank once; both whole states after the last step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.specs import rank_state
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import TrainController, build_train_step
    cfg = train_config(job)
    mesh = _mesh(job)
    opt = make_optimizer(cfg.optimizer, constant(job["lr"]))
    step_fn = build_train_step(cfg, opt, microbatches=2, mesh=mesh)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=8,
                                global_batch=4, seed=0))
    out = {}
    for tag, fault_at in (("clean", None), ("fault", job["fault_at"])):
        params, opt_state, layout = rank_state(cfg, mesh, opt, seed=0,
                                               device="cpu")
        state = (params, opt_state)
        fired = []

        def hook(step):
            if step == fault_at and not fired:
                fired.append(step)
                raise RuntimeError("injected fault")

        def run_step(state, step):
            params, opt_state = state
            batch = {k: torch.from_numpy(v)
                     for k, v in ds.batch_at(step).items()}
            params, opt_state, m = step_fn(params, opt_state, batch, step)
            return (params, opt_state), {k: float(v) for k, v in m.items()}

        ckpt = CheckpointManager(os.path.join(job["dir"], tag), keep=2,
                                 layout=layout)
        ctl = TrainController(run_step, ckpt, ckpt_every=2,
                              fault_hook=hook)
        state, hist = ctl.run(state, start_step=0, num_steps=job["steps"])
        full = layout.gather(state)
        for k, v in flatten(full[0]).items():
            out[f"{tag}:{k}"] = v.detach().numpy()
        out[f"{tag}:loss"] = np.array([h["loss"] for h in hist])
        out[f"{tag}:fired"] = np.array(fired)
    return out


# ---------------------------------------------------------------------------
# The warm set under a mesh (F5)
# ---------------------------------------------------------------------------

def job_warm(job):
    """``warm_train_dispatch(..., mesh=)`` then one step over the mesh:
    the cold builds the step made, and the (family, key) labels it asked
    for and the trace lists."""
    from repro_torch.artifacts.dispatch import (DispatchCache,
                                                set_default_cache)
    from repro_torch.launch.specs import rank_state
    from repro_torch.optim import adamw, constant
    from repro_torch.plans.trace import op_label, trace_train_warm_set
    from repro_torch.runtime import build_train_step, warm_train_dispatch
    cfg = train_config(job)
    mesh = _mesh(job)
    B, S = job["batch"], job["seq"]
    cache = DispatchCache()
    set_default_cache(cache)
    try:
        warm_train_dispatch(cfg, global_batch=B, seq=S, microbatches=2,
                            mesh=mesh)
        cold = cache.stats.cold_builds
        opt = adamw(constant(1e-3))
        params, opt_state, _ = rank_state(cfg, mesh, opt, device="cpu")
        step = build_train_step(cfg, opt, microbatches=2, mesh=mesh)
        rng = np.random.default_rng(3)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
                 for k in ("tokens", "labels")}
        if cfg.encoder is not None:
            batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
        with cache.record() as rec:
            step(params, opt_state, batch, 0)
        cold = cache.stats.cold_builds - cold
    finally:
        set_default_cache(None)
    seen = sorted({op_label(f, dict(items)) for f, _, items in rec.requests})
    traced = sorted(op.label for op in trace_train_warm_set(
        cfg, global_batch=B, seq=S, microbatches=2, mesh=mesh))
    return {"cold": np.int64(cold), "seen": np.array(seen),
            "traced": np.array(traced)}


# ---------------------------------------------------------------------------
# Tensor parallelism's collectives and attention
# ---------------------------------------------------------------------------

def _every_rank(t):
    """Every rank's ``t`` (one shape), stacked in rank order."""
    parts = [torch.empty_like(t) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, t.contiguous())
    return torch.stack(parts).numpy()


def job_comm(job):
    """The new collectives over the world: ``gather`` along dim 1 of each
    rank's x under losses that add (sum(w_r * y) on rank r), and the
    Megatron pair around a column- then row-parallel MLP under one loss
    (sum(w * y), w the same on every rank); every rank's gradients."""
    from repro_torch.distributed.comm import copy_to, gather, reduce_from
    inp = _inputs(job)
    r, group = tdist.get_rank(), tdist.group.WORLD
    x = torch.from_numpy(inp["x"][r]).requires_grad_()
    y = gather(x, 1, group)
    (torch.from_numpy(inp["w"][r]) * y).sum().backward()
    out = {"gather_y": _every_rank(y.detach()), "gather_dx":
           _every_rank(x.grad)}
    n = tdist.get_world_size()
    h = inp["w1"].shape[1] // n
    a = torch.from_numpy(inp["a"]).requires_grad_()
    w1 = torch.from_numpy(inp["w1"][:, r * h:(r + 1) * h]).requires_grad_()
    w2 = torch.from_numpy(inp["w2"][r * h:(r + 1) * h]).requires_grad_()
    z = reduce_from(torch.relu(copy_to(a, group) @ w1) @ w2, group)
    (torch.from_numpy(inp["v"]) * z).sum().backward()
    out.update({"mlp_z": _every_rank(z.detach()),
                "mlp_da": _every_rank(a.grad),
                "mlp_dw1": _every_rank(w1.grad),
                "mlp_dw2": _every_rank(w2.grad)})
    return out


def attn_config():
    from repro_torch.models.config import ModelConfig
    # 10 query heads over 5 KV heads of 8: on 4 ranks each holds 2.5
    # query heads and 1.25 KV heads, and its query heads straddle KV
    # groups (K2 then reads KV heads repeated a query head)
    return ModelConfig(name="tp-attn", layers=1, d_model=32, heads=10,
                       kv_heads=5, head_dim=8, d_ff=64, vocab=64,
                       dtype="float32", param_dtype="float32")


def job_attn(job):
    """``layers.attention`` over a ``model`` mesh from the whole weights'
    column and row parts, one loss sum(w * y): y, dx and the whole
    weights' gradients."""
    from repro_torch.distributed import sharding as dist
    from repro_torch.models.layers import attention
    inp = _inputs(job)
    cfg, mesh = attn_config(), _mesh(job)
    specs = {"wq": (None, "model"), "wk": (None, "model"),
             "wv": (None, "model"), "wo": ("model",)}
    p = {k: dist.local_shard(torch.from_numpy(inp[k]), spec,
                             mesh).requires_grad_()
         for k, spec in specs.items()}
    x = torch.from_numpy(inp["x"]).requires_grad_()
    with dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
        y = attention(p, x, cfg, positions=torch.arange(x.shape[1]))
        (torch.from_numpy(inp["w"]) * y).sum().backward()
    out = {"y": y.detach().numpy(), "dx": _every_rank(x.grad)}
    for k, spec in specs.items():
        out[f"d{k}"] = dist.gather_shard(p[k].grad, spec, mesh).numpy()
    return out


def ssm_config():
    from repro_torch.models.config import ModelConfig, SSMConfig
    # 6 SSD heads of 8 (48 columns) on 4 ranks: 1.5 heads a rank, each
    # rank's ``wo`` rows cut a head; the state (8) splits, the heads do not
    return ModelConfig(name="tp-ssm", layers=1, d_model=32, heads=4,
                       kv_heads=4, d_ff=0, vocab=64, block="ssm",
                       ssm=SSMConfig(state=8, heads=6, head_dim=8, chunk=16),
                       dtype="float32", param_dtype="float32")


SSM_SPECS = {"wx": (None, "model"), "wb": (None, "model"),
             "wc": (None, "model"), "wa": (), "a_bias": (),
             "wo": ("model",)}


def job_ssm(job):
    """``layers.ssm_block`` over a ``model`` mesh from the whole weights'
    parts as JAX's rules give them, one loss sum(w * y): y, dx and the
    whole weights' gradients."""
    from repro_torch.distributed import sharding as dist
    from repro_torch.models.layers import ssm_block
    inp = _inputs(job)
    cfg, mesh = ssm_config(), _mesh(job)
    p = {k: dist.local_shard(torch.from_numpy(inp[k]), spec,
                             mesh).requires_grad_()
         for k, spec in SSM_SPECS.items()}
    x = torch.from_numpy(inp["x"]).requires_grad_()
    with dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
        y, state = ssm_block(p, x, cfg)
        (torch.from_numpy(inp["w"]) * y).sum().backward()
    assert state is None
    out = {"y": _every_rank(y.detach()), "dx": _every_rank(x.grad)}
    for k, spec in SSM_SPECS.items():
        out[f"d{k}"] = dist.gather_shard(p[k].grad, spec, mesh).numpy()
    return out


def moe_config(case):
    from repro_torch.models.config import ModelConfig, MoEConfig
    return ModelConfig(
        name="ep-test", layers=1, d_model=case["d"], heads=4, kv_heads=2,
        d_ff=case["f"], vocab=64, block="attn_moe",
        moe=MoEConfig(num_experts=case["E"], top_k=case["k"],
                      d_ff_expert=case["f"], capacity_factor=case["cf"]),
        dtype="float32", param_dtype="float32")


def job_moe(job):
    """The dense MoE layer over the mesh, each rank its rows of x (over
    the batch axes), its experts (over ``data``) and their ``ff`` columns
    (over ``model``), once as given and once with each expert's ``wo``
    zeroed: the whole outputs (E + 1, B, S, d), every rank's aux loss and
    the experts a rank holds."""
    from repro_torch.distributed import sharding as dist
    from repro_torch.models.moe import moe_block
    inp = _inputs(job)
    case = job["case"]
    cfg, mesh = moe_config(case), _mesh(job)
    specs = {"router": (), "wi": ("data", None, "model"),
             "wg": ("data", None, "model"), "wo": ("data", "model")}
    p = {k: dist.local_shard(torch.from_numpy(inp[k]), spec, mesh)
         for k, spec in specs.items()}
    batch = dist.batch_axes(mesh)
    rows = (batch if len(batch) > 1 else batch[0],)
    x = dist.local_shard(torch.from_numpy(inp["x"]), rows, mesh)
    E = case["E"]
    scales = torch.ones((E + 1, E))
    scales[torch.arange(E), torch.arange(E)] = 0.0
    scales = dist.local_shard(scales, (None, "data"), mesh)
    ys = []
    with dist.use_mesh_rules(mesh, dist.rules_for(cfg, mesh)):
        for s in scales:
            q = dict(p, wo=p["wo"] * s[:, None, None])
            y, aux = moe_block(q, x, cfg, group_size=case["group_size"])
            ys.append(dist.gather_shard(y, rows, mesh))
    return {"y": torch.stack(ys).numpy(),
            "aux": _every_rank(aux.reshape(1)),
            "held": np.int64(p["wi"].shape[0])}


def job_single(job):
    """:func:`job_train` without a mesh on rank ``job["rank"]`` alone,
    which writes its output itself (the single-process reference, run
    beside the other ranks' work)."""
    if tdist.get_rank() == job["rank"]:
        np.savez(job["out"], **job_train(dict(job, mesh=None)))


JOBS = {"a2a": job_a2a, "ring": job_ring, "train": job_train,
        "restart": job_restart, "warm": job_warm, "comm": job_comm,
        "attn": job_attn, "ssm": job_ssm, "moe": job_moe,
        "single": job_single}
