"""Training launcher of the port: the JAX launcher's loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --steps 100 --device cpu          # plain versions, CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --layers 4 --seq-len 1024 --global-batch 8 --microbatches 2 \
        --steps 6                                  # full width, on the card

The flags are the JAX launcher's (``repro.launch.train``), plus
``--device`` (default: the card) and ``--layers``, which cuts the depth of
the config (and of whisper's encoder) to fit one card: llama3-8b's training
state is 16 bytes a parameter (f32 masters, gradients, AdamW's two
moments), 128 GB at its 32 layers.  The loop: the stateless
``SyntheticLM`` batches, the train step (K1, K4, their batched entries,
K2, K2b, K3 and K3b on
the card), ``warmup_cosine(lr, 10, steps)``, async checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` and a resume from the newest, the
``TrainController``'s restart on failure.  Whisper's ``enc_embeds`` come
from a ``torch.Generator`` seeded by (seed, step): not the JAX launcher's
numbers.  Every config trains: the dense ``attn_mlp`` ones, the ``ssm``
and ``hybrid`` ones (mamba2-130m, hymba-1.5b: K3 and K3b on the card),
whisper-large-v3 and the ``attn_moe`` ones (the experts on K1's and K4's
batched entries).  On one card llama4-scout trains at full width with
``--layers 1`` (4.1 B parameters, 66 GB of state); kimi-k2, whose one
layer and embeddings are 19.4 B parameters, trains at ``--smoke`` size
only (its full width is a multi-card path)::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama4-scout-17b-a16e --layers 1 --seq-len 1024 \
        --global-batch 2 --microbatches 2 --steps 4

Under torchrun (``RANK`` and ``WORLD_SIZE`` in the environment) it starts
the process group (NCCL on the cards, gloo with ``--device cpu``) and
builds ``make_host_mesh()``, as the JAX launcher builds its mesh over the
devices there are, and runs the step over it (``build_train_step(...,
mesh=)``) on the JAX launcher's layout (``launch.specs.state_layout``):
the batch's rows over ``data``, FSDP of ``embed`` over the ranks for
chameleon-34b, llama4-scout and kimi-k2, ZeRO-1 of the optimizer state, a
``moe_a2a`` config's experts over the ranks (the flag comes from the
config, as in the JAX launcher).  Each rank builds its part of the state
leaf by leaf (``launch.specs.rank_state``: one whole leaf at a time).
Rank 0 alone prints and writes checkpoints (the whole tree, gathered)::

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch llama3-8b \
        --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.launch.specs import grad_dtype_for, rank_state
from repro_torch.models import init_train_state
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import (TrainController, build_train_step,
                                 warm_train_dispatch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (decoder and encoder) to fit one "
                         "card")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        kw = {"layers": args.layers}
        if cfg.encoder is not None:
            kw["encoder"] = dataclasses.replace(cfg.encoder,
                                                layers=args.layers)
        cfg = cfg.scaled(**kw)
    dev = resolve_device(args.device)
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
        mesh = make_host_mesh()
    lead = mesh is None or mesh.rank == 0
    opt = make_optimizer(cfg.optimizer,
                         warmup_cosine(args.lr, 10, args.steps))
    step_fn = build_train_step(cfg, opt, microbatches=args.microbatches,
                               grad_dtype=grad_dtype_for(cfg), mesh=mesh)
    layout = None
    if mesh is None:
        params = init_train_state(cfg, seed=args.seed, device=dev)
        opt_state = opt.init(params)
    else:
        params, opt_state, layout = rank_state(cfg, mesh, opt,
                                               seed=args.seed, device=dev)
    warm_train_dispatch(cfg, global_batch=args.global_batch,
                        seq=args.seq_len, microbatches=args.microbatches,
                        mesh=mesh)
    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                global_batch=args.global_batch,
                                seed=args.seed))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2, layout=layout)

    def run_step(state, step):
        params, opt_state = state
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch_at(step).items()}
        if cfg.encoder is not None:
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed * 1_000_003 + step)
            batch["enc_embeds"] = torch.randn(
                (args.global_batch, cfg.encoder.seq_len, cfg.d_model),
                generator=g, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        return (params, opt_state), {k: float(v) for k, v in metrics.items()}

    # resume if a checkpoint exists
    start = 0
    restored_step, restored = ckpt.restore_latest((params, opt_state))
    if restored is not None:
        params, opt_state = restored
        start = restored_step
        if lead:
            print(f"resumed from step {start}")

    ctl = TrainController(run_step, ckpt, ckpt_every=args.ckpt_every)
    t0 = time.time()
    (params, opt_state), hist = ctl.run(
        (params, opt_state), start_step=start, num_steps=args.steps)
    dt = time.time() - t0
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if not lead:
        return

    for h in hist[::max(1, len(hist) // (args.steps // args.log_every or 1))]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  {h['step_time_s']*1e3:.0f}ms")
    toks = args.steps * args.global_batch * args.seq_len
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    if mesh is not None:
        where += f" on {mesh.size} ranks"
    print(f"done: {len(hist)} steps on {where}, {toks/dt:.0f} tok/s, "
          f"final loss {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
