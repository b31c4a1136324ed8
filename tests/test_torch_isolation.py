"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its copies of the observability package ``repro_torch.obs``, the fault
harness, the disk tier, the serve plans, the MoE layer, the config
modules (whisper-large-v3's too), the non-paged serve steps, the tuning
package and the kernel monitor, and the training path (optimizers, data,
checkpoints, the autograd functions and K2b, the train launcher) and the
multi-rank path (the mesh, the sharding rules, the collectives, the int8
ring, the all-to-all MoE layer; the tensor-parallel layers, FSDP's
gathers, the sharded step and ZeRO-1) and the dry run (its collective
record, the ring model, the count of a launch's work) included.  Each
module the sharded step or the dry run changed also imports first,
alone, in a fresh process."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax...` now raises
sys.modules["repro"] = None        # ...and so does `import repro...`
import repro_torch
import repro_torch.obs
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.obs.events", "repro_torch.obs.recorder",
        "repro_torch.obs.registry",
        "repro_torch.runtime.ft", "repro_torch.runtime.faults",
        "repro_torch.artifacts.serde", "repro_torch.artifacts.store",
        "repro_torch.artifacts.compile", "repro_torch.plans.serde",
        "repro_torch.plans.store", "repro_torch.plans.loader",
        "repro_torch.launch.compile_artifacts",
        "repro_torch.launch.plan_artifacts", "repro_torch.models.moe",
        "repro_torch.configs.granite_3_8b", "repro_torch.configs.yi_6b",
        "repro_torch.configs.qwen1p5_4b", "repro_torch.configs.chameleon_34b",
        "repro_torch.configs.llama4_scout_17b_a16e",
        "repro_torch.configs.kimi_k2_1t_a32b",
        "repro_torch.tuning.measure", "repro_torch.tuning.calibrate",
        "repro_torch.tuning.compact", "repro_torch.runtime.monitor",
        "repro_torch.launch.tune_artifacts",
        "repro_torch.configs.whisper_large_v3", "repro_torch.runtime.steps",
        "repro_torch.plans.trace", "repro_torch.optim.optimizers",
        "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
        "repro_torch.kernels.autograd",
        "repro_torch.kernels.flash_attention_bwd",
        "repro_torch.launch.train", "repro_torch.launch.specs",
        "repro_torch.launch.mesh", "repro_torch.distributed",
        "repro_torch.distributed.sharding",
        "repro_torch.distributed.compression",
        "repro_torch.distributed.comm", "repro_torch.models.moe_a2a",
        "repro_torch.models.layers", "repro_torch.models.transformer",
        "repro_torch.launch.dryrun", "repro_torch.launch.comm_analysis",
        "repro_torch.launch.roofline"
        } <= set(names), names
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30       # every submodule was imported


#: the modules the sharded step (tensor parallelism, FSDP, ZeRO-1, the
#: dense MoE layer's expert parallelism) changed
SHARDED_STEP = ["repro_torch.distributed.comm",
                "repro_torch.distributed.sharding",
                "repro_torch.launch.mesh", "repro_torch.launch.specs",
                "repro_torch.launch.train",
                "repro_torch.models.layers", "repro_torch.models.transformer",
                "repro_torch.models.moe_a2a", "repro_torch.models.moe",
                "repro_torch.runtime.steps",
                "repro_torch.optim.optimizers",
                "repro_torch.checkpoint.manager", "repro_torch.plans.trace"]
#: the dry run's modules
DRY_RUN = ["repro_torch.launch.dryrun", "repro_torch.launch.comm_analysis",
           "repro_torch.launch.roofline"]


@pytest.mark.parametrize("module", SHARDED_STEP + DRY_RUN)
def test_sharded_step_module_imports_first_with_jax_and_repro_blocked(
        module):
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            f"import {module}; "
            "assert not [m for m in sys.modules if (m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))"
            " and sys.modules[m] is not None]")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "chip_k4.py", "chip_k3b.py", "chip_moe.py"]))
def test_no_source_imports_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT_RE.search(text), path


def test_import_never_builds_kernels(tmp_path):
    """Importing the port (and resolving a kernel pick) leaves the build
    directory untouched: nvcc runs only at a kernel's first launch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "kbuild"))
    code = ("from repro_torch.kernels import ops; import torch;"
            "a = torch.ones(4, 8); print(ops.matmul(a, torch.ones(8, 3))"
            ".sum().item())")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == 96.0
    assert not (tmp_path / "kbuild").exists()
