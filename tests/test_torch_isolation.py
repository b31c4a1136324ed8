"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its copies of the observability package ``repro_torch.obs``, the fault
harness, the disk tier and the serve plans included."""
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
        "repro_torch.launch.plan_artifacts"} <= set(names), names
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


_IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
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
