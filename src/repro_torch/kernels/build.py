"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface, loaded with :mod:`ctypes` — no PyTorch headers, so a build takes
seconds.  Libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: importing the package or running the CPU tests
never invokes ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("matmul", "matmul_experts", "flash_attention",
           "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd", "matadd",
           "transpose", "jacobi1d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    """Start one nvcc (None when the library is already built)."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu:\n{log}")
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(log)
    os.replace(log_tmp, out.with_suffix(".log"))
    os.replace(tmp, out)                      # atomic: racing builds agree


def build_log(name: str) -> str:
    """nvcc's output for the built library of ``csrc/<name>.cu``, kept
    beside it (``-Xptxas -v``: each kernel's registers, shared memory and
    spills); empty when it was not built here."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def build_all() -> float:
    """Build every source in parallel (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        nvcc = find_nvcc()
        procs = {n: _start(n, nvcc) for n in SOURCES if n not in _LIBS}
        for n, p in procs.items():
            _finish(n, p)
        for n in procs:
            _LIBS[n] = ctypes.CDLL(str(_lib_path(n)))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name, find_nvcc()))
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def entry(name: str, symbol: str, argtypes) -> Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared; it returns a ``cudaError_t``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
