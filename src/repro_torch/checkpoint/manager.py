"""Fault-tolerant checkpointing: atomic, checksummed, async, multi-shard
(the port of ``repro.checkpoint.manager``, over trees of tensors).

The on-disk format is the JAX package's, so either package restores the
other's checkpoints::

    <dir>/step_000123/
        MANIFEST.h<k>.json   {step, host_index, host_count,
                              leaves: {name: {shape, dtype, crc32, file}}}
        <leaf>.h<k>.npy      one file per tree leaf (host-local shard)
    <dir>/LATEST             text file naming the newest *complete* step dir

Leaf names join the path's keys with ``::`` in ``jax.tree_util``'s order
(dict keys sorted, sequences by index), so a port tree of nested dicts and
the JAX tree of the same layout name their leaves alike.

Guarantees, as in the JAX package:

* **Atomicity** — a step directory is written under ``.tmp_step_*`` and
  renamed into place only after every leaf and the manifest are fsynced;
  ``LATEST`` is updated last.
* **Integrity** — every leaf carries a CRC32; ``restore_latest`` verifies
  and falls back to the previous step directory on a mismatch.
* **Async** — ``save_async`` copies every leaf to host memory before it
  returns (:func:`host_copy`: a CPU tensor is cloned, since the port's train
  step updates the state in place and would otherwise write into the
  snapshot), then writes on a background thread, at most one save in
  flight.
* **Restore** puts each leaf back on its template leaf's device and in its
  type (:func:`restore_like`).  numpy has no bf16, so a bf16 leaf raises.

On more than one rank (``layout``: the saved tree's
:class:`~repro_torch.distributed.sharding.Layout` over its mesh: tensor-
parallel, FSDP, ZeRO-1 and expert leaves alike) rank 0 writes the whole
tree in the same format: a sharded leaf is gathered from every rank to
rank 0 alone, leaf by leaf (``Layout.gather_leaf_to``), and the other
ranks wait for the write of a synchronous save.  A restore reads on
rank 0 (falling back past corrupt steps there) and scatters each rank
its part of every sharded leaf; every rank takes part in a save or a
restore, in the same order.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import tree_items as _items
from ..distributed.sharding import tree_rebuild as _rebuild

PyTree = Any

_SEP = "::"


def _name(path) -> str:
    return _SEP.join(str(k) for k in path)


def host_copy(tree: PyTree) -> PyTree:
    """A copy of ``tree`` in host memory that nothing done to ``tree``
    afterwards can change: tensors copied to the CPU (a CPU tensor cloned),
    numpy arrays copied, other leaves kept."""
    def leaf(_, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x
    return _rebuild(tree, leaf)


def restore_like(tree: PyTree, template: PyTree) -> PyTree:
    """New leaves from ``tree`` (a :func:`host_copy` or loaded arrays) on
    each of ``template``'s leaf's device and in its type."""
    flat = dict(_items(tree))

    def leaf(path, want):
        x = flat[path]
        if isinstance(want, torch.Tensor):
            x = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
            return x.to(device=want.device, dtype=want.dtype, copy=True)
        if isinstance(x, np.ndarray):
            return np.array(x, dtype=np.asarray(want).dtype, copy=True)
        return x
    return _rebuild(template, leaf)


def _to_numpy(x) -> np.ndarray:
    """A host array that owns its memory."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bf16 leaf cannot be checkpointed: numpy has "
                            "no bf16")
        x = x.detach()
        return x.numpy().copy() if x.device.type == "cpu" else \
            x.cpu().numpy()
    return np.array(x, copy=True)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    """{name: host array}: each leaf copied out of ``tree``."""
    return {_name(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def _unflatten_like(template: PyTree, flat: Dict[str, np.ndarray]) -> PyTree:
    def leaf(path, want):
        name = _name(path)
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = flat[name]
        shape = tuple(np.shape(want))
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {name}: checkpoint shape {arr.shape} != "
                             f"expected {shape}")
        return arr
    return restore_like(_rebuild(template, leaf), template)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, host_index: int = 0,
                 host_count: int = 1, layout=None):
        self.dir = directory
        self.keep = keep
        self.host_index = host_index
        self.host_count = host_count
        multi = layout is not None and layout.mesh.size > 1
        self.layout = layout if multi else None
        self.writer = self.layout is None or self.layout.mesh.rank == 0
        if self.writer:
            os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step:09d}_h{self.host_index}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "host_index": self.host_index,
                    "host_count": self.host_count, "leaves": {}}
        for name, arr in flat.items():
            safe = name.replace("/", "_")
            fn = f"{safe}.h{self.host_index}.npy"
            path = os.path.join(tmp, fn)
            with open(path, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][name] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "crc32": zlib.crc32(arr.tobytes()), "file": fn,
            }
        mpath = os.path.join(tmp, f"MANIFEST.h{self.host_index}.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # single-host: rename into place; multi-host would barrier here
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def _host_tree(self, tree: PyTree) -> Dict[str, np.ndarray]:
        """{name: host array} of the whole tree (on rank 0; empty on the
        others, which only send their parts)."""
        if self.layout is None:
            return _flatten(tree)
        flat = {}
        for path, leaf in _items(tree):
            if self.layout.sharded(path):
                leaf = self.layout.gather_leaf_to(path, leaf)
            if self.writer:
                flat[_name(path)] = _to_numpy(leaf)
        return flat

    def save(self, step: int, tree: PyTree) -> None:
        """Synchronous save (used at job end and by tests)."""
        self.wait()
        flat = self._host_tree(tree)
        if self.writer:
            self._write(step, flat)
        if self.layout is not None:
            torch.distributed.barrier()

    def save_async(self, step: int, tree: PyTree) -> None:
        """Copy every leaf to host memory now, write in the background
        (at most one save in flight)."""
        self.wait()
        flat = self._host_tree(tree)
        if not self.writer:
            return

        def run():
            try:
                self._write(step, flat)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore ----------------------------------------------------------------
    def available_steps(self):
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def _load_step(self, step: int, template: PyTree) -> PyTree:
        return _unflatten_like(template, self._load_flat(step))

    def _load_flat(self, step: int) -> Dict[str, np.ndarray]:
        d = os.path.join(self.dir, f"step_{step:09d}")
        mpath = os.path.join(d, f"MANIFEST.h{self.host_index}.json")
        with open(mpath) as f:
            manifest = json.load(f)
        flat = {}
        for name, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(d, meta["file"]))
            if zlib.crc32(arr.tobytes()) != meta["crc32"]:
                raise IOError(f"crc mismatch for {name} at step {step}")
            flat[name] = arr
        return flat

    def restore_latest(self, template: PyTree
                       ) -> Tuple[Optional[int], Optional[PyTree]]:
        """Restore the newest valid checkpoint; fall back past corrupt ones."""
        self.wait()
        if self.layout is not None:
            return self._restore_scattered(template)
        for step in reversed(self.available_steps()):
            try:
                return step, self._load_step(step, template)
            except BaseException:
                continue            # corrupt / partial — try the previous one
        return None, None

    def _restore_scattered(self, template: PyTree
                           ) -> Tuple[Optional[int], Optional[PyTree]]:
        """Rank 0 reads the newest valid step; every rank gets its part
        of each leaf (a sharded leaf scattered, the others broadcast)."""
        import torch.distributed as tdist
        from ..distributed.sharding import local_shard
        lay, mesh = self.layout, self.layout.mesh
        found, flat = [None], {}
        if self.writer:
            for step in reversed(self.available_steps()):
                try:
                    flat, found[0] = self._load_flat(step), step
                    break
                except BaseException:
                    continue
        tdist.broadcast_object_list(found, src=0)
        if found[0] is None:
            return None, None

        def leaf(path, want):
            name = _name(path)
            whole = None
            if self.writer:
                if name not in flat:
                    raise KeyError(f"checkpoint missing leaf {name}")
                if tuple(flat[name].shape) != lay.shapes[path]:
                    raise ValueError(
                        f"leaf {name}: checkpoint shape {flat[name].shape}"
                        f" != expected {lay.shapes[path]}")
                whole = torch.from_numpy(flat.pop(name)).to(
                    device=want.device, dtype=want.dtype)
            if not lay.sharded(path):
                if whole is None:
                    whole = torch.empty_like(want)
                tdist.broadcast(whole, src=0)
                return whole
            out = torch.empty_like(want)
            parts = ([local_shard(whole, lay.spec(path), mesh, r)
                      for r in range(mesh.size)] if self.writer else None)
            tdist.scatter(out, parts, src=0)
            return out
        return found[0], _rebuild(template, leaf)
