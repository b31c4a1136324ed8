"""Per-device scratch buffers of the split kernels (K1's split-K partials
and tickets, K2's split partials).

A buffer grows on demand and is used by one launch at a time: the port
launches on one stream.  A captured CUDA graph keeps the addresses it was
captured with, so while any graph holds the workspaces (:meth:`Workspace.
hold`) none of them grows: a launch that would need more raises, and the
engine sizes every workspace before it captures.  The holder keeps the
buffers it was given, so they are not freed under it either.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import torch

#: Every workspace of the port, in the order the kernel modules made them.
WORKSPACES: List["Workspace"] = []


class Workspace:
    """One buffer of ``dtype`` a device, at least ``minimum`` elements,
    zeroed when allocated if ``zeroed`` (each launch leaves it as it found
    it)."""

    def __init__(self, name: str, dtype: torch.dtype, minimum: int, *,
                 zeroed: bool = False):
        self.name = name
        self.dtype = dtype
        self.minimum = minimum
        self.zeroed = zeroed
        self.bufs: Dict[torch.device, torch.Tensor] = {}
        self._holders = weakref.WeakSet()
        WORKSPACES.append(self)

    @staticmethod
    def _device(device) -> torch.device:
        """``cuda`` and ``cuda:<current>`` name one buffer."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def size(self, device) -> int:
        """Elements the device's buffer has now (0 before its first use)."""
        buf = self.bufs.get(self._device(device))
        return 0 if buf is None else buf.numel()

    def get(self, device: torch.device, n: int) -> torch.Tensor:
        """The device's buffer, grown to at least ``n`` elements; raises if
        it would have to grow while a graph holds it."""
        device = self._device(device)
        buf = self.bufs.get(device)
        if buf is None or buf.numel() < n:
            if len(self._holders):
                have = 0 if buf is None else buf.numel()
                raise RuntimeError(
                    f"the {self.name} workspace on {device} has {have} "
                    f"elements and a launch needs {n}, but a captured CUDA "
                    "graph holds it: size it before the capture")
            alloc = torch.zeros if self.zeroed else torch.empty
            buf = alloc(max(n, self.minimum), dtype=self.dtype,
                        device=device)
            self.bufs[device] = buf
        return buf

    def hold(self, holder: object) -> List[torch.Tensor]:
        """Freeze this workspace's size for as long as ``holder`` lives;
        returns its buffers, for the holder to keep."""
        self._holders.add(holder)
        return list(self.bufs.values())

    def release(self, holder: object) -> None:
        self._holders.discard(holder)
