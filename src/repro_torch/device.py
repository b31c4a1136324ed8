"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take ``cuda`` (``cuda:LOCAL_RANK`` under torchrun, one
card a rank), and raise when there is no GPU.  They never fall back to the
CPU on their own.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions on "
                               "the CPU")
        local = os.environ.get("LOCAL_RANK")
        return torch.device("cuda" if local is None else f"cuda:{local}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def grow_segments_in_place() -> None:
    """Turn on the CUDA caching allocator's ``expandable_segments`` for this
    process, unless ``PYTORCH_CUDA_ALLOC_CONF`` already sets it; without
    CUDA, nothing.  A training step at full width frees and asks for blocks
    the size of a gradient (2.7 GB for one of llama4-scout's expert weights
    in f32) in an order that leaves the allocator's cached segments split:
    llama4-scout's step beside NCCL's communicator then ran out of memory
    on an 80 GB H100 with 4.8 GiB free in pieces.  Segments that grow in
    place map freed pages anew instead, so a request is refused only when
    the card is full."""
    if not torch.cuda.is_available():
        return
    if "expandable_segments" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""):
        return
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def device_error(e: BaseException) -> bool:
    """Whether ``e`` is an error of the CUDA runtime (an illegal address, a
    launch failure, ...): the context may be lost, so it is fatal, never
    demoted or counted as data."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and bool(
        re.search(r"CUDA (\w+ )?error", str(e)))
