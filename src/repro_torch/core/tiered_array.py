"""Memory kinds on a CUDA host: where a tier-resident tensor lives.

The port's counterpart of the memory-kind mapping of
``repro.core.tiered_array`` (``sharding_for_kind``), which the paged KV
pool uses to place its blocks:

  * ``device``        -> the engine's CUDA device (HBM);
  * ``pinned_host``   -> page-locked CPU memory (``pin_memory``), the
                         CXL-class capacity tier the card reaches by DMA;
  * ``unpinned_host`` -> pageable CPU memory.

Under ``device="cpu"`` all three kinds are logical, as the reference
makes them on a single-memory CPU host: tensors stay in CPU memory and
placement is bookkeeping only.  ``TieredArray`` itself is not ported
yet (it belongs to the one-shot and training paths).
"""
from __future__ import annotations

from typing import Union

import torch

LOGICAL_KINDS = ("device", "pinned_host", "unpinned_host")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for (or implied) and there
    is none — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (--device cpu) to run on the "
                               "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_kind(t: torch.Tensor, kind: str, device: torch.device,
            non_blocking: bool = False) -> torch.Tensor:
    """``t`` placed on memory kind ``kind`` of an engine on ``device``
    (returns ``t`` itself when it already lives there).

    Copies into host memory are blocking, so a host-resident payload is
    complete when this returns.  ``non_blocking`` applies to copies onto
    the device; from pinned memory they overlap with host work.
    """
    if kind not in LOGICAL_KINDS:
        raise ValueError(f"unknown memory kind {kind!r}; "
                         f"choose from {LOGICAL_KINDS}")
    if device.type != "cuda":
        return t.cpu()                       # logical kinds
    if kind == "device":
        return t.to(device, non_blocking=non_blocking)
    if kind == "pinned_host":
        if t.device.type == "cpu" and t.is_pinned():
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out
    if t.device.type == "cpu" and not t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype)     # pageable
    out.copy_(t)
    return out
