"""Logical-axis sharding constraints for model internals (counterpart of
``repro.models.psharding``).

Models call ``constrain(x, "dp", None, "tp", None)`` with *logical*
axes; the launcher activates a mapping to concrete mesh axes per run.
Inactive by default.  Dimensions that don't divide their mesh axes are
replicated (same policy as ``shardings._fit``).

On a mesh of one device a constraint computes nothing, so ``constrain``
returns ``x`` itself wherever every axis it resolves has size 1, and
raises naming ``launch.mesh.MULTI_DEVICE_ITEM`` where it would split
``x`` over more than one device.  The port's model modules call it
nowhere yet: the item that splits tensors over several cards places
the calls.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from ..launch.mesh import MULTI_DEVICE_ITEM

_STATE = {"mesh": None, "dp": (), "tp": None}


def set_mesh(mesh, dp: Sequence[str] = ("data",),
             tp: Optional[str] = "model") -> None:
    _STATE["mesh"] = mesh
    _STATE["dp"] = tuple(dp)
    _STATE["tp"] = tp


@contextlib.contextmanager
def use_mesh(mesh, dp: Sequence[str] = ("data",),
             tp: Optional[str] = "model"):
    old = dict(_STATE)
    set_mesh(mesh, dp, tp)
    try:
        yield
    finally:
        _STATE.update(old)


def active() -> bool:
    return _STATE["mesh"] is not None


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` under logical axes 'dp'/'tp'/None: ``x`` itself where the
    resolved spec splits it over one device."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = []
    n = 1
    for dim, l in zip(x.shape, logical):
        if l == "dp":
            axes = [a for a in _STATE["dp"] if a in sizes]
            total = 1
            for a in axes:
                total *= sizes[a]
            if axes and dim % total == 0:
                spec.append(tuple(axes))
                n *= total
            else:
                spec.append(None)
        elif l == "tp":
            a = _STATE["tp"]
            if a in sizes and dim % sizes[a] == 0:
                spec.append(a)
                n *= sizes[a]
            else:
                spec.append(None)
        else:
            spec.append(None)
    if n > 1:
        raise NotImplementedError(
            f"constrain: {tuple(spec)} splits a tensor of shape "
            f"{tuple(x.shape)} over {n} devices: {MULTI_DEVICE_ITEM}")
    return x
