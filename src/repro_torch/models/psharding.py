"""Logical-axis sharding constraints for model internals (counterpart of
``repro.models.psharding``).

The reference's models call ``constrain(x, "dp", None, "tp", None)``
with *logical* axes; its launcher activates a mapping to concrete mesh
axes per run (``use_mesh``; inactive by default), as the port's does.

A sharding constraint changes no value, so ``constrain`` returns ``x``
itself under any mesh.  The port places activations by the data split
of the batch (``models.shardings.data_shards``: each data shard computes
on its own devices), not by constraints, and its model modules call
``constrain`` nowhere; the mesh state is kept for callers that read
it (``active``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

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
    """``x`` under logical axes 'dp'/'tp'/None: ``x`` itself."""
    return x
