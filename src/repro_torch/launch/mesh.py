"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is a grid of ``torch.device``s with named axes, the
shape and names ``jax.sharding.Mesh`` carries: the partition rules
(``models.shardings``, ``models.psharding``, ``cluster.sharding``) read
only ``axis_names`` and ``devices.shape``.  It is not a
``torch.distributed.DeviceMesh``, which needs a process group for each
device: splitting tensors over several cards is ROADMAP queue 1, item
11 (``MULTI_DEVICE_ITEM``), and until then work is placed on meshes of
one device only.

Functions, not module-level constants, so importing this module never
touches CUDA.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.tiered_array import resolve_device

# what a placement that would split a tensor over more than one device
# raises with: the ROADMAP item that ports it
MULTI_DEVICE_ITEM = "ROADMAP queue 1, item 11 (multi-device sharding)"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``s, one axis
    per name in ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        names = tuple(self.axis_names)
        if devs.ndim != len(names):
            raise ValueError(f"mesh of shape {devs.shape} needs "
                             f"{devs.ndim} axis names, got {names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device a one-device mesh places on."""
        if self.size != 1:
            raise NotImplementedError(
                f"a mesh of {self.size} devices {dict(self.shape)}: "
                f"{MULTI_DEVICE_ITEM}")
        return self.devices.flat[0]


def cuda_devices() -> list:
    """Every CUDA device of this machine; raises when there is none
    (``resolve_device``)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over the first devices of ``devices`` (every
    CUDA device by default).  Raises when the shape needs more devices
    than there are, as ``jax.make_mesh`` does."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else cuda_devices()
    n = math.prod(shape)
    if len(devs) < n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} "
                         f"devices, {len(devs)} available")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512), over
    ``devices`` (every CUDA device by default).  The dry-run passes
    placeholder entries (``placeholder_devices``): it places nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def placeholder_devices(n: int) -> list:
    """``n`` device entries that hold nothing (the ``meta`` device): a
    mesh over them has the production shape for the partition rules,
    and placing a tensor on it is never attempted."""
    return [torch.device("meta")] * n


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_size(mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def tp_size(mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get("model", 1)
