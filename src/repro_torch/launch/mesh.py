"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is a grid of ``torch.device``s with named axes, the
shape and names ``jax.sharding.Mesh`` carries: the partition rules
(``models.shardings``, ``models.psharding``, ``cluster.sharding``) read
only ``axis_names`` and ``devices.shape``.  It is not a
``torch.distributed.DeviceMesh``, which needs a process group for each
device: one process drives every device of the mesh.  A mesh may name
one physical device several times (*logical* devices, ``["cuda:0"] *
4``): ``models.shardings.ShardedTensor`` then keeps one shard per
entry, each at the shard's shape, on that one device.  The serving
plane places its replicas so, and training lays its FSDP x TP meshes
so; a mesh of more physical cards than the machine has raises
(``MULTI_DEVICE_ITEM``).

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

# what a mesh of more entries than this machine's devices raises with,
# where no list of (logical) devices was given: the ROADMAP item that
# runs over several physical cards
MULTI_DEVICE_ITEM = ("ROADMAP queue 1, item 11c (a run over several "
                     "physical cards; pass devices= to lay the mesh over "
                     "logical devices of one)")


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
        flat = np.empty(devs.size, dtype=object)
        flat[:] = [_existing(d) for d in devs.flat]
        object.__setattr__(self, "devices", flat.reshape(devs.shape))
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device a one-device mesh places on; a larger mesh has
        none (``first_device``, ``physical_devices``)."""
        if self.size != 1:
            raise ValueError(
                f"a mesh of {self.size} devices {dict(self.shape)} has no "
                "one device: read first_device or physical_devices")
        return self.devices.flat[0]

    @property
    def first_device(self) -> torch.device:
        """The device that runs the work on replicated operands and
        receives sums and gathers across shards."""
        return self.devices.flat[0]

    @property
    def physical_devices(self) -> list:
        """The distinct devices of the mesh, in order of first entry."""
        return list(dict.fromkeys(self.devices.flat))


def _existing(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA one with its index; raises for
    a CUDA device this machine does not have."""
    d = torch.device(d)
    if d.type == "cuda":
        n = torch.cuda.device_count()
        i = torch.cuda.current_device() if d.index is None and n else d.index
        if i is None or not 0 <= i < n:
            raise ValueError(f"mesh device {d}: this machine has {n} CUDA "
                             "device(s)")
        d = torch.device("cuda", i)
    return d


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
