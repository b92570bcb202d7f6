"""Per-request recurrent state slots for the Mamba-2 layers of a hybrid
model, beside the paged KV pool of its attention layers (port only: the
reference's paged engine serves attention-only models).

A Mamba layer's state does not grow with the sequence: each running
request holds one slot of ``(U, n_mamba)`` conv states (d_conv - 1 x
conv_dim, bf16) and SSM states (H x N x P, fp32) on the engine's
device.  A slot is taken when a request is prefilled (prefill writes
its final states there) and freed when it finishes or is preempted
(preemption is recompute: the resumed request prefills again into a
new slot).  One slot more than ``n_slots`` is the padded rows' slot:
the decode step's padded rows read and write it, and no request ever
holds it.

The slots' use is published as counters into the engine's tracer
(``state.slots_in_use``, ``state.bytes_in_use``,
``state.preempted_slots``) and its ``MetricsRegistry``
(``serving.state.*``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..configs.base import ModelConfig


def slot_nbytes(cfg: ModelConfig) -> int:
    """Bytes of one request's slot: every Mamba layer's conv and SSM
    state."""
    from ..models.lm import _mdims
    md = _mdims(cfg)
    layers = cfg.n_units * len(cfg.unit_mamba_layers)
    return layers * ((md.d_conv - 1) * md.conv_dim * 2
                     + md.n_heads * md.d_state * md.head_dim * 4)


def pool_nbytes(cfg: ModelConfig, n_slots: int) -> int:
    """Bytes a ``StateSlotPool`` of ``n_slots`` allocates: the slots and
    the padded rows' slot."""
    return (n_slots + 1) * slot_nbytes(cfg)


class StateSlotPool:
    """``n_slots`` slots (and the padded rows' slot) of every Mamba
    layer's states, on ``device``: ``conv`` (U, n_mamba, n_slots + 1,
    d_conv - 1, conv_dim) bf16 and ``ssm`` (U, n_mamba, n_slots + 1, H,
    N, P) fp32."""

    def __init__(self, cfg: ModelConfig, n_slots: int, device,
                 tracer=None, registry=None):
        from ..models.lm import _mdims
        if n_slots <= 0:
            raise ValueError("n_slots must be positive")
        md = _mdims(cfg)
        U, n = cfg.n_units, len(cfg.unit_mamba_layers)
        self.n_slots = n_slots
        self.slot_nbytes = slot_nbytes(cfg)
        self.conv = torch.zeros((U, n, n_slots + 1, md.d_conv - 1,
                                 md.conv_dim), dtype=torch.bfloat16,
                                device=device)
        self.ssm = torch.zeros((U, n, n_slots + 1, md.n_heads, md.d_state,
                                md.head_dim), dtype=torch.float32,
                               device=device)
        self.pad_slot = n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self.slot: Dict[int, int] = {}          # request id -> slot
        self.preempted_slots = 0
        self.tracer, self.registry = tracer, registry
        self._publish()

    @property
    def nbytes(self) -> int:
        """Bytes of the stores on the device, the padded rows' slot
        included (``pool_nbytes``)."""
        return (self.conv.numel() * self.conv.element_size()
                + self.ssm.numel() * self.ssm.element_size())

    def in_use(self) -> int:
        return len(self.slot)

    def _publish(self) -> None:
        n = self.in_use()
        counters = {"slots_in_use": n,
                    "bytes_in_use": n * self.slot_nbytes,
                    "preempted_slots": self.preempted_slots}
        if self.tracer is not None:
            for name, v in counters.items():
                self.tracer.counter(f"state.{name}", v, cat="state")
        if self.registry is not None:
            self.registry.gauge("serving.state.slots_in_use").set(n)
            self.registry.gauge("serving.state.bytes_in_use").set(
                n * self.slot_nbytes)
            self.registry.gauge("serving.state.bytes_allocated").set(
                self.nbytes)

    def take(self, rid: int) -> int:
        """A free slot for request ``rid``."""
        if not self._free:
            raise RuntimeError(f"no free state slot for request {rid}: "
                               f"all {self.n_slots} are held")
        s = self.slot[rid] = self._free.pop()
        self._publish()
        return s

    def release(self, rid: int, preempted: bool = False) -> None:
        """Free ``rid``'s slot, if it holds one."""
        s = self.slot.pop(rid, None)
        if s is None:
            return
        self._free.append(s)
        if preempted:
            self.preempted_slots += 1
            if self.registry is not None:
                self.registry.counter("serving.state.preempted_slots").inc()
        self._publish()

    def write_prefill(self, rid: int, conv: torch.Tensor,
                      ssm: torch.Tensor) -> None:
        """A prefill's final states into ``rid``'s slot: conv (U,
        n_mamba, d_conv - 1, conv_dim), ssm (U, n_mamba, H, N, P)."""
        s = self.slot[rid]
        self.conv[:, :, s].copy_(conv)
        self.ssm[:, :, s].copy_(ssm)

    def rows(self, rids: Sequence[int], pad_to: int) -> torch.Tensor:
        """The slots of ``rids`` then the padded rows' slot, to
        ``pad_to`` rows: (pad_to,) int32 on the stores' device."""
        ids = [self.slot[r] for r in rids]
        ids += [self.pad_slot] * (pad_to - len(ids))
        return torch.as_tensor(ids, dtype=torch.int32, device=self.ssm.device)
