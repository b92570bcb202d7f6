"""ZeRO-Offload training engine (paper Sec. IV-A; counterpart of
``repro.offload.train_engine``).

  * fp32 master params and Adam moments live as ``TieredArray``s on the
    memory kinds of a placement policy (the paper's interleaving study:
    LDRAM-only / +CXL / interleave-all map to shares across ``device``,
    ``pinned_host`` and ``unpinned_host``);
  * each step: the card computes loss and bf16 grads; the grads go to
    pinned host buffers (allocated once, reused every step); per leaf,
    master/m/v/g are gathered to the card, updated by ``fused_adam``
    (the CUDA kernel) and written back into their blocks in place; the
    bf16 params are cast from the new masters.
  * the step time splits as Fig. 9 does: {fwd_bwd, grad_xfer, optimizer,
    param_xfer}, each phase timed on the host clock after a
    ``torch.cuda.synchronize()``.

As in the reference, the update runs where ``gather`` materializes, the
card, so the new params are already there and ``param_xfer`` only
installs them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from ..configs.base import ModelConfig
from ..core.tiered_array import DeviceLike, resolve_device, TieredArray
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..launch import steps as steps_mod
from ..optim import adam


@dataclasses.dataclass
class OffloadConfig:
    # fraction shares of opt-state bytes per memory kind — the paper's
    # interleaving policies expressed directly:
    #   LDRAM only      -> [("device", 1.0)]
    #   LDRAM + CXL     -> [("device", .5), ("unpinned_host", .5)]
    #   interleave all  -> thirds
    opt_state_shares: Sequence[Tuple[str, float]] = (("pinned_host", 1.0),)
    use_fused_kernel: bool = True
    adam: adam.AdamConfig = dataclasses.field(default_factory=adam.AdamConfig)


def emit_step_traffic(telemetry, param_bytes: int) -> None:
    """Record one train step's per-phase traffic (the Fig. 9 phases):
    params read twice on fwd/bwd, grads streamed device->host, fp32
    master+m+v (6x the bf16 param bytes) read and rewritten by the
    optimizer, updated params streamed back."""
    pb = param_bytes
    telemetry.observe("params_bf16", 2 * pb, 0, 0.0, phase="fwd_bwd")
    telemetry.observe("grads_bf16", pb, pb, 0.0, phase="grad_xfer")
    telemetry.observe("opt_state_fp32", 6 * pb, 6 * pb, 0.0,
                      phase="optimizer")
    telemetry.observe("params_bf16", 0, pb, 0.0, phase="param_xfer")
    telemetry.advance_epoch()


@dataclasses.dataclass
class StepTiming:
    fwd_bwd_s: float
    grad_xfer_s: float
    optimizer_s: float
    param_xfer_s: float
    loss: float

    @property
    def total_s(self) -> float:
        return (self.fwd_bwd_s + self.grad_xfer_s + self.optimizer_s
                + self.param_xfer_s)


class ZeroOffloadEngine:
    """Single-device engine with real host-tier placement of the
    optimizer state.  Runs on CUDA unless ``device="cpu"`` (then every
    memory kind is logical CPU memory).

    ``telemetry`` (an object with ``observe`` and ``advance_epoch``, as
    the reference's AccessTrace) receives one event per Fig.-9 phase
    per step; it is optional, as in the reference."""

    def __init__(self, cfg: ModelConfig, params: Any,
                 off: Optional[OffloadConfig] = None,
                 telemetry=None, device: DeviceLike = None):
        self.cfg = cfg
        self.off = off or OffloadConfig()
        self.device = resolve_device(device)
        self.telemetry = telemetry
        self.params = pytree.tree_map(lambda t: t.to(self.device), params)
        self.grad_step = steps_mod.make_grad_step(cfg)
        shares = list(self.off.opt_state_shares)

        def state(p, zero):
            if zero:
                return TieredArray.alloc(p.shape, torch.float32, shares,
                                         device=self.device, zero=True)
            return TieredArray.place(p.float(), shares, device=self.device)

        # host-resident fp32 state, one leaf at a time (the fp32 copy of
        # a param is a transient of one leaf)
        self.master = pytree.tree_map(lambda p: state(p, False),
                                      self.params)
        self.m = pytree.tree_map(lambda p: state(p, True), self.params)
        self.v = pytree.tree_map(lambda p: state(p, True), self.params)
        # the grads' pinned host buffers, reused by every step
        self.grads_host = pytree.tree_map(
            lambda p: TieredArray.alloc(p.shape, p.dtype,
                                        [("pinned_host", 1.0)],
                                        device=self.device), self.params)
        self.step_count = 0

    # ------------------------------------------------------------------ #
    def _param_bytes(self) -> int:
        return sum(p.nbytes for p in pytree.tree_leaves(self.params))

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ------------------------------------------------------------------ #
    def train_step(self, batch: Dict[str, Any]) -> StepTiming:
        """One step on ``batch`` ({"tokens", "labels"}: (B, S) ints,
        numpy or tensors)."""
        o = self.off.adam
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        t0 = self._sync()
        loss, grads = self.grad_step(self.params, batch)
        t1 = self._sync()

        # gradient transfer: into the pinned host buffers
        flat_p, spec = pytree.tree_flatten(self.params)
        fg = spec.flatten_up_to(self.grads_host)
        for gh, g in zip(fg, spec.flatten_up_to(grads)):
            gh.update(g, non_blocking=True)
        del grads
        t2 = self._sync()

        # fused Adam over each leaf, on the device (the paper's optimizer
        # step, fed from and written back to the state's placement)
        self.step_count += 1
        b1c = 1.0 - o.b1 ** self.step_count
        b2c = 1.0 - o.b2 ** self.step_count
        update = kops.fused_adam if self.off.use_fused_kernel \
            else kref.fused_adam
        new_params = []
        for p, ma, mm, vv, gg in zip(flat_p, spec.flatten_up_to(self.master),
                                     spec.flatten_up_to(self.m),
                                     spec.flatten_up_to(self.v), fg):
            nm, m2, v2 = update(ma.gather(), mm.gather(), vv.gather(),
                                gg.gather(), lr=o.lr, b1=o.b1, b2=o.b2,
                                eps=o.eps, wd=o.weight_decay, b1c=b1c,
                                b2c=b2c)
            ma.update(nm, non_blocking=True)
            mm.update(m2, non_blocking=True)
            vv.update(v2, non_blocking=True)
            new_params.append(nm.to(p.dtype))
        t3 = self._sync()

        # param transfer: the new bf16 params onto the device
        self.params = pytree.tree_unflatten(
            [p.to(self.device, non_blocking=True) for p in new_params], spec)
        t4 = self._sync()

        if self.telemetry is not None:
            emit_step_traffic(self.telemetry, self._param_bytes())

        return StepTiming(t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                          float(loss))

    def opt_state_bytes_on(self, kind: str) -> int:
        return sum(leaf.bytes_on(kind)
                   for t in (self.master, self.m, self.v)
                   for leaf in pytree.tree_leaves(t))
