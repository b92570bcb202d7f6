"""Step builders (counterpart of ``repro.launch.steps``): the training
loss, forward+backward, a whole train step, prefill and the serving
decode step.  Gradients come from torch autograd in place of
``jax.value_and_grad``."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from ..configs.base import ModelConfig
from ..models import lm, shardings as SH
from ..optim import adam


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        return lm.forward_loss(params, cfg, batch["tokens"],
                               batch["labels"], batch.get("frames"))
    return loss_fn


def make_grad_step(cfg: ModelConfig) -> Callable:
    """Forward+backward only: ``grad_step(params, batch) -> (loss,
    grads)``, grads in the params' tree layout and dtypes (bf16 params
    get bf16 grads, as ``jax.value_and_grad`` gives).  The params are
    neither modified nor given ``.grad``.

    Params placed on a mesh (``models.shardings.to_named``): the leaves
    that require grad are each placed leaf's distinct blocks, and the
    grads come back placed alike (``ShardedTensor``s with the params'
    specs).  ``lm.loss_terms`` splits the batch over the data axes and
    each data shard gathers what it reads, so autograd hands every
    block the sum of its gradient over the data shards (the
    reduce-scatter); copies of one block on several physical devices
    then get the sum of their gradients (the all-reduce)."""
    loss_fn = make_loss_fn(cfg)

    def grad_step(params, batch):
        flat, spec = pytree.tree_flatten(params)
        leaves = [SH.per_shard(_wrt, t) for t in flat]
        wrt = [x for t in leaves for x in SH.local_tensors(t)
               if x.requires_grad]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
            got = dict(zip(map(id, wrt), torch.autograd.grad(
                loss, wrt, allow_unused=True)))
        grads = [SH.per_shard(lambda x: _grad_of(x, got), t) for t in leaves]
        return loss.detach(), pytree.tree_unflatten(
            [_all_reduce(g) for g in grads], spec)

    return grad_step


def _wrt(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(t.is_floating_point())


def _grad_of(x: torch.Tensor, got: dict) -> torch.Tensor:
    g = got.get(id(x)) if x.requires_grad else None
    return torch.zeros_like(x) if g is None else g


def _all_reduce(g):
    """A placed gradient whose block has copies on several physical
    devices: each copy replaced by the sum of them all."""
    if not isinstance(g, SH.ShardedTensor):
        return g
    total = {}
    for key, ts in g.distinct_blocks().items():
        if len(ts) > 1:
            s = sum(t.to(ts[0].device) for t in ts)
            for t in ts:
                total[id(t)] = s if t.device == s.device else s.to(t.device)
    if not total:
        return g
    return SH.ShardedTensor(g.shape, g.spec, g.mesh,
                            [total.get(id(t), t) for t in g.shards])


def make_train_step(cfg: ModelConfig,
                    adam_cfg: Optional[adam.AdamConfig] = None) -> Callable:
    adam_cfg = adam_cfg or adam.AdamConfig()
    grad_step = make_grad_step(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = grad_step(params, batch)
        new_params, new_state = adam.apply_update(params, opt_state, grads,
                                                  adam_cfg)
        return new_params, new_state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, units=None):
        return lm.prefill(params, cfg, batch["tokens"],
                          batch.get("frames"), units=units)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens, units=None):
        return lm.decode_step(params, cfg, cache, tokens, units=units)
    return serve_step
