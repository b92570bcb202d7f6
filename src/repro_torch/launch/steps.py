"""Step builders (counterpart of ``repro.launch.steps``): the training
loss, forward+backward, a whole train step, prefill and the serving
decode step.  Gradients come from torch autograd in place of
``jax.value_and_grad``."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from ..configs.base import ModelConfig
from ..models import lm
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
    neither modified nor given ``.grad``."""
    loss_fn = make_loss_fn(cfg)

    def grad_step(params, batch):
        flat, spec = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in flat]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for t in leaves:
            g = next(got) if t.requires_grad else None
            grads.append(torch.zeros_like(t) if g is None else g)
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    return grad_step


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
