"""AdamW with mixed precision and bf16 gradient compression (counterpart
of ``repro.optim.adam``).

The state is {master (fp32), m (fp32), v (fp32), step} shaped like the
params, as in the reference.  ``apply_update`` clips by the global norm,
optionally compresses the gradients to bf16 with error feedback, and
updates each leaf either with the plain math (``kernels.ref``) or, with
``use_fused_kernel``, through ``kernels.ops.fused_adam``: the CUDA
kernel on the card, its plain version on the CPU.  The reference streams
layer-stacked leaves through ``lax.map`` only to bound fp32 temporaries;
one call per leaf computes the same function.

Params placed on a mesh (``models.shardings.to_named``, FSDP x TP):
master, m, v and err are placed as the params are (one tensor per
distinct block, ``opt_state_pspecs``), and the update runs once per
distinct block of every leaf (``shardings.per_shard``): AdamW is
elementwise, so each block's update is the whole leaf's restricted to
it.  The global norm counts each block once (``_norm_blocks``).  The
reference's fused Pallas call returns the state replicated; the port
keeps it split.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.utils._pytree as pytree

from ..kernels import ops as kops
from ..kernels import ref as kref
from ..models import shardings as SH

Params = Any

# fp32 elements per chunk of the plain update (256 MiB per temporary)
CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradient compression (bf16 + error feedback)
    compress_grads: bool = False
    # update through kernels.ops.fused_adam (the CUDA kernel on the card)
    use_fused_kernel: bool = False


def init_state(params: Params, cfg: AdamConfig) -> Dict[str, Any]:
    """Fresh state; every leaf is a new tensor (fp32 params are copied,
    not aliased), placed as its parameter is.  ``step`` is a 0-d int32
    tensor on the params' (first) device."""
    def f32(p):
        return SH.per_shard(lambda t: torch.zeros(
            t.shape, dtype=torch.float32, device=t.device), p)

    leaves = pytree.tree_leaves(params)
    state = {
        "master": pytree.tree_map(lambda p: SH.per_shard(
            lambda t: t.detach().to(torch.float32, copy=True), p), params),
        "m": pytree.tree_map(f32, params),
        "v": pytree.tree_map(f32, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None),
    }
    if cfg.compress_grads:
        state["err"] = pytree.tree_map(f32, params)
    return state


def init_state_shapes(param_shapes: Params, cfg: AdamConfig
                      ) -> Dict[str, Any]:
    """The twin of ``init_state`` without storage: every leaf a tensor
    on the ``meta`` device, fp32 in the shape of its parameter (anything
    with a ``shape``; a placed parameter gives a leaf placed alike, each
    block a ``meta`` tensor), and ``step`` a 0-d int32."""
    def f32(p):
        return SH.per_shard(lambda t: torch.empty(
            tuple(t.shape), dtype=torch.float32, device="meta"), p)

    state = {
        "master": pytree.tree_map(f32, param_shapes),
        "m": pytree.tree_map(f32, param_shapes),
        "v": pytree.tree_map(f32, param_shapes),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }
    if cfg.compress_grads:
        state["err"] = pytree.tree_map(f32, param_shapes)
    return state


def _chunked(update, ma, m, v, g, scale, kw):
    """``update`` over row chunks of at most ``CHUNK_ELEMS`` elements of
    one leaf (a 0-d leaf whole); returns (master', m', v') whole."""
    if ma.dim() == 0:
        return update(ma, m, v, g.float() * scale, **kw)
    rows = max(1, CHUNK_ELEMS // max(1, ma[0].numel()))
    outs = tuple(torch.empty_like(ma) for _ in range(3))
    for r0 in range(0, ma.shape[0], rows):
        sl = slice(r0, r0 + rows)
        for out, part in zip(outs, update(ma[sl], m[sl], v[sl],
                                          g[sl].float() * scale, **kw)):
            out[sl] = part
    return outs


def _norm_blocks(g) -> list:
    """The tensors a gradient leaf adds to the global norm: a placed
    leaf's distinct blocks, each once however many devices hold it."""
    if isinstance(g, SH.ShardedTensor):
        return [ts[0] for ts in g.distinct_blocks().values()]
    return [g]


def _global_norm(leaves) -> torch.Tensor:
    parts = [torch.sum(torch.square(t.float()))
             for g in leaves for t in _norm_blocks(g)]
    first = parts[0].device if parts else None
    return torch.sqrt(sum(t.to(first) for t in parts))


def apply_update(params: Params, state: Dict[str, Any], grads: Params,
                 cfg: AdamConfig) -> Tuple[Params, Dict[str, Any]]:
    """One AdamW step.  Returns (new params in the params' dtypes, new
    state); the inputs are not modified."""
    flat_p, spec = pytree.tree_flatten(params)
    flat_g = spec.flatten_up_to(grads)
    step = state["step"] + 1
    if cfg.compress_grads:
        # error-feedback compression: quantize (grad + residual) to bf16,
        # keep the quantization error for the next step (per block)
        def compress(g, e):
            c = (g.float() + e).to(torch.bfloat16)
            return c, g.float() + e - c.float()
        pairs = [SH.per_shard(compress, g, e) for g, e in
                 zip(flat_g, spec.flatten_up_to(state["err"]))]
        flat_g = [c for c, _ in pairs]
        new_err = [e for _, e in pairs]
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    # bias corrections in fp32 from the step counter, as the reference
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    if cfg.use_fused_kernel:
        # read once: the kernel takes them as float arguments
        b1c, b2c = float(b1c), float(b2c)
    kw = dict(lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              wd=cfg.weight_decay, b1c=b1c, b2c=b2c)

    def update(ma, m, v, g):
        # one block (or leaf) on its device
        here = {k: x.to(ma.device) if isinstance(x, torch.Tensor) else x
                for k, x in kw.items()}
        s = scale.to(ma.device)
        if cfg.use_fused_kernel:
            return kops.fused_adam(ma, m, v, g.float() * s, **here)
        return _chunked(kref.fused_adam, ma, m, v, g, s, here)

    new_mast, new_m, new_v, new_p = [], [], [], []
    for p, ma, m, v, g in zip(flat_p, spec.flatten_up_to(state["master"]),
                              spec.flatten_up_to(state["m"]),
                              spec.flatten_up_to(state["v"]), flat_g):
        nm_, m2_, v2_ = SH.per_shard(update, ma, m, v, g)
        new_mast.append(nm_)
        new_m.append(m2_)
        new_v.append(v2_)
        new_p.append(SH.per_shard(lambda t, dt=p.dtype: t.to(dt), nm_))
    out_state = dict(state)
    out_state["master"] = pytree.tree_unflatten(new_mast, spec)
    out_state["m"] = pytree.tree_unflatten(new_m, spec)
    out_state["v"] = pytree.tree_unflatten(new_v, spec)
    out_state["step"] = step
    if cfg.compress_grads:
        out_state["err"] = pytree.tree_unflatten(new_err, spec)
    return pytree.tree_unflatten(new_p, spec), out_state
