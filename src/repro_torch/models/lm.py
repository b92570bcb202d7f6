"""Pattern language model in PyTorch (counterpart of ``repro.models.lm``)
for attention-only families: parameters, prefill, and the conversion
of the reference's parameters.

Parameters keep the reference's pytree layout — nested dicts and
tuples, with the repeating unit's layers stacked on a leading ``units``
axis — so the two packages can be fed the same weights.  The
reference's ``lax.scan`` over units becomes a Python loop over that
axis (``unit_views``).  Prefill attention runs through
``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.tiered_array import DeviceLike, resolve_device
from ..kernels import ops
from . import modules as M

Params = Dict[str, Any]


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.cross_attn:
            return f"layer kind {spec.kind!r}" + (
                "+cross" if spec.cross_attn else "")
        if spec.moe:
            return "MoE layers (ROADMAP queue 1, the MoE slice)"
    if cfg.encoder_layers:
        return "encoder-decoder models"
    if cfg.pos_emb not in ("rope", "learned", "none"):
        return f"pos_emb {cfg.pos_emb!r}"
    return None


def check_supported(cfg: ModelConfig) -> None:
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention-only models; "
            f"{why} are not ported yet")


# ====================================================================== #
# Parameters                                                             #
# ====================================================================== #
def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tensor_from_numpy(a, device: DeviceLike = "cpu") -> torch.Tensor:
    """One numpy array as a tensor.  bf16 arrays (``ml_dtypes``, what
    ``np.asarray`` of a JAX bf16 array gives) cross bit-exactly through
    an int16 view, since torch cannot read that dtype directly."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:       # e.g. a view of a JAX buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """The reference's parameters, as a tree of numpy arrays, turned
    into the port's (same layout, same dtypes) on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def _normal(shape, std: float, g: torch.Generator, device,
            units: int = 0) -> torch.Tensor:
    """bf16 N(0, std^2) draws; with ``units`` > 0 a (units, *shape)
    stack drawn one unit at a time, so the fp32 transient stays one
    layer in size."""
    if not units:
        return (torch.randn(shape, generator=g, device=device) * std
                ).to(torch.bfloat16)
    out = torch.empty((units, *shape), dtype=torch.bfloat16, device=device)
    for u in range(units):
        out[u] = _normal(shape, std, g, device)
    return out


def _init_layer(cfg: ModelConfig, g: torch.Generator, device) -> Params:
    """One layer of the unit, every leaf stacked over the U units."""
    U, D, F, hd = cfg.n_units, cfg.d_model, cfg.d_ff, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)

    def norm():
        n = {"scale": torch.ones(U, D, device=device)}
        if cfg.norm != "rms":
            n["bias"] = torch.zeros(U, D, device=device)
        return n

    def zeros(n):
        return torch.zeros(U, n, dtype=torch.bfloat16, device=device)

    attn = {"wq": _normal((D, H * hd), s, g, device, U),
            "wk": _normal((D, KV * hd), s, g, device, U),
            "wv": _normal((D, KV * hd), s, g, device, U),
            "wo": _normal((H * hd, D), s, g, device, U)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(H * hd), bk=zeros(KV * hd), bv=zeros(KV * hd))
    mlp = {"w_up": _normal((D, F), s, g, device, U),
           "w_down": _normal((F, D), sf, g, device, U)}
    if cfg.act == "silu":
        mlp["w_gate"] = _normal((D, F), s, g, device, U)
    return {"norm1": norm(), "attn": attn, "norm2": norm(), "mlp": mlp}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    ``device="cpu"``).  The draws differ from the reference's
    ``jax.random`` ones; the scales are the same."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    D = cfg.d_model
    norm = {"scale": torch.ones(D, device=dev)}
    if cfg.norm != "rms":
        norm["bias"] = torch.zeros(D, device=dev)
    p: Params = {
        "embed": _normal((cfg.vocab, D), 0.02, g, dev),
        "final_norm": norm,
        "units": {"layers": tuple(_init_layer(cfg, g, dev)
                                  for _ in cfg.pattern)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((cfg.vocab, D), 0.02, g, dev)
    if cfg.pos_emb == "learned":
        p["pos_emb"] = _normal((cfg.max_pos, D), 0.02, g, dev)
    return p


def unit_views(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-unit parameter views (``units[u]``): the loop body's inputs
    in place of the reference's ``lax.scan`` slices."""
    return [tree_map(lambda t, u=u: t[u], params["units"])
            for u in range(cfg.n_units)]


# ====================================================================== #
# Forward                                                                #
# ====================================================================== #
def _embed_tokens(p: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    x = p["embed"][tokens].to(torch.bfloat16)
    if cfg.pos_emb == "learned":
        x = x + p["pos_emb"][:tokens.shape[1]][None].to(x.dtype)
    return x


def _lm_head(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"] if cfg.tie_embeddings else p["lm_head"]


def project_qkv(cfg: ModelConfig, ap: Params, h: torch.Tensor):
    """q (B, S, H, hd), k/v (B, S, KV, hd) before rotary embedding."""
    B, S = h.shape[0], h.shape[1]
    q, k, v = h @ ap["wq"], h @ ap["wk"], h @ ap["wv"]
    if "bq" in ap:
        q = q + ap["bq"]
    if "bk" in ap:
        k = k + ap["bk"]
        v = v + ap["bv"]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv, cfg.head_dim))


def _unit_prefill(cfg: ModelConfig, up: Params, x: torch.Tensor,
                  positions: torch.Tensor):
    """One unit over the whole prompt; returns (x, [k], [v]) with the
    post-rotary bf16 K/V of each attention layer."""
    B, S, _ = x.shape
    ks, vs = [], []
    for li in range(len(cfg.pattern)):
        lp = up["layers"][li]
        h = M.apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = project_qkv(cfg, lp["attn"], h)
        if cfg.pos_emb == "rope":
            q = M.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
            k = M.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
        att = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
        x = x + att.reshape(B, S, cfg.n_heads * cfg.head_dim) \
            @ lp["attn"]["wo"]
        h = M.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + M.mlp_fwd(lp["mlp"], h, cfg.act)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return x, ks, vs


@torch.no_grad()
def prefill(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            units: Optional[List[Params]] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill: tokens (B, S) -> (last-token logits (B, V) fp32, cache
    {"kv_k", "kv_v": (U, n_attn, B, S, KV, hd) bf16, "index"})."""
    check_supported(cfg)
    tokens = tokens.to(device=p["embed"].device, dtype=torch.int64)
    x = _embed_tokens(p, cfg, tokens)
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)
    kk, vv = [], []
    for up in (units if units is not None else unit_views(p, cfg)):
        x, ks, vs = _unit_prefill(cfg, up, x, positions)
        kk.append(torch.stack(ks))
        vv.append(torch.stack(vs))
    x = M.apply_norm(cfg.norm, p["final_norm"], x[:, -1:])
    logits = (x[:, 0] @ _lm_head(p, cfg).T).float()
    cache = {"kv_k": torch.stack(kk), "kv_v": torch.stack(vv),
             "index": S}
    return logits, cache
