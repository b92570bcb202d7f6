"""Pattern language model in PyTorch (counterpart of ``repro.models.lm``)
for attention-only families, dense or MoE, with bf16 KV caches:
parameters, prefill, the decode step and its cache, the training loss,
and the conversion of the reference's parameters.

Parameters keep the reference's pytree layout — nested dicts and
tuples, with the repeating unit's layers stacked on a leading ``units``
axis — so the two packages can be fed the same weights.  The
reference's ``lax.scan`` over units becomes a Python loop over that
axis (``unit_views``).  Prefill attention runs through
``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU; training attention through the plain
``chunked_attention``, as in the reference's train mode.  A one-token
decode step attends through ``kernels.ops.decode_attention`` (the
kernel on the card); a step of several tokens through the plain
``dense_attention``, as the reference's decode mode does.

Cache layout (the reference's): ``kv_k``/``kv_v`` (U, n_attn, B, S_max,
KV, hd) bf16, plus ``index``, the tokens already in the cache (an int).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
    if cfg.encoder_layers:
        return "encoder-decoder models"
    if cfg.pos_emb not in ("rope", "learned", "none"):
        return f"pos_emb {cfg.pos_emb!r}"
    if cfg.kv_cache_dtype == "int8":
        return "int8 KV caches"
    return None


def check_supported(cfg: ModelConfig) -> None:
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention-only models with bf16 "
            f"KV caches; {why} are not ported yet (ROADMAP queue 1, "
            "item 8)")


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
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        # e.g. a view of a JAX buffer; a 0-d array stays 0-d
        a = np.array(a, order="C")
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
            units: int = 0, dtype: torch.dtype = torch.bfloat16
            ) -> torch.Tensor:
    """N(0, std^2) draws in ``dtype``; with ``units`` > 0 a (units,
    *shape) stack drawn one unit at a time, so the fp32 transient stays
    one layer in size."""
    if not units:
        return torch.randn(shape, generator=g, device=device).mul_(
            std).to(dtype)
    out = torch.empty((units, *shape), dtype=dtype, device=device)
    for u in range(units):
        out[u] = _normal(shape, std, g, device, dtype=dtype)
    return out


def _init_moe(cfg: ModelConfig, g: torch.Generator, device) -> Params:
    """The reference's ``init_moe`` layout, stacked over the U units: an
    fp32 router (D, E) and bf16 experts (E, D, F) / (E, F, D)."""
    U, D, F, E = cfg.n_units, cfg.d_model, cfg.d_ff, cfg.n_experts
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    p = {"router": _normal((D, E), s, g, device, U, torch.float32),
         "w_up": _normal((E, D, F), s, g, device, U),
         "w_down": _normal((E, F, D), sf, g, device, U)}
    if cfg.act == "silu":
        p["w_gate"] = _normal((E, D, F), s, g, device, U)
    return p


def _init_layer(cfg: ModelConfig, spec, g: torch.Generator,
                device) -> Params:
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
    p = {"norm1": norm(), "attn": attn, "norm2": norm()}
    if spec.moe:
        p["moe"] = _init_moe(cfg, g, device)
        return p
    p["mlp"] = {"w_up": _normal((D, F), s, g, device, U),
                "w_down": _normal((F, D), sf, g, device, U)}
    if cfg.act == "silu":
        p["mlp"]["w_gate"] = _normal((D, F), s, g, device, U)
    return p


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
        "units": {"layers": tuple(_init_layer(cfg, spec, g, dev)
                                  for spec in cfg.pattern)},
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
def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  index: Optional[int] = None) -> torch.Tensor:
    """Token embeddings, plus the learned position embeddings of
    positions ``index`` onwards (0 onwards without ``index``).  The
    start is clamped so that the S rows fit, as the reference's
    ``lax.dynamic_slice`` clamps it."""
    x = p["embed"][tokens].to(torch.bfloat16)
    if cfg.pos_emb == "learned":
        S = tokens.shape[1]
        i = 0 if index is None else min(max(int(index), 0),
                                        p["pos_emb"].shape[0] - S)
        x = x + p["pos_emb"][i:i + S][None].to(x.dtype)
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


def ffn(cfg: ModelConfig, spec, lp: Params, h: torch.Tensor):
    """The layer's MLP, or its MoE (``moe_fwd``, capacity and drop as
    the config sets them) where the layer spec says so.  Returns (out,
    MoE aux loss, or None for an MLP)."""
    if spec.moe:
        return M.moe_fwd(lp["moe"], h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         n_groups=cfg.moe_groups, act=cfg.act)
    return M.mlp_fwd(lp["mlp"], h, cfg.act), None


def _unit_fwd(cfg: ModelConfig, up: Params, x: torch.Tensor,
              positions: torch.Tensor, train: bool = False):
    """One unit over the whole sequence; returns (x, MoE aux loss (fp32),
    [k], [v]) with the post-rotary bf16 K/V of each attention layer.
    Attention runs through ``ops.flash_attention`` (the kernel on the
    card) or, with ``train``, through the plain ``chunked_attention``, as
    the reference's train mode does: the kernel has no backward."""
    B, S, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        h = M.apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = project_qkv(cfg, lp["attn"], h)
        if cfg.pos_emb == "rope":
            q = M.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
            k = M.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
        if train:
            att = M.chunked_attention(q, k, v, causal=True,
                                      chunk_q=cfg.attn_chunk,
                                      chunk_kv=cfg.attn_chunk)
        else:
            att = ops.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True)
        x = x + att.reshape(B, S, cfg.n_heads * cfg.head_dim) \
            @ lp["attn"]["wo"]
        h = M.apply_norm(cfg.norm, lp["norm2"], x)
        out, a = ffn(cfg, spec, lp, h)
        x = x + out
        if a is not None:
            aux = aux + a
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return x, aux, ks, vs


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
        x, _, ks, vs = _unit_fwd(cfg, up, x, positions)
        kk.append(torch.stack(ks))
        vv.append(torch.stack(vs))
    x = M.apply_norm(cfg.norm, p["final_norm"], x[:, -1:])
    logits = (x[:, 0] @ _lm_head(p, cfg).T).float()
    cache = {"kv_k": torch.stack(kk), "kv_v": torch.stack(vv),
             "index": S}
    return logits, cache


# ====================================================================== #
# Decode                                                                 #
# ====================================================================== #
def _decode_unit_fwd(cfg: ModelConfig, up: Params, x: torch.Tensor,
                     kv_k: torch.Tensor, kv_v: torch.Tensor, idx: int,
                     lens: Optional[torch.Tensor]) -> torch.Tensor:
    """One unit of a decode step over its caches kv_k/kv_v (n_attn, B,
    S_max, KV, hd): each attention layer writes the step's K/V at
    ``idx`` in place, then attends over ``idx + S`` positions without a
    causal mask, as the reference's decode mode does.  ``lens`` (B,)
    int32 holds ``idx + 1`` for a one-token step, which runs
    ``ops.decode_attention``; None for longer steps (``dense_attention``)."""
    B, S, _ = x.shape
    positions = idx + torch.arange(S, device=x.device)
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        h = M.apply_norm(cfg.norm, lp["norm1"], x)
        q, k, v = project_qkv(cfg, lp["attn"], h)
        if cfg.pos_emb == "rope":
            q = M.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
            k = M.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
        ck, cv = kv_k[li], kv_v[li]                  # (B, S_max, KV, hd)
        ck[:, idx:idx + S] = k.to(ck.dtype)
        cv[:, idx:idx + S] = v.to(cv.dtype)
        if lens is not None:
            att = ops.decode_attention(q[:, 0].contiguous(), ck, cv, lens)
        else:
            att = M.dense_attention(q, ck, cv, causal=False,
                                    kv_len=idx + S)
        x = x + att.reshape(B, S, cfg.n_heads * cfg.head_dim) \
            @ lp["attn"]["wo"]
        h = M.apply_norm(cfg.norm, lp["norm2"], x)
        out, _ = ffn(cfg, spec, lp, h)
        x = x + out
    return x


@torch.no_grad()
def decode_step(p: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor,
                units: Optional[List[Params]] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, S) -> (logits (B, V) fp32, cache).

    The step's K/V are written into the cache's ``kv_k``/``kv_v``
    buffers in place (the reference returns updated copies; its callers
    drop the old cache), and the returned cache holds those buffers and
    ``index + S``.  As in the reference, the logits are those of the
    step's first token."""
    check_supported(cfg)
    dev = p["embed"].device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    idx = int(cache["index"])
    B, S = tokens.shape
    kv_k, kv_v = cache["kv_k"], cache["kv_v"]
    if idx + S > kv_k.shape[3]:
        raise ValueError(f"decode step of {S} token(s) at index {idx} "
                         f"overflows a cache of {kv_k.shape[3]} positions")
    x = _embed_tokens(p, cfg, tokens, index=idx)
    lens = (torch.full((B,), idx + 1, dtype=torch.int32, device=dev)
            if S == 1 else None)
    for u, up in enumerate(units if units is not None
                           else unit_views(p, cfg)):
        x = _decode_unit_fwd(cfg, up, x, kv_k[u], kv_v[u], idx, lens)
    x = M.apply_norm(cfg.norm, p["final_norm"], x)
    logits = (x[:, 0] @ _lm_head(p, cfg).T).float()
    return logits, {"kv_k": kv_k, "kv_v": kv_v, "index": idx + S}


def make_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device: DeviceLike = None) -> Params:
    """Zero-initialized decode cache on ``device`` (CUDA unless
    ``device="cpu"``): ``kv_k``/``kv_v`` (U, n_attn, B, max_seq, KV, hd)
    bf16 and ``index`` 0."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_units, len(cfg.unit_attn_layers), batch, max_seq,
             cfg.n_kv, cfg.head_dim)
    return {"index": 0,
            "kv_k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "kv_v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


# ====================================================================== #
# Training loss                                                          #
# ====================================================================== #
def _stack_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor):
    """The units in order (the reference's ``lax.scan``); with
    ``cfg.remat`` each unit is recomputed in the backward pass, so only
    the unit boundaries are kept.  Returns (x, summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for up in unit_views(p, cfg):
        body = functools.partial(_unit_fwd, cfg, up, train=True)
        if cfg.remat:
            x, a, _, _ = checkpoint(body, x, positions, use_reentrant=False)
        else:
            x, a, _, _ = body(x, positions)
        aux = aux + a
    return x, aux


def _chunk_ce(xi: torch.Tensor, yi: torch.Tensor,
              W: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one sequence chunk, logits in fp32."""
    logits = (xi @ W.T).float()                               # (B,C,V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yi[..., None])[..., 0]
    return torch.sum(lse - gold)


def forward_loss(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 labels: torch.Tensor,
                 cross_inputs: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Training loss, a 0-d fp32 tensor: the mean token cross-entropy,
    computed over chunks of ``cfg.loss_chunk`` positions so the (B, S, V)
    logits never exist at once, plus 0.01 x the MoE aux loss."""
    check_supported(cfg)
    if cross_inputs is not None:
        raise NotImplementedError("cross inputs (encoder-decoder models) "
                                  "are not ported yet")
    dev = p["embed"].device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    labels = labels.to(device=dev, dtype=torch.int64)
    x = _embed_tokens(p, cfg, tokens)
    B, S = tokens.shape
    x, aux = _stack_fwd(cfg, p, x, torch.arange(S, device=dev))
    x = M.apply_norm(cfg.norm, p["final_norm"], x)
    W = _lm_head(p, cfg)
    C = min(cfg.loss_chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"loss_chunk {C}")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for c0 in range(0, S, C):
        xi, yi = x[:, c0:c0 + C], labels[:, c0:c0 + C]
        if cfg.remat:
            total = total + checkpoint(_chunk_ce, xi, yi, W,
                                       use_reentrant=False)
        else:
            total = total + _chunk_ce(xi, yi, W)
    return total / (B * S) + 0.01 * aux
