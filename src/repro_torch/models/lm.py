"""Pattern language model in PyTorch (counterpart of ``repro.models.lm``):
one implementation for every architecture of the registry, a repeating
*unit* of layers (attention, gated cross-attention, Mamba or RWKV, each
optionally MoE; Whisper-style layers add a cross-attention sublayer)
over ``n_units`` units, plus the Whisper encoder.  Parameters, prefill,
the decode step and its cache, the training loss, and the conversion of
the reference's parameters.

Parameters keep the reference's pytree layout — nested dicts and
tuples, with the repeating unit's layers stacked on a leading ``units``
axis — so the two packages can be fed the same weights.  The
reference's ``lax.scan`` over units becomes a Python loop over that
axis (``unit_views``).

Attention routes:
  * causal self-attention in prefill: ``kernels.ops.flash_attention``
    (the CUDA kernel on the card, its plain version on the CPU);
  * one-token steps, self-attention over the KV cache and
    cross-attention over the cached ``cross_k``/``cross_v`` (kv_len =
    S_enc): ``kernels.ops.decode_attention`` (the kernel on the card);
  * non-causal attention over a whole sequence (the Whisper encoder,
    cross-attention in prefill), all training attention, and decode
    steps of several tokens: the plain ``chunked_attention`` /
    ``dense_attention``, as the reference's train and decode modes
    compute them.  (The flash wrapper refuses non-causal attention over
    a key length that is not a multiple of 128, as the reference's
    does; the encoder's 1500 frames and the 1600 image tokens are not.)
An int8 KV cache is dequantized to bf16 for its attention, as in the
reference.

Prefill and the decode step also take parameters placed on a mesh
(``cluster.sharding.shard_lm_params``, through
``shardings.compute_view``): a vocab-split ``embed`` is looked up block
by block (``shardings.embed_rows``), a vocab-split head gives its logits
as a ``shardings.ShardedTensor`` of fp32 blocks (``vocab_logits``: read
them with ``shardings.argmax`` or ``shardings.gather``), and
expert-split MoE stacks run in ``modules.moe_fwd`` block by block.  The
training loss takes parameters placed for training
(``shardings.to_named``, FSDP x TP): ``loss_terms`` runs the batch's
data shards in turn, each gathering what it reads (``local_params``),
the vocab and expert splits kept.

Cache layout (the reference's; axis 0 = unit):
  kv_k/kv_v        (U, n_attn, B, S_max, KV, hd)  bf16, or int8 with
  kv_k/v_scale     (U, n_attn, B, S_max, KV)      bf16
  conv/ssm         (U, n_mamba, B, K-1, d_inner) bf16 / (U, n_mamba, B,
                   H, N, P) fp32
  wkv/shift_t/c    (U, n_rwkv, B, H, P, P) fp32 / (U, n_rwkv, B, D) bf16
  cross_k/cross_v  (U, n_cross, B, S_enc, KV, hd) bf16
plus ``index``, the tokens already in the cache (an int).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerSpec, ModelConfig
from ..core.tiered_array import DeviceLike, resolve_device
from ..kernels import ops
from . import modules as M
from . import shardings as SH

Params = Dict[str, Any]


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


ENC_SPEC = LayerSpec(kind="attn")
CACHE_KEYS = ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale", "conv", "ssm",
              "wkv", "shift_t", "shift_c", "cross_k", "cross_v")


def _mdims(cfg: ModelConfig) -> M.MambaDims:
    return M.mamba_dims(cfg.d_model, cfg.mamba_expand, cfg.mamba_head_dim,
                        cfg.mamba_d_state, cfg.mamba_d_conv, cfg.ssd_chunk,
                        cfg.mamba_groups)


def norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The config's norm, at its ``norm_eps`` where one is set."""
    return M.apply_norm(cfg.norm, p, x, cfg.norm_eps or None)


def residual(cfg: ModelConfig, x: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """x plus a sublayer's output, scaled by ``residual_multiplier``."""
    if cfg.residual_multiplier == 1.0:
        return x + out
    return x + out * cfg.residual_multiplier


def head_logits(cfg: ModelConfig, x: torch.Tensor, W):
    """fp32 logits of the head ``W`` (``shardings.vocab_logits``),
    divided by ``logits_scaling``."""
    logits = SH.vocab_logits(x, W)
    if cfg.logits_scaling == 1.0:
        return logits
    if SH.is_split(logits):
        raise ValueError(f"{cfg.name}: logits_scaling over a vocab-split "
                         "head is not supported")
    return logits / cfg.logits_scaling


def mamba_mixer(cfg: ModelConfig, mp: Params, h: torch.Tensor,
                conv_state=None, ssm_state=None):
    """The config's Mamba block over a whole sequence: the published
    Mamba-2 (``mamba2_fwd``) where ``mamba_groups`` is set, else the
    reference's SSD block.  Returns (out, (conv_state, ssm_state))."""
    if cfg.mamba_groups:
        return M.mamba2_fwd(mp, h, _mdims(cfg), conv_state, ssm_state,
                            eps=cfg.norm_eps or 1e-6)
    return M.mamba_fwd(mp, h, _mdims(cfg), conv_state=conv_state,
                       ssm_state=ssm_state)


def mamba_step(cfg: ModelConfig, mp: Params, h: torch.Tensor,
               conv_store: torch.Tensor, ssm_store: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """One decode token of the published Mamba-2 block per row, on the
    rows' state slots in place (``modules.mamba2_step``)."""
    return M.mamba2_step(mp, h, _mdims(cfg), conv_store, ssm_store, slots,
                         eps=cfg.norm_eps or 1e-6)


def _rdims(cfg: ModelConfig) -> M.RwkvDims:
    return M.rwkv_dims(cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim,
                       cfg.rwkv_chunk)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The Whisper encoder's config: one attention layer per unit over
    ``encoder_layers`` units, sinusoidal positions (no rotary)."""
    return dataclasses.replace(cfg, pattern=(ENC_SPEC,),
                               n_layers=cfg.encoder_layers,
                               pos_emb="sinusoidal")


def _needs_cross_inputs(cfg: ModelConfig) -> bool:
    """Whether prefill and the loss take ``cross_inputs`` (image
    embeddings, or the frames the encoder reads)."""
    return bool(cfg.encoder_layers) or any(
        s.kind == "cross" or s.cross_attn for s in cfg.pattern)


def _init_norm(kind: str, D: int, device, U: int = 0) -> Params:
    lead = (U,) if U else ()
    n = {"scale": torch.ones(*lead, D, device=device)}
    if kind != "rms":
        n["bias"] = torch.zeros(*lead, D, device=device)
    return n


def _init_attention(cfg: ModelConfig, g, device, U: int,
                    bias: bool) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = 1.0 / math.sqrt(D)
    p = {"wq": M.randn((D, H * hd), s, g, device, U),
         "wk": M.randn((D, KV * hd), s, g, device, U),
         "wv": M.randn((D, KV * hd), s, g, device, U),
         "wo": M.randn((H * hd, D), s, g, device, U)}
    if bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(U, n, dtype=torch.bfloat16, device=device)
    return p


def _init_moe(cfg: ModelConfig, g: torch.Generator, device,
              U: int) -> Params:
    """The reference's ``init_moe`` layout, stacked over the U units: an
    fp32 router (D, E) and bf16 experts (E, D, F) / (E, F, D)."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    p = {"router": M.randn((D, E), s, g, device, U, torch.float32),
         "w_up": M.randn((E, D, F), s, g, device, U),
         "w_down": M.randn((E, F, D), sf, g, device, U)}
    if cfg.act == "silu":
        p["w_gate"] = M.randn((E, D, F), s, g, device, U)
    return p


def _init_layer(cfg: ModelConfig, spec: LayerSpec, g: torch.Generator,
                device, U: int) -> Params:
    """One layer of the unit (the reference's ``_init_layer``), every
    leaf stacked over the U units."""
    D, F, hd, KV = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_kv
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    if spec.kind == "rwkv":
        rd = _rdims(cfg)
        return {"norm1": _init_norm("ln", D, device, U),
                "tmix": M.init_rwkv_tmix(rd, g, device, U),
                "norm2": _init_norm("ln", D, device, U),
                "cmix": M.init_rwkv_cmix(rd, g, device, U)}
    p: Params = {"norm1": _init_norm(cfg.norm, D, device, U)}
    if spec.kind == "attn":
        p["attn"] = _init_attention(cfg, g, device, U, cfg.qkv_bias)
    elif spec.kind == "cross":
        p["attn"] = _init_attention(cfg, g, device, U, cfg.qkv_bias)
        # projections applied to the cross inputs; the tanh gates start
        # at 0, which silences the layer until they are trained
        p["xkv"] = {"wk": M.randn((D, KV * hd), s, g, device, U),
                    "wv": M.randn((D, KV * hd), s, g, device, U)}
        p["gate_attn"] = torch.zeros(U, device=device)
        p["gate_mlp"] = torch.zeros(U, device=device)
    elif spec.kind == "mamba":
        p["mamba"] = (M.init_mamba2 if cfg.mamba_groups else M.init_mamba)(
            _mdims(cfg), g, device, U)
    else:
        raise ValueError(spec.kind)
    if spec.cross_attn:          # Whisper-style extra cross sublayer
        p["cross_norm"] = _init_norm(cfg.norm, D, device, U)
        p["cross"] = _init_attention(cfg, g, device, U, False)
    p["norm2"] = _init_norm(cfg.norm, D, device, U)
    if cfg.shared_expert_ff:
        Fs = cfg.shared_expert_ff
        p["shared"] = {"w_gate": M.randn((D, Fs), s, g, device, U),
                       "w_up": M.randn((D, Fs), s, g, device, U),
                       "w_down": M.randn((Fs, D), 1.0 / math.sqrt(Fs), g,
                                         device, U)}
    if spec.moe:
        p["moe"] = _init_moe(cfg, g, device, U)
        return p
    p["mlp"] = {"w_up": M.randn((D, F), s, g, device, U),
                "w_down": M.randn((F, D), sf, g, device, U)}
    if cfg.act == "silu":
        p["mlp"]["w_gate"] = M.randn((D, F), s, g, device, U)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    ``device="cpu"``).  The draws differ from the reference's
    ``jax.random`` ones; the scales are the same."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    D = cfg.d_model
    p: Params = {
        "embed": M.randn((cfg.vocab, D), 0.02, g, dev),
        "final_norm": _init_norm(cfg.norm, D, dev),
        "units": {"layers": tuple(_init_layer(cfg, spec, g, dev,
                                              cfg.n_units)
                                  for spec in cfg.pattern)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = M.randn((cfg.vocab, D), 0.02, g, dev)
    if cfg.pos_emb == "learned":
        p["pos_emb"] = M.randn((cfg.max_pos, D), 0.02, g, dev)
    if cfg.encoder_layers:
        p["encoder"] = {
            "units": {"layers": (_init_layer(cfg, ENC_SPEC, g, dev,
                                             cfg.encoder_layers),)},
            "final_norm": _init_norm(cfg.norm, D, dev)}
    return p


def _views(tree: Params, n: int) -> List[Params]:
    return [tree_map(lambda t, u=u: t[u], tree) for u in range(n)]


def unit_views(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-unit parameter views (``units[u]``): the loop body's inputs
    in place of the reference's ``lax.scan`` slices.  A leaf placed on a
    mesh gives the ``ShardedTensor`` of its blocks' unit-``u`` views
    (nothing gathered)."""
    return _views(params["units"], cfg.n_units)


# ====================================================================== #
# Forward                                                                #
# ====================================================================== #
def _sinusoidal(S: int, D: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """(S, D) fp32 sinusoidal position table of positions ``offset``
    onwards: sin on even columns, cos on odd ones."""
    pos = torch.arange(S, device=device)[:, None] + offset
    dim = torch.arange(0, D, 2, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / D)
    out = torch.zeros((S, D), device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  index: Optional[int] = None) -> torch.Tensor:
    """Token embeddings, plus the position embeddings of positions
    ``index`` onwards (0 onwards without ``index``): learned rows (the
    start clamped so that the S rows fit, as the reference's
    ``lax.dynamic_slice`` clamps it) or the sinusoidal table."""
    x = SH.embed_rows(p["embed"], tokens).to(torch.bfloat16)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    S = tokens.shape[1]
    if cfg.pos_emb == "learned":
        i = 0 if index is None else min(max(int(index), 0),
                                        p["pos_emb"].shape[0] - S)
        x = x + p["pos_emb"][i:i + S][None].to(x.dtype)
    elif cfg.pos_emb == "sinusoidal":
        x = x + _sinusoidal(S, cfg.d_model, 0 if index is None else
                            int(index), x.device)[None].to(x.dtype)
    return x


def _lm_head(p: Params, cfg: ModelConfig) -> torch.Tensor:
    return p["embed"] if cfg.tie_embeddings else p["lm_head"]


def project_qkv(cfg: ModelConfig, ap: Params, h: torch.Tensor):
    """q (B, S, H, hd), k/v (B, S, KV, hd) before rotary embedding.
    Under ``attention_multiplier`` q is scaled by it times sqrt(hd), so
    that attention's 1/sqrt(hd) gives the published softmax scale (the
    kernels take no scale; q takes one more bf16 rounding)."""
    B, S = h.shape[0], h.shape[1]
    q, k, v = h @ ap["wq"], h @ ap["wk"], h @ ap["wv"]
    if cfg.attention_multiplier:
        q = q * (cfg.attention_multiplier * math.sqrt(cfg.head_dim))
    if "bq" in ap:
        q = q + ap["bq"]
    if "bk" in ap:
        k = k + ap["bk"]
        v = v + ap["bv"]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv, cfg.head_dim))


def ffn(cfg: ModelConfig, spec, lp: Params, h: torch.Tensor,
        shards: Optional[int] = None):
    """The layer's MLP, or its MoE (``moe_fwd``, capacity and drop as
    the config sets them) where the layer spec says so, plus the shared
    expert where the layer has one.  Returns (out, MoE aux loss, or None
    for an MLP); with ``shards`` (``h`` one of that many data shards) the
    MoE's (2, E) aux terms in place of its loss."""
    if spec.moe:
        out, aux = M.moe_fwd(lp["moe"], h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             n_groups=cfg.moe_groups, act=cfg.act,
                             shards=shards)
    else:
        out, aux = M.mlp_fwd(lp["mlp"], h, cfg.act), None
    if "shared" in lp:
        out = out + M.mlp_fwd(lp["shared"], h, cfg.act)
    return out, aux


def _cross_kv(cfg: ModelConfig, wp: Params, cross: torch.Tensor):
    """K/V (B, S_enc, KV, hd) of the cross inputs under ``wp``'s wk/wv,
    in the inputs' and weights' promoted dtype (fp32 image embeddings
    give fp32 K/V, as in the reference; the cache keeps them bf16)."""
    B, S_enc = cross.shape[0], cross.shape[1]
    shape = (B, S_enc, cfg.n_kv, cfg.head_dim)
    return (M.mm(cross, wp["wk"]).reshape(shape),
            M.mm(cross, wp["wv"]).reshape(shape))


def _cross_attend(cfg: ModelConfig, ap: Params, h: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor,
                  enc_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Non-causal attention of ``h``'s queries over precomputed cross
    K/V, without rotary (the reference passes no positions), projected
    by ``wo``.  ``enc_lens`` (B,) int32 = S_enc for a one-token step,
    which runs ``ops.decode_attention`` over the bf16 cross cache; None
    for a whole sequence (the plain ``chunked_attention``)."""
    B, S = h.shape[0], h.shape[1]
    q = h @ ap["wq"]
    if "bq" in ap:
        q = q + ap["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if enc_lens is not None:
        att = ops.decode_attention(q[:, 0].contiguous(), xk, xv, enc_lens)
    else:
        att = M.chunked_attention(q, xk, xv, causal=False,
                                  chunk_q=cfg.attn_chunk,
                                  chunk_kv=cfg.attn_chunk)
    return att.reshape(B, S, cfg.n_heads * cfg.head_dim) @ ap["wo"]


def _gate(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g).to(out.dtype) * out


def _unit_fwd(cfg: ModelConfig, up: Params, x: torch.Tensor,
              positions: torch.Tensor, cross: Optional[torch.Tensor],
              train: bool = False, causal: bool = True,
              shards: Optional[int] = None):
    """One unit over the whole sequence (prefill, training, and the
    encoder); returns (x, MoE aux loss (fp32), cache) where cache maps
    each of the unit's cache keys to its per-layer entries (None with
    ``train``).  With ``shards`` (``x`` one of that many data shards)
    the aux is a tuple of each MoE layer's (2, E) terms (``moe_fwd``).
    Causal self-attention runs through ``ops.flash_attention`` (the
    kernel on the card); with ``train``, or non-causal, through the
    plain ``chunked_attention``, as the reference's train mode does:
    the kernel has no backward."""
    B, S, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    terms: List[torch.Tensor] = []
    cache: Dict[str, list] = {k: [] for k in CACHE_KEYS}

    def put(key: str, t: torch.Tensor) -> None:
        if not train:
            cache[key].append(t)

    kv_int8 = cfg.kv_cache_dtype == "int8"
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        if spec.kind == "attn":
            h = norm(cfg, lp["norm1"], x)
            q, k, v = project_qkv(cfg, lp["attn"], h)
            if cfg.pos_emb == "rope":
                q = M.apply_rope(q, positions, cfg.rope_theta,
                                 cfg.rotary_pct)
                k = M.apply_rope(k, positions, cfg.rope_theta,
                                 cfg.rotary_pct)
            if train or not causal:
                att = M.chunked_attention(q, k, v, causal=causal,
                                          chunk_q=cfg.attn_chunk,
                                          chunk_kv=cfg.attn_chunk)
            else:
                att = ops.flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal=True)
            x = residual(cfg, x, att.reshape(B, S, cfg.n_heads
                                             * cfg.head_dim)
                         @ lp["attn"]["wo"])
            if kv_int8 and not train:
                for name, t in (("k", k), ("v", v)):
                    tq, ts = M.quantize_kv(t)
                    put(f"kv_{name}", tq)
                    put(f"kv_{name}_scale", ts)
            elif not train:
                put("kv_k", k.to(torch.bfloat16))
                put("kv_v", v.to(torch.bfloat16))
        elif spec.kind == "cross":
            # cross-only layer (Llama-3.2-Vision image layers)
            h = M.apply_norm(cfg.norm, lp["norm1"], x)
            xk, xv = _cross_kv(cfg, lp["xkv"], cross)
            out = _cross_attend(cfg, lp["attn"], h, xk, xv, None)
            x = x + _gate(lp["gate_attn"], out)
            put("cross_k", xk.to(torch.bfloat16))
            put("cross_v", xv.to(torch.bfloat16))
        elif spec.kind == "mamba":
            h = norm(cfg, lp["norm1"], x)
            out, (cs, ss) = mamba_mixer(cfg, lp["mamba"], h)
            x = residual(cfg, x, out)
            put("conv", cs)
            put("ssm", ss)
        elif spec.kind == "rwkv":
            x, states = _rwkv_layer(cfg, lp, x, None)
            for name, t in zip(("wkv", "shift_t", "shift_c"), states):
                put(name, t)
            continue             # an RWKV layer has no separate MLP
        if spec.cross_attn:      # Whisper-style extra cross sublayer
            h = M.apply_norm(cfg.norm, lp["cross_norm"], x)
            xk, xv = _cross_kv(cfg, lp["cross"], cross)
            x = x + _cross_attend(cfg, lp["cross"], h, xk, xv, None)
            put("cross_k", xk.to(torch.bfloat16))
            put("cross_v", xv.to(torch.bfloat16))
        x, a = _mlp_sublayer(cfg, spec, lp, x, shards)
        if a is not None and shards:
            terms.append(a)
        elif a is not None:
            aux = aux + a
    return x, (tuple(terms) if shards else aux), (
        None if train else {k: v for k, v in cache.items() if v})


def _rwkv_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                states: Optional[tuple]):
    """An RWKV layer: time-mix then channel-mix, each behind a
    LayerNorm, from ``states`` = (wkv, shift_t, shift_c) or from zeros.
    Returns (x, new states)."""
    ws, sh, shc = states if states is not None else (None, None, None)
    h = M.apply_norm("ln", lp["norm1"], x)
    out, (ws2, sh2) = M.rwkv_tmix_fwd(lp["tmix"], h, _rdims(cfg),
                                      wkv_state=ws, shift_state=sh)
    x = x + out
    h = M.apply_norm("ln", lp["norm2"], x)
    out, shc2 = M.rwkv_cmix_fwd(lp["cmix"], h, shift_state=shc)
    return x + out, (ws2, sh2, shc2)


def _mlp_sublayer(cfg: ModelConfig, spec: LayerSpec, lp: Params,
                  x: torch.Tensor, shards: Optional[int] = None):
    """The MLP / MoE sublayer behind ``norm2`` (tanh-gated in a cross
    layer).  Returns (x, MoE aux loss (terms, with ``shards``) or
    None)."""
    h = norm(cfg, lp["norm2"], x)
    out, a = ffn(cfg, spec, lp, h, shards)
    if spec.kind == "cross":
        out = _gate(lp["gate_mlp"], out)
    return residual(cfg, x, out), a


def _stack_cache(per_unit: List[Dict[str, list]]) -> Params:
    """Per-unit lists of per-layer entries -> (U, n_kind, ...) stacks."""
    return {k: torch.stack([torch.stack(c[k]) for c in per_unit])
            for k in per_unit[0]}


def _stack_fwd(cfg: ModelConfig, units: List[Params], x: torch.Tensor,
               positions: torch.Tensor, cross: Optional[torch.Tensor],
               causal: bool = True, shard: Optional[SH.DataShard] = None):
    """The units in order over the whole sequence with the plain
    attention (the reference's train-mode ``lax.scan``); with
    ``cfg.remat`` under autograd each unit is recomputed in the
    backward pass, so only the unit boundaries are kept.  Returns (x,
    summed aux loss).

    With ``shard`` (``x`` that data shard's rows; ``units`` placed on a
    mesh) each unit's leaves are gathered onto the shard's devices
    first, inside the remat region, so the backward gathers them again
    and no more than one unit is ever whole (FSDP per scanned unit);
    the aux is then the list of each MoE layer's (2, E) terms."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    terms: List[torch.Tensor] = []

    def body(up, h, pos, xc):
        if shard is not None:
            up = local_params(up, shard)
        h, a, _ = _unit_fwd(cfg, up, h, pos, xc, train=True, causal=causal,
                            shards=shard.n if shard is not None else None)
        return h, a

    for up in units:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(functools.partial(body, up), x, positions,
                              cross, use_reentrant=False)
        else:
            x, a = body(up, x, positions, cross)
        if shard is not None:
            terms.extend(a)
        else:
            aux = aux + a
    return x, (terms if shard is not None else aux)


def encode(p: Params, cfg: ModelConfig, frames: torch.Tensor,
           shard: Optional[SH.DataShard] = None) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, S_enc,
    D): sinusoidal positions, ``encoder_layers`` non-causal attention
    layers (the plain ``chunked_attention``), the final norm.  Returns
    (B, S_enc, D) bf16.  ``shard``: as for ``_stack_fwd``."""
    S_enc = frames.shape[1]
    x = frames.to(torch.bfloat16)
    x = x + _sinusoidal(S_enc, cfg.d_model,
                        device=x.device)[None].to(x.dtype)
    enc = p["encoder"]
    x, _ = _stack_fwd(_enc_cfg(cfg), _views(enc["units"],
                                            cfg.encoder_layers), x,
                      torch.arange(S_enc, device=x.device), None,
                      causal=False, shard=shard)
    norm = enc["final_norm"] if shard is None else local_params(
        enc["final_norm"], shard)
    return M.apply_norm(cfg.norm, norm, x)


def _cross_inputs(p: Params, cfg: ModelConfig, cross_inputs, dev,
                  shard: Optional[SH.DataShard] = None
                  ) -> Optional[torch.Tensor]:
    """The cross inputs on ``dev`` (float64 arrays as fp32, as JAX reads
    them), run through the encoder where the model has one; None for a
    model that takes none.  Raises when a model that needs them gets
    none."""
    if not _needs_cross_inputs(cfg):
        return None
    if cross_inputs is None:
        raise ValueError(
            f"{cfg.name} attends over {cfg.n_frontend_tokens} stubbed "
            "frontend embeddings: pass cross_inputs (frames) of shape "
            f"(B, {cfg.n_frontend_tokens}, {cfg.d_model})")
    t = torch.as_tensor(cross_inputs, device=dev)
    if t.dtype == torch.float64:
        t = t.float()
    if t.dim() != 3 or t.shape[2] != cfg.d_model:
        raise ValueError(f"{cfg.name}: cross_inputs of shape "
                         f"{tuple(t.shape)}, expected (B, S_enc, "
                         f"{cfg.d_model})")
    return encode(p, cfg, t, shard) if cfg.encoder_layers else t


@torch.no_grad()
def prefill(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cross_inputs: Optional[torch.Tensor] = None,
            units: Optional[List[Params]] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Prefill: tokens (B, S) -> (last-token logits (B, V) fp32, a
    ``ShardedTensor`` under a vocab-split head; cache of the model's
    keys (the module docstring's layout) and ``index``
    S).  ``cross_inputs`` (B, S_enc, D): the image embeddings, or the
    frames the encoder reads; models without cross layers ignore them."""
    dev = p["embed"].device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    cross = _cross_inputs(p, cfg, cross_inputs, dev)
    x = _embed_tokens(p, cfg, tokens)
    S = tokens.shape[1]
    positions = torch.arange(S, device=dev)
    per_unit = []
    for up in (units if units is not None else unit_views(p, cfg)):
        x, _, c = _unit_fwd(cfg, up, x, positions, cross)
        per_unit.append(c)
    x = norm(cfg, p["final_norm"], x[:, -1:])
    logits = head_logits(cfg, x[:, 0], _lm_head(p, cfg))
    cache = _stack_cache(per_unit)
    cache["index"] = S
    return logits, cache


# ====================================================================== #
# Decode                                                                 #
# ====================================================================== #
def _decode_unit_fwd(cfg: ModelConfig, up: Params, x: torch.Tensor,
                     uc: Params, idx: int, lens: Optional[torch.Tensor],
                     enc_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """One unit of a decode step over its cache views ``uc`` (key ->
    (n_kind, B, ...)), updated in place.  Each attention layer writes
    the step's K/V (quantized, for an int8 cache) at ``idx``, then
    attends over ``idx + S`` positions without a causal mask, as the
    reference's decode mode does; recurrent layers step their states
    from the cache.  ``lens`` (B,) int32 holds ``idx + 1`` and
    ``enc_lens`` S_enc for a one-token step, which runs
    ``ops.decode_attention``; None for longer steps (the plain
    ``dense_attention`` / ``chunked_attention``)."""
    B, S, _ = x.shape
    positions = idx + torch.arange(S, device=x.device)
    kv_int8 = cfg.kv_cache_dtype == "int8"
    i_attn = i_mamba = i_rwkv = i_cross = 0
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        if spec.kind == "attn":
            h = norm(cfg, lp["norm1"], x)
            q, k, v = project_qkv(cfg, lp["attn"], h)
            if cfg.pos_emb == "rope":
                q = M.apply_rope(q, positions, cfg.rope_theta,
                                 cfg.rotary_pct)
                k = M.apply_rope(k, positions, cfg.rope_theta,
                                 cfg.rotary_pct)
            ck, cv = uc["kv_k"][i_attn], uc["kv_v"][i_attn]
            if kv_int8:
                cks = uc["kv_k_scale"][i_attn]
                cvs = uc["kv_v_scale"][i_attn]
                (kq, ks), (vq, vs) = M.quantize_kv(k), M.quantize_kv(v)
                ck[:, idx:idx + S], cks[:, idx:idx + S] = kq, ks
                cv[:, idx:idx + S], cvs[:, idx:idx + S] = vq, vs
                ck, cv = M.dequantize_kv(ck, cks), M.dequantize_kv(cv, cvs)
            else:
                ck[:, idx:idx + S] = k.to(ck.dtype)
                cv[:, idx:idx + S] = v.to(cv.dtype)
            if lens is not None:
                att = ops.decode_attention(q[:, 0].contiguous(), ck, cv,
                                           lens)
            else:
                att = M.dense_attention(q, ck, cv, causal=False,
                                        kv_len=idx + S)
            x = residual(cfg, x, att.reshape(B, S, cfg.n_heads
                                             * cfg.head_dim)
                         @ lp["attn"]["wo"])
            i_attn += 1
        elif spec.kind == "cross":
            h = M.apply_norm(cfg.norm, lp["norm1"], x)
            out = _cross_attend(cfg, lp["attn"], h, uc["cross_k"][i_cross],
                                uc["cross_v"][i_cross], enc_lens)
            x = x + _gate(lp["gate_attn"], out)
            i_cross += 1
        elif spec.kind == "mamba":
            h = norm(cfg, lp["norm1"], x)
            cs, ss = uc["conv"][i_mamba], uc["ssm"][i_mamba]
            if cfg.mamba_groups and S == 1:
                # the slot form over the cache's rows, updated in place
                out = mamba_step(cfg, lp["mamba"], h, cs, ss,
                                 torch.arange(B, dtype=torch.int32,
                                              device=x.device))
            else:
                out, (cs2, ss2) = mamba_mixer(cfg, lp["mamba"], h, cs, ss)
                cs.copy_(cs2)
                ss.copy_(ss2)
            x = residual(cfg, x, out)
            i_mamba += 1
        elif spec.kind == "rwkv":
            states = tuple(uc[k][i_rwkv]
                           for k in ("wkv", "shift_t", "shift_c"))
            x, new = _rwkv_layer(cfg, lp, x, states)
            for t, t2 in zip(states, new):
                t.copy_(t2)
            i_rwkv += 1
            continue
        if spec.cross_attn:
            h = M.apply_norm(cfg.norm, lp["cross_norm"], x)
            x = x + _cross_attend(cfg, lp["cross"], h,
                                  uc["cross_k"][i_cross],
                                  uc["cross_v"][i_cross], enc_lens)
            i_cross += 1
        x, _ = _mlp_sublayer(cfg, spec, lp, x)
    return x


@torch.no_grad()
def decode_step(p: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor,
                units: Optional[List[Params]] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, S) -> (logits (B, V) fp32, cache).

    The step writes the cache's buffers in place (the reference returns
    updated copies; its callers drop the old cache): its K/V into
    ``kv_k``/``kv_v`` (and their scales) at ``index``, and the new
    recurrent states over the old.  The returned cache holds those
    buffers and ``index + S``.  As in the reference, the logits are those
    of the step's first token."""
    dev = p["embed"].device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    idx = int(cache["index"])
    B, S = tokens.shape
    bufs = {k: cache[k] for k in CACHE_KEYS if k in cache}
    if "kv_k" in bufs and idx + S > bufs["kv_k"].shape[3]:
        raise ValueError(f"decode step of {S} token(s) at index {idx} "
                         f"overflows a cache of {bufs['kv_k'].shape[3]} "
                         "positions")
    x = _embed_tokens(p, cfg, tokens, index=idx)
    lens = enc_lens = None
    if S == 1:
        lens = torch.full((B,), idx + 1, dtype=torch.int32, device=dev)
        if "cross_k" in bufs:
            enc_lens = torch.full((B,), bufs["cross_k"].shape[3],
                                  dtype=torch.int32, device=dev)
    for u, up in enumerate(units if units is not None
                           else unit_views(p, cfg)):
        x = _decode_unit_fwd(cfg, up, x, {k: t[u] for k, t in bufs.items()},
                             idx, lens, enc_lens)
    x = norm(cfg, p["final_norm"], x)
    logits = head_logits(cfg, x[:, 0], _lm_head(p, cfg))
    return logits, dict(bufs, index=idx + S)


def make_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      enc_len: int = 0, device: DeviceLike = None) -> Params:
    """Zero-initialized decode cache on ``device`` (CUDA unless
    ``device="cpu"``), every key of the model's layers in the module
    docstring's layout, and ``index`` 0."""
    dev = resolve_device(device)
    U, B, bf16, f32 = cfg.n_units, batch, torch.bfloat16, torch.float32
    n_attn = len(cfg.unit_attn_layers)
    n_mamba = len(cfg.unit_mamba_layers)
    n_rwkv = len(cfg.unit_rwkv_layers)
    n_cross = len([s for s in cfg.pattern
                   if s.cross_attn or s.kind == "cross"])
    hd, KV = cfg.head_dim, cfg.n_kv
    shapes: Dict[str, tuple] = {}
    if n_attn:
        int8 = cfg.kv_cache_dtype == "int8"
        kv = ((U, n_attn, B, max_seq, KV, hd), torch.int8 if int8 else bf16)
        shapes.update(kv_k=kv, kv_v=kv)
        if int8:
            sc = ((U, n_attn, B, max_seq, KV), bf16)
            shapes.update(kv_k_scale=sc, kv_v_scale=sc)
    if n_mamba:
        md = _mdims(cfg)
        shapes["conv"] = ((U, n_mamba, B, cfg.mamba_d_conv - 1,
                           md.conv_dim), bf16)
        shapes["ssm"] = ((U, n_mamba, B, md.n_heads, md.d_state,
                          md.head_dim), f32)
    if n_rwkv:
        rd = _rdims(cfg)
        shapes["wkv"] = ((U, n_rwkv, B, rd.n_heads, rd.head_dim,
                          rd.head_dim), f32)
        shapes["shift_t"] = shapes["shift_c"] = ((U, n_rwkv, B,
                                                  cfg.d_model), bf16)
    if n_cross:
        shapes["cross_k"] = shapes["cross_v"] = (
            (U, n_cross, B, enc_len, KV, hd), bf16)
    cache: Params = {"index": 0}
    for k, (shape, dt) in shapes.items():
        cache[k] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


# ====================================================================== #
# Training loss                                                          #
# ====================================================================== #
def _chunk_ce(xi: torch.Tensor, yi: torch.Tensor, W) -> torch.Tensor:
    """Summed cross-entropy of one sequence chunk, logits in fp32.  A
    head split over vocab (a ``ShardedTensor``) gives each block's
    logits on its device: the log-sum-exp merges the blocks' own
    log-sum-exps (their maxima and sums of exponentials), and the gold
    logit comes from the block that owns the label."""
    if not SH.is_split(W):
        logits = (xi @ SH.gather(W).T).float()                # (B,C,V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, yi[..., None])[..., 0]
        return torch.sum(lse - gold)
    first, lses, gold = xi.device, [], None
    logits = SH.vocab_logits(xi, W)
    for lo, hi, dev, local in logits.blocks(logits.ndim - 1):
        lses.append(torch.logsumexp(local, dim=-1).to(first))
        y = yi.to(dev)
        g = local.gather(-1, torch.clamp(y - lo, 0, hi - lo - 1)[..., None])
        g = torch.where((y >= lo) & (y < hi), g[..., 0],
                        torch.zeros((), dtype=g.dtype, device=dev)).to(first)
        gold = g if gold is None else gold + g
    return torch.sum(torch.logsumexp(torch.stack(lses), dim=0) - gold)


def _split_rows(path: Tuple[str, ...]) -> bool:
    """Whether a leaf keeps a ``model`` split of its dimension 0 when a
    data shard gathers it: the vocab rows of the embedding and head, and
    the expert stacks, which the model reads block by block
    (``embed_rows``, ``vocab_logits``, ``expert_blocks``)."""
    return path[-1] in ("embed", "lm_head") or (
        len(path) > 1 and path[-2] == "moe"
        and path[-1] in ("w_gate", "w_up", "w_down"))


def local_params(tree: Params, shard: SH.DataShard) -> Params:
    """``tree``'s leaves gathered onto data shard ``shard``'s devices
    (``shardings.local_view``): whole, but the vocab and expert splits
    kept (``_split_rows``)."""
    return SH._map_with_path(
        lambda path, t: SH.local_view(t, shard, _split_rows(path)), tree)


def _moe_groups(cfg: ModelConfig, n_tokens: int) -> int:
    """The MoE dispatch groups of a batch of ``n_tokens`` (``moe_fwd``'s
    G); 0 for a model without MoE layers."""
    if not any(s.moe for s in cfg.pattern):
        return 0
    G = min(cfg.moe_groups, n_tokens)
    while n_tokens % G:
        G -= 1
    return G


def _shard_loss(p: Params, cfg: ModelConfig, shard: SH.DataShard,
                tokens: torch.Tensor, labels: torch.Tensor, cross_inputs
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One data shard's summed token cross-entropy and its MoE layers'
    aux terms, computed on its devices from params placed on a mesh."""
    dev = shard.device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    labels = labels.to(device=dev, dtype=torch.int64)
    top = local_params({k: v for k, v in p.items()
                        if k not in ("units", "encoder")}, shard)
    cross = _cross_inputs(p, cfg, cross_inputs, dev, shard)
    x = _embed_tokens(top, cfg, tokens)
    S = tokens.shape[1]
    x, terms = _stack_fwd(cfg, unit_views(p, cfg), x,
                          torch.arange(S, device=dev), cross, shard=shard)
    return _ce_sum(cfg, norm(cfg, top["final_norm"], x),
                   labels, _lm_head(top, cfg)), terms


def _ce_sum(cfg: ModelConfig, x: torch.Tensor, labels: torch.Tensor,
            W) -> torch.Tensor:
    """Summed token cross-entropy of the final hidden states, over
    chunks of ``cfg.loss_chunk`` positions so the (B, S, V) logits never
    exist at once.  Under ``logits_scaling`` the hidden states are
    divided by it before the head, which divides the logits."""
    if cfg.logits_scaling != 1.0:
        x = x / cfg.logits_scaling
    S = x.shape[1]
    C = min(cfg.loss_chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"loss_chunk {C}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, C):
        xi, yi = x[:, c0:c0 + C], labels[:, c0:c0 + C]
        if cfg.remat:
            total = total + checkpoint(_chunk_ce, xi, yi, W,
                                       use_reentrant=False)
        else:
            total = total + _chunk_ce(xi, yi, W)
    return total


def _shards_aux(terms: List[List[torch.Tensor]], first) -> torch.Tensor:
    """The MoE aux loss from every data shard's per-layer (2, E) terms:
    each layer's ``me`` and ``ce`` summed over the shards first (they
    are the whole batch's), then ``moe_aux``, summed over the layers."""
    aux = torch.zeros((), dtype=torch.float32, device=first)
    for layer in zip(*terms):
        me, ce = sum(t.to(first) for t in layer)
        aux = aux + M.moe_aux(me, ce)
    return aux


def loss_terms(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
               labels: torch.Tensor,
               cross_inputs: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training loss's two terms, 0-d fp32: the mean token
    cross-entropy and the MoE aux loss (``forward_loss`` adds 0.01 x the
    aux).  ``cross_inputs`` as for ``prefill``.

    Params placed on a mesh (``shardings.to_named``) split the global
    batch into ``shardings.data_shards``, each computed on its own data
    row's devices (``_shard_loss``): the mean is the shards' summed
    token losses over the global B x S, and the aux is the global
    batch's (``_shards_aux``).  The terms land on the mesh's first
    device."""
    B, S = tokens.shape
    mesh = SH.mesh_of(p)
    if mesh is not None:
        first = mesh.first_device
        ce = torch.zeros((), dtype=torch.float32, device=first)
        terms = []
        for shard in SH.data_shards(mesh, B, _moe_groups(cfg, B * S)):
            rows = slice(shard.lo, shard.hi)
            c, t = _shard_loss(p, cfg, shard, tokens[rows], labels[rows],
                               None if cross_inputs is None
                               else cross_inputs[rows])
            ce = ce + c.to(first)
            terms.append(t)
        return ce / (B * S), _shards_aux(terms, first)
    dev = p["embed"].device
    tokens = tokens.to(device=dev, dtype=torch.int64)
    labels = labels.to(device=dev, dtype=torch.int64)
    cross = _cross_inputs(p, cfg, cross_inputs, dev)
    x = _embed_tokens(p, cfg, tokens)
    x, aux = _stack_fwd(cfg, unit_views(p, cfg), x,
                        torch.arange(S, device=dev), cross)
    x = norm(cfg, p["final_norm"], x)
    return _ce_sum(cfg, x, labels, _lm_head(p, cfg)) / (B * S), aux


def forward_loss(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 labels: torch.Tensor,
                 cross_inputs: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Training loss, a 0-d fp32 tensor: the mean token cross-entropy,
    computed over chunks of ``cfg.loss_chunk`` positions so the (B, S, V)
    logits never exist at once, plus 0.01 x the MoE aux loss
    (``loss_terms``; params placed on a mesh too).  ``cross_inputs`` as
    for ``prefill``."""
    ce, aux = loss_terms(p, cfg, tokens, labels, cross_inputs)
    return ce + 0.01 * aux
