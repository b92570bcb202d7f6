"""Model building blocks in PyTorch (counterpart of
``repro.models.modules``): norms, RoPE, attention, the int8 KV
quantizer, MLP, MoE, Mamba-2 (SSD) and RWKV6.

Plain functions over explicit parameter dictionaries, in the reference's
layouts: activations (B, S, D), heads (B, S, H, hd), weights stored
(in, out) so a projection is ``x @ w``.  Compute dtype bf16 unless
stated; norms, softmax statistics and the recurrent scans run in fp32,
as in the reference.  The reference's ``lax.scan`` over sequence chunks
is a Python loop over the chunks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import shardings as SH

Params = Dict[str, Any]


def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the two operands' promoted dtype, as JAX promotes a
    mixed fp32 x bf16 product (torch's matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def randn(shape, std: float, g: torch.Generator, device, units: int = 0,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """N(0, std^2) draws in ``dtype``; with ``units`` > 0 a (units,
    *shape) stack drawn one unit at a time, so the fp32 transient stays
    one layer in size."""
    if not units:
        return torch.randn(shape, generator=g, device=device).mul_(
            std).to(dtype)
    out = torch.empty((units, *shape), dtype=dtype, device=device)
    for u in range(units):
        out[u] = randn(shape, std, g, device, dtype=dtype)
    return out


def _full(shape, value: float, device, units: int = 0,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return torch.full(((units,) if units else ()) + tuple(shape), value,
                      dtype=dtype, device=device)


# ====================================================================== #
# Norms                                                                  #
# ====================================================================== #
def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def apply_norm(kind: str, p: Params, x: torch.Tensor,
               eps: Optional[float] = None) -> torch.Tensor:
    """The ``kind`` norm, with its own default epsilon unless ``eps``."""
    if kind == "rms":
        return rms_norm(p, x) if eps is None else rms_norm(p, x, eps)
    return layer_norm(p, x) if eps is None else layer_norm(p, x, eps)


# ====================================================================== #
# RoPE                                                                   #
# ====================================================================== #
def rope_freqs(rotary_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rotary_dim, 2,
                                         dtype=torch.float32,
                                         device=device) / rotary_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).

    Rotates *interleaved* pairs ``(x[..., 0::2], x[..., 1::2])``, the
    reference's layout — not the half-split pairs common in PyTorch
    code."""
    hd = x.shape[-1]
    rotary_dim = int(hd * rotary_pct)
    rotary_dim -= rotary_dim % 2
    if rotary_dim == 0:
        return x
    freqs = rope_freqs(rotary_dim, theta, device=x.device)   # (rd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # (B,S,rd/2)
    cos = torch.cos(ang)[:, :, None, :]                       # (B,S,1,rd/2)
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
    xf1 = xr[..., 0::2].float()
    xf2 = xr[..., 1::2].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rotary_dim < hd else out


# ====================================================================== #
# Chunked attention (plain prefill attention)                             #
# ====================================================================== #
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, q_offset: int = 0,
                      chunk_q: int = 1024, chunk_kv: int = 1024,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over (chunk_q, chunk_kv) tiles, never
    materializing the (Sq, Sk) scores — the reference's pure-JAX prefill
    attention, and the plain form of what the flash kernel computes.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(hd)
    cq, ck = min(chunk_q, Sq), min(chunk_kv, Sk)
    valid_k = Sk if kv_len is None else kv_len
    outs = []
    for q0 in range(0, Sq, cq):
        qc = q[:, q0:q0 + cq].float()                         # (B,cq,H,hd)
        nq = qc.shape[1]
        q_pos = q_offset + q0 + torch.arange(nq, device=q.device)
        m = torch.full((B, H, nq), float("-inf"), device=q.device)
        lsum = torch.zeros((B, H, nq), device=q.device)
        acc = torch.zeros((B, H, nq, hd), device=q.device)
        for k0 in range(0, Sk, ck):
            kc = k[:, k0:k0 + ck].float().repeat_interleave(rep, dim=2)
            vc = v[:, k0:k0 + ck].float().repeat_interleave(rep, dim=2)
            k_pos = k0 + torch.arange(kc.shape[1], device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
            mask = (k_pos[None, :] < valid_k).expand(nq, -1)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask[None, None], s,
                            torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       p, vc)
            m = m_new
        out = acc / torch.clamp(lsum[..., None], min=1e-30)
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, dim=1)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_len=None) -> torch.Tensor:
    """Direct softmax attention (the decode path's plain attention and
    the small-S oracle), in the grouped (KV, rep) layout: the cache is
    never repeated to H heads.  Scores in fp32; masked positions get
    -1e30 (``causal``: key position <= ``q_offset`` + query position;
    ``kv_len``, an int or 0-d tensor: key position < ``kv_len``).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.reshape(B, Sq, KV, rep, hd).float()
    s = torch.einsum("bqgrh,bkgh->bgrqk", qf, k.float()) / math.sqrt(hd)
    k_pos = torch.arange(Sk, device=q.device)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if kv_len is not None:
        mask = mask & (k_pos[None, :] < kv_len)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgh->bgrqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


# ====================================================================== #
# KV-cache quantization (int8, per-(position, head) symmetric scales)    #
# ====================================================================== #
def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, KV, hd) -> (int8 values, bf16 scales (B, S, KV))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


# ====================================================================== #
# MLP (SwiGLU / GELU)                                                    #
# ====================================================================== #
def mlp_fwd(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ====================================================================== #
# Mixture of Experts (group-local capacity dispatch)                      #
# ====================================================================== #
def moe_fwd(p: Params, x: torch.Tensor, *, top_k: int,
            capacity_factor: float, n_groups: int, act: str = "silu",
            shards: Optional[int] = None):
    """Token-choice top-k MoE with group-local capacity and drop, the
    reference's function step for step.

    The N = B*S tokens split into G groups (the largest divisor of N not
    above ``n_groups``) of T tokens.  The router runs in fp32; each
    (token, slot) takes the next free position of its expert's bucket in
    token-major order, and positions past the capacity C go to a dump
    slot and are dropped (weight 0: the residual alone carries them).
    Dispatch and combine run in ``x.dtype``, the combine adding slot by
    slot in order, through ``kernels.ops``' ``moe_bucket_*``: on CUDA
    three kernels, the plain values bit for bit, except where autograd
    records the tokens (training: dispatch and combine) or the expert
    outputs and weights (combine), which take the plain versions in
    ``kernels.ref``, as on the CPU.  The expert products are
    batched matmuls over E, as the reference leaves them to XLA's
    einsum.

    Expert stacks split over ``experts`` (``shardings``): the
    router is gathered whole first (so routing is the one-device
    routing), each block's buckets run on its device against its own
    experts, and their outputs are gathered to the first device, where
    the combine runs in the same slot order as on one device.

    ``shards``: ``x`` is one of that many equal data shards of the global
    batch (``shardings.data_shards``).  The groups are the global
    batch's (G from the global token count), this shard taking its
    G / shards of them, so capacity and drops are those of the whole
    batch; and in place of the aux loss it returns this shard's terms
    of the global ``me`` and ``ce``, (2, E) fp32 (each over the global
    token count), which ``moe_aux`` turns into the loss once they are
    summed over the shards.

    Returns (out (B, S, D), aux_loss): the Switch load-balancing loss."""
    B, S, D = x.shape
    router = SH.gather(p["router"])
    E = router.shape[1]
    N = B * S
    Ng = N * (shards or 1)                # the global batch's tokens
    G = min(n_groups, Ng)
    while Ng % G:
        G -= 1
    if shards:
        if G % shards:
            raise ValueError(f"{G} MoE groups do not split over {shards} "
                             "data shards")
        G //= shards
    T = N // G
    xt = x.reshape(G, T, D)

    probs = torch.softmax(xt.float() @ router, dim=-1)        # (G,T,E)
    topw, topi = torch.topk(probs, top_k, dim=-1)             # (G,T,k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    flat = topi.reshape(-1)
    ce = torch.zeros(E, device=x.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (Ng * top_k),
                            device=x.device))
    if shards:
        aux = torch.stack([probs.sum(dim=(0, 1)) / Ng, ce])
    else:
        aux = moe_aux(probs.mean(dim=(0, 1)), ce)

    C = max(int(T * top_k * capacity_factor / E), 4)
    pos = ops.moe_bucket_positions(topi, E, xt)               # (G,T,k)
    # (E, G*C, D): one batched product over the experts
    be = ops.moe_bucket_scatter(xt, topi, pos, E, C).reshape(E, G * C, D)
    names = ("w_gate", "w_up", "w_down") if act == "silu" \
        else ("w_up", "w_down")
    outs = []
    for lo, hi, dev, ws in SH.expert_blocks(*(p[n] for n in names)):
        b = (be if hi - lo == E else be[lo:hi]).to(dev)
        if act == "silu":
            h = F.silu(torch.bmm(b, ws[0])) * torch.bmm(b, ws[1])
        else:
            h = F.gelu(torch.bmm(b, ws[0]), approximate="tanh")
        outs.append(torch.bmm(h, ws[-1]).to(x.device))
    out_buf = (outs[0] if len(outs) == 1 else torch.cat(outs)).reshape(
        E, G, C, D)
    acc = ops.moe_bucket_combine(out_buf, topi, topw, pos)
    return acc.reshape(B, S, D), aux


def moe_aux(me: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss E * sum(me * ce) of the whole
    batch's mean router probabilities ``me`` and routed fractions ``ce``
    (E,)."""
    return me.shape[-1] * torch.sum(me * ce)


# ====================================================================== #
# Mamba (SSD / Mamba-2 form)                                             #
# ====================================================================== #
@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_inner: int
    n_heads: int     # d_inner // head_dim
    head_dim: int
    d_state: int
    d_conv: int = 4
    chunk: int = 128

    @property
    def conv_dim(self) -> int:
        """Channels of the depthwise conv (x alone)."""
        return self.d_inner


@dataclasses.dataclass(frozen=True)
class Mamba2Dims(MambaDims):
    """The published Mamba-2 block's sizes: B and C per group of heads,
    the conv over [x, B, C] (``mamba2_fwd``)."""
    groups: int = 1

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.groups * self.d_state


def mamba_dims(d_model: int, expand: int = 2, head_dim: int = 64,
               d_state: int = 16, d_conv: int = 4,
               chunk: int = 128, groups: int = 0) -> MambaDims:
    """The block's sizes; ``groups`` > 0: the published Mamba-2's."""
    d_inner = expand * d_model
    dims = (d_model, d_inner, d_inner // head_dim, head_dim, d_state,
            d_conv, chunk)
    return Mamba2Dims(*dims, groups) if groups else MambaDims(*dims)


def init_mamba(dims: MambaDims, g: torch.Generator, device,
               units: int = 0) -> Params:
    """The reference's ``init_mamba`` layout and scales (``units`` > 0:
    stacked over that many units), drawn from ``g``."""
    di, H, N = dims.d_inner, dims.n_heads, dims.d_state
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        # in_proj -> [x (di), z (di), B (H*N), C (H*N), dt (H)]
        "w_in": randn((dims.d_model, 2 * di + 2 * H * N + H),
                      1.0 / math.sqrt(dims.d_model), g, device, units),
        "conv_w": randn((dims.d_conv, di), 0.1, g, device, units),
        "conv_b": _full((di,), 0.0, device, units),
        "A_log": (a_log.expand(units, H).clone() if units else a_log),
        "D": _full((H,), 1.0, device, units, f32),
        "dt_bias": _full((H,), 0.0, device, units, f32),
        "w_out": randn((di, dims.d_model), 1.0 / math.sqrt(di), g, device,
                       units),
        "norm": {"scale": _full((di,), 1.0, device, units, f32)},
    }


def _mamba_split(p: Params, x: torch.Tensor, dims: MambaDims):
    di, H, N = dims.d_inner, dims.n_heads, dims.d_state
    proj = mm(x, p["w_in"])
    return torch.split(proj, [di, di, H * N, H * N, H], dim=-1)


def _ssd_chunk_scan(xh, dt, A, Bm, Cm, dims: MambaDims,
                    init_state: Optional[torch.Tensor] = None):
    """Chunked SSD: y_t = C_t^T sum_{s<=t} (prod_{r=s+1..t} a_r) dt_s B_s
    x_s, with a_t = exp(-dt_t A_h) one decay per head (Mamba-2 / SSD).

    xh: (B, S, H, P); dt: (B, S, H) (softplus'd); Bm, Cm: (B, S, H, N).
    A ragged last chunk is zero-padded: dt = 0 is the identity decay and
    adds no input, so the carried state stays exact.  fp32 throughout.
    Returns (y (B, S, H, P) fp32, final state (B, H, N, P) fp32)."""
    B, S, H, P = xh.shape
    N = dims.d_state
    L = min(dims.chunk, S)
    nC = -(-S // L)
    pad = nC * L - S
    if pad:
        xh, Bm, Cm = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xh, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    loga = (-dt * A[None, None, :]).float()                  # (B,S,H) <= 0
    x_dt = xh.float() * dt[..., None]                        # (B,S,H,P)
    bf, cf = Bm.float(), Cm.float()
    state = (torch.zeros((B, H, N, P), device=xh.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    ys = []
    for c0 in range(0, nC * L, L):
        xk, bk = x_dt[:, c0:c0 + L], bf[:, c0:c0 + L]
        ck, lk = cf[:, c0:c0 + L], loga[:, c0:c0 + L]
        cum = torch.cumsum(lk, dim=1)             # (B,L,H) log decay to t
        total = cum[:, -1]                        # (B,H)
        # intra-chunk: G[t,s] = exp(cum_t - cum_s) * (C_t . B_s), s <= t
        gmat = cum[:, :, None, :] - cum[:, None, :, :]         # (B,L,L,H)
        gmat = gmat.masked_fill(~tri[None, :, :, None], float("-inf"))
        cb = torch.einsum("blhn,bshn->blsh", ck, bk)
        y_intra = torch.einsum("blsh,bshp->blhp", torch.exp(gmat) * cb, xk)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               ck * torch.exp(cum)[..., None], state)
        # S' = exp(total) S + sum_s exp(total - cum_s) B_s x_s
        decay_s = torch.exp(total[:, None, :] - cum)            # (B,L,H)
        state = (torch.exp(total)[..., None, None] * state
                 + torch.einsum("bshn,bshp->bhnp",
                                bk * decay_s[..., None], xk))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], state


def mamba_fwd(p: Params, x: torch.Tensor, dims: MambaDims,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None):
    """Mamba block forward.

    Whole sequence (states None, or S > 1): the chunked scan, from
    ``ssm_state`` where given.  Decode (S == 1 with states): one step
    of the recurrence.  conv_state: (B, d_conv - 1, d_inner);
    ssm_state: (B, H, N, P) fp32.  Returns (out (B, S, D), (conv_state
    bf16, ssm_state fp32))."""
    B, S, _ = x.shape
    di, H, P, N = dims.d_inner, dims.n_heads, dims.head_dim, dims.d_state
    xs, z, Bm, Cm, dt = _mamba_split(p, x, dims)

    # causal depthwise conv along the sequence
    K = dims.d_conv
    if conv_state is None:
        pad = torch.zeros((B, K - 1, di), dtype=xs.dtype, device=xs.device)
    else:
        pad = conv_state.to(xs.dtype)
    xpad = torch.cat([pad, xs], dim=1)                       # (B,S+K-1,di)
    conv = sum(xpad[:, i:i + S, :] * p["conv_w"][i] for i in range(K))
    conv = F.silu(conv + p["conv_b"])
    new_conv_state = xpad[:, -(K - 1):, :] if K > 1 else pad

    xh = conv.reshape(B, S, H, P)
    Bm = Bm.reshape(B, S, H, N)
    Cm = Cm.reshape(B, S, H, N)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = torch.exp(p["A_log"])

    if S == 1 and ssm_state is not None:
        a = torch.exp(-dtf[:, 0] * A[None, :])                # (B,H)
        bx = torch.einsum("bhn,bhp->bhnp", Bm[:, 0].float(),
                          xh[:, 0].float() * dtf[:, 0, :, None])
        state = a[..., None, None] * ssm_state + bx
        y = torch.einsum("bhn,bhnp->bhp", Cm[:, 0].float(), state)[:, None]
    else:
        y, state = _ssd_chunk_scan(xh, dtf, A, Bm, Cm, dims,
                                   init_state=ssm_state)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(p["norm"], y) * F.silu(z)
    return mm(y, p["w_out"]), (new_conv_state.to(torch.bfloat16), state)


# ====================================================================== #
# Mamba-2 as published (grouped B and C, gated norm)                     #
# ====================================================================== #
def init_mamba2(dims: MambaDims, g: torch.Generator, device,
                units: int = 0) -> Params:
    """The published Mamba-2 block's parameters (``units`` > 0: stacked
    over that many units), at ``init_mamba``'s scales.  ``w_in`` gives
    [z (di), x (di), B (G*N), C (G*N), dt (H)], the published in_proj's
    order; the conv runs over the conv_dim = di + 2*G*N channels of
    [x, B, C] with a bias."""
    di, H, C = dims.d_inner, dims.n_heads, dims.conv_dim
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        "w_in": randn((dims.d_model, di + C + H),
                      1.0 / math.sqrt(dims.d_model), g, device, units),
        "conv_w": randn((dims.d_conv, C), 0.1, g, device, units),
        "conv_b": _full((C,), 0.0, device, units),
        "A_log": (a_log.expand(units, H).clone() if units else a_log),
        "D": _full((H,), 1.0, device, units, f32),
        "dt_bias": _full((H,), 0.0, device, units, f32),
        "w_out": randn((di, dims.d_model), 1.0 / math.sqrt(di), g, device,
                       units),
        "norm": {"scale": _full((di,), 1.0, device, units, f32)},
    }


def _ssd_group_scan(xh, dt, A, Bg, Cg, chunk: int,
                    init_state: Optional[torch.Tensor] = None):
    """``_ssd_chunk_scan`` with B and C per group: y_t = C_t^T
    sum_{s<=t} exp(sum_{r=s+1..t} dt_r A_h) dt_s B_s x_s^T, where the
    H / G heads of a group read its B and C.

    xh: (B, S, H, P); dt: (B, S, H) (softplus'd); A: (H,) < 0; Bg, Cg:
    (B, S, G, N).  fp32 throughout; a ragged last chunk is zero-padded
    (dt = 0: the identity decay, no input).  Returns (y (B, S, H, P),
    final state (B, H, N, P))."""
    B, S, H, P = xh.shape
    G, N = Bg.shape[2], Bg.shape[3]
    R = H // G
    L = min(chunk, S)
    nC = -(-S // L)
    pad = nC * L - S
    if pad:
        xh, Bg, Cg = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xh, Bg, Cg))
        dt = F.pad(dt, (0, 0, 0, pad))
    loga = dt.float() * A[None, None, :]                       # (B,S,H) <= 0
    x_dt = xh.float() * dt[..., None]
    bf, cf = Bg.float(), Cg.float()
    state = (torch.zeros((B, H, N, P), device=xh.device)
             if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    ys = []
    for c0 in range(0, nC * L, L):
        xk, bk = x_dt[:, c0:c0 + L], bf[:, c0:c0 + L]
        ck, lk = cf[:, c0:c0 + L], loga[:, c0:c0 + L]
        cum = torch.cumsum(lk, dim=1)                          # (B,L,H)
        total = cum[:, -1]                                     # (B,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,L,L,H)
        seg = seg.masked_fill(~tri[None, :, :, None], float("-inf"))
        cb = torch.einsum("blgn,bsgn->blsg", ck, bk)           # (B,L,L,G)
        w = (torch.exp(seg).view(B, L, L, G, R)
             * cb[..., None]).view(B, L, L, H)
        y_intra = torch.einsum("blsh,bshp->blhp", w, xk)
        y_inter = torch.einsum("blgn,bgrnp->blgrp", ck,
                               state.view(B, G, R, N, P)).reshape(
                                   B, L, H, P) * torch.exp(cum)[..., None]
        decay_s = torch.exp(total[:, None, :] - cum)           # (B,L,H)
        upd = torch.einsum("bsgn,bsgrp->bgrnp", bk,
                           (xk * decay_s[..., None]).view(B, L, G, R, P))
        state = (torch.exp(total)[..., None, None] * state
                 + upd.reshape(B, H, N, P))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], state


def gated_rms_norm(p: Params, y: torch.Tensor, z: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    """The published block's output norm: ``y * silu(z)`` (fp32), then
    an RMS norm over each of ``groups`` groups of its d_inner channels,
    scaled; returned in ``z``'s dtype."""
    g = y.float() * F.silu(z.float())
    gs = g.reshape(*g.shape[:-1], groups, g.shape[-1] // groups)
    gs = gs * torch.rsqrt((gs * gs).mean(-1, keepdim=True) + eps)
    return (gs.reshape(g.shape) * p["scale"]).to(z.dtype)


def _conv_silu(p: Params, xpad: torch.Tensor, S: int) -> torch.Tensor:
    """The causal depthwise conv of the K - 1 carried inputs and S new
    ones (xpad (B, S + K - 1, C)) with its bias, then silu, in fp32,
    rounded once to ``xpad``'s dtype."""
    K = p["conv_w"].shape[0]
    w = p["conv_w"].float()
    conv = sum(xpad[:, i:i + S].float() * w[i] for i in range(K))
    return F.silu(conv + p["conv_b"].float()).to(xpad.dtype)


def mamba2_fwd(p: Params, x: torch.Tensor, dims: MambaDims,
               conv_state: Optional[torch.Tensor] = None,
               ssm_state: Optional[torch.Tensor] = None,
               eps: float = 1e-6):
    """The published Mamba-2 block over a whole sequence, from the
    carried states where given (the grouped chunked scan).

    x: (B, S, D); conv_state: (B, d_conv - 1, conv_dim); ssm_state:
    (B, H, N, P) fp32.  A = -exp(A_log), dt = softplus(dt + dt_bias),
    y = scan + D x, out = w_out(norm(y * silu(z))).  Returns (out
    (B, S, D), (conv_state bf16, ssm_state fp32))."""
    B, S, _ = x.shape
    di, H, P, N, G = (dims.d_inner, dims.n_heads, dims.head_dim,
                      dims.d_state, dims.groups)
    z, xbc, dt = torch.split(mm(x, p["w_in"]), [di, dims.conv_dim, H],
                             dim=-1)
    K = dims.d_conv
    pad = (torch.zeros((B, K - 1, dims.conv_dim), dtype=xbc.dtype,
                       device=x.device)
           if conv_state is None else conv_state.to(xbc.dtype))
    xpad = torch.cat([pad, xbc], dim=1)
    conv = _conv_silu(p, xpad, S)
    xs, Bg, Cg = torch.split(conv, [di, G * N, G * N], dim=-1)
    xh = xs.reshape(B, S, H, P)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, state = _ssd_group_scan(xh, dtf, A, Bg.reshape(B, S, G, N),
                               Cg.reshape(B, S, G, N), dims.chunk,
                               init_state=ssm_state)
    y = y + xh.float() * p["D"][None, None, :, None]
    out = gated_rms_norm(p["norm"], y.reshape(B, S, di), z, G, eps)
    return mm(out, p["w_out"]), (xpad[:, -(K - 1):].to(torch.bfloat16),
                                 state)


def mamba2_step(p: Params, x: torch.Tensor, dims: MambaDims,
                conv_store: torch.Tensor, ssm_store: torch.Tensor,
                slots: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """One decode token of the published Mamba-2 block for each row,
    its states read from and written back to slot ``slots[row]`` of the
    stores in place: conv_store (n_slots, d_conv - 1, conv_dim) bf16,
    ssm_store (n_slots, H, N, P) fp32, slots (B,) int32.  The SSM
    update and readout run in ``kernels.ops.ssm_state_update`` (the
    kernel on the card).  x: (B, 1, D); returns (B, 1, D)."""
    B = x.shape[0]
    di, H, P, N, G = (dims.d_inner, dims.n_heads, dims.head_dim,
                      dims.d_state, dims.groups)
    z, xbc, dt = torch.split(mm(x[:, 0], p["w_in"]),
                             [di, dims.conv_dim, H], dim=-1)
    idx = slots.long()
    xpad = torch.cat([conv_store[idx], xbc[:, None].to(conv_store.dtype)],
                     dim=1)                                 # (B, K, C)
    conv_store.index_copy_(0, idx, xpad[:, 1:])
    conv = _conv_silu(p, xpad, 1)[:, 0]                     # (B, C)
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y = ops.ssm_state_update(ssm_store, slots, conv[:, :di],
                             conv[:, di:di + G * N],
                             conv[:, di + G * N:], dtf, A, p["D"])
    out = gated_rms_norm(p["norm"], y.reshape(B, 1, di), z[:, None], G, eps)
    return mm(out, p["w_out"])


# ====================================================================== #
# RWKV6 ("Finch"): data-dependent decay linear attention                  #
# ====================================================================== #
@dataclasses.dataclass(frozen=True)
class RwkvDims:
    d_model: int
    n_heads: int
    head_dim: int
    d_ff: int
    chunk: int = 64


def rwkv_dims(d_model: int, d_ff: int, head_dim: int = 64,
              chunk: int = 64) -> RwkvDims:
    return RwkvDims(d_model, d_model // head_dim, head_dim, d_ff, chunk)


def init_rwkv_tmix(dims: RwkvDims, g: torch.Generator, device,
                   units: int = 0) -> Params:
    """The reference's ``init_rwkv_tmix`` layout and scales."""
    D, H, P = dims.d_model, dims.n_heads, dims.head_dim
    s = 1.0 / math.sqrt(D)
    lora = max(32, D // 64)
    p = {f"mix_{c}": _full((D,), 0.5, device, units) for c in "rkvwg"}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = randn((D, D), s, g, device, units)
    p.update(
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        w0=_full((D,), -2.0, device, units, torch.float32),
        wA=randn((D, lora), s, g, device, units),
        wB=randn((lora, D), 0.01, g, device, units),
        u=randn((H, P), 0.1, g, device, units, torch.float32),
        ln_x={"scale": _full((D,), 1.0, device, units, torch.float32),
              "bias": _full((D,), 0.0, device, units, torch.float32)})
    return p


def _token_shift(x: torch.Tensor, shift_state: Optional[torch.Tensor]):
    """Previous-token features of (B, S, D) ``x`` (``shift_state`` before
    the first), and the last token, carried for decode."""
    S = x.shape[1]
    if shift_state is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    elif S > 1:
        prev = torch.cat([shift_state[:, None, :], x[:, :S - 1]], dim=1)
    else:
        prev = shift_state[:, None, :]
    return prev, x[:, -1, :]


def rwkv_tmix_fwd(p: Params, x: torch.Tensor, dims: RwkvDims,
                  wkv_state: Optional[torch.Tensor] = None,
                  shift_state: Optional[torch.Tensor] = None):
    """RWKV6 time-mix.  wkv_state: (B, H, P, P) fp32; shift_state:
    (B, D).  Returns (out, (wkv_state, shift_state bf16))."""
    B, S, D = x.shape
    H, P = dims.n_heads, dims.head_dim
    prev, last = _token_shift(x, shift_state)

    def mix(m):
        return x * p[m] + prev * (1.0 - p[m])

    r = mm(mix("mix_r"), p["wr"]).reshape(B, S, H, P)
    k = mm(mix("mix_k"), p["wk"]).reshape(B, S, H, P)
    v = mm(mix("mix_v"), p["wv"]).reshape(B, S, H, P)
    g = F.silu(mm(mix("mix_g"), p["wg"]))
    # data-dependent decay (per channel): logw in (-inf, 0)
    wx = mm(torch.tanh(mm(mix("mix_w"), p["wA"])), p["wB"])
    logw = -torch.exp(p["w0"] + wx.float()).reshape(B, S, H, P)

    if wkv_state is None:
        wkv_state = torch.zeros((B, H, P, P), device=x.device)
    if S == 1:
        rf, kf, vf = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        kv = torch.einsum("bhp,bhq->bhpq", kf, vf)
        y = torch.einsum("bhp,bhpq->bhq", rf,
                         wkv_state + p["u"][None, :, :, None] * kv)
        state = wkv_state * torch.exp(logw[:, 0])[..., None] + kv
        out = y.reshape(B, 1, D)
    else:
        out, state = _rwkv_chunk_scan(r, k, v, logw, p["u"], dims,
                                      wkv_state)
        out = out.reshape(B, S, D)
    out = layer_norm(p["ln_x"], out.to(x.dtype)) * g
    return mm(out, p["wo"]), (state, last.to(torch.bfloat16))


def _rwkv_chunk_scan(r, k, v, logw, u, dims: RwkvDims, init_state):
    """Chunked RWKV6 recurrence, the reference's formula step for step.

    State S_t (P_k x P_v per head): S_t = diag(w_t) S_{t-1} + k_t v_t^T;
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).  Within a chunk, pairwise
    decays through r_t exp(cum_{t-1}) and k_s exp(-cum_s) under a strict
    lower triangle, plus the current-token bonus; across chunks, the
    carried state.  A ragged last chunk is zero-padded (logw = 0 is the
    identity decay; k = v = 0 adds nothing).  fp32 throughout."""
    B, S, H, P = r.shape
    L = min(dims.chunk, S)
    nC = -(-S // L)
    pad = nC * L - S
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    rf, kf, vf, wf = r.float(), k.float(), v.float(), logw
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)                        # strict: s < t
    state = init_state
    ys = []
    for c0 in range(0, nC * L, L):
        rk, kk = rf[:, c0:c0 + L], kf[:, c0:c0 + L]
        vk, wk = vf[:, c0:c0 + L], wf[:, c0:c0 + L]
        cum = torch.cumsum(wk, dim=1)         # decay from chunk start to t
        r_dec = rk * torch.exp(cum - wk)      # r_t exp(cum_{t-1})
        k_dec = kk * torch.exp(-cum)          # k_s exp(-cum_s)
        att = torch.einsum("blhp,bshp->blsh", r_dec, k_dec) \
            * tri[None, :, :, None]
        y_intra = torch.einsum("blsh,bshq->blhq", att, vk)
        # current-token bonus: r_t . (u * k_t) v_t
        bonus = torch.einsum("blhp,blhp->blh", rk, u[None, None] * kk)
        y_inter = torch.einsum("blhp,bhpq->blhq", r_dec, state)
        # S' = diag(exp(cum_L)) S + sum_s exp(cum_L - cum_s) k_s v_s^T
        total = cum[:, -1]                                   # (B,H,P)
        k_tail = kk * torch.exp(total[:, None] - cum)
        state = state * torch.exp(total)[..., None] + torch.einsum(
            "bshp,bshq->bhpq", k_tail, vk)
        ys.append(y_intra + bonus[..., None] * vk + y_inter)
    return torch.cat(ys, dim=1)[:, :S], state


def init_rwkv_cmix(dims: RwkvDims, g: torch.Generator, device,
                   units: int = 0) -> Params:
    """The reference's ``init_rwkv_cmix`` layout and scales."""
    D, Fd = dims.d_model, dims.d_ff
    return {"mix_k": _full((D,), 0.5, device, units),
            "wk": randn((D, Fd), 1.0 / math.sqrt(D), g, device, units),
            "wv": randn((Fd, D), 1.0 / math.sqrt(Fd), g, device, units)}


def rwkv_cmix_fwd(p: Params, x: torch.Tensor,
                  shift_state: Optional[torch.Tensor] = None):
    """RWKV6 channel-mix.  Returns (out, shift_state bf16)."""
    prev, last = _token_shift(x, shift_state)
    xk = x * p["mix_k"] + prev * (1.0 - p["mix_k"])
    h = torch.square(torch.relu(mm(xk, p["wk"])))
    return mm(h, p["wv"]), last.to(torch.bfloat16)
