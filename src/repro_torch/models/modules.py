"""Model building blocks in PyTorch (counterpart of
``repro.models.modules``, attention-only families).

Plain functions over explicit parameter dictionaries, in the reference's
layouts: activations (B, S, D), heads (B, S, H, hd), weights stored
(in, out) so a projection is ``x @ w``.  Compute dtype bf16 unless
stated; norms and softmax statistics run in fp32, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


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


def apply_norm(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(p, x) if kind == "rms" else layer_norm(p, x)


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
