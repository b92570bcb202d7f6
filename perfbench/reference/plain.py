"""Plain PyTorch pieces of the references: fp32, no kernels, no cache,
no batching.  Nothing here imports the program.

``Precision`` says how a matrix product is computed: fp32 (the
reference) or with both operands rounded to float8 e4m3 first, weights
per output column and activations per row (the control: the step below
the configuration's bf16)."""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """fp32 products on the card without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (fp32) rounded to e4m3 with one scale per slice along
    ``dim`` (amax / 448), returned in fp32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (..., in, out) weight as the products will read it."""
        w = w.float()
        return fp8_round(w, dim=-2) if self.fp8 else w

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (..., in) @ w (in, out), w from ``weight``."""
        if self.fp8:
            a = fp8_round(a, dim=-1)
        return a @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding of x (S, H, hd) over interleaved pairs (x[2i],
    x[2i+1]), as the port rotates them."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = positions.float()[:, None] * freqs                  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = b * cos + a * sin
    return out


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     chunk: int = 1024) -> torch.Tensor:
    """q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd): softmax(q k^T /
    sqrt(hd)) v over the positions up to each query's own, grouped
    query heads reading KV head h // (H // KV); queries in chunks so
    that the scores of one chunk exist at a time."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).permute(1, 2, 0)     # (H, hd, S)
    vh = v.repeat_interleave(rep, dim=1).permute(1, 0, 2)     # (H, S, hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, chunk):
        q1 = min(S, q0 + chunk)
        s = (q[q0:q1].permute(1, 0, 2) @ kh[:, :, :q1]) / math.sqrt(hd)
        mask = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        out[q0:q1] = (torch.softmax(s, dim=-1) @ vh[:, :q1]).permute(1, 0, 2)
    return out

