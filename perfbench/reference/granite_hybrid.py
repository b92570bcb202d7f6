"""Plain reference of the served granite-4.0-h-small (IBM Granite 4.0-H:
Mamba-2 and GQA layers, each followed by routed and shared SwiGLU
experts), a full forward pass over each prompt and its served tokens,
layer by layer over every sampled sequence at once, in fp32 (TF32 off:
``plain.strict_fp32``).

The Mamba-2 layers follow the published block (Dao & Gu, "Transformers
are SSMs", arXiv:2405.21060): in_proj to [z, x, B, C, dt], a causal
depthwise conv with bias over [x, B, C] and silu, dt = softplus(dt +
dt_bias), A = -exp(A_log), and the SSM in its quadratic masked form
(Sec. 3 there), y = (L o C B^T) (dt x) + D x with L[t, s] = exp(sum of
dt_r A over s < r <= t) for s <= t, computed for one block of query
positions at a time, the decay sums taken from the block's first
position so that nearby positions lose no precision; then the gated
norm, RMS over groups of y * silu(z), and out_proj.  This is not the
program's chunked scan.  Attention has no positional encoding and the
softmax scale ``attention_multiplier``; every sublayer's output is
scaled by ``residual_multiplier``, the embeddings by
``embedding_multiplier``, the logits divided by ``logits_scaling``.

The semantics are the port's where it departs from the published model
(``perfbench/configs/granite-4.0-h-small.json`` lists the departures):
the prompt's MoE layers are routed with the port's group capacity
(``qwen3_moe.capacity_route``: pairs past an expert's capacity
dropped), served positions with the plain top-k, renormalised.

It reads the benchmark's weights and token ids, and nothing the program
made; the program's served tokens are what it judges.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .plain import Precision, rms_norm
from .qwen3_moe import capacity_route, gaps, plain_route  # noqa: F401

QUERY_BLOCK = 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, chunk: int = 1024) -> torch.Tensor:
    """Causal GQA softmax(scale q k^T) v without positions: q (S, H, hd),
    k/v (S, KV, hd), query head h reading KV head h // (H // KV); the
    queries in chunks."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).permute(1, 2, 0)     # (H, hd, S)
    vh = v.repeat_interleave(rep, dim=1).permute(1, 0, 2)     # (H, S, hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, chunk):
        q1 = min(S, q0 + chunk)
        s = (q[q0:q1].permute(1, 0, 2) @ kh[:, :, :q1]) * scale
        mask = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        out[q0:q1] = (torch.softmax(s, dim=-1) @ vh[:, :q1]).permute(1, 0, 2)
    return out


def ssd_quadratic(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  block: int = QUERY_BLOCK) -> torch.Tensor:
    """y_t = sum_{s <= t} exp(sum_{s < r <= t} dt_r A) (C_t . B_s) dt_s
    x_s, the masked quadratic form, for one sequence: x (S, H, P), dt
    (S, H) (after softplus), A (H,) < 0, Bm and Cm (S, G, N), the H / G
    heads of a group reading its B and C.  Returns y (S, H, P) fp32."""
    S, H, P = x.shape
    G = Bm.shape[1]
    a = dt * A                                               # (S, H)
    xdt = x * dt[..., None]
    y = torch.empty((S, H, P), dtype=torch.float32, device=x.device)
    pos = torch.arange(S, device=x.device)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        # decay sums from q0: fwd[t] over q0 < r <= t, and for s <= q0
        # back[s] over s < r <= q0 (summed from q0 backwards)
        fwd = torch.cumsum(
            torch.cat([torch.zeros_like(a[:1]), a[q0 + 1:q1]]), 0)
        back = torch.cat([torch.flip(torch.cumsum(
            torch.flip(a[1:q0 + 1], [0]), 0), [0]), torch.zeros_like(a[:1])])
        e = torch.cat([back, -fwd[1:]])                      # (q1, H)
        seg = fwd[:, None, :] + e[None, :, :]                # (Q, q1, H)
        live = pos[None, :q1] <= pos[q0:q1, None]
        L = torch.exp(seg.masked_fill(~live[..., None], float("-inf")))
        cb = torch.einsum("qgn,sgn->qsg", Cm[q0:q1], Bm[:q1])
        W = (L.view(q1 - q0, q1, G, H // G) * cb[..., None]).view(
            q1 - q0, q1, H)
        y[q0:q1] = torch.einsum("qsh,shp->qhp", W, xdt[:q1])
    return y


def _mamba(lw: Dict, h: torch.Tensor, m: Dict,
           prec: Precision) -> torch.Tensor:
    """The published Mamba-2 block over one sequence h (S, D)."""
    S = h.shape[0]
    di = m["mamba_expand"] * m["d_model"]
    P, N, G, K = (m["mamba_head_dim"], m["mamba_d_state"], m["mamba_groups"],
                  m["mamba_d_conv"])
    H = di // P
    z, xbc, dt = torch.split(prec.mm(h, lw["w_in"]),
                             [di, di + 2 * G * N, H], dim=-1)
    xpad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xpad[i:i + S] * lw["conv_w"][i] for i in range(K))
    conv = F.silu(conv + lw["conv_b"])
    xs, Bm, Cm = torch.split(conv, [di, G * N, G * N], dim=-1)
    x = xs.reshape(S, H, P)
    dt = F.softplus(dt + lw["dt_bias"])
    y = ssd_quadratic(x, dt, -torch.exp(lw["A_log"]), Bm.reshape(S, G, N),
                      Cm.reshape(S, G, N))
    y = (y + x * lw["D"][:, None]).reshape(S, di)
    g = (y * F.silu(z)).reshape(S, G, di // G)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + m["norm_eps"])
    return prec.mm(g.reshape(S, di) * lw["norm"], lw["w_out"])


def _layer(w: Dict, l: int, m: Dict, prec: Precision) -> Dict:
    """Layer ``l``'s weights in fp32 (products' operands as ``prec``
    reads them): unit l // period, place l % period of the stacks."""
    layers = w["units"]["layers"]
    lp = layers[l % len(layers)]
    u = l // len(layers)
    out = {"norm1": lp["norm1"]["scale"][u].float(),
           "norm2": lp["norm2"]["scale"][u].float(),
           "router": lp["moe"]["router"][u].float(),
           **{k: prec.weight(lp["moe"][k][u])
              for k in ("w_gate", "w_up", "w_down")},
           **{"s_" + k: prec.weight(lp["shared"][k][u])
              for k in ("w_gate", "w_up", "w_down")}}
    if "attn" in lp:
        out.update({k: prec.weight(lp["attn"][k][u])
                    for k in ("wq", "wk", "wv", "wo")})
    else:
        mp = lp["mamba"]
        out.update(w_in=prec.weight(mp["w_in"][u]),
                   w_out=prec.weight(mp["w_out"][u]),
                   norm=mp["norm"]["scale"][u].float(),
                   **{k: mp[k][u].float() for k in ("conv_w", "conv_b",
                                                    "A_log", "D",
                                                    "dt_bias")})
    return out


def _swiglu(h, wg, wu, wd, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, wg)) * prec.mm(h, wu), wd)


def served_logits(w: Dict, m: Dict, seqs: Sequence[torch.Tensor],
                  prompt_lens: Sequence[int], fp8: bool = False
                  ) -> List[torch.Tensor]:
    """For each sequence (prompt and served tokens, the last served one
    left out) the fp32 logits (n, V) at positions prompt_len - 1 onwards:
    row j predicts served token j.  ``fp8``: the control's products."""
    prec = Precision(fp8)
    H, KV, hd, K = m["n_heads"], m["n_kv"], m["head_dim"], m["top_k"]
    eps, rm = m["norm_eps"], m["residual_multiplier"]
    dev = w["embed"].device
    xs = [w["embed"][s.to(dev)].float() * m["embedding_multiplier"]
          for s in seqs]
    lens = [x.shape[0] for x in xs]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    for l in range(m["n_layers"]):
        lw = _layer(w, l, m, prec)
        for i, x in enumerate(xs):
            S = x.shape[0]
            h = rms_norm(x, lw["norm1"], eps)
            if "wq" in lw:
                q = prec.mm(h, lw["wq"]).reshape(S, H, hd)
                k = prec.mm(h, lw["wk"]).reshape(S, KV, hd)
                v = prec.mm(h, lw["wv"]).reshape(S, KV, hd)
                out = prec.mm(attention(q, k, v, m["attention_multiplier"])
                              .reshape(S, H * hd), lw["wo"])
            else:
                out = _mamba(lw, h, m, prec)
            xs[i] = x + out * rm
        h = torch.cat([rms_norm(x, lw["norm2"], eps) for x in xs])
        probs = torch.softmax(h @ lw["router"], dim=-1)
        ids, wts = [], []
        for st, L, P in zip(starts, lens, prompt_lens):
            a, b = capacity_route(probs[st:st + P], K,
                                  m["capacity_factor"], m["moe_groups"])
            c, d = plain_route(probs[st + P:st + L], K)
            ids.append(torch.cat([a, c]))
            wts.append(torch.cat([b, d]))
        ids, wts = torch.cat(ids), torch.cat(wts)
        out = _swiglu(h, lw["s_w_gate"], lw["s_w_up"], lw["s_w_down"], prec)
        for e in range(m["n_experts"]):
            tok, slot = torch.nonzero(ids == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = _swiglu(h[tok], lw["w_gate"][e], lw["w_up"][e],
                        lw["w_down"][e], prec)
            out.index_add_(0, tok, y * wts[tok, slot, None])
        for i, (st, L) in enumerate(zip(starts, lens)):
            xs[i] = xs[i] + out[st:st + L] * rm
        del lw
    head = prec.weight(w["embed"].T)
    outs = []
    for x, P in zip(xs, prompt_lens):
        h = rms_norm(x[P - 1:], w["final_norm"]["scale"], eps)
        outs.append(prec.mm(h, head) / m["logits_scaling"])
    return outs
