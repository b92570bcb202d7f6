"""Plain reference of the served Qwen3-MoE model, as the port serves it:
a full forward pass over each prompt and its served tokens, layer by
layer over every sampled sequence at once, in fp32.

The semantics are the port's, which depart from the published model in
three places (``perfbench/configs/qwen3-moe-30b-a3b.json`` lists them):
no q/k norms, rotary pairs interleaved, and the prompt's MoE layers
routed with the port's group capacity, where (token, slot) pairs past an
expert's capacity are dropped.  So a prompt position takes the capacity
routing of its own prefill (the prompt's tokens split into groups, each
pair's place in its expert's bucket counted token-major, pairs at or
past the capacity weighted 0), and a served position the plain top-k,
renormalised, without drop.

It reads the benchmark's weights and token ids, and nothing the program
made; the program's served tokens are what it judges.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .plain import Precision, causal_attention, rms_norm, rope

EPS = 1e-6


def capacity_route(probs: torch.Tensor, K: int, capacity_factor: float,
                   n_groups: int):
    """A prompt's routing: probs (N, E) fp32 -> (ids (N, K), weights
    (N, K)), the weights of dropped pairs 0.  The N tokens split into G
    contiguous groups, G the largest divisor of N not above
    ``n_groups``; the capacity is max(int(T K cf / E), 4) for T = N / G."""
    N, E = probs.shape
    G = min(n_groups, N)
    while N % G:
        G -= 1
    T = N // G
    topw, topi = torch.topk(probs, K, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    C = max(int(T * K * capacity_factor / E), 4)
    ids = topi.reshape(G, T * K)
    pos = (torch.cumsum(F.one_hot(ids, E), dim=1) - 1).gather(
        -1, ids[..., None])[..., 0].reshape(N, K)
    return topi, topw * (pos < C)


def plain_route(probs: torch.Tensor, K: int):
    topw, topi = torch.topk(probs, K, dim=-1)
    return topi, topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)


def _layer(w: Dict, u: int, prec: Precision) -> Dict:
    lw = w["units"]["layers"][0]
    a, moe = lw["attn"], lw["moe"]
    return {"norm1": lw["norm1"]["scale"][u], "norm2": lw["norm2"]["scale"][u],
            **{k: prec.weight(a[k][u]) for k in ("wq", "wk", "wv", "wo")},
            "router": moe["router"][u].float(),
            **{k: prec.weight(moe[k][u])
               for k in ("w_gate", "w_up", "w_down")}}


def served_logits(w: Dict, m: Dict, seqs: Sequence[torch.Tensor],
                  prompt_lens: Sequence[int], fp8: bool = False
                  ) -> List[torch.Tensor]:
    """For each sequence (prompt and served tokens, the last served one
    left out) the fp32 logits (n, V) at positions prompt_len - 1 onwards:
    row j predicts served token j.  ``fp8``: the control's products."""
    prec = Precision(fp8)
    H, KV, hd, K = m["n_heads"], m["n_kv"], m["head_dim"], m["top_k"]
    dev = w["embed"].device
    xs = [w["embed"][s.to(dev)].float() for s in seqs]
    lens = [x.shape[0] for x in xs]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    for u in range(m["n_layers"]):
        lw = _layer(w, u, prec)
        for i, x in enumerate(xs):
            S = x.shape[0]
            h = rms_norm(x, lw["norm1"], EPS)
            pos = torch.arange(S, device=dev)
            q = rope(prec.mm(h, lw["wq"]).reshape(S, H, hd), pos,
                     m["rope_theta"])
            k = rope(prec.mm(h, lw["wk"]).reshape(S, KV, hd), pos,
                     m["rope_theta"])
            v = prec.mm(h, lw["wv"]).reshape(S, KV, hd)
            xs[i] = x + prec.mm(causal_attention(q, k, v).reshape(S, H * hd),
                                lw["wo"])
        h = torch.cat([rms_norm(x, lw["norm2"], EPS) for x in xs])
        probs = torch.softmax(h @ lw["router"], dim=-1)
        ids, wts = [], []
        for st, L, P in zip(starts, lens, prompt_lens):
            a, b = capacity_route(probs[st:st + P], K,
                                  m["capacity_factor"], m["moe_groups"])
            c, d = plain_route(probs[st + P:st + L], K)
            ids.append(torch.cat([a, c]))
            wts.append(torch.cat([b, d]))
        ids, wts = torch.cat(ids), torch.cat(wts)
        out = torch.zeros_like(h)
        for e in range(m["n_experts"]):
            tok, slot = torch.nonzero(ids == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            he = h[tok]
            y = prec.mm(F.silu(prec.mm(he, lw["w_gate"][e]))
                        * prec.mm(he, lw["w_up"][e]), lw["w_down"][e])
            out.index_add_(0, tok, y * wts[tok, slot, None])
        for i, (st, L) in enumerate(zip(starts, lens)):
            xs[i] = xs[i] + out[st:st + L]
        del lw
    head = prec.weight(w["lm_head"].T)
    outs = []
    for x, P in zip(xs, prompt_lens):
        h = rms_norm(x[P - 1:], w["final_norm"]["scale"], EPS)
        outs.append(prec.mm(h, head))
    return outs


def gaps(logits: Sequence[torch.Tensor],
         served: Sequence[torch.Tensor]) -> torch.Tensor:
    """At every served position, how far the served token's reference
    logit lies below the reference's best (0 where it is the best)."""
    out = []
    for lg, tok in zip(logits, served):
        got = lg.gather(-1, tok.to(lg.device)[:, None])[:, 0]
        out.append(lg.max(dim=-1).values - got)
    return torch.cat(out)

