"""Weights of a hybrid Mamba-2 / attention model with routed and shared
experts (granite-4.0-h-small's layout), made by the benchmark from the
seed on the card, in the port's parameter layout
(``repro_torch.models.lm``: each place of the repeating unit a dict of
leaves stacked over the units), one large draw per leaf, in the dtype
they are served in.  The program and the plain reference
(``perfbench/reference/granite_hybrid.py``) read these same tensors.

Scales: projections N(0, 1/fan_in), the conv N(0, 1/d_conv) with a
bias of N(0, 0.1^2), the embedding (tied to the head) N(0, 1/(16 D)):
through the tied head a token's own embedding, carried in the residual
stream at ``embedding_multiplier`` x, gives its own logit a share that
grows as the embedding's std times sqrt(D), and at the N(0, 0.02^2) of
the other weight makers that share wins at every position at D 4096
(a random model that repeats its input, which any decode serves
"correctly"); at 1/(16 D) no position's argmax is its input token
(PERF.md).  Norm scales and the skip D are 1 + N(0, 0.1^2), so that one
applied wrongly shows; A_log = log U(1, 16) and dt_bias the inverse
softplus of dt = exp U(log 0.001, log 0.1), the published Mamba-2
initialisation.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .weights import _draw, BF16

F32 = torch.float32


def make(cfg: Dict, seed: int, device="cuda") -> Dict:
    """The parameter tree the configuration file's ``model`` describes:
    ``attn_layers`` (layer indices) of GQA attention, the other layers
    published Mamba-2, each layer an MoE of ``n_experts`` SwiGLU
    experts and a shared SwiGLU expert of ``shared_expert_ff``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, D = cfg["n_layers"], cfg["d_model"]
    period = cfg["period"]
    U = L // period
    H, KV, hd, F = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"], cfg["d_ff"]
    E, Fs = cfg["n_experts"], cfg["shared_expert_ff"]
    di = cfg["mamba_expand"] * D
    Hm, N, Gm, K = (di // cfg["mamba_head_dim"], cfg["mamba_d_state"],
                    cfg["mamba_groups"], cfg["mamba_d_conv"])
    conv = di + 2 * Gm * N
    s = 1.0 / math.sqrt(D)
    attn_at = {l % period for l in cfg["attn_layers"]}

    def norm(lead, width=D):
        return {"scale": _draw(g, (*lead, width), 0.1, F32, device, 1.0)}

    def uniform(lo, hi):
        return torch.empty((U, Hm), dtype=F32, device=device).uniform_(
            lo, hi, generator=g)

    def mixer(i):
        if i in attn_at:
            return "attn", {
                "wq": _draw(g, (U, D, H * hd), s, BF16, device),
                "wk": _draw(g, (U, D, KV * hd), s, BF16, device),
                "wv": _draw(g, (U, D, KV * hd), s, BF16, device),
                "wo": _draw(g, (U, H * hd, D), s, BF16, device)}
        dt = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
        return "mamba", {
            "w_in": _draw(g, (U, D, di + conv + Hm), s, BF16, device),
            "conv_w": _draw(g, (U, K, conv), 1.0 / math.sqrt(K), BF16,
                            device),
            "conv_b": _draw(g, (U, conv), 0.1, BF16, device),
            "A_log": torch.log(uniform(1.0, 16.0)),
            "D": _draw(g, (U, Hm), 0.1, F32, device, 1.0),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "w_out": _draw(g, (U, di, D), 1.0 / math.sqrt(di), BF16, device),
            "norm": norm((U,), di)}

    layers = []
    for i in range(period):
        kind, mp = mixer(i)
        layers.append({
            "norm1": norm((U,)), kind: mp, "norm2": norm((U,)),
            "moe": {"router": _draw(g, (U, D, E), s, F32, device),
                    "w_gate": _draw(g, (U, E, D, F), s, BF16, device),
                    "w_up": _draw(g, (U, E, D, F), s, BF16, device),
                    "w_down": _draw(g, (U, E, F, D), 1.0 / math.sqrt(F),
                                    BF16, device)},
            "shared": {"w_gate": _draw(g, (U, D, Fs), s, BF16, device),
                       "w_up": _draw(g, (U, D, Fs), s, BF16, device),
                       "w_down": _draw(g, (U, Fs, D), 1.0 / math.sqrt(Fs),
                                       BF16, device)}})
    return {"embed": _draw(g, (cfg["vocab"], D), 0.25 / math.sqrt(D), BF16,
                           device),
            "final_norm": norm(()),
            "units": {"layers": tuple(layers)}}
