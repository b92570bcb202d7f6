"""Weights made by the benchmark from the seed, on the card, in the
port's parameter layout (``repro_torch.models.lm``: per-layer leaves
stacked over the units), one large draw per leaf, in the dtype they are
served in.  Both the program and the plain reference read these same
tensors.

The scales are the port's initialisation's (N(0, 1/fan_in) projections,
N(0, 0.02^2) embeddings); norm scales are 1 + N(0, 0.1^2), so that a
norm applied wrongly shows.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

BF16 = torch.bfloat16


def _draw(g: torch.Generator, shape, std: float, dtype, device,
          mean: float = 0.0) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(mean, std, generator=g)


def make(cfg: Dict, seed: int, device="cuda") -> Dict:
    """The parameter tree of the MoE attention model the configuration
    file's ``model`` describes: RMS norms, rotary positions, SwiGLU
    experts behind a router, a separate head."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    U, D = cfg["n_layers"], cfg["d_model"]
    H, KV, hd, F = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"], cfg["d_ff"]
    E = cfg["n_experts"]
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)

    def norm(lead=()):
        return {"scale": _draw(g, (*lead, D), 0.1, torch.float32, device,
                               1.0)}

    layer = {"norm1": norm((U,)),
             "attn": {"wq": _draw(g, (U, D, H * hd), s, BF16, device),
                      "wk": _draw(g, (U, D, KV * hd), s, BF16, device),
                      "wv": _draw(g, (U, D, KV * hd), s, BF16, device),
                      "wo": _draw(g, (U, H * hd, D), s, BF16, device)},
             "norm2": norm((U,)),
             "moe": {"router": _draw(g, (U, D, E), s, torch.float32, device),
                     "w_gate": _draw(g, (U, E, D, F), s, BF16, device),
                     "w_up": _draw(g, (U, E, D, F), s, BF16, device),
                     "w_down": _draw(g, (U, E, F, D), sf, BF16, device)}}
    return {"embed": _draw(g, (cfg["vocab"], D), 0.02, BF16, device),
            "final_norm": norm(),
            "units": {"layers": (layer,)},
            "lm_head": _draw(g, (cfg["vocab"], D), 0.02, BF16, device)}
