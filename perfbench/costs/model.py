"""Model FLOPs: the work the model needs, not what an implementation
executes (no recomputation, no padded rows)."""
from __future__ import annotations

from typing import Dict


def layer_params(m: Dict) -> int:
    """Matrix parameters a token passes through in one layer (active
    experts only, router included)."""
    D, H, KV, hd, F = (m["d_model"], m["n_heads"], m["n_kv"], m["head_dim"],
                       m["d_ff"])
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    mats = 3 if m["act"] == "silu" else 2
    if m.get("n_experts"):
        return attn + D * m["n_experts"] + m["top_k"] * mats * D * F
    return attn + mats * D * F


def serve_flops(m: Dict, tokens: int, context_sum: int, logits_rows: int
                ) -> float:
    """Inference: 2 FLOPs per active non-embedding parameter per token
    (Kaplan et al. 2020, arXiv:2001.08361, Table 1), attention's 4 x
    n_layers x H x hd per (token, attended position) with
    ``context_sum`` the positions attended summed over the tokens, and
    the head's 2 x D x vocab for each row of logits computed."""
    return (2.0 * m["n_layers"] * layer_params(m) * tokens
            + 4.0 * m["n_layers"] * m["n_heads"] * m["head_dim"] * context_sum
            + 2.0 * m["d_model"] * m["vocab"] * logits_rows)

