"""Model FLOPs of a hybrid Mamba-2 / attention model with routed and
shared experts, and the operations and bytes of one call of the
Mamba-2 decode state update (``kernels/ops.py ssm_state_update``),
counted as ``costs/kernels.py`` counts: each input byte read once, each
output byte written once."""
from __future__ import annotations

from typing import Dict, Tuple

BF16, F32, I32 = 2, 4, 4


def mamba_dims(m: Dict) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, N, P, groups) of the Mamba-2 layers."""
    di = m["mamba_expand"] * m["d_model"]
    P = m["mamba_head_dim"]
    return di, di // P, m["mamba_d_state"], P, m["mamba_groups"]


def layer_params(m: Dict, attention: bool) -> int:
    """Matrix parameters a token passes through in one layer: the mixer
    (Mamba-2's in_proj to [z, x, B, C, dt] and out_proj, or attention's
    four projections), the router, its top-k routed experts and the
    shared expert."""
    D, F = m["d_model"], m["d_ff"]
    if attention:
        H, KV, hd = m["n_heads"], m["n_kv"], m["head_dim"]
        mixer = D * H * hd + 2 * D * KV * hd + H * hd * D
    else:
        di, H, N, _, G = mamba_dims(m)
        mixer = D * (2 * di + 2 * G * N + H) + di * D
    return (mixer + D * m["n_experts"] + m["top_k"] * 3 * D * F
            + 3 * D * m["shared_expert_ff"])


def serve_flops(m: Dict, tokens: int, context_sum: int, logits_rows: int
                ) -> float:
    """Inference: 2 FLOPs per active matrix parameter per token (Kaplan
    et al. 2020, arXiv:2001.08361, Table 1) over every layer; each
    Mamba-2 layer's SSM, 4 H N P a token (the state's decay-and-add and
    its readout, a multiply-add each per state element); attention's
    4 H hd per (token, attended position) at the attention layers, with
    ``context_sum`` the positions attended summed over the tokens; and
    the head's 2 D V per row of logits."""
    L = m["n_layers"]
    n_attn = len(m["attn_layers"])
    _, H, N, P, _ = mamba_dims(m)
    per_token = (2.0 * (n_attn * layer_params(m, True)
                        + (L - n_attn) * layer_params(m, False))
                 + 4.0 * (L - n_attn) * H * N * P)
    return (per_token * tokens
            + 4.0 * n_attn * m["n_heads"] * m["head_dim"] * context_sum
            + 2.0 * m["d_model"] * m["vocab"] * logits_rows)


def ssm_state_update(B: int, H: int, N: int, P: int, G: int
                     ) -> Tuple[float, float]:
    """One decode token for B rows: each row's (H, N, P) fp32 state read
    once and written once (decay, add dt B x^T: 3 operations an element;
    the readout C^T s: 2), plus x (bf16), B and C (bf16, a group's
    shared by its heads), dt (fp32), the slot ids, A and D, and y
    (fp32) written."""
    flops = 5.0 * B * H * N * P + 2.0 * B * H * P
    nbytes = (2 * B * H * N * P * F32 + B * H * P * BF16
              + 2 * B * G * N * BF16 + B * H * F32 + B * I32
              + 2 * H * F32 + B * H * P * F32)
    return flops, nbytes
