"""Plain PyTorch versions of the ported kernels (counterpart of
``repro.kernels.ref``).

They compute each kernel's function directly, in fp32, and are what the
kernels are held against: on the CPU, ``kernels.ops`` runs them in the
kernels' place; on the card, ``chip_smoke.py`` compares each kernel with
its plain version on the same inputs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def fused_adam(master: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, *, lr: float, b1: float, b2: float,
               eps: float, wd: float, b1c, b2c
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AdamW update (fp32; g cast to fp32).  Returns (new_master, new_m,
    new_v)."""
    g = g.float()
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    mh = m2 / b1c
    vh = v2 / b2c
    new = master - lr * (mh / (torch.sqrt(vh) + eps) + wd * master)
    return new, m2, v2


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kf = k.repeat_interleave(rep, dim=2).float()
    vf = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _per_row(kv_len, B: int, device) -> torch.Tensor:
    """kv_len as a (B,) int64 tensor (accepts an int, a 0-d or (B,)
    tensor, or an array)."""
    t = torch.as_tensor(kv_len, device=device).to(torch.int64)
    return t.reshape(-1).expand(B) if t.numel() == 1 else t.reshape(B)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """GQA decode: q (B, H, hd); caches (B, S, KV, hd); kv_len scalar or
    (B,) (per-row, unlike the JAX oracle's broadcast).  Returns
    (B, H, hd)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    kf = k_cache.repeat_interleave(rep, dim=2).float()
    vf = v_cache.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kf) / math.sqrt(hd)
    lens = _per_row(kv_len, B, q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] \
        < lens[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vf).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tbl: torch.Tensor,
                           kv_len, k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """Gather-then-compute version of the paged decode kernel.

    Stages the pool blocks named by ``block_tbl`` (B, nb) into a
    contiguous (B, nb*bt, KV, hd) cache, writes the new token at
    position ``kv_len``, and runs plain decode attention over
    ``kv_len + 1`` positions.
    """
    B = q.shape[0]
    bt, KV, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    nb = block_tbl.shape[1]
    idx = block_tbl.to(torch.int64).reshape(-1)
    lens = _per_row(kv_len, B, q.device)
    rows = torch.arange(B, device=q.device)

    def staged(pool, new):
        c = pool.index_select(0, idx).reshape(B, nb * bt, KV, hd)
        # one extra slot so a full table can still take the new token
        c = torch.cat([c, c.new_zeros(B, 1, KV, hd)], dim=1)
        c[rows, lens] = new.to(pool.dtype)
        return c

    return decode_attention(q, staged(k_pool, k_new),
                            staged(v_pool, v_new), lens + 1)


def expert_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, expert_ids: torch.Tensor,
               expert_wts: torch.Tensor) -> torch.Tensor:
    """Gather-then-compute version of the fused expert FFN.

    x (B, D); w_gate/w_up (E, D, F); w_down (E, F, D); expert_ids (B, K);
    expert_wts (B, K).  Copies the routed experts' weights out of the
    stacked store as fp32 (B, K, D, F) selections — the staging the
    kernel skips — and returns sum_k wts * ffn_silu(x; expert) in
    ``x.dtype``, (B, D)."""
    idx = expert_ids.to(torch.int64)
    xf = x.float()
    wg, wu, wd = (w[idx].float() for w in (w_gate, w_up, w_down))
    h = torch.nn.functional.silu(torch.einsum("bd,bkdf->bkf", xf, wg)) \
        * torch.einsum("bd,bkdf->bkf", xf, wu)
    out = torch.einsum("bkf,bkfd->bkd", h, wd)
    return torch.einsum("bk,bkd->bd", expert_wts.float(), out).to(x.dtype)


def expert_ffn_partial(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor,
                       expert_ids: torch.Tensor, expert_wts: torch.Tensor,
                       e_lo: int, e_hi: int, n_experts: int) -> torch.Tensor:
    """Plain version of ``fused_expert_ffn_partial``: the fp32 (B, D)
    sum over the slots whose global id lies in [e_lo, e_hi), read from
    the shard's (e_hi - e_lo, ...) stacks; other slots add 0, and a
    token with an id outside [0, n_experts) gives NaN."""
    idx = expert_ids.to(torch.int64)
    mine = (idx >= e_lo) & (idx < e_hi)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if e_hi > e_lo:
        loc = torch.where(mine, idx - e_lo, torch.zeros_like(idx))
        xf = x.float()
        wg, wu, wd = (w[loc].float() for w in (w_gate, w_up, w_down))
        h = torch.nn.functional.silu(torch.einsum("bd,bkdf->bkf", xf, wg)) \
            * torch.einsum("bd,bkdf->bkf", xf, wu)
        per = torch.einsum("bkf,bkfd->bkd", h, wd)
        per = torch.where(mine[..., None], per, torch.zeros_like(per))
        out = torch.einsum("bk,bkd->bd", expert_wts.float(), per)
    bad = ((idx < 0) | (idx >= n_experts)).any(-1)
    return torch.where(bad[:, None], torch.full_like(out, math.nan), out)


def moe_bucket_positions(topi: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """topi (G, T, k) routed experts (int64) -> (G, T, k) int64: the
    position of each (token, slot) within its expert's bucket of its
    group, counted in token-major order with the slot fastest."""
    G, T, top_k = topi.shape
    ids = topi.reshape(G, T * top_k)
    pos_all = torch.cumsum(F.one_hot(ids, n_experts), dim=1) - 1  # (G,T*k,E)
    return pos_all.gather(-1, ids[..., None])[..., 0].reshape(G, T, top_k)


def moe_bucket_scatter(xt: torch.Tensor, topi: torch.Tensor,
                       pos: torch.Tensor, n_experts: int,
                       capacity: int) -> torch.Tensor:
    """xt (G, T, D); topi, pos (G, T, k).  Returns the expert-major
    buffer (E, G, C, D) in ``xt.dtype`` (a permuted view): each slot's
    token at row (expert, group, position) when the position is below
    the capacity C, zeros elsewhere.  Positions past C go to a dump slot
    C, which is cut off."""
    G = xt.shape[0]
    E, C = n_experts, capacity
    keep = pos < C
    safe_pos = torch.where(keep, pos, torch.full_like(pos, C))

    g = torch.arange(G, device=xt.device)[:, None]
    buf = torch.zeros(G, E, C + 1, xt.shape[-1], dtype=xt.dtype,
                      device=xt.device)
    for j in range(topi.shape[-1]):
        buf.index_put_((g, topi[..., j], safe_pos[..., j]), xt,
                       accumulate=True)
    return buf[:, :, :C].permute(1, 0, 2, 3)


def moe_bucket_combine(expert_out: torch.Tensor, topi: torch.Tensor,
                       topw: torch.Tensor, pos: torch.Tensor
                       ) -> torch.Tensor:
    """expert_out (E, G, C, D), the experts' outputs on the scatter's
    rows; topi, pos (G, T, k); topw (G, T, k) fp32.  Returns (G, T, D) in
    ``expert_out.dtype``: the slots' rows weighted by ``topw`` (0 for a
    slot past C, which reads row C - 1) and added slot by slot in
    order."""
    E, G, C, D = expert_out.shape
    T = topi.shape[1]
    out_buf = expert_out.permute(1, 0, 2, 3)                   # (G,E,C,D)
    keep = pos < C
    safe_pos = torch.where(keep, pos, torch.full_like(pos, C))

    g = torch.arange(G, device=expert_out.device)[:, None]
    w_comb = (topw * keep).to(expert_out.dtype)
    last = torch.clamp(safe_pos, max=C - 1)
    acc = torch.zeros(G, T, D, dtype=expert_out.dtype,
                      device=expert_out.device)
    for j in range(topi.shape[-1]):
        gat = out_buf[g, topi[..., j], last[..., j]]          # (G,T,D)
        acc = acc + gat * w_comb[..., j, None]
    return acc


def ssm_state_update(state: torch.Tensor, slots: torch.Tensor,
                     x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     dt: torch.Tensor, A: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
    """One step of the Mamba-2 recurrence per row, over the state slots:
    s = state[slots[b]] (H, N, P) becomes exp(dt A) s + dt B x^T (B and
    C the row's group's, shared by its H / G heads), written back in
    place; returns y = C^T s + D x, (B, H, P) fp32.  x (B, H*P), Bm and
    Cm (B, G*N), dt (B, H), A and D (H,)."""
    n_slots, H, N, P = state.shape
    B, G = x.shape[0], Bm.shape[1] // N
    xs = x.float().reshape(B, H, P)

    def per_head(t):
        return t.float().reshape(B, G, 1, N).expand(
            B, G, H // G, N).reshape(B, H, N)
    idx = slots.long()
    dtf = dt.float()
    s = (torch.exp(dtf * A)[..., None, None] * state[idx]
         + (dtf[..., None] * per_head(Bm))[..., None] * xs[:, :, None, :])
    state[idx] = s
    return torch.einsum("bhn,bhnp->bhp", per_head(Cm), s) \
        + D[None, :, None] * xs
