"""Port kernels' plain versions (what the CPU runs in the kernels'
place) against the JAX kernels, run through ``repro.kernels.ops`` in
interpret mode, on the reference tests' shapes and edge cases."""
import math
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, BF16, FP32, normal,  # noqa: E402
                           to_torch)

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention as decode_kernel)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_split_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels._launch import expert_plan  # noqa: E402
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    fused_expert_ffn as expert_kernel)
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    paged_decode_attention as paged_kernel)
from repro_torch.kernels.tiered_gather import split_plan  # noqa: E402

BF16_NP = jnp.bfloat16


def _both(a):
    return jnp.asarray(a), to_torch(a)


# ------------------------- flash attention ---------------------------- #
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 256, 256, 8, 2, 64),      # GQA
    (1, 384, 128, 4, 1, 32),      # MQA, Sq > Sk
    (2, 130, 259, 4, 4, 64),      # ragged (padding path)
])
def test_flash_attention_sweep(B, Sq, Sk, H, KV, hd):
    rs = np.random.RandomState(0)
    q = normal(rs, (B, Sq, H, hd), 0.5)
    k = normal(rs, (B, Sk, KV, hd), 0.5)
    v = normal(rs, (B, Sk, KV, hd), 0.5)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    got = ops.flash_attention(*map(to_torch, (q, k, v)), causal=True)
    assert got.shape == (B, Sq, H, hd)
    assert_close(got, want, FP32)


def test_flash_attention_bf16():
    rs = np.random.RandomState(1)
    q, k, v = (normal(rs, (1, 128, 4, 64), 0.5).astype(BF16_NP)
               for _ in range(3))
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    got = ops.flash_attention(*map(to_torch, (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, BF16)


def test_flash_matches_chunked_attention():
    """The plain flash version and the port's chunked attention compute
    the same function as the reference's chunked attention."""
    from repro.models.modules import chunked_attention as jchunked
    from repro_torch.models.modules import chunked_attention
    rs = np.random.RandomState(2)
    q = normal(rs, (2, 256, 8, 64), 0.3)
    k = normal(rs, (2, 256, 4, 64), 0.3)
    v = normal(rs, (2, 256, 4, 64), 0.3)
    want = jchunked(*map(jnp.asarray, (q, k, v)), causal=True,
                    chunk_q=64, chunk_kv=64)
    tq, tk, tv = map(to_torch, (q, k, v))
    assert_close(ops.flash_attention(tq, tk, tv, causal=True), want, FP32)
    assert_close(chunked_attention(tq, tk, tv, causal=True, chunk_q=64,
                                   chunk_kv=64), want, FP32)


def test_flash_noncausal_ragged_raises_like_reference():
    rs = np.random.RandomState(3)
    q = normal(rs, (1, 8, 2, 32))
    k = normal(rs, (1, 130, 2, 32))
    with pytest.raises(ValueError, match="non-causal"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(k), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(to_torch(q), to_torch(k), to_torch(k),
                            causal=False)


# ------------------------- decode attention --------------------------- #
@pytest.mark.parametrize("B,S,H,KV,hd,blk", [
    (1, 256, 4, 4, 64, 128),
    (4, 512, 8, 2, 64, 256),
    (2, 1024, 16, 1, 128, 256),
])
def test_decode_attention_sweep(B, S, H, KV, hd, blk):
    rs = np.random.RandomState(4)
    q = normal(rs, (B, H, hd))
    kc = normal(rs, (B, S, KV, hd))
    vc = normal(rs, (B, S, KV, hd))
    kv_len = (np.arange(1, B + 1) * (S // (B + 1)) + 1).astype(np.int32)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, kv_len)),
                                 block_k=blk)
    got = ops.decode_attention(*map(to_torch, (q, kc, vc, kv_len)))
    assert_close(got, want, FP32)


@pytest.mark.parametrize("kv_len", [0, 1, 15, 16, 17, 128])
def test_decode_attention_ragged_edges(kv_len):
    """Block edges, one live position, and kv_len = 0 (the reference
    then averages V over the whole padded cache)."""
    rs = np.random.RandomState(5)
    B, S, H, KV, hd = 2, 128, 8, 2, 32
    q = normal(rs, (B, H, hd))
    kc, vc = normal(rs, (B, S, KV, hd)), normal(rs, (B, S, KV, hd))
    lens = np.full((B,), kv_len, np.int32)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                                 block_k=16)
    got = ops.decode_attention(*map(to_torch, (q, kc, vc, lens)))
    assert_close(got, want, FP32)


@pytest.mark.parametrize("KV", [4, 8])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [16, 96, 544, 2048])
def test_decode_split_plan(S, B, KV):
    """The contiguous kernel's pass-1 plan: T a multiple of 16, splits
    that cover S and none that starts past it, at least one block per SM
    (132) unless each split is one 16-token granule, and (64, 9) at the
    main path (S 544, batch 4)."""
    T, n_split = decode_split_plan(S, B, KV)
    assert T >= 16 and T % 16 == 0 and n_split >= 1
    assert (n_split - 1) * T < S <= n_split * T
    assert B * KV * n_split >= 132 or T == 16
    if (S, B) == (544, 4):
        assert (T, n_split) == (64, 9)


def _split_decode(q, kc, vc, kv_len, T):
    """The contiguous kernel's two passes, in PyTorch: per T-token split,
    scores of positions >= kv_len masked to -1e30 and tokens past
    ``end = kv_len <= 0 ? S : min(kv_len, S)`` not read, fp32 partials
    (m, l, acc), a split past ``end`` empty (m -1e30, l 0, acc 0); then
    the merge with the max correction, out = A / max(L, 1e-30)."""
    B, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    rep = H // KV
    kf = kc.float().repeat_interleave(rep, 2)
    vf = vc.float().repeat_interleave(rep, 2)
    out = torch.empty(B, H, hd)
    for b in range(B):
        n = int(kv_len[b])
        end = S if n <= 0 else min(n, S)
        ms, ls, accs = [], [], []
        for t0 in range(0, S, T):
            t1 = min(t0 + T, end)
            if t1 <= t0:
                ms.append(torch.full((H,), -1e30))
                ls.append(torch.zeros(H))
                accs.append(torch.zeros(H, hd))
                continue
            s = torch.einsum("hd,thd->ht", q[b].float(), kf[b, t0:t1]) \
                / math.sqrt(hd)
            pos = torch.arange(t0, t1)
            s = torch.where(pos[None] < n, s, torch.full_like(s, -1e30))
            m = s.max(-1).values
            p = torch.exp(s - m[:, None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("ht,thd->hd", p, vf[b, t0:t1]))
        m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        c = torch.exp(m - m.max(0).values)
        out[b] = (acc * c[..., None]).sum(0) \
            / (l * c).sum(0).clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype", [np.float32, BF16_NP])
@pytest.mark.parametrize("KV,hd", [(4, 64), (4, 128), (8, 64), (8, 128)])
def test_decode_split_merge_matches_reference(KV, hd, dtype):
    """The split form (T-token partials, then the merge) against the JAX
    kernel at S 544 (planned as the main path's 560-token caches: T 64,
    9 splits), one row per kv_len: -1 and 0 (the
    reference's uniform weights over the whole cache), one live token,
    the split edges T - 1, T, T + 1, and S - 1, S."""
    S, H = 544, 2 * KV
    T, n_split = decode_split_plan(S, 8, KV)
    assert (T, n_split) == (64, 9)
    lens = np.asarray([-1, 0, 1, T - 1, T, T + 1, S - 1, S], np.int32)
    B = len(lens)
    rs = np.random.RandomState(6)
    q = normal(rs, (B, H, hd), 1.0, dtype)
    kc = normal(rs, (B, S, KV, hd), 1.0, dtype)
    vc = normal(rs, (B, S, KV, hd), 1.0, dtype)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                                 block_k=32)
    got = _split_decode(*map(to_torch, (q, kc, vc, lens)), T)
    tol = FP32 if dtype == np.float32 else BF16
    assert_close(got, want, tol)
    uniform = to_torch(vc[:2]).float().mean(1).repeat_interleave(H // KV, 1)
    assert_close(got[:2], uniform, tol)


# ---------------------- paged decode attention ------------------------ #
def _paged_inputs(seed, B, H, KV, hd, bt, nb, num_blocks,
                  dtype=np.float32):
    rs = np.random.RandomState(seed)
    q = normal(rs, (B, H, hd), 0.3, dtype)
    kp = normal(rs, (num_blocks, bt, KV, hd), 0.3, dtype)
    vp = normal(rs, (num_blocks, bt, KV, hd), 0.3, dtype)
    tbl = rs.randint(0, num_blocks, (B, nb)).astype(np.int32)
    kn = normal(rs, (B, KV, hd), 0.3, dtype)
    vn = normal(rs, (B, KV, hd), 0.3, dtype)
    return q, kp, vp, tbl, kn, vn


def _paged_both(q, kp, vp, tbl, lens, kn, vn, bt):
    want = jops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tbl, lens, kn, vn)), block_tokens=bt)
    got = ops.paged_decode_attention(
        *map(to_torch, (q, kp, vp, tbl, lens, kn, vn)), block_tokens=bt)
    return got, want


@pytest.mark.parametrize("B,H,KV,hd,bt,nb,num_blocks", [
    (1, 4, 4, 64, 16, 2, 8),       # MHA, tiny pool
    (4, 8, 2, 64, 32, 4, 16),      # GQA
    (2, 16, 1, 32, 64, 3, 32),     # MQA, odd block count
])
def test_paged_decode_attention_sweep(B, H, KV, hd, bt, nb, num_blocks):
    q, kp, vp, tbl, kn, vn = _paged_inputs(0, B, H, KV, hd, bt, nb,
                                           num_blocks)
    lens = np.asarray([(i * 7 + 3) % (nb * bt) for i in range(B)],
                      np.int32)
    got, want = _paged_both(q, kp, vp, tbl, lens, kn, vn, bt)
    assert got.shape == (B, H, hd)
    assert_close(got, want, FP32)


@pytest.mark.parametrize("kv_len", [0, 31, 32, 33, 127])
def test_paged_decode_attention_block_boundaries(kv_len):
    B, H, KV, hd, bt, nb = 2, 4, 2, 32, 32, 4
    q, kp, vp, tbl, kn, vn = _paged_inputs(1, B, H, KV, hd, bt, nb, 8)
    lens = np.full((B,), kv_len, np.int32)
    got, want = _paged_both(q, kp, vp, tbl, lens, kn, vn, bt)
    assert_close(got, want, FP32)


def test_paged_decode_attention_shared_blocks_and_bf16():
    B, H, KV, hd, bt, nb = 3, 8, 2, 64, 16, 3
    q, kp, vp, _, kn, vn = _paged_inputs(2, B, H, KV, hd, bt, nb, 4,
                                         dtype=BF16_NP)
    tbl = np.asarray([[0, 1, 2], [2, 1, 0], [1, 1, 3]], np.int32)
    lens = np.asarray([40, 17, 5], np.int32)
    got, want = _paged_both(q, kp, vp, tbl, lens, kn, vn, bt)
    assert_close(got, want, BF16)


@pytest.mark.parametrize("nb,bt,B,KV", [
    (35, 16, 4, 8), (35, 16, 4, 4),          # the main path: 288, 144
    (35, 16, 1, 8), (35, 16, 1, 4), (4, 16, 3, 8), (1, 16, 1, 1),
    (8, 32, 2, 2), (3, 64, 2, 1), (5, 128, 4, 8), (200, 16, 16, 8),
])
def test_paged_split_plan(nb, bt, B, KV):
    """The split plan of the paged kernel's pass 1: T a multiple of
    block_tokens, n_split >= 1 splits that cover the table and none that
    starts past it, and at least one block per SM (132) unless each
    split is already one pool block."""
    T, n_split = split_plan(nb, bt, B, KV)
    assert n_split >= 1 and T >= bt and T % bt == 0
    assert (n_split - 1) * T < nb * bt <= n_split * T
    assert B * KV * n_split >= 132 or T == bt
    if (nb, bt, B) == (35, 16, 4):
        assert B * KV * n_split >= 132 and (T, n_split) == (64, 9)


def _flash_tiles(q, k, v, split_p: bool, block_k: int = 64):
    """The CUDA flash kernel's arithmetic, in PyTorch: 64-key tiles,
    scores in log2 units, fp32 running max and sum, and P rounded to
    bf16 as the operand of P V, either once or as hi + lo."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kf = k.repeat_interleave(rep, 2).float()
    vf = v.repeat_interleave(rep, 2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) \
        * (math.log2(math.e) / math.sqrt(hd))
    causal = torch.arange(S)[None, :] <= torch.arange(S)[:, None]
    s = torch.where(causal, s, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:3], -1e30)
    l = torch.zeros(s.shape[:3])
    o = torch.zeros(B, H, S, hd)
    for k0 in range(0, S, block_k):
        st = s[..., k0:k0 + block_k]
        mx = torch.maximum(m, st.max(-1).values)
        c, p = torch.exp2(m - mx), torch.exp2(st - mx[..., None])
        l = l * c + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi + (p - hi).bfloat16().float() if split_p else hi
        o = o * c[..., None] + torch.einsum("bhqk,bkhd->bhqd", pv,
                                            vf[:, k0:k0 + block_k])
        m = mx
    return (o / l[..., None]).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("KV", [8, 4])
def test_flash_p_operand_needs_two_bf16_terms(KV):
    """Why the flash kernel splits P into bf16 hi + lo: at the main path's
    geometry (L 512, 32 heads) and the card check's inputs (q, k of std
    1.5) and tolerance (2e-3 + 1.6e-2 relative), a single bf16 P puts
    outputs outside it on some of four draws, and hi + lo keeps every
    output of every draw within half of it."""
    L, H, hd = 512, 32, 128
    worst = {False: 0.0, True: 0.0}
    for seed in range(4):
        rs = np.random.RandomState(seed)
        q = normal(rs, (1, L, H, hd), 1.5)
        k, v = normal(rs, (1, L, KV, hd), 1.5), normal(rs, (1, L, KV, hd))
        q, k, v = (to_torch(x).bfloat16() for x in (q, k, v))
        want = ref.flash_attention(q, k, v, causal=True).float()
        tol = 2e-3 + 1.6e-2 * want.abs()
        for split in worst:
            err = (_flash_tiles(q, k, v, split).float() - want).abs()
            worst[split] = max(worst[split], (err / tol).max().item())
    assert worst[True] < 0.5
    assert worst[False] > 1.0


# -------------------------- fused expert FFN --------------------------- #
def _expert_inputs(seed, E, D, F, B, K, dtype=np.float32):
    """x, w_gate, w_up, w_down, ids, wts at the reference test's scales;
    distinct ids per token unless a test overrides them."""
    rs = np.random.RandomState(seed)
    x = normal(rs, (B, D), 0.3, dtype)
    wg, wu = normal(rs, (E, D, F), 0.1, dtype), normal(rs, (E, D, F), 0.1,
                                                       dtype)
    wd = normal(rs, (E, F, D), 0.1, dtype)
    ids = np.stack([rs.permutation(E)[:K] for _ in range(B)]).astype(
        np.int32)
    z = rs.standard_normal((B, K))
    wts = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(dtype)
    return x, wg, wu, wd, ids, wts


def _expert_both(*args):
    """(port, JAX kernel in interpret mode, JAX gather oracle)."""
    j = list(map(jnp.asarray, args))
    return (ops.fused_expert_ffn(*map(to_torch, args)),
            jops.fused_expert_ffn(*j), jref.expert_ffn(*j))


@pytest.mark.parametrize("dtype", [np.float32, BF16_NP],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("E,D,F,B,K", [
    (4, 16, 32, 1, 1),
    (8, 64, 128, 6, 2),
    (16, 32, 64, 5, 4),
])
def test_expert_ffn_sweep(E, D, F, B, K, dtype):
    args = _expert_inputs(0, E, D, F, B, K, dtype)
    got, kern, oracle = _expert_both(*args)
    assert got.shape == (B, D) and got.dtype == to_torch(args[0]).dtype
    tol = FP32 if dtype is np.float32 else BF16
    assert_close(got, kern, tol)
    assert_close(got, oracle, tol)


def test_expert_ffn_duplicate_experts():
    """A token routed twice to one expert adds both weighted
    contributions, as the reference kernel does."""
    x, wg, wu, wd, _, _ = _expert_inputs(1, 4, 32, 64, 3, 2)
    ids = np.asarray([[2, 2], [0, 3], [1, 1]], np.int32)
    wts = np.asarray([[0.7, 0.3], [0.5, 0.5], [1.0, 0.0]], np.float32)
    got, kern, oracle = _expert_both(x, wg, wu, wd, ids, wts)
    assert_close(got, kern, FP32)
    assert_close(got, oracle, FP32)


def test_expert_ffn_identical_experts_closed_form():
    """With every expert identical the routed sum is the plain FFN
    times the sum of the weights, whatever the routing."""
    x, wg, wu, wd, ids, wts = _expert_inputs(2, 4, 32, 64, 5, 2)
    wg, wu, wd = (np.broadcast_to(w[:1], w.shape).copy()
                  for w in (wg, wu, wd))
    got, kern, _ = _expert_both(x, wg, wu, wd, ids, wts)
    h = x @ wg[0]
    h = h / (1.0 + np.exp(-h)) * (x @ wu[0])
    want = (h @ wd[0]) * wts.sum(-1, keepdims=True)
    assert_close(got, want, FP32)
    assert_close(got, kern, FP32)


@pytest.mark.parametrize("B,K,E,n", [
    (4, 8, 128, 4), (4, 8, 128, 1), (4, 8, 128, 2), (4, 8, 128, 3),
    (32, 8, 128, 1), (32, 8, 128, 4), (1, 8, 128, 4), (1, 1, 128, 8),
    (64, 8, 128, 4), (4, 2, 16, 16),
])
@pytest.mark.parametrize("D,F", [(2048, 768), (4096, 1536), (64, 32)])
def test_expert_plan(B, K, E, n, D, F):
    """The expert kernel's pass-1 plan over each range of ``n``: S splits
    of D into ``rows``, a multiple of 8, that cover D with none empty, at
    most 8 (one cluster) and of 128 rows or more; each (in-range slot, F
    tile, split) taken by one block once, for every routed count from 0
    to B*K; two expected working blocks per SM (132) unless S is at its
    cap, and 288 (8 expected slots x 6 tiles x 6 splits, in 14 slot
    groups) at the main path's quarter range (B 4, top-8, a quarter of
    128 experts)."""
    tiles = -(-F // 128)
    for lo, hi in [(i * E // n, (i + 1) * E // n) for i in range(n)]:
        S, rows = expert_plan(B, K, D, F, E, lo, hi)
        assert rows % 8 == 0 and S >= 1
        assert (S - 1) * rows < D <= S * rows
        m = math.ceil(B * K * (hi - lo) / E)       # expected slots
        # the kernel's slot groups: m and two standard deviations
        groups = min(B * K, m + math.ceil(2 * math.sqrt(m))) if m else 0
        blocks = m * tiles * S              # expected working blocks
        assert S <= 8 and (S == 1 or rows >= 128)
        assert blocks >= 2 * 132 or S == max(1, min(8, D // 128))
        if (B, K, E, n, D, F) == (4, 8, 128, 4, 2048, 768):
            assert (S, rows, m, groups, blocks) == (6, 344, 8, 14, 288)
        # grid (tiles * S, groups): block (x, g) takes split x % S of F
        # tile x // S for the in-range slots of rank g, g + groups, ...
        assert sorted(divmod(bx, S) for bx in range(tiles * S)) == [
            (t, s) for t in range(tiles) for s in range(S)]
        for count in range(B * K + 1):
            taken = Counter(r for g in range(groups)
                            for r in range(g, count, groups))
            assert taken == Counter(range(count))


def _split_expert(x, wg, wu, wd, ids, wts, e_lo, e_hi, n_experts, S,
                  silu_per_split=False):
    """The expert kernel's two passes over the range [e_lo, e_hi), in
    PyTorch: the compact list of in-range (token, slot)s in slot order;
    pass 1's fp32 partials of ``x Wg`` and ``x Wu`` over S splits of D
    into rows of ``expert_plan``'s size; pass 2 over the compact slots
    only, ``wts * silu(sum g) * sum u`` (or, with ``silu_per_split``,
    silu applied to each split's partial before the sum: the wrong
    order) times ``Wd`` summed in slot order; a token with an id outside
    [0, n_experts) NaN.  Returns the fp32 (B, D) partial."""
    B, D = x.shape
    K, F = ids.shape[1], wg.shape[2]
    rows = -(-(-(-D // S)) // 8) * 8
    flat = ids.reshape(-1).long()
    compact = [i for i in range(B * K) if e_lo <= int(flat[i]) < e_hi]
    part = {}
    for i in compact:
        b, e = i // K, int(flat[i]) - e_lo
        part[i] = [(x[b, d:d + rows].float() @ wg[e, d:d + rows].float(),
                    x[b, d:d + rows].float() @ wu[e, d:d + rows].float())
                   for d in range(0, D, rows)]
        assert len(part[i]) == S
    silu = torch.nn.functional.silu
    out = torch.zeros(B, D)
    for i in compact:
        b, e = i // K, int(flat[i]) - e_lo
        g = sum(p[0] for p in part[i])
        u = sum(p[1] for p in part[i])
        h = (sum(silu(p[0]) for p in part[i]) * u if silu_per_split
             else silu(g) * u)
        out[b] += (wts[b, i % K].float() * h) @ wd[e].float()
    bad = ((flat < 0) | (flat >= n_experts)).reshape(B, K).any(-1)
    out[bad] = math.nan
    return out


def _unequal_ranges(E, n):
    return [(i * E // n, (i + 1) * E // n) for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["router", "duplicate"])
def test_split_expert_matches_reference(n, case):
    """The kernel's partition (compact in-range slots, S D-split partials
    of g and u, silu after their sum, pass 2 over the compact slots),
    emulated in PyTorch with each range's plan, against the plain range
    version per range and, summed over the ranges, against the JAX
    kernel in interpret mode: the whole form (n 1) and 2, 3 (10/11/11 of
    32 experts, as 42/43/43 of 128) and 4 ranges, on distinct routed
    ids and with a token routed twice to one expert."""
    E, D, F, B, K = 32, 512, 64, 4, 4
    args = _expert_inputs(7, E, D, F, B, K)
    if case == "duplicate":
        args[4][1, K - 1] = args[4][1, 0]
        args[4][2, :] = args[4][2, 0]
    x, wg, wu, wd, ids, wts = map(to_torch, args)
    total = torch.zeros(B, D)
    for lo, hi in _unequal_ranges(E, n):
        S, _ = expert_plan(B, K, D, F, E, lo, hi)
        assert S > 1
        got = _split_expert(x, wg[lo:hi], wu[lo:hi], wd[lo:hi], ids, wts,
                            lo, hi, E, S)
        assert_close(got, ref.expert_ffn_partial(
            x, wg[lo:hi], wu[lo:hi], wd[lo:hi], ids, wts, lo, hi, E), FP32)
        total += got
    assert_close(total, jops.fused_expert_ffn(*map(jnp.asarray, args)),
                 FP32)


def test_split_expert_edges():
    """A range no slot routes into gives exact zeros (and reads no
    weight: its stacks are NaN); an id outside [0, E) makes its token's
    row NaN in every range and leaves the other rows to the reference."""
    E, D, F, B, K = 32, 512, 64, 4, 4
    args = _expert_inputs(8, E, D, F, B, K)
    x, wg, wu, wd, ids, wts = map(to_torch, args)
    nan = torch.full_like(wg[16:24], math.nan)
    empty = _split_expert(x, nan, nan, nan.transpose(1, 2), ids % 16, wts,
                          16, 24, E, 2)
    assert torch.equal(empty, torch.zeros(B, D))
    ids[2, 1] = E
    want = jops.fused_expert_ffn(*map(jnp.asarray, args))
    for n in (1, 4):
        total = torch.zeros(B, D)
        for lo, hi in _unequal_ranges(E, n):
            S, _ = expert_plan(B, K, D, F, E, lo, hi)
            got = _split_expert(x, wg[lo:hi], wu[lo:hi], wd[lo:hi], ids, wts,
                                lo, hi, E, S)
            assert torch.isnan(got[2]).all()
            assert_close(got, ref.expert_ffn_partial(
                x, wg[lo:hi], wu[lo:hi], wd[lo:hi], ids, wts, lo, hi, E),
                FP32)
            total += got
        keep = [0, 1, 3]
        assert_close(total[keep], np.asarray(want)[keep], FP32)


def test_split_expert_silu_per_split_fails():
    """silu is not linear: applied to each D split's partial before the
    sum, the same partition reads past the tolerance."""
    E, D, F, B, K = 32, 512, 64, 4, 4
    args = _expert_inputs(7, E, D, F, B, K)
    x, wg, wu, wd, ids, wts = map(to_torch, args)
    S, _ = expert_plan(B, K, D, F, E, 0, E // 4)
    assert S > 1
    part = [wg[:8], wu[:8], wd[:8], ids, wts, 0, E // 4, E, S]
    want = ref.expert_ffn_partial(x, *part[:-1])
    assert_close(_split_expert(x, *part), want, FP32)
    with pytest.raises(AssertionError):
        assert_close(_split_expert(x, *part, silu_per_split=True), want,
                     FP32)


# ---------------------------- dispatch --------------------------------- #
def test_cpu_tensors_never_touch_launch_counters():
    before = dict(build.LAUNCHES)
    q, kp, vp, tbl, kn, vn = _paged_inputs(3, 2, 8, 2, 64, 16, 2, 4,
                                           dtype=BF16_NP)
    tq, tkp, tvp, ttbl, tkn, tvn = map(to_torch, (q, kp, vp, tbl, kn, vn))
    lens = torch.tensor([5, 20], dtype=torch.int32)
    ops.paged_decode_attention(tq, tkp, tvp, ttbl, lens, tkn, tvn,
                               block_tokens=16)
    cache = tkp.reshape(2, 32, 2, 64)
    ops.decode_attention(tq, cache, cache, lens)
    ops.flash_attention(cache[:, :, None, 0].repeat(1, 1, 4, 1), cache,
                        cache, causal=True)
    ops.fused_expert_ffn(*map(to_torch, _expert_inputs(4, 4, 16, 32, 2, 2,
                                                       BF16_NP)))
    assert build.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    cache = torch.zeros(2, 32, 2, 64, dtype=torch.bfloat16)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel(q, cache, cache, lens)
    pool = torch.zeros(4, 16, 2, 64, dtype=torch.bfloat16)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    new = torch.zeros(2, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel(q, pool, pool, tbl, lens, new, new, block_tokens=16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel(cache.repeat(1, 1, 4, 1), cache, cache)
    with pytest.raises(ValueError, match="CUDA"):
        expert_kernel(*map(to_torch, _expert_inputs(4, 4, 16, 32, 2, 2,
                                                    BF16_NP)))
    assert build.LAUNCHES == before


def test_plain_decode_takes_per_row_lengths():
    """ref.decode_attention applies a (B,) kv_len row by row (the JAX
    oracle broadcasts it; the reference test loops over rows)."""
    rs = np.random.RandomState(6)
    q = normal(rs, (3, 4, 16))
    kc, vc = normal(rs, (3, 32, 2, 16)), normal(rs, (3, 32, 2, 16))
    lens = np.asarray([3, 17, 32], np.int32)
    got = ref.decode_attention(*map(to_torch, (q, kc, vc, lens)))
    for i in range(3):
        row = ref.decode_attention(*map(to_torch, (q[i:i + 1], kc[i:i + 1],
                                                   vc[i:i + 1])), int(lens[i]))
        assert_close(got[i:i + 1], row, FP32)
