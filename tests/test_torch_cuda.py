"""Port kernels on the card: each CUDA kernel against its plain version.

Marked ``cuda``; every test skips where no NVIDIA GPU is present (the
check runs inside the fixture, never at import).  On a GPU machine,
without ``tests/conftest.py``, which imports JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_split_plan)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.kernels.moe_bucket import (  # noqa: E402
    moe_bucket_combine, moe_bucket_positions, moe_bucket_scatter)
from repro_torch.kernels.ssm_state_update import (  # noqa: E402
    ssm_state_update)
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    fused_expert_ffn, fused_expert_ffn_partial, paged_decode_attention,
    split_plan)

pytestmark = pytest.mark.cuda
# q and k of std 1.5 peak the softmax, so outputs are O(1); the
# tolerance is at least two bf16 ulps of them, and a kernel that drops
# keys or mis-scales its running sums fails it
QK_STD = 1.5
TOL = dict(rtol=1.6e-2, atol=2e-3)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rnd(g, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * std).to(
        torch.bfloat16)


def _as_rows(edges, B):
    """Lengths as rows of B, every edge in at least one row (one row each
    when B is 1)."""
    if B == 1:
        return [[n] for n in edges]
    return [edges[i:i + B] + edges[:max(0, i + B - len(edges))]
            for i in range(len(edges))]


def _decode_edges(S, B, KV):
    """kv_len at the split edges of ``decode_split_plan``: 0 (uniform
    weights over the cache), 1, T - 1, T, T + 1, S - 1 and S."""
    T, _ = decode_split_plan(S, B, KV)
    return _as_rows([0, 1, T - 1, T, T + 1, S - 1, S], B)


@pytest.mark.parametrize("H,KV,hd,B,S,lens", [
    # the first cases: head geometries, lengths [0, 1, 17, 96]
    (32, 8, 128, 4, 96, "short"), (8, 8, 64, 4, 96, "short"),
    (16, 2, 64, 4, 96, "short"),
    # split edges at S 544 (T 64, 9 splits, as at the main path's 560)
    *[(32, KV, hd, B, 544, "edges") for B in (1, 4) for KV in (4, 8)
      for hd in (64, 128)],
])
def test_decode_attention_kernel(gen, H, KV, hd, B, S, lens):
    q, kc = _rnd(gen, B, H, hd, std=QK_STD), _rnd(gen, B, S, KV, hd,
                                                  std=QK_STD)
    vc = _rnd(gen, B, S, KV, hd)
    rows = [[0, 1, 17, 96]] if lens == "short" else _decode_edges(S, B, KV)
    for row in rows:
        kv_len = torch.tensor(row, dtype=torch.int32, device="cuda")
        n = build.LAUNCHES["decode_attention"]
        got = decode_attention(q, kc, vc, kv_len)
        assert build.LAUNCHES["decode_attention"] == n + 1
        torch.testing.assert_close(
            got, ref.decode_attention(q, kc, vc, kv_len), **TOL)


def test_decode_attention_reads_only_live_rows(gen):
    """Positions >= kv_len of a kv_len >= 1 row are never read: with NaN
    there, the output is unchanged; a kv_len 0 row (not poisoned) keeps
    the uniform weights, the mean of V over the whole cache."""
    B, H, KV, hd, S = 4, 32, 8, 128, 544
    q, kc = _rnd(gen, B, H, hd, std=QK_STD), _rnd(gen, B, S, KV, hd,
                                                  std=QK_STD)
    vc = _rnd(gen, B, S, KV, hd)
    kv_len = torch.tensor([0, 63, 65, 300], dtype=torch.int32,
                          device="cuda")
    want = decode_attention(q, kc, vc, kv_len)
    dead = torch.arange(S, device="cuda")[None, :] >= kv_len[:, None]
    dead[kv_len <= 0] = False
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[dead] = float("nan")
    vc2[dead] = float("nan")
    got = decode_attention(q, kc2, vc2, kv_len)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        got[0].float(), vc[0].float().mean(0).repeat_interleave(H // KV, 0),
        **TOL)
    torch.testing.assert_close(want, ref.decode_attention(q, kc, vc, kv_len),
                               **TOL)


def _paged_case(gen, B, KV, hd, nb, lens, bt=16, H=32):
    """Pool of B * nb blocks in a random order; row 2 (when B > 2) shares
    row 0's first half of blocks; slots past each row's blocks hold
    block 0, as the engine pads them."""
    num_blocks = B * nb
    q = _rnd(gen, B, H, hd, std=QK_STD)
    kp = _rnd(gen, num_blocks, bt, KV, hd, std=QK_STD)
    vp = _rnd(gen, num_blocks, bt, KV, hd)
    kn, vn = _rnd(gen, B, KV, hd, std=QK_STD), _rnd(gen, B, KV, hd)
    perm = torch.randperm(num_blocks, generator=gen, device="cuda")
    tbl = perm.reshape(B, nb).to(torch.int32).contiguous()
    if B > 2:
        tbl[2, :nb // 2] = tbl[0, :nb // 2]
    for i, n in enumerate(lens):
        tbl[i, -(-(n + 1) // bt):] = 0
    return q, kp, vp, tbl, kn, vn


def _split_edges(B, KV, nb, bt=16):
    """kv_len at the split edges of ``split_plan``: 0, T - 1, T, T + 1 and
    a full table, nb * bt - 1 (the new token takes the last slot)."""
    T, _ = split_plan(nb, bt, B, KV)
    return _as_rows([0, T - 1, T, T + 1, nb * bt - 1], B)


@pytest.mark.parametrize("B,KV,hd,nb,lens", [
    # a hand-written table: repeated blocks, a padded row (kv_len 0)
    (3, 8, 128, 4, "table"),
    # split edges at the main path's table width, shared blocks
    (1, 4, 128, 35, "edges"), (1, 8, 128, 35, "edges"),
    (4, 4, 128, 35, "edges"), (4, 8, 128, 35, "edges"),
    (4, 8, 64, 35, "edges"),
])
def test_paged_decode_attention_kernel(gen, B, KV, hd, nb, lens):
    H, bt = 32, 16
    if lens == "table":
        q = _rnd(gen, B, H, hd, std=QK_STD)
        kp = _rnd(gen, 10, bt, KV, hd, std=QK_STD)
        vp = _rnd(gen, 10, bt, KV, hd)
        kn, vn = _rnd(gen, B, KV, hd, std=QK_STD), _rnd(gen, B, KV, hd)
        tbl = torch.tensor([[3, 1, 0, 0], [1, 1, 9, 2], [0, 0, 0, 0]],
                           dtype=torch.int32, device="cuda")
        cases = [([20, 63, 0], (q, kp, vp, tbl, kn, vn))]
    else:
        cases = [(row, _paged_case(gen, B, KV, hd, nb, row))
                 for row in _split_edges(B, KV, nb)]
    for row, (q, kp, vp, tbl, kn, vn) in cases:
        kv_len = torch.tensor(row, dtype=torch.int32, device="cuda")
        n = build.LAUNCHES["paged_decode_attention"]
        got = paged_decode_attention(q, kp, vp, tbl, kv_len, kn, vn,
                                     block_tokens=bt)
        assert build.LAUNCHES["paged_decode_attention"] == n + 1
        torch.testing.assert_close(
            got, ref.paged_decode_attention(q, kp, vp, tbl, kv_len, kn, vn),
            **TOL)


def test_paged_decode_attention_reads_only_live_blocks(gen):
    """Pad slots (block 0) and blocks past kv_len are never read: with
    NaN in every block no row owns, the output is unchanged and finite,
    and the kv_len 0 row returns its new token's v."""
    B, H, KV, hd, bt, nb = 4, 32, 8, 128, 16, 35
    lens = [0, 63, 64, 300]
    q, kp, vp, _, kn, vn = _paged_case(gen, B, KV, hd, nb, lens)
    # blocks 1.. in a random order, so that no row owns block 0
    perm = torch.randperm(B * nb - 1, generator=gen, device="cuda") + 1
    tbl = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    live = torch.zeros(B * nb, dtype=torch.bool, device="cuda")
    for i, n in enumerate(lens):
        used = -(-n // bt)
        tbl[i, :used] = perm[i * nb:i * nb + used].to(torch.int32)
        live[tbl[i, :used].long()] = True
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    want = paged_decode_attention(q, kp, vp, tbl, kv_len, kn, vn,
                                  block_tokens=bt)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[~live] = float("nan")
    vp2[~live] = float("nan")
    got = paged_decode_attention(q, kp2, vp2, tbl, kv_len, kn, vn,
                                 block_tokens=bt)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got[0], vn[0].repeat_interleave(H // KV, 0),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        want, ref.paged_decode_attention(q, kp, vp, tbl, kv_len, kn, vn),
        **TOL)


FLASH_LENGTHS = (1, 63, 64, 65, 127, 129, 2048)   # the 64-row tiles' edges


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", [
    (512, 512, 32, 8, 128), (130, 259, 4, 4, 64), (96, 40, 8, 1, 128)] + [
    (Sq, Sk, 2 * rep, 2, hd)
    for Sq in FLASH_LENGTHS for Sk in FLASH_LENGTHS if Sq != Sk
    for hd in (64, 128) for rep in (1, 4, 8)])
def test_flash_attention_kernel(gen, Sq, Sk, H, KV, hd):
    B = 1 if max(Sq, Sk) == 2048 else 2
    q, k = _rnd(gen, B, Sq, H, hd, std=QK_STD), _rnd(gen, B, Sk, KV, hd,
                                                     std=QK_STD)
    v = _rnd(gen, B, Sk, KV, hd)
    n = build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True)
    assert build.LAUNCHES["flash_attention"] == n + 1
    torch.testing.assert_close(got, ref.flash_attention(q, k, v, causal=True),
                               **TOL)


@pytest.mark.parametrize("Sq,hd", [(1, 128), (100, 64), (300, 128)])
def test_flash_attention_kernel_noncausal(gen, Sq, hd):
    q = _rnd(gen, 2, Sq, 8, hd, std=QK_STD)
    k, v = _rnd(gen, 2, 256, 2, hd, std=QK_STD), _rnd(gen, 2, 256, 2, hd)
    torch.testing.assert_close(flash_attention(q, k, v, causal=False),
                               ref.flash_attention(q, k, v, causal=False),
                               **TOL)


def _expert_case(gen, B):
    """qwen3-moe-30b-a3b's decode shapes at batch B: top-8 of a router
    softmax, one row with a duplicated expert, one padded row that
    repeats row 0; x of std 1 and weights at their init scales."""
    D, F, E, K = 2048, 768, 128, 8
    x = _rnd(gen, B, D)
    x[3] = x[0]
    wg, wu = _rnd(gen, E, D, F, std=D ** -0.5), _rnd(gen, E, D, F,
                                                     std=D ** -0.5)
    wd = _rnd(gen, E, F, D, std=F ** -0.5)
    router = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    wts, ids = torch.topk(torch.softmax(x.float() @ router, -1), K)
    wts = wts / wts.sum(-1, keepdim=True)
    ids = ids.to(torch.int32)
    ids[1, K - 1] = ids[1, 0]
    return x, wg, wu, wd, ids, wts


def _ranged(x, wg, wu, wd, ids, wts, ranges):
    """The range kernel once per range, the fp32 partials summed in range
    order and rounded to bf16 once (the sharded path's sum)."""
    E = wg.shape[0]
    return sum(fused_expert_ffn_partial(x, wg[a:b], wu[a:b], wd[a:b], ids,
                                        wts, a, b, E)
               for a, b in ranges).bfloat16()


def _ranges(E, n):
    return [(i * E // n, (i + 1) * E // n) for i in range(n)]


def test_fused_expert_ffn_kernel(gen):
    """The whole kernel at qwen3-moe-30b-a3b's decode shapes, batch 4
    (``_expert_case``): one launch, the plain version's output, and the
    padded row equal to row 0."""
    x, wg, wu, wd, ids, wts = _expert_case(gen, 4)
    n = build.LAUNCHES["fused_expert_ffn"]
    got = fused_expert_ffn(x, wg, wu, wd, ids, wts)
    assert build.LAUNCHES["fused_expert_ffn"] == n + 1
    torch.testing.assert_close(got, ref.expert_ffn(x, wg, wu, wd, ids, wts),
                               **TOL)
    assert torch.equal(got[3], got[0])


@pytest.mark.parametrize("B,n", [(4, 3), (32, 1), (32, 4)])
def test_fused_expert_ffn_ranges(gen, B, n):
    """The range form over n ranges (3: 42 / 43 / 43 of 128 experts) and
    the whole kernel at batch 32 (max_batch 32, top-8), against the
    plain version; the ranges' sum also against the whole kernel."""
    args = _expert_case(gen, B)
    want = ref.expert_ffn(*args)
    got = (fused_expert_ffn(*args) if n == 1
           else _ranged(*args, _ranges(args[1].shape[0], n)))
    torch.testing.assert_close(got, want, **TOL)
    if n > 1:
        torch.testing.assert_close(got, fused_expert_ffn(*args), **TOL)


def test_fused_expert_ffn_range_edges(gen):
    """A range no slot routes into, and a range of no experts, give exact
    zeros with NaN stacks (no weight read); an id outside [0, E) makes
    its token's row NaN in the whole kernel and in each of 4 ranges, and
    leaves the other rows to the plain version."""
    x, wg, wu, wd, ids, wts = _expert_case(gen, 4)
    E = wg.shape[0]
    lo, hi = E // 2, E // 2 + E // 4
    nan = [torch.full_like(w[lo:hi], float("nan")) for w in (wg, wu, wd)]
    for top, routed in ((hi, ids % lo), (lo, ids)):
        got = fused_expert_ffn_partial(x, *(w[:top - lo] for w in nan),
                                       routed, wts, lo, top, E)
        assert torch.equal(got, torch.zeros_like(got))
    want = ref.expert_ffn(x, wg, wu, wd, ids, wts)   # ids all in range
    ids[2, 3] = E
    keep = [0, 1, 3]
    whole = fused_expert_ffn(x, wg, wu, wd, ids, wts)
    assert torch.isnan(whole[2]).all()
    torch.testing.assert_close(whole[keep], want[keep], **TOL)
    for a, b in _ranges(E, 4):
        part = fused_expert_ffn_partial(x, wg[a:b], wu[a:b], wd[a:b], ids,
                                        wts, a, b, E)
        assert torch.isnan(part[2]).all()
        torch.testing.assert_close(
            part[keep], ref.expert_ffn_partial(
                x, wg[a:b], wu[a:b], wd[a:b], ids, wts, a, b, E)[keep],
            **TOL)


# fused_adam against its plain version, as chip_smoke.py holds it: the
# update master' - master (about lr = 3e-4 against masters of about
# 0.02, so a tolerance on master' alone would pass a kernel that skipped
# it) to 1e-6 of itself plus two fp32 ulps of the master (master' may
# round one ulp apart: PyTorch divides by a scalar through its
# reciprocal); m' and v' to 1e-6 of themselves plus 1e-6 of their rms
ADAM_KW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
               b1c=1.0 - 0.9 ** 3, b2c=1.0 - 0.95 ** 3)


@pytest.mark.parametrize("shape,gdtype,offset", [
    ((48, 1600, 6400), torch.bfloat16, 0),   # gpt2-xl-offload mlp.w_up
    ((70001,), torch.float32, 0),            # vector loop and its tail
    ((70001,), torch.float32, 1),            # misaligned: scalar loop
    ((3, 5), torch.float16, 0),
])
def test_fused_adam_kernel(gen, shape, gdtype, offset):
    n = 1
    for d in shape:
        n *= d

    def draw(std, dtype=torch.float32):
        t = torch.randn(n + offset, generator=gen, device="cuda") * std
        return t.to(dtype)[offset:].view(shape)

    master, m, g = draw(0.02), draw(3e-4), draw(1e-3, gdtype)
    v = draw(1.0).square_().mul_(1.5e-7)
    # NaN in the blocks the outputs will reuse: an unwritten element fails
    poison = [torch.full((n,), float("nan"), device="cuda")
              for _ in range(3)]
    del poison
    before = build.LAUNCHES["fused_adam"]
    got = fused_adam(master, m, v, g, **ADAM_KW)
    assert build.LAUNCHES["fused_adam"] == before + 1
    want = ref.fused_adam(master, m, v, g, **ADAM_KW)
    eps32 = torch.finfo(torch.float32).eps
    for a, b, extra in ((got[0] - master, want[0] - master,
                         2 * eps32 * master.abs()),
                        (got[1], want[1], None), (got[2], want[2], None)):
        assert torch.isfinite(a).all()
        tol = 1e-6 * b.abs() + (extra if extra is not None
                                else 1e-6 * b.square().mean().sqrt())
        assert ((a - b).abs() <= tol).all()


def test_fused_adam_refuses_what_it_does_not_take(gen):
    x = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fused_adam(x, x, x, x.double(), **ADAM_KW)
    with pytest.raises(ValueError, match="dtype"):
        fused_adam(x.half(), x, x, x, **ADAM_KW)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(8, 2, device="cuda")[:, 0]
        fused_adam(y, y, y, y, **ADAM_KW)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rnd(gen, 2, 8, 32)                  # head_dim 32: not compiled
    cache = _rnd(gen, 2, 16, 2, 32)
    lens = torch.tensor([3, 4], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_attention(q, cache, cache, lens)
    with pytest.raises(ValueError, match="dtype"):
        decode_attention(q.float(), cache, cache, lens)
    w = _rnd(gen, 2, 20, 12)                  # D = 20: not a multiple of 8
    ids = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_expert_ffn(_rnd(gen, 2, 20), w, w, w.transpose(1, 2)
                         .contiguous(), ids, ids.float())


# the prefill MoE's dispatch and combine at qwen3-moe-30b-a3b's widths
# and the cell's routing: D 2048, 128 experts of F 768, top-8, capacity
# 1.25, 32 groups; N tokens with 1 token a group, 2, 34 (C 4), 1021 (a
# prime: one group, C 99), 128 and 5003 (a prime: C 390)
MOE_N = (16, 64, 1020, 1021, 4096, 5003)
MOE = dict(D=2048, E=128, F=768, k=8, cf=1.25, groups=32)
BUCKETS = ("moe_bucket_positions", "moe_bucket_scatter",
           "moe_bucket_combine")


def _bits(t):
    """A float tensor's bit patterns, so that -0 and +0 differ."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.fixture(scope="module")
def moe_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    D, E, F = MOE["D"], MOE["E"], MOE["F"]
    return {"router": torch.randn(D, E, generator=g, device="cuda")
            * D ** -0.5,
            "w_gate": _rnd(g, E, D, F, std=D ** -0.5),
            "w_up": _rnd(g, E, D, F, std=D ** -0.5),
            "w_down": _rnd(g, E, F, D, std=F ** -0.5)}


def _moe_inputs(layer, N, skew, seed=2):
    """x (1, N, D) and the layer; with ``skew`` x is shifted by 0.5 and
    the router's column 0 by 0.01, so that every token routes a slot to
    expert 0 and its bucket overflows wherever a group has more than C
    tokens.  A few elements of x are -0."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn(1, N, MOE["D"], generator=g, device="cuda")
    p = dict(layer)
    if skew:
        x = x + 0.5
        p["router"] = p["router"].clone()
        p["router"][:, 0] += 0.01
    x = x.to(torch.bfloat16)
    x[0, :, :3] = -0.0
    return p, x


def _routing(p, x):
    """moe_fwd's grouping, capacity and routing of x."""
    N, E, k = x.shape[1], MOE["E"], MOE["k"]
    G = max(g for g in range(1, MOE["groups"] + 1) if N % g == 0)
    T = N // G
    C = max(int(T * k * MOE["cf"] / E), 4)
    xt = x.reshape(G, T, -1)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return xt, topi, topw, C


@pytest.mark.parametrize("skew", [False, True], ids=["plain", "skewed"])
@pytest.mark.parametrize("N", MOE_N)
def test_moe_bucket_kernels_match_plain_versions(moe_layer, N, skew):
    """Each kernel against its plain version (``ref.moe_bucket_*``) on the
    same inputs, bit for bit, one launch each; the combine on expert
    outputs of std 1 with -0 and the scatter's dropped slots."""
    p, x = _moe_inputs(moe_layer, N, skew)
    xt, topi, topw, C = _routing(p, x)
    E = MOE["E"]
    before = {name: build.LAUNCHES[name] for name in BUCKETS}
    pos = moe_bucket_positions(topi, E)
    want_pos = ref.moe_bucket_positions(topi, E)
    assert pos.dtype == torch.int32
    assert torch.equal(pos.long(), want_pos)
    if skew and xt.shape[1] > C:
        assert not bool((pos < C).all())
    buf = moe_bucket_scatter(xt, topi, pos, E, C)
    assert torch.equal(_bits(buf), _bits(ref.moe_bucket_scatter(
        xt, topi, want_pos, E, C).contiguous()))
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    eo = _rnd(g, *buf.shape)
    eo[..., :5] = -0.0
    got = moe_bucket_combine(eo, topi, topw, pos)
    assert torch.equal(_bits(got), _bits(ref.moe_bucket_combine(
        eo, topi, topw, want_pos)))
    assert {name: build.LAUNCHES[name] - before[name]
            for name in BUCKETS} == dict.fromkeys(BUCKETS, 1)


@pytest.mark.parametrize("skew", [False, True], ids=["plain", "skewed"])
@pytest.mark.parametrize("N", MOE_N)
def test_moe_fwd_kernel_path_matches_plain_path(moe_layer, N, skew):
    """``moe_fwd`` with autograd off (the three kernels), with x
    requiring a gradient (training: the plain versions, recorded for the
    backward) and with only the weights requiring one (the positions'
    and scatter's kernels, the combine's plain version on their int32
    positions) give the same output and aux loss bit for bit, and the
    last two a backward."""
    from repro_torch.models import modules as M
    p, x = _moe_inputs(moe_layer, N, skew)
    kw = dict(top_k=MOE["k"], capacity_factor=MOE["cf"],
              n_groups=MOE["groups"], act="silu")
    with torch.no_grad():
        before = {n: build.LAUNCHES[n] for n in BUCKETS}
        got, aux = M.moe_fwd(p, x, **kw)
    assert {n: build.LAUNCHES[n] - before[n]
            for n in BUCKETS} == dict.fromkeys(BUCKETS, 1)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    xr = x.detach().requires_grad_()
    trained = {k: v.detach().requires_grad_() for k, v in p.items()}
    for name, args, leaves, launched in (
            ("x", (p, xr), [xr], (0, 0, 0)),
            ("weights", (trained, x), list(trained.values()), (1, 1, 0))):
        before = {n: build.LAUNCHES[n] for n in BUCKETS}
        want, want_aux = M.moe_fwd(*args, **kw)
        assert {n: build.LAUNCHES[n] - before[n]
                for n in BUCKETS} == dict(zip(BUCKETS, launched)), name
        assert torch.equal(_bits(got), _bits(want.detach())), name
        assert torch.equal(aux, want_aux.detach()), name
        (want.float().sum() + want_aux).backward()
        for leaf in leaves:
            assert torch.isfinite(leaf.grad).all() and bool(
                leaf.grad.any()), name


def test_moe_bucket_kernels_in_fp32(gen):
    """fp32 rows (a model held in fp32): the scatter and the combine
    against their plain versions, bit for bit."""
    G, T, D, E, k, C = 3, 50, 64, 8, 2, 12
    xt = torch.randn(G, T, D, generator=gen, device="cuda")
    topw, topi = torch.topk(torch.softmax(torch.randn(
        G, T, E, generator=gen, device="cuda"), -1), k, dim=-1)
    pos = moe_bucket_positions(topi, E)
    want_pos = ref.moe_bucket_positions(topi, E)
    assert torch.equal(pos.long(), want_pos)
    buf = moe_bucket_scatter(xt, topi, pos, E, C)
    assert torch.equal(_bits(buf), _bits(ref.moe_bucket_scatter(
        xt, topi, want_pos, E, C).contiguous()))
    eo = torch.randn(E, G, C, D, generator=gen, device="cuda")
    assert torch.equal(_bits(moe_bucket_combine(eo, topi, topw, pos)),
                       _bits(ref.moe_bucket_combine(eo, topi, topw,
                                                    want_pos)))


def test_moe_bucket_wrappers_refuse_what_the_kernels_do_not_take(gen):
    G, T, k, D, E, C = 2, 8, 2, 64, 8, 4
    xt = _rnd(gen, G, T, D)
    topi = torch.randint(0, E, (G, T, k), generator=gen, device="cuda")
    topw = torch.rand(G, T, k, generator=gen, device="cuda")
    pos = moe_bucket_positions(topi, E)
    eo = _rnd(gen, E, G, C, D)
    with pytest.raises(ValueError, match="dtype"):
        moe_bucket_positions(topi.int(), E)
    with pytest.raises(ValueError, match="dtype"):
        moe_bucket_scatter(xt, topi, pos.long(), E, C)
    with pytest.raises(ValueError, match="dtype"):
        moe_bucket_scatter(xt.half(), topi, pos, E, C)
    with pytest.raises(ValueError, match="dtype"):
        moe_bucket_combine(eo, topi, topw.bfloat16(), pos)
    with pytest.raises(ValueError, match="16 bytes"):
        moe_bucket_scatter(xt[..., :20].contiguous(), topi, pos, E, C)
    with pytest.raises(ValueError, match="aligned"):
        flat = _rnd(gen, G * T * D + 1)
        moe_bucket_scatter(flat[1:].view(G, T, D), topi, pos, E, C)
    with pytest.raises(ValueError, match="contiguous"):
        moe_bucket_combine(eo.transpose(0, 1).contiguous().transpose(0, 1),
                           topi, topw, pos)
    with pytest.raises(ValueError, match="shape"):
        moe_bucket_combine(eo, topi, topw, pos[:, :-1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_bucket_combine(eo, topi, topw.cpu(), pos)
    with pytest.raises(RuntimeError, match="CUDA error"):
        moe_bucket_positions(topi, 10000)   # its counters exceed 48 KiB


# ---------------------------------------------------------------------- #
# The Mamba-2 decode state update and the expert FFN at                  #
# granite-4.0-h-small's decode shapes                                    #
# ---------------------------------------------------------------------- #
def _ssm_case(gen, B, H, N, P, G, n_slots):
    """A step's inputs: x, B and C as column slices of one conv output
    row per batch row (row stride H*P + 2*G*N), dt of the published
    range, A in [-16, -1], slots a random choice of distinct slots."""
    state = torch.randn(n_slots, H, N, P, generator=gen, device="cuda")
    xbc = _rnd(gen, B, H * P + 2 * G * N)
    x, Bm = xbc[:, :H * P], xbc[:, H * P:H * P + G * N]
    Cm = xbc[:, H * P + G * N:]
    dt = torch.exp(torch.empty(B, H, device="cuda").uniform_(
        -6.9, -2.3, generator=gen))
    A = -torch.empty(H, device="cuda").uniform_(1, 16, generator=gen)
    D = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    slots = torch.randperm(n_slots, generator=gen, device="cuda")[:B].to(
        torch.int32)
    return state, slots, x, Bm, Cm, dt, A, D


@pytest.mark.parametrize("B,H,N,P,G", [(64, 128, 128, 64, 1),
                                       (5, 8, 16, 32, 2),
                                       (3, 4, 128, 128, 4)])
def test_ssm_state_update_kernel(gen, B, H, N, P, G):
    """granite-4.0-h-small's decode step at 64 rows x 128 heads x N 128
    x P 64 over 65 slots, rows in permuted slots, and two other
    geometries: y and every slot's state against the plain version (fp32:
    a state row left out moves y by ~1/N of itself), the slots no row
    names untouched bit for bit, one launch."""
    state, slots, *args = _ssm_case(gen, B, H, N, P, G, B + 1)
    want_state = state.clone()
    want = ref.ssm_state_update(want_state, slots, *args)
    n = build.LAUNCHES["ssm_state_update"]
    got = ssm_state_update(state, slots, *args)
    assert build.LAUNCHES["ssm_state_update"] == n + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(state, want_state, rtol=1e-5, atol=1e-6)
    free = sorted(set(range(B + 1)) - set(slots.tolist()))
    assert torch.equal(state[free], want_state[free])


def test_ssm_state_update_kernel_refuses_and_marks(gen):
    """A slot outside the pool gives a NaN row and touches no state; the
    wrapper refuses what the kernel does not take."""
    state, slots, x, Bm, Cm, dt, A, D = _ssm_case(gen, 4, 8, 16, 32, 1, 6)
    slots[1] = 6
    before = state.clone()
    y = ssm_state_update(state, slots, x, Bm, Cm, dt, A, D)
    assert torch.isnan(y[1]).all() and not torch.isnan(y[[0, 2, 3]]).any()
    idle = [i for i in range(6) if i not in slots.tolist()]
    assert torch.equal(state[idle], before[idle])
    with pytest.raises(ValueError, match="dtype"):
        ssm_state_update(state.bfloat16(), slots, x, Bm, Cm, dt, A, D)
    with pytest.raises(ValueError, match="contiguous columns"):
        ssm_state_update(state, slots, x.t().contiguous().t(), Bm, Cm, dt,
                         A, D)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_state_update(state, slots, x.cpu(), Bm, Cm, dt, A, D)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssm_state_update(state[..., :30].contiguous(), slots,
                         x.reshape(4, 8, 32)[..., :30].reshape(4, 240)
                         .contiguous(), Bm, Cm, dt, A, D)   # P % 4


def test_fused_expert_ffn_at_granite_shapes(gen):
    """``fused_expert_ffn`` at granite-4.0-h-small's decode: 64 rows,
    D 4096, 72 experts of width 768, top-10 (down pass (K*F + 2048) * 4
    bytes of shared memory), against the plain version."""
    B, D, F, E, K = 64, 4096, 768, 72, 10
    x = _rnd(gen, B, D)
    wg, wu = (_rnd(gen, E, D, F, std=D ** -0.5) for _ in range(2))
    wd = _rnd(gen, E, F, D, std=F ** -0.5)
    router = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    wts, ids = torch.topk(torch.softmax(x.float() @ router, -1), K)
    wts = wts / wts.sum(-1, keepdim=True)
    got = fused_expert_ffn(x, wg, wu, wd, ids.to(torch.int32), wts)
    torch.testing.assert_close(got, ref.expert_ffn(x, wg, wu, wd, ids, wts),
                               **TOL)
