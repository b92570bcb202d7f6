"""Port model blocks and prefill against the JAX reference on the
llama3-8b and qwen3-moe-30b-a3b smoke configs, with the reference's
weights carried across by ``params_from_numpy``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, BF16, FP32, normal,  # noqa: E402
                           to_torch, tree_to_torch)

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import modules as M  # noqa: E402


ARCHS = ("llama3-8b", "qwen3-moe-30b-a3b")
# the other attention-only configs of the port's registry
COPIED = ("codeqwen1.5-7b", "qwen1.5-32b", "stablelm-1.6b",
          "bert-large-offload", "llama-65b-serve", "opt-66b-serve",
          "qwen3-moe-235b-a22b")


def _smoke(arch):
    jcfg = jsmoke(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_smoke_config(arch), tree_to_torch(jparams)


@pytest.fixture(scope="module")
def smoke():
    return _smoke("llama3-8b")


@pytest.fixture(scope="module")
def moe_smoke():
    return _smoke("qwen3-moe-30b-a3b")


# the other families' configs (tests/test_torch_families.py)
FAMILIES = ("llama-3.2-vision-11b", "jamba-1.5-large-398b",
            "whisper-large-v3", "rwkv6-7b")


@pytest.mark.parametrize("arch", ARCHS + COPIED + FAMILIES)
def test_config_copy_matches_reference(arch):
    from repro.configs import get_config
    from repro_torch.configs import get_config as tget
    for ours, ref in ((get_smoke_config(arch), jsmoke(arch)),
                      (tget(arch), get_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert tget(arch).param_count() == get_config(arch).param_count()


def _check_params_cross_bit_exact(jparams, params):
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert str(t.dtype).endswith(str(leaf.dtype)), path
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      t.float().numpy())


def test_params_cross_bit_exact(smoke):
    _, jparams, _, params = smoke
    _check_params_cross_bit_exact(jparams, params)


def test_moe_params_cross_bit_exact(moe_smoke):
    _, jparams, _, params = moe_smoke
    assert params["units"]["layers"][0]["moe"]["router"].dtype == \
        torch.float32
    _check_params_cross_bit_exact(jparams, params)


def _check_reference_layout(jparams, cfg):
    mine = lm.init_params(cfg, seed=0, device="cpu")
    def desc(shape, dtype):
        return f"{tuple(shape)}:{str(dtype).replace('torch.', '')}"

    assert jax.tree.map(lambda a: desc(a.shape, a.dtype), jparams) == \
        lm.tree_map(lambda t: desc(t.shape, t.dtype), mine)


def test_init_params_has_reference_layout(smoke):
    _, jparams, cfg, _ = smoke
    _check_reference_layout(jparams, cfg)


def test_moe_init_params_has_reference_layout(moe_smoke):
    _, jparams, cfg, _ = moe_smoke
    _check_reference_layout(jparams, cfg)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rms_norm(dtype):
    rs = np.random.RandomState(0)
    x = normal(rs, (2, 5, 64)).astype(dtype)
    scale = normal(rs, (64,), 0.5) + 1.0
    want = JM.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = M.rms_norm({"scale": to_torch(scale)}, to_torch(x))
    assert_close(got, want, BF16 if dtype is not np.float32 else FP32)


def test_layer_norm():
    rs = np.random.RandomState(1)
    x = normal(rs, (3, 64))
    p = {"scale": normal(rs, (64,)), "bias": normal(rs, (64,))}
    want = JM.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = M.layer_norm({k: to_torch(v) for k, v in p.items()}, to_torch(x))
    assert_close(got, want, FP32)


@pytest.mark.parametrize("pct,per_seq", [(1.0, False), (1.0, True),
                                         (0.5, False)])
def test_apply_rope_interleaved_pairs(pct, per_seq):
    rs = np.random.RandomState(2)
    x = normal(rs, (2, 6, 4, 16))
    pos = (rs.randint(0, 600, (2, 6)) if per_seq
           else np.arange(6)).astype(np.int32)
    want = JM.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, pct)
    got = M.apply_rope(to_torch(x), to_torch(pos), 500000.0, pct)
    assert_close(got, want, FP32)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention(causal):
    rs = np.random.RandomState(3)
    q = normal(rs, (2, 40, 4, 16), 0.5)
    k = normal(rs, (2, 40, 2, 16), 0.5)
    v = normal(rs, (2, 40, 2, 16), 0.5)
    want = JM.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                causal=causal, chunk_q=16, chunk_kv=16)
    got = M.chunked_attention(*map(to_torch, (q, k, v)), causal=causal,
                              chunk_q=16, chunk_kv=16)
    assert_close(got, want, FP32)


def test_mlp_fwd(smoke):
    _, jparams, _, params = smoke
    rs = np.random.RandomState(4)
    x = normal(rs, (2, 3, 64)).astype(jnp.bfloat16)
    jp = jax.tree.map(lambda a: a[0], jparams["units"]["layers"][0]["mlp"])
    tp = lm.tree_map(lambda t: t[0],
                     params["units"]["layers"][0]["mlp"])
    assert_close(M.mlp_fwd(tp, to_torch(x)),
                 JM.mlp_fwd(jp, jnp.asarray(x)), BF16)


def _check_prefill(jcfg, jparams, cfg, params, B, S):
    rs = np.random.RandomState(5)
    toks = rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    want_logits, want_cache = jlm.prefill(jparams, jcfg, jnp.asarray(toks))
    logits, cache = lm.prefill(params, cfg, to_torch(toks))
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab)
    assert_close(logits, want_logits, BF16)
    for key in ("kv_k", "kv_v"):
        assert cache[key].dtype == torch.bfloat16
        assert_close(cache[key], want_cache[key], BF16)
    assert cache["index"] == int(want_cache["index"])
    np.testing.assert_array_equal(
        logits.argmax(-1).numpy(), np.asarray(want_logits).argmax(-1))


@pytest.mark.parametrize("B,S", [(1, 12), (2, 37)])
def test_prefill_matches_reference(smoke, B, S):
    _check_prefill(*smoke, B, S)


# MoE shapes whose reference top-2 logits are not tied, so the argmax
# check has a margin (at B=2, S=37 the reference ties in bf16)
@pytest.mark.parametrize("B,S", [(1, 12), (2, 40)])
def test_moe_prefill_matches_reference(moe_smoke, B, S):
    _check_prefill(*moe_smoke, B, S)


# codeqwen1.5-7b and qwen1.5-32b: QKV bias; stablelm-1.6b: LayerNorm
# and 25% rotary; bert-large-offload: learned positions, tied
# embeddings, gelu; llama-65b-serve, opt-66b-serve: the serving
# configs' smoke variants; qwen3-moe-235b-a22b: MoE
@pytest.mark.parametrize("arch", COPIED)
def test_copied_config_prefill_matches_reference(arch):
    """Biases start at zero; drawn at random here so the QKV-bias and
    LayerNorm-bias paths are held, not multiplied away."""
    jcfg = jsmoke(arch)
    rs = np.random.RandomState(7)

    def draw_bias(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv", "bias"):
            return jnp.asarray(normal(rs, leaf.shape, 0.5), leaf.dtype)
        return leaf

    jparams = jax.tree_util.tree_map_with_path(
        draw_bias, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = get_smoke_config(arch)
    # at S 21 opt-66b-serve's reference top-2 logits of row 0 tie
    # exactly, so the argmax check would compare rounding
    S = 24 if arch == "opt-66b-serve" else 21
    _check_prefill(jcfg, jparams, cfg, tree_to_torch(jparams), 2, S)


def test_unported_families_raise():
    """The paged (continuous) engine serves attention-only patterns: on
    each hybrid family it raises the reference's ValueError, which points
    at the one-shot FlexGenEngine; the port's models themselves run all
    of them (tests/test_torch_families.py)."""
    from repro.configs import get_smoke_config as jget
    from repro.serving.engine import check_paged_support as jcheck
    from repro_torch.serving.engine import check_paged_support
    for arch in ("llama-3.2-vision-11b", "jamba-1.5-large-398b",
                 "whisper-large-v3", "rwkv6-7b"):
        with pytest.raises(ValueError) as want:
            jcheck(jget(arch))
        with pytest.raises(ValueError, match="FlexGenEngine") as got:
            check_paged_support(get_smoke_config(arch))
        assert str(got.value) == str(want.value)


def test_moe_init_scales_and_dtypes(moe_smoke):
    """Router fp32 with std 1/sqrt(D); experts bf16, w_down with std
    1/sqrt(F) (the reference's init_moe)."""
    _, _, cfg, _ = moe_smoke
    cfg = dataclasses.replace(cfg, d_model=256, d_ff=512)
    mp = lm.init_params(cfg, seed=0, device="cpu")["units"]["layers"][0][
        "moe"]
    assert mp["router"].dtype == torch.float32
    for name, fan_in in (("router", 256), ("w_gate", 256), ("w_up", 256),
                         ("w_down", 512)):
        std = mp[name].float().std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.02, name
    assert all(mp[n].dtype == torch.bfloat16
               for n in ("w_gate", "w_up", "w_down"))


def _moe_layer(jparams, params, u=0):
    jp = jax.tree.map(lambda a: a[u], jparams["units"]["layers"][0]["moe"])
    tp = lm.tree_map(lambda t: t[u], params["units"]["layers"][0]["moe"])
    return jp, tp


@pytest.mark.parametrize("capacity_factor,n_groups", [(8.0, 4), (0.25, 2)],
                         ids=["no-drop", "drop"])
def test_moe_fwd_matches_reference(moe_smoke, capacity_factor, n_groups):
    """Output and aux loss, with capacity to spare and with a capacity
    that drops (token, slot) pairs: the port drops the same ones."""
    _, jparams, cfg, params = moe_smoke
    jp, tp = _moe_layer(jparams, params)
    rs = np.random.RandomState(7)
    x = normal(rs, (2, 24, cfg.d_model)).astype(jnp.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=capacity_factor,
              n_groups=n_groups, act=cfg.act)
    want, want_aux = JM.moe_fwd(jp, jnp.asarray(x), **kw)
    got, aux = M.moe_fwd(tp, to_torch(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert_close(got, want, BF16)
    assert_close(aux, want_aux, FP32)
    if capacity_factor < 1:
        full, _ = M.moe_fwd(tp, to_torch(x), **dict(kw, capacity_factor=8.0))
        dropped = (full.float() - got.float()).abs().amax(-1) > 1e-3
        assert 0 < int(dropped.sum()) < 48   # some tokens lost a slot


def _bucket_positions(topi, E):
    """Each (token, slot)'s position in its expert's bucket of its group,
    counted one slot at a time in token-major order (the definition)."""
    topi = np.asarray(topi)
    G, T, k = topi.shape
    pos = np.zeros_like(topi)
    for g in range(G):
        seen = [0] * E
        for t in range(T):
            for j in range(k):
                pos[g, t, j] = seen[topi[g, t, j]]
                seen[topi[g, t, j]] += 1
    return pos


def _skewed(jp, x, skew):
    """With ``skew``, x shifted by 0.5 and the router's column 0 by 0.2:
    nearly every token routes a slot to expert 0, whose bucket
    overflows at capacity 1.25."""
    if not skew:
        return jp, x
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 0.2
    return dict(jp, router=jnp.asarray(router)), (x.astype(np.float32)
                                                  + 0.5).astype(x.dtype)


# a prime token count (one group of 37) and 640 tokens in 32 groups of
# 20; routing plain or skewed to one expert; capacity 1.25 and 8.0
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("skew", [False, True], ids=["plain", "skewed"])
@pytest.mark.parametrize("B,S,n_groups", [(1, 37, 4), (2, 320, 32)],
                         ids=["prime", "by-32"])
def test_moe_bucket_plain_versions_match_reference(moe_smoke, B, S,
                                                   n_groups, skew,
                                                   capacity_factor):
    """The dispatch and combine's plain versions (``ref.moe_bucket_*``,
    which the CPU runs in the kernels' place) and ``moe_fwd`` composed
    from them, with autograd off (through ``kernels.ops``) and on,
    against the reference's ``moe_fwd``; the positions against their
    definition, and drops where the skewed expert overflows."""
    from repro_torch.kernels import ops
    _, jparams, cfg, params = moe_smoke
    jp, _ = _moe_layer(jparams, params)
    rs = np.random.RandomState(11)
    x = normal(rs, (B, S, cfg.d_model)).astype(jnp.bfloat16)
    jp, x = _skewed(jp, x, skew)
    tp = {k: to_torch(np.asarray(v)) for k, v in jp.items()}
    kw = dict(top_k=cfg.top_k, capacity_factor=capacity_factor,
              n_groups=n_groups, act=cfg.act)
    want, want_aux = JM.moe_fwd(jp, jnp.asarray(x), **kw)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got, aux = M.moe_fwd(tp, to_torch(x), **kw)
        assert got.dtype == torch.bfloat16
        assert_close(got, want, BF16)
        assert_close(aux, want_aux, FP32)

    # the parts, at moe_fwd's grouping and capacity
    N, E, k = B * S, cfg.n_experts, cfg.top_k
    G = max(g for g in range(1, n_groups + 1) if N % g == 0)
    T = N // G
    C = max(int(T * k * capacity_factor / E), 4)
    xt = to_torch(x).reshape(G, T, -1)
    probs = torch.softmax(xt.float() @ tp["router"], dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    pos = ops.moe_bucket_positions(topi, E, xt)
    np.testing.assert_array_equal(pos.numpy(), _bucket_positions(topi, E))
    kept = pos < C
    if capacity_factor == 8.0:    # C >= 2T: no bucket overflows
        assert bool(kept.all())
    elif skew:
        assert int((~kept).sum()) >= T // 2
    buf = ops.moe_bucket_scatter(xt, topi, pos, E, C)
    assert buf.shape == (E, G, C, xt.shape[-1])
    rows = {(int(topi[g, t, j]), g, int(pos[g, t, j])): t
            for g in range(G) for t in range(T) for j in range(k)
            if pos[g, t, j] < C}
    for e in range(E):
        for g in range(G):
            for c in range(C):
                t = rows.get((e, g, c))
                torch.testing.assert_close(
                    buf[e, g, c], xt[g, t] if t is not None
                    else torch.zeros_like(xt[g, 0]), rtol=0, atol=0)
    out = ops.moe_bucket_combine(buf * 2, topi, topw, pos)
    w = (topw * kept).to(torch.bfloat16)
    acc = torch.zeros_like(xt)
    for j in range(k):
        for g in range(G):
            for t in range(T):
                e, c = int(topi[g, t, j]), min(int(pos[g, t, j]), C - 1)
                acc[g, t] = acc[g, t] + buf[e, g, c] * 2 * w[g, t, j]
    torch.testing.assert_close(out, acc, rtol=0, atol=0)


BUCKETS = ("moe_bucket_positions", "moe_bucket_scatter",
           "moe_bucket_combine")


def _cuda_stand_ins(monkeypatch, calls=None, refuse=()):
    """Route ``kernels.ops``' MoE bucket entry points as for CUDA
    tensors, each kernel stood in by its plain version (positions as
    int32, as the kernel returns them) that appends its name to
    ``calls``; a kernel named in ``refuse`` raises."""
    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)

    def stand_in(name, fn):
        def call(*a):
            if name in refuse:
                raise AssertionError(f"{name} ran under autograd")
            if calls is not None:
                calls.append(name)
            return fn(*a)
        return call

    for attr, name, fn in (
            ("_positions_kernel", BUCKETS[0],
             lambda topi, E: ref.moe_bucket_positions(topi, E).int()),
            ("_scatter_kernel", BUCKETS[1],
             lambda *a: ref.moe_bucket_scatter(*a).contiguous()),
            ("_combine_kernel", BUCKETS[2], ref.moe_bucket_combine)):
        monkeypatch.setattr(ops, attr, stand_in(name, fn))


@pytest.mark.parametrize("capacity_factor,n_groups,skew",
                         [(8.0, 4, False), (1.25, 1, True)],
                         ids=["no-drop", "drop"])
def test_moe_fwd_under_autograd_takes_the_plain_path(
        moe_smoke, monkeypatch, capacity_factor, n_groups, skew):
    """With autograd recording the layer, ``moe_fwd`` routed as for CUDA
    tensors never reaches the bucket kernels (patched to raise): the
    plain dispatch and combine carry the gradients, which equal
    ``jax.grad`` of the reference's ``moe_fwd`` (fp32 weights and
    activations, so that bf16 rounding does not part the two)."""
    _, jparams, cfg, params = moe_smoke
    jp, _ = _moe_layer(jparams, params)
    rs = np.random.RandomState(13)
    x = normal(rs, (2, 24, cfg.d_model)).astype(jnp.bfloat16)
    jp, x = _skewed(jp, x, skew)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    x = np.asarray(x, np.float32)
    r = normal(rs, x.shape)
    kw = dict(top_k=cfg.top_k, capacity_factor=capacity_factor,
              n_groups=n_groups, act=cfg.act)

    def jloss(p, xj):
        out, aux = JM.moe_fwd(p, xj, **kw)
        return jnp.sum(out * r) + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    _cuda_stand_ins(monkeypatch, refuse=BUCKETS)
    tp = {k: to_torch(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    xt = to_torch(x).requires_grad_()
    out, aux = M.moe_fwd(tp, xt, **kw)
    (torch.sum(out * to_torch(r)) + aux).backward()
    assert_close(xt.grad, want_x, FP32)
    for name, leaf in tp.items():
        assert float(leaf.grad.abs().max()) > 0, name
        assert_close(leaf.grad, want_p[name], FP32)


def test_moe_fwd_dispatches_through_ops_only_without_autograd(
        moe_smoke, monkeypatch):
    """``moe_fwd`` routed as for CUDA tensors (``_cuda_stand_ins``): the
    three kernels run wherever autograd records nothing (autograd off;
    grad mode on with nothing requiring a gradient, as an inference
    caller without ``no_grad``; the data shards' path); with x requiring
    a gradient none runs, with only the weights requiring one the
    positions' and the scatter's.  Every path's output is the plain
    versions' bit for bit."""
    _, _, cfg, params = moe_smoke
    tp = lm.tree_map(lambda t: t[0], params["units"]["layers"][0]["moe"])
    x = to_torch(normal(np.random.RandomState(3),
                        (2, 8, cfg.d_model)).astype(jnp.bfloat16))
    kw = dict(top_k=cfg.top_k, capacity_factor=1.25, n_groups=4,
              act=cfg.act)
    with torch.no_grad():             # the CPU's plain versions
        want = M.moe_fwd(tp, x, **kw)[0]
        want_shard = M.moe_fwd(tp, x, shards=2, **kw)[0]
    calls = []
    _cuda_stand_ins(monkeypatch, calls)
    trained = {k: v.detach().requires_grad_() for k, v in tp.items()}
    for name, grad, run, kernels, out in (
            ("autograd off", False, lambda: M.moe_fwd(tp, x, **kw),
             BUCKETS, want),
            ("inference with grad mode on", True,
             lambda: M.moe_fwd(tp, x, **kw), BUCKETS, want),
            ("data shards", False,
             lambda: M.moe_fwd(tp, x, shards=2, **kw), BUCKETS, want_shard),
            ("x requires a gradient", True, lambda: M.moe_fwd(
                tp, x.detach().requires_grad_(), **kw), (), want),
            ("weights require gradients", True,
             lambda: M.moe_fwd(trained, x, **kw), BUCKETS[:2], want)):
        calls.clear()
        with torch.set_grad_enabled(grad):
            got, _ = run()
        assert calls == list(kernels), name
        assert torch.equal(got.detach(), out), name
