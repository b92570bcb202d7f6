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


@pytest.mark.parametrize("arch", ARCHS + COPIED)
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


# codeqwen1.5-7b: QKV bias; stablelm-1.6b: LayerNorm and 25% rotary;
# bert-large-offload: learned positions, tied embeddings, gelu
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "stablelm-1.6b",
                                  "bert-large-offload"])
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
    lm.check_supported(cfg)
    _check_prefill(jcfg, jparams, cfg, tree_to_torch(jparams), 2, 21)


def test_unported_families_raise():
    from repro.configs import get_smoke_config as jget
    cfg = jget("rwkv6-7b")
    with pytest.raises(NotImplementedError, match="rwkv"):
        lm.check_supported(cfg)


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
