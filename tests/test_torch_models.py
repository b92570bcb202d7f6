"""Port model blocks and prefill against the JAX reference on the
llama3-8b smoke config, with the reference's weights carried across by
``params_from_numpy``."""
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


@pytest.fixture(scope="module")
def smoke():
    jcfg = jsmoke("llama3-8b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_smoke_config("llama3-8b"), \
        tree_to_torch(jparams)


def test_config_copy_matches_reference(smoke):
    import dataclasses
    jcfg, _, cfg, _ = smoke
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    from repro.configs import get_config
    from repro_torch.configs import get_config as tget
    assert tget("llama3-8b").param_count() == \
        get_config("llama3-8b").param_count()


def test_params_cross_bit_exact(smoke):
    _, jparams, _, params = smoke
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat:
        t = params
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert str(t.dtype).endswith(str(leaf.dtype)), path
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      t.float().numpy())


def test_init_params_has_reference_layout(smoke):
    _, jparams, cfg, _ = smoke
    mine = lm.init_params(cfg, seed=0, device="cpu")
    def desc(shape, dtype):
        return f"{tuple(shape)}:{str(dtype).replace('torch.', '')}"

    assert jax.tree.map(lambda a: desc(a.shape, a.dtype), jparams) == \
        lm.tree_map(lambda t: desc(t.shape, t.dtype), mine)


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


@pytest.mark.parametrize("B,S", [(1, 12), (2, 37)])
def test_prefill_matches_reference(smoke, B, S):
    jcfg, jparams, cfg, params = smoke
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


def test_unported_families_raise():
    from repro.configs import get_smoke_config as jget
    cfg = jget("qwen3-moe-30b-a3b")
    with pytest.raises(NotImplementedError, match="MoE"):
        lm.check_supported(cfg)
