"""The other model families of the port against the JAX reference on the
CPU: the Mamba-2 (SSD) and RWKV6 blocks, the int8 KV quantizer, and the
llama-3.2-vision-11b, jamba-1.5-large-398b, whisper-large-v3 and
rwkv6-7b smoke models (configs, parameters, prefill logits and every
cache leaf), plus the
port's counterparts of the reference's chunk-vs-step and int8 decode
tests.  Decode steps, the loss and gradients are in
``test_torch_families_steps.py``.  Inputs are numpy draws from a seed;
the reference's weights cross bit-exactly through ``params_from_numpy``.
The module tests hold the port as it is against the reference as it is;
the whole-model tests of the ``_torch_parity.ROUNDING_SENSITIVE``
families run the reference op by op (``reference_runner``)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, BF16, eager,  # noqa: E402
                           FP32, normal, reference_runner, smoke_model,
                           to_numpy, to_torch, tree_to_torch)

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import modules as M  # noqa: E402

FAMILIES = ("llama-3.2-vision-11b", "jamba-1.5-large-398b",
            "whisper-large-v3", "rwkv6-7b")


@functools.lru_cache(maxsize=None)
def _model(arch):
    """``smoke_model(arch)`` and its cross inputs (or None)."""
    jcfg, jparams, cfg, params = smoke_model(arch)
    cross = (normal(np.random.RandomState(12),
                    (2, jcfg.n_frontend_tokens, jcfg.d_model))
             if jcfg.n_frontend_tokens else None)
    return jcfg, jparams, cfg, params, cross


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else to_torch(a)


def _port_cache(jcache):
    return {k: (int(v) if k == "index" else to_torch(v))
            for k, v in jcache.items()}


def _pad_kv(cache, extra):
    """The reference test's ``_pad_kv``: pad ``kv_k``/``kv_v`` along
    positions, where the cache has them."""
    out = dict(cache)
    for k in ("kv_k", "kv_v"):
        if k in out:
            pads = [(0, 0)] * out[k].ndim
            pads[3] = (0, extra)
            out[k] = jnp.pad(out[k], pads)
    return out


def _check_cache(got, want):
    assert set(got) == set(want)
    assert got["index"] == int(want["index"])
    for k, w in want.items():
        if k == "index":
            continue
        assert str(got[k].dtype).endswith(str(w.dtype)), k
        assert tuple(got[k].shape) == w.shape, k
        # the fp32 states (ssm, wkv) too: they sum bf16 activations
        assert_close(got[k], w, BF16)


# ===================================================================== #
# configs and parameters                                                #
# ===================================================================== #
def test_registry_matches_reference():
    from repro.configs import ARCH_IDS as J_IDS
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs import ASSIGNED_ARCHS
    assert ARCH_IDS == J_IDS and list(ASSIGNED_ARCHS) == list(J_ASSIGNED)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_cross_bit_exact(arch):
    _, jparams, _, params, _ = _model(arch)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = params
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        assert str(t.dtype).endswith(str(leaf.dtype)), path
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      t.float().numpy())


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_reference_layout(arch):
    """The port's own init: the reference's tree, shapes and dtypes
    (the per-unit 0-d gates stacked as (U,), fp32 A_log/D/dt_bias/w0/u),
    and the reference's constant leaves exactly."""
    jcfg, jparams, cfg, _, _ = _model(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    mine = lm.init_params(cfg, seed=0, device="cpu")

    def desc(shape, dtype):
        return f"{tuple(shape)}:{str(dtype).replace('torch.', '')}"

    assert jax.tree.map(lambda a: desc(a.shape, a.dtype), jparams) == \
        lm.tree_map(lambda t: desc(t.shape, t.dtype), mine)
    consts = ("A_log", "D", "dt_bias", "conv_b", "w0", "gate_attn",
              "gate_mlp", "mix_r", "mix_k", "mix_v", "mix_w", "mix_g")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        if getattr(path[-1], "key", None) in consts:
            t = mine
            for k in path:
                t = t[getattr(k, "key", getattr(k, "idx", None))]
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(leaf, np.float32),
                                       rtol=1e-6, atol=1e-6)


# ===================================================================== #
# modules                                                               #
# ===================================================================== #
def _mamba(d_model=32, **kw):
    dims = JM.mamba_dims(d_model, expand=2, head_dim=16, d_state=8, **kw)
    jp = JM.init_mamba(jax.random.PRNGKey(0), dims)
    return dims, jp, tree_to_torch(jp)


@pytest.mark.parametrize("S,chunk", [(19, 8), (16, 8), (5, 8)])
def test_mamba_fwd_matches_reference(S, chunk):
    """Whole sequence (a ragged last chunk at S 19), then from those
    states: a chunked continuation of 3 tokens and one step."""
    jdims, jp, p = _mamba(chunk=chunk)
    dims = M.mamba_dims(32, expand=2, head_dim=16, d_state=8, chunk=chunk)
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    rs = np.random.RandomState(0)
    x = normal(rs, (2, S, 32), 0.5).astype(jnp.bfloat16)
    want, (jcs, jss) = JM.mamba_fwd(jp, jnp.asarray(x), jdims)
    got, (cs, ss) = M.mamba_fwd(p, to_torch(x), dims)
    assert got.dtype == torch.bfloat16 and cs.dtype == torch.bfloat16
    assert ss.dtype == torch.float32
    assert_close(got, want, BF16)
    assert_close(cs, jcs, BF16)
    assert_close(ss, jss, FP32)
    for n in (3, 1):
        xn = normal(rs, (2, n, 32), 0.5).astype(jnp.bfloat16)
        want, (jcs2, jss2) = JM.mamba_fwd(jp, jnp.asarray(xn), jdims,
                                          conv_state=jcs, ssm_state=jss)
        got, (cs2, ss2) = M.mamba_fwd(p, to_torch(xn), dims,
                                      conv_state=to_torch(jcs),
                                      ssm_state=to_torch(jss))
        assert_close(got, want, BF16)
        assert_close(cs2, jcs2, BF16)
        assert_close(ss2, jss2, FP32)


def _rwkv():
    dims = JM.rwkv_dims(32, d_ff=64, head_dim=16, chunk=8)
    jp = JM.init_rwkv_tmix(jax.random.PRNGKey(0), dims)
    jc = JM.init_rwkv_cmix(jax.random.PRNGKey(1), dims)
    return dims, jp, jc


@pytest.mark.parametrize("S", [21, 8, 1])
def test_rwkv_tmix_fwd_matches_reference(S):
    """From zero states (S 21: a ragged last chunk; S 1: the step form)
    and from drawn states."""
    jdims, jp, _ = _rwkv()
    dims = M.rwkv_dims(32, d_ff=64, head_dim=16, chunk=8)
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    p = tree_to_torch(jp)
    rs = np.random.RandomState(1)
    x = normal(rs, (2, S, 32), 0.5).astype(jnp.bfloat16)
    want, (jst, jsh) = JM.rwkv_tmix_fwd(jp, jnp.asarray(x), jdims)
    got, (st, sh) = M.rwkv_tmix_fwd(p, to_torch(x), dims)
    assert st.dtype == torch.float32 and sh.dtype == torch.bfloat16
    assert_close(got, want, BF16)
    assert_close(st, jst, FP32)
    assert_close(sh, jsh, BF16)
    ws = normal(rs, (2, 2, 16, 16), 0.3)
    sh0 = normal(rs, (2, 32), 0.5).astype(jnp.bfloat16)
    want, (jst, _) = JM.rwkv_tmix_fwd(jp, jnp.asarray(x), jdims,
                                      wkv_state=jnp.asarray(ws),
                                      shift_state=jnp.asarray(sh0))
    got, (st, _) = M.rwkv_tmix_fwd(p, to_torch(x), dims,
                                   wkv_state=to_torch(ws),
                                   shift_state=to_torch(sh0))
    assert_close(got, want, BF16)
    assert_close(st, jst, FP32)


@pytest.mark.parametrize("S,with_state", [(7, False), (7, True),
                                          (1, True)])
def test_rwkv_cmix_fwd_matches_reference(S, with_state):
    _, _, jc = _rwkv()
    p = tree_to_torch(jc)
    rs = np.random.RandomState(2)
    x = normal(rs, (2, S, 32), 0.5).astype(jnp.bfloat16)
    sh = (normal(rs, (2, 32), 0.5).astype(jnp.bfloat16) if with_state
          else None)
    want, jsh = JM.rwkv_cmix_fwd(jc, jnp.asarray(x), _j(sh))
    got, gsh = M.rwkv_cmix_fwd(p, to_torch(x), _t(sh))
    assert_close(got, want, BF16)
    np.testing.assert_array_equal(to_numpy(gsh), to_numpy(jsh))


def test_silu_within_two_ulps_of_reference():
    """The port's ``F.silu`` and the reference's ``jax.nn.silu`` in bf16
    differ by at most two bf16 ulps (what ``reference_runner`` takes
    away on the ``ROUNDING_SENSITIVE`` families), and ``reference_silu``
    equals the reference's bit for bit."""
    from _torch_parity import reference_silu
    x = normal(np.random.RandomState(4), (4096,), 3.0).astype(jnp.bfloat16)
    want = np.asarray(jax.nn.silu(jnp.asarray(x)))
    got = torch.nn.functional.silu(to_torch(x))
    ulps = np.abs(got.view(torch.int16).numpy().astype(int)
                  - want.view(np.int16).astype(int))
    assert ulps.max() <= 2 and (ulps > 0).mean() > 0.1
    np.testing.assert_array_equal(
        reference_silu(to_torch(x)).view(torch.int16).numpy(),
        want.view(np.int16))


def test_quantize_kv_matches_reference():
    rs = np.random.RandomState(3)
    x = normal(rs, (2, 9, 2, 16), 2.0).astype(jnp.bfloat16)
    jq, js = JM.quantize_kv(jnp.asarray(x))
    q, s = M.quantize_kv(to_torch(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(s), to_numpy(js))
    # a division may round a .5 the other way: at most one level, rarely
    diff = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    got = M.dequantize_kv(q, s)
    assert got.dtype == torch.bfloat16
    assert_close(got, JM.dequantize_kv(jq, js), BF16)
    assert_close(M.dequantize_kv(q, s, torch.float32), x,
                 dict(rtol=0, atol=float(np.abs(x.astype(np.float32))
                                         .max() / 127)))


# ===================================================================== #
# whole models                                                          #
# ===================================================================== #
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch, monkeypatch):
    """Logits and every cache leaf (K/V, conv/ssm, wkv/shifts, cross
    K/V) of a 12-token prefill; S 12 leaves a ragged Mamba/RWKV chunk."""
    jcfg, jparams, cfg, params, cross = _model(arch)
    run = reference_runner(arch, monkeypatch)
    rs = np.random.RandomState(5)
    toks = rs.randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    want, jcache = run(jlm.prefill, jparams, jcfg, jnp.asarray(toks),
                         _j(cross))
    got, cache = lm.prefill(params, cfg, to_torch(toks), _t(cross))
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    assert_close(got, want, BF16)
    _check_cache(cache, jcache)


# ===================================================================== #
# the reference's decode-consistency tests, on the port                 #
# ===================================================================== #
def test_mamba_chunk_vs_step_recurrence():
    """SSD chunked scan == token-by-token recurrence (the reference's
    oracle check, on the port's blocks with the reference's weights)."""
    jdims, jp, p = _mamba(chunk=8)
    dims = M.mamba_dims(32, expand=2, head_dim=16, d_state=8, chunk=8)
    x = to_torch(np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (2, 19, 32), jnp.float32) * 0.5))
    y_full, (cs, ss) = M.mamba_fwd(p, x, dims)
    cs2 = torch.zeros((2, dims.d_conv - 1, dims.d_inner),
                      dtype=torch.bfloat16)
    ss2 = torch.zeros((2, dims.n_heads, dims.d_state, dims.head_dim))
    outs = []
    for t in range(19):
        y, (cs2, ss2) = M.mamba_fwd(p, x[:, t:t + 1], dims,
                                    conv_state=cs2, ssm_state=ss2)
        outs.append(y)
    y_step = torch.cat(outs, dim=1)
    np.testing.assert_allclose(to_numpy(y_full), to_numpy(y_step),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(to_numpy(ss), to_numpy(ss2),
                               rtol=2e-2, atol=2e-2)


def test_rwkv_chunk_vs_step_recurrence():
    jdims, jp, _ = _rwkv()
    dims = M.rwkv_dims(32, d_ff=64, head_dim=16, chunk=8)
    p = tree_to_torch(jp)
    x = to_torch(np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (2, 21, 32), jnp.float32) * 0.5))
    y_full, (state, _) = M.rwkv_tmix_fwd(p, x, dims)
    st = sh = None
    outs = []
    for t in range(21):
        y, (st, sh) = M.rwkv_tmix_fwd(p, x[:, t:t + 1], dims,
                                      wkv_state=st, shift_state=sh)
        outs.append(y)
    y_step = torch.cat(outs, dim=1)
    np.testing.assert_allclose(to_numpy(y_full), to_numpy(y_step),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(to_numpy(state), to_numpy(st),
                               rtol=2e-2, atol=2e-2)


def _int8_cfg():
    return dataclasses.replace(get_smoke_config("llama3-8b"),
                               kv_cache_dtype="int8")


def test_int8_kv_cache_decode():
    """int8-quantized KV cache: decode within quantization tolerance
    (the reference test's limit, 0.1)."""
    cfg = _int8_cfg()
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 32)))
    logits_p, cache = lm.prefill(params, cfg, toks)
    out = dict(cache)
    for k in ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale"):
        pad = [0, 0] * (out[k].dim() - 4) + [0, 8]
        out[k] = torch.nn.functional.pad(out[k], pad)
    assert out["kv_k"].dtype == torch.int8
    assert out["kv_k_scale"].dtype == torch.bfloat16
    nxt = torch.argmax(logits_p, -1)[:, None]
    logits_d, _ = lm.decode_step(params, cfg, out, nxt)
    logits_full, _ = lm.prefill(params, cfg, torch.cat([toks, nxt], 1))
    a, b = to_numpy(logits_d), to_numpy(logits_full)
    rel = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)
    assert rel < 0.1, rel


@pytest.mark.parametrize("S", [1, 3])
def test_int8_decode_step_matches_reference(S):
    """Prefill's int8 cache and scales, and one decode step of S tokens
    from it, against the reference."""
    cfg = _int8_cfg()
    jcfg = dataclasses.replace(jsmoke("llama3-8b"), kv_cache_dtype="int8")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = tree_to_torch(jparams)
    rs = np.random.RandomState(9)
    toks = rs.randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    nxt = rs.randint(0, cfg.vocab, (2, S)).astype(np.int32)
    want, jcache = jlm.prefill(jparams, jcfg, jnp.asarray(toks))
    got, cache = lm.prefill(params, cfg, to_torch(toks))
    assert_close(got, want, BF16)
    assert set(cache) == set(jcache)
    for k in ("kv_k_scale", "kv_v_scale"):
        assert_close(cache[k], jcache[k], BF16)
    for k in ("kv_k", "kv_v"):
        assert cache[k].dtype == torch.int8
        diff = np.abs(cache[k].numpy().astype(int)
                      - np.asarray(jcache[k]).astype(int))
        assert diff.max() <= 2, k
    jpad = dict(jcache)
    for k in ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale"):
        pads = [(0, 0)] * jpad[k].ndim
        pads[3] = (0, 6)
        jpad[k] = jnp.pad(jpad[k], pads)
    want, _ = jlm.decode_step(jparams, jcfg, jpad, jnp.asarray(nxt))
    got, new = lm.decode_step(params, cfg, _port_cache(jpad),
                              torch.from_numpy(nxt))
    assert_close(got, want, BF16)
    assert new["index"] == 12 + S


def test_reference_flexgen_fails_on_int8_kv():
    """The reference's FlexGenEngine pads kv_k/kv_v and not their int8
    scales, so its first decode step cannot dequantize the cache; the
    port's engine refuses an int8 config up front, naming the cause."""
    from repro.offload import serve_engine as jserve
    from repro_torch.offload import serve_engine
    cfg = _int8_cfg()
    jcfg = dataclasses.replace(jsmoke("llama3-8b"), kv_cache_dtype="int8")
    jeng = jserve.FlexGenEngine(
        jcfg, jlm.init_params(jax.random.PRNGKey(0), jcfg),
        jserve.ServeConfig(max_new_tokens=3, prompt_len=8))
    with pytest.raises(TypeError, match="broadcast"):
        jeng.run(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="kv_k_scale"):
        serve_engine.FlexGenEngine(
            cfg, lm.init_params(cfg, seed=0, device="cpu"), device="cpu")


@pytest.mark.parametrize("units", [1, 2])
def test_jamba_reference_rounding_spread(units, monkeypatch):
    """The JAX package's jamba smoke model at one and two units, widened
    to head_dim 64, over 8 prompts of 64 (the shapes at which
    ``chip_smoke.py`` compares the port's run on the card with its run
    on the CPU), prefilled compiled and op by op: the two runs' logits
    part past the bf16 tolerance (``rel_err``: max |a - b| over max |b|,
    the chip script's measure).  Rounding alone moves this model's
    logits that far (its bf16 router scores tie and flip a top-2
    choice), so jamba's whole-model tests run the reference op by op
    (``ROUNDING_SENSITIVE``).  Run with ``-s`` to print the readings,
    and beside them the port's own spread on the CPU: its prefill with
    ``F.silu`` against its prefill with ``reference_silu``, at most two
    bf16 ulps apart."""
    from _torch_parity import _ReferenceRoundingF
    smoke = jsmoke("jamba-1.5-large-398b")
    jcfg = dataclasses.replace(smoke, head_dim=64,
                               n_layers=units * len(smoke.pattern))
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                              head_dim=64, n_layers=jcfg.n_layers)
    params = tree_to_torch(jparams)
    toks = np.random.RandomState(0).randint(
        0, jcfg.vocab, (8, 64)).astype(np.int32)
    compiled, _ = jlm.prefill(jparams, jcfg, jnp.asarray(toks))
    op_by_op, _ = eager(jlm.prefill, jparams, jcfg, jnp.asarray(toks))
    port, _ = lm.prefill(params, cfg, to_torch(toks))
    monkeypatch.setattr(M, "F", _ReferenceRoundingF())
    port_silu, _ = lm.prefill(params, cfg, to_torch(toks))

    def rel_err(a, b):
        a, b = to_numpy(a), to_numpy(b)
        return float(np.abs(a - b).max() / np.abs(b).max())
    spread = rel_err(compiled, op_by_op)
    print(f"\njamba smoke, {units} unit(s), head_dim 64, 8 x 64: reference "
          f"compiled vs op by op {spread:.4g}; port F.silu vs "
          f"reference_silu {rel_err(port, port_silu):.4g}")
    assert np.isfinite(to_numpy(port)).all()
    assert spread > BF16["atol"]
