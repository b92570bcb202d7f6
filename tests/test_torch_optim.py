"""Port optimizer against the JAX package: the plain ``fused_adam``
against the Pallas kernel (interpret mode) over the reference's sweep,
and ``apply_update`` (clipping, bf16 error-feedback compression, fused
and plain paths) against ``repro.optim.apply_update`` on the same numpy
inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import assert_close, normal, to_numpy, to_torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.fused_adam import fused_adam as adam_kernel  # noqa: E402
from repro_torch.optim import AdamConfig, apply_update, init_state  # noqa: E402

# the reference kernel tests' tolerance (tests/test_kernels.py)
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _adam_inputs(rs, shape, gdtype, zero_moments=False):
    master = normal(rs, shape)
    m = np.zeros(shape, np.float32) if zero_moments else normal(rs, shape, .1)
    v = np.zeros(shape, np.float32) if zero_moments \
        else np.abs(normal(rs, shape, .01))
    g = normal(rs, shape).astype(gdtype)
    return master, m, v, g


def _check_fused_adam(arrays, kw):
    want = jops.fused_adam(*(jnp.asarray(a) for a in arrays), **kw)
    got = ref.fused_adam(*(to_torch(a) for a in arrays), **kw)
    via_ops = ops.fused_adam(*(to_torch(a) for a in arrays), **kw)
    for a, b, c in zip(got, want, via_ops):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert_close(a, b, ADAM_TOL)
        assert torch.equal(a, c)      # a CPU tensor takes the plain version


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 4096, 70000])
@pytest.mark.parametrize("gdtype", [np.float32, jnp.bfloat16])
def test_fused_adam_plain_matches_jax_kernel(n, gdtype):
    rs = np.random.RandomState(n)
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, b1c=0.1, b2c=0.05)
    _check_fused_adam(_adam_inputs(rs, (n,), gdtype), kw)


@pytest.mark.parametrize("shape", [(3, 5), (16, 128), (2, 3, 4, 5)])
def test_fused_adam_nd_shapes(shape):
    rs = np.random.RandomState(0)
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, b1c=0.1,
              b2c=0.001)
    _check_fused_adam(_adam_inputs(rs, shape, np.float32, True), kw)


def test_cpu_input_never_launches_the_kernel():
    x = torch.ones(8)
    n = build.LAUNCHES["fused_adam"]
    ops.fused_adam(x, x, x, x, lr=1e-3, b1=.9, b2=.95, eps=1e-8, wd=0.,
                   b1c=.1, b2c=.05)
    assert build.LAUNCHES["fused_adam"] == n
    with pytest.raises(ValueError, match="CUDA tensor"):
        adam_kernel(x, x, x, x, lr=1e-3, b1=.9, b2=.95, eps=1e-8, wd=0.,
                    b1c=.1, b2c=.05)


# ---------------------------------------------------------------------- #
# apply_update                                                            #
# ---------------------------------------------------------------------- #
def _tree(rs, stacked=False):
    """bf16 params (a layer-stacked leaf when ``stacked``, which the
    reference streams through ``lax.map``) plus an fp32 norm scale."""
    w_shape = (24, 8, 4) if stacked else (8, 4)
    return {"w": normal(rs, w_shape, 0.1).astype(jnp.bfloat16),
            "b": np.zeros((4,), jnp.bfloat16),
            "scale": 1.0 + normal(rs, (4,), 0.1)}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: to_torch(v) for k, v in tree.items()})


def _check_state(got, want, tol=ADAM_TOL):
    for key in ("master", "m", "v") + (("err",) if "err" in want else ()):
        for name in want[key]:
            assert_close(got[key][name], want[key][name], tol)
    assert int(got["step"]) == int(want["step"])


CASES = {
    # (config kwargs, grad scale): clipping active / inactive
    "plain_clipped": (dict(lr=1e-2, grad_clip=0.05), 1.0),
    "plain_unclipped": (dict(lr=1e-2, weight_decay=0.0, grad_clip=1e9),
                        0.01),
    "fused_clipped": (dict(lr=1e-2, grad_clip=0.05, use_fused_kernel=True),
                      1.0),
    "compressed": (dict(lr=1e-3, grad_clip=1e9, compress_grads=True), 1e-3),
    "compressed_fused": (dict(lr=1e-3, grad_clip=0.5, compress_grads=True,
                              use_fused_kernel=True), 1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("stacked", [False, True])
def test_apply_update_matches_reference(case, stacked):
    """Three steps from the same params, state and grads: state and
    params agree with the reference's at the kernel tolerance."""
    kw, gscale = CASES[case]
    rs = np.random.RandomState(3)
    jp, tp = _both(_tree(rs, stacked))
    jcfg, tcfg = jadam.AdamConfig(**kw), AdamConfig(**kw)
    js, ts = jadam.init_state(jp, jcfg), init_state(tp, tcfg)
    for step in range(3):
        g = {k: normal(rs, np.shape(v), gscale) for k, v in jp.items()}
        jp, js = jadam.apply_update(jp, js, jax.tree.map(jnp.asarray, g),
                                    jcfg)
        tp, ts = apply_update(tp, ts, {k: to_torch(v) for k, v in g.items()},
                              tcfg)
        _check_state(ts, js)
        for name in jp:
            assert tp[name].dtype == (torch.bfloat16 if name != "scale"
                                      else torch.float32)
            assert_close(tp[name], jp[name], dict(rtol=1e-2, atol=1e-6))


@pytest.mark.parametrize("chunk", [1, 7, 32, 1 << 26])
def test_plain_update_in_row_chunks_is_bit_exact(monkeypatch, chunk):
    """The plain update runs over row chunks of at most ``CHUNK_ELEMS``
    elements of a leaf (one row where a row is larger); it is
    elementwise, so every chunking gives the whole-leaf update bit for
    bit."""
    from repro_torch.optim import adam
    cfg = AdamConfig(lr=1e-2, grad_clip=0.05)
    rs = np.random.RandomState(5)
    params = {k: to_torch(v) for k, v in _tree(rs, stacked=True).items()}
    grads = {k: to_torch(normal(rs, tuple(v.shape))) for k, v in
             params.items()}
    want = apply_update(params, init_state(params, cfg), grads, cfg)
    monkeypatch.setattr(adam, "CHUNK_ELEMS", chunk)
    got = apply_update(params, init_state(params, cfg), grads, cfg)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_grad_clip_bounds_the_first_moment():
    cfg = AdamConfig(lr=1.0, grad_clip=0.001, weight_decay=0.0)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    _, state = apply_update(params, init_state(params, cfg),
                            {"w": torch.full((4,), 100.0)}, cfg)
    m = to_numpy(state["m"]["w"])
    assert np.linalg.norm(m / (1 - cfg.b1)) <= 0.0011


def test_compression_error_feedback_tracks_uncompressed():
    """bf16 compression keeps a residual; over steps the applied updates
    converge to the uncompressed ones (the reference's property)."""
    kw = dict(lr=1e-3, grad_clip=1e9, weight_decay=0.0)
    cfg_c = AdamConfig(compress_grads=True, **kw)
    cfg_u = AdamConfig(**kw)
    pc = pu = {"w": torch.zeros(64, dtype=torch.bfloat16)}
    sc, su = init_state(pc, cfg_c), init_state(pu, cfg_u)
    g = {"w": torch.linspace(1e-4, 3e-3, 64)}
    for _ in range(50):
        pc, sc = apply_update(pc, sc, g, cfg_c)
        pu, su = apply_update(pu, su, g, cfg_u)
    np.testing.assert_allclose(to_numpy(sc["master"]["w"]),
                               to_numpy(su["master"]["w"]),
                               rtol=0.05, atol=1e-5)
    assert torch.any(sc["err"]["w"] != 0)


def test_fused_path_equals_plain_path_on_cpu():
    rs = np.random.RandomState(2)
    _, params = _both(_tree(rs))
    grads = {k: to_torch(normal(rs, tuple(v.shape), 0.01))
             for k, v in params.items()}
    cfg_f = AdamConfig(lr=1e-2, grad_clip=1e9, use_fused_kernel=True)
    cfg_p = AdamConfig(lr=1e-2, grad_clip=1e9)
    _, sf = apply_update(params, init_state(params, cfg_f), grads, cfg_f)
    _, sp = apply_update(params, init_state(params, cfg_p), grads, cfg_p)
    for key in ("master", "m", "v"):
        for name in params:
            assert torch.equal(sf[key][name], sp[key][name])


def test_init_state_copies_fp32_params():
    p = {"scale": torch.ones(4)}
    s = init_state(p, AdamConfig(compress_grads=True))
    assert s["master"]["scale"].data_ptr() != p["scale"].data_ptr()
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 0
    assert set(s) == {"master", "m", "v", "step", "err"}
