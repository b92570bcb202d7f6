"""Training the recurrent families, the port against the JAX reference on
the CPU: the gradients of the RWKV6 time-mix and channel-mix and of the
Mamba-2 block against the reference's ``jax.grad`` in fp32 and in bf16,
the whole-model gradients of the rwkv6-7b and jamba-1.5-large-398b smoke
models (jamba's in fp32, and in bf16 as a reading), and the chunked scans' backward against the one-token
recurrence's with the planted faults of ``chip_smoke.py``'s recurrent
backward phase.  Inputs are numpy draws from a seed; the reference's
weights cross bit-exactly through ``params_from_numpy``."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from _torch_parity import (_ReferenceRoundingF, eager,  # noqa: E402
                           fp32_models, normal, smoke_model, to_numpy,
                           to_torch, tree_to_torch)

from repro.launch import steps as jsteps  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import modules as M  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# Module gradients, per leaf by relative norm.  fp32: the two packages
# sum in another order (measured 8e-7 or less).  bf16: each package
# rounds its bf16 products and activations where its own ops round, two
# bf16 ulps (1.6e-2) apart at most per element, and the recurrences and
# the data-dependent decay carry that into the small leaves (measured
# 1.3e-2 for mix_k and conv_b)
MODULE_GRAD_REL = {"fp32": 1e-4, "bf16": 3e-2}
# the rwkv6-7b smoke model against the reference run op by op with the
# port's silu rounded as the reference's (``reference_runner``):
# measured 2.0e-2 (tmix.mix_w); compiled, the reference's own two runs
# part by up to 3.0e-2
RWKV_MODEL_GRAD_REL = 5e-2
# the jamba smoke model in fp32 against the compiled reference: no
# router choice flips there, and the two packages sum in another order
# (measured 5.2e-5, a Mamba A_log leaf; the loss 4.8e-7 apart).  A
# gradient left out or detached in the wiring reads 1.0
JAMBA_FP32_GRAD_REL = 5e-4


def _rel(got, want) -> float:
    g, w = to_numpy(got), np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _leaf(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", None))]
    return tree


def _module_grads(jfn, tfn, jp, x, w):
    """(reference grads of p and x, port grads of p and x) of
    ``sum(fn(p, x)[0] * w)``; ``jp``'s leaves and ``x`` in the dtypes
    they come in."""
    def jloss(p, xx):
        return jnp.sum(jfn(p, xx)[0].astype(jnp.float32) * w)
    jg, jdx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    flat, spec = pytree.tree_flatten(tree_to_torch(jp))
    leaves = [t.detach().requires_grad_() for t in flat]
    xt = to_torch(np.asarray(x)).requires_grad_()
    out = tfn(pytree.tree_unflatten(leaves, spec), xt)[0]
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              leaves + [xt])
    return (jg, jdx), (pytree.tree_unflatten(list(got[:-1]), spec), got[-1])


def _rwkv_dims():
    return (JM.rwkv_dims(32, d_ff=64, head_dim=16, chunk=8),
            M.rwkv_dims(32, d_ff=64, head_dim=16, chunk=8))


def _mamba_dims():
    return (JM.mamba_dims(32, expand=2, head_dim=16, d_state=8, chunk=8),
            M.mamba_dims(32, expand=2, head_dim=16, d_state=8, chunk=8))


def _module(name):
    """(reference fn, port fn, reference params, S) of one block at the
    module tests' widths; S leaves a ragged last chunk."""
    if name == "rwkv_tmix":
        jd, td = _rwkv_dims()
        return (lambda p, x: JM.rwkv_tmix_fwd(p, x, jd),
                lambda p, x: M.rwkv_tmix_fwd(p, x, td),
                JM.init_rwkv_tmix(jax.random.PRNGKey(0), jd), 21)
    if name == "rwkv_cmix":
        jd, _ = _rwkv_dims()
        return (JM.rwkv_cmix_fwd, M.rwkv_cmix_fwd,
                JM.init_rwkv_cmix(jax.random.PRNGKey(1), jd), 21)
    jd, td = _mamba_dims()
    return (lambda p, x: JM.mamba_fwd(p, x, jd),
            lambda p, x: M.mamba_fwd(p, x, td),
            JM.init_mamba(jax.random.PRNGKey(0), jd), 19)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["rwkv_tmix", "rwkv_cmix", "mamba"])
def test_module_grads_match_reference(name, dtype):
    """Every leaf's gradient and x's, the port's autograd against the
    reference's ``jax.grad``: fp32 (params and x upcast) and bf16 (the
    blocks' own dtypes, x bf16)."""
    jfn, tfn, jp, S = _module(name)
    rs = np.random.RandomState(0)
    x = normal(rs, (2, S, 32), 0.5)
    w = normal(rs, (2, S, 32))
    if dtype == "fp32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    else:
        x = x.astype(jnp.bfloat16)
    (jg, jdx), (g, dx) = _module_grads(jfn, tfn, jp, x, w)
    tol = MODULE_GRAD_REL[dtype]
    assert dx.dtype == to_torch(np.asarray(x)).dtype
    assert _rel(dx, jdx) < tol
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = _leaf(g, path)
        assert str(got.dtype).endswith(str(want.dtype)), path
        assert _rel(got, want) < tol, (jax.tree_util.keystr(path),
                                       _rel(got, want))


def _model_grads(arch, monkeypatch):
    """(reference op by op, reference compiled, port with the reference's
    silu) grads of one step of ``arch``'s smoke model over 2 x 64
    tokens; the port's loss too."""
    jcfg, jparams, cfg, params = smoke_model(arch)
    rs = np.random.RandomState(8)
    toks = rs.randint(0, cfg.vocab, (2, 64)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    el, eg = eager(jsteps.make_grad_step(jcfg), jparams, jb)
    cl, cg = jax.jit(jsteps.make_grad_step(jcfg))(jparams, jb)
    monkeypatch.setattr(M, "F", _ReferenceRoundingF())
    loss, g = steps.make_grad_step(cfg)(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    return (el, eg), (cl, cg), (loss, g)


def test_rwkv_model_grads_match_reference(monkeypatch):
    """rwkv6-7b smoke: the loss and every leaf's gradient against the
    reference run op by op."""
    (el, eg), _, (loss, g) = _model_grads("rwkv6-7b", monkeypatch)
    assert abs(float(loss) - float(el)) < 2e-4
    for path, want in jax.tree_util.tree_leaves_with_path(eg):
        got = _leaf(g, path)
        assert str(got.dtype).endswith(str(want.dtype)), path
        assert torch.isfinite(got.float()).all(), path
        assert _rel(got, want) < RWKV_MODEL_GRAD_REL, (
            jax.tree_util.keystr(path), _rel(got, want))


def test_jamba_model_grads_match_reference(monkeypatch):
    """jamba smoke, the whole model in fp32 (``fp32_models``): the loss
    and every leaf's gradient through the port's wiring (``unit_views``,
    remat over hybrid units, the Mamba, MoE and attention layers)
    against the compiled reference's ``jax.grad``."""
    jcfg, jparams, cfg, _ = smoke_model("jamba-1.5-large-398b")
    jparams, params = fp32_models(jparams, monkeypatch)
    rs = np.random.RandomState(8)
    toks = rs.randint(0, cfg.vocab, (2, 64)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl, jg = jax.jit(jsteps.make_grad_step(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    loss, g = steps.make_grad_step(cfg)(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    assert abs(float(loss) - float(jl)) < 1e-4
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = _leaf(g, path)
        assert got.dtype == torch.float32, path
        assert _rel(got, want) < JAMBA_FP32_GRAD_REL, (
            jax.tree_util.keystr(path), _rel(got, want))


def test_jamba_model_grads_within_reference_spread(monkeypatch):
    """jamba smoke in bf16, a reading (run with ``-s``): its bf16 router
    flips a top-2 choice on an ulp, so the reference's own compiled and
    op-by-op gradients part by up to ~2x their norm on a leaf (measured
    0.37-2.4 on the Mamba leaves), and no bf16 limit can tell a wrong
    gradient from that.  The check of the gradients is the fp32 test
    above; this one prints how far the port's part from the op-by-op
    run, as a share of each leaf's compiled-vs-op-by-op spread
    (measured: at most 0.76), and holds the loss, finite gradients of
    the reference's dtypes and the port within that spread."""
    (el, eg), (cl, cg), (loss, g) = _model_grads("jamba-1.5-large-398b",
                                                 monkeypatch)
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(el)) < 2e-3
    worst = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(eg):
        got = _leaf(g, path)
        assert str(got.dtype).endswith(str(want.dtype)), path
        assert torch.isfinite(got.float()).all(), path
        spread = _rel(_leaf(cg, path), want)
        err = _rel(got, want)
        assert err < spread, (jax.tree_util.keystr(path), err, spread)
        worst = max(worst, err / spread)
    print(f"\njamba smoke grads (bf16): port vs op by op at most "
          f"{worst:.3g} of the reference's compiled-vs-op-by-op spread")


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_chunk_vs_step_backward_and_planted_faults(kind):
    """``chip_smoke.recurrent_grad_readings`` at smoke widths on the CPU,
    held as the chip script's recurrent backward phase holds it at full
    width: every leaf's gradient through the chunked scan (one call, and
    two halves with the states carried) within ``RECURRENT_GRAD_REL`` of
    the one-token recurrence's, and each planted fault above it."""
    g = torch.Generator()
    g.manual_seed(0)
    if kind == "rwkv":
        dims = M.rwkv_dims(64, d_ff=128, head_dim=16, chunk=8)
        p = M.init_rwkv_tmix(dims, g, "cpu")
    else:
        dims = M.mamba_dims(64, expand=2, head_dim=16, d_state=8, chunk=8)
        p = M.init_mamba(dims, g, "cpu")
    p = lm.tree_map(lambda t: t.float(), p)
    x = torch.randn((2, 37, 64), generator=g)
    w = torch.randn((2, 37, 64), generator=g)
    r = chip_smoke.recurrent_grad_readings(kind, dims, p, x, w)
    assert set(r["leaves"]) == {"x"} | {
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in pytree.tree_flatten_with_path(p)[0]}
    for name, v in r["forms"].items():
        assert v["max"] < chip_smoke.RECURRENT_GRAD_REL, (name, v)
    assert len(r["faults"]) == 3
    for name, v in r["faults"].items():
        assert v["max"] > chip_smoke.RECURRENT_GRAD_REL, (name, v)
    assert all(len(t) == 2 for t in r["ms"].values())
