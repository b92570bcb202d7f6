"""The other model families' decode steps, loss and gradients against
the JAX reference on the CPU (llama-3.2-vision-11b, jamba-1.5-large-398b,
whisper-large-v3, rwkv6-7b smoke models): one decode step of 1 and of 3
tokens from the reference's prefill cache (logits and every leaf of the
stepped cache), ``forward_loss``, and one grad step.  Inputs are numpy
draws from a seed; the reference's weights cross bit-exactly through
``params_from_numpy``.  The decode steps of the
``_torch_parity.ROUNDING_SENSITIVE`` families run the reference op by
op (``reference_runner``); the loss holds the port as it is against the
reference as it is."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, BF16, FP32,  # noqa: E402
                           reference_runner, to_torch)
from test_torch_families import (_check_cache, _j, _model,  # noqa: E402
                                 _pad_kv, _port_cache, _t, FAMILIES)

from repro.models import lm as jlm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_reference(arch, S, monkeypatch):
    """One decode step of S tokens from the reference's prefill cache:
    logits and every leaf of the stepped cache."""
    jcfg, jparams, cfg, params, cross = _model(arch)
    run = reference_runner(arch, monkeypatch)
    rs = np.random.RandomState(6)
    prompt = rs.randint(0, jcfg.vocab, (2, 12)).astype(np.int32)
    nxt = rs.randint(0, jcfg.vocab, (2, S)).astype(np.int32)
    _, jcache = run(jlm.prefill, jparams, jcfg, jnp.asarray(prompt),
                    _j(cross))
    jcache = _pad_kv(jcache, 6)
    cache = _port_cache(jcache)
    want, jnew = run(jlm.decode_step, jparams, jcfg, jcache,
                     jnp.asarray(nxt))
    got, new = lm.decode_step(params, cfg, cache, torch.from_numpy(nxt))
    assert_close(got, want, BF16)
    _check_cache(new, jnew)


def _batch(cfg, cross):
    rs = np.random.RandomState(8)
    toks = rs.randint(0, cfg.vocab, (2, 64)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cross is not None:
        b["frames"] = cross
    return b


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_matches_reference(arch):
    jcfg, jparams, cfg, params, cross = _model(arch)
    b = _batch(cfg, cross)
    want = jlm.forward_loss(jparams, jcfg, jnp.asarray(b["tokens"]),
                            jnp.asarray(b["labels"]), _j(cross))
    got = lm.forward_loss(params, cfg, to_torch(b["tokens"]),
                          to_torch(b["labels"]), _t(cross))
    assert got.dtype == torch.float32 and got.shape == ()
    # an fp32 scalar at the fp32 tolerance: jamba's MoE routes 1024
    # (token, layer) choices, and at S 64 a few round to another expert
    # (the loss moves by up to 2e-3 of ~6.3)
    assert_close(got, want, FP32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_grads_are_finite(arch):
    """One grad step through the step builders (frames in the batch, as
    the reference's steps pass them): the loss of ``forward_loss``, a
    finite gradient on every leaf of the reference's tree in the leaf's
    dtype, and nonzero gradients on the family's own leaves."""
    _, jparams, cfg, params, cross = _model(arch)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, cross).items()}
    loss, grads = steps.make_grad_step(cfg)(params, b)
    want = lm.forward_loss(params, cfg, b["tokens"], b["labels"],
                           b.get("frames"))
    assert float(loss) == float(want)
    flat_p = jax.tree_util.tree_leaves_with_path(jparams)
    own = {"A_log", "w0", "u", "gate_attn", "gate_mlp", "conv_w", "wA"}
    seen = set()
    for path, leaf in flat_p:
        g = grads
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        assert str(g.dtype).endswith(str(leaf.dtype)), path
        assert tuple(g.shape) == leaf.shape, path
        assert torch.isfinite(g.float()).all(), path
        name = getattr(path[-1], "key", None)
        if name in own and g.float().abs().sum() > 0:
            seen.add(name)
    assert seen == own & {getattr(p[-1], "key", None) for p, _ in flat_p}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_launcher_trains_the_recurrent_families(arch, capsys):
    """The training launcher on the attention-free and the hybrid smoke
    models (the vision and Whisper models need frames, which its data
    pipeline does not make, as the reference's does not)."""
    import re
    from repro_torch.launch import train
    train.main(["--arch", arch, "--smoke", "--steps", "2", "--device",
                "cpu"])
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"loss=([\d.]+)", out)]
    assert len(losses) >= 1 and all(np.isfinite(losses)), out
    assert out.strip().endswith("done")
