"""The frozen plain references against the port's own plain path at a
small size on the CPU: serving logits through prefill and decode.  (The
references import nothing of the port; this test imports both.)"""
import numpy as np
import torch

from perfbench import weights
from perfbench.drivers import port_config
from perfbench.reference import qwen3_moe
from perfbench.reference.plain import fp8_round
from perfbench.tests import tiny


def _port_serve_logits(cfg, w, prompt, n_new):
    """Greedy prefill and decode through the port's ``lm`` functions on a
    contiguous cache; every step's fp32 logits and the served tokens."""
    from repro_torch.models import lm
    L = prompt.shape[0]
    logits, cache = lm.prefill(w, cfg, prompt[None])
    buf = lm.make_decode_cache(cfg, 1, L + n_new, device="cpu")
    buf["kv_k"][:, :, :, :L] = cache["kv_k"]
    buf["kv_v"][:, :, :, :L] = cache["kv_v"]
    buf["index"] = L
    rows, served = [logits[0]], [int(logits[0].argmax())]
    for _ in range(n_new - 1):
        logits, buf = lm.decode_step(w, cfg, buf,
                                     torch.tensor([[served[-1]]]))
        rows.append(logits[0])
        served.append(int(logits[0].argmax()))
    return torch.stack(rows), torch.tensor(served)


def test_serving_reference_follows_prefill_and_decode():
    """Row by row, the port's bf16 logits lie within a few percent of
    the reference's; a reference without the prompt's capacity drops
    lies several times further off (a routing near tie in bf16 can move
    one row, so the median row is compared)."""
    c = tiny.serve_cell()
    m = c["config"]["model"]
    cfg = port_config(c["config"])
    w = weights.make(m, 11, "cpu")
    g = np.random.default_rng(3)
    for L in (37, 40, 64):     # one group of 37; 4 groups; 4 groups
        prompt = torch.as_tensor(g.integers(0, m["vocab"], L))
        port, served = _port_serve_logits(cfg, w, prompt, 8)
        seq = torch.cat([prompt, served[:-1]])
        ref = qwen3_moe.served_logits(w, m, [seq], [L])[0]
        undropped = qwen3_moe.served_logits(
            w, dict(m, capacity_factor=100.0), [seq], [L])[0]
        assert ref.shape == port.shape
        scale = float(ref.abs().max())
        row = (port - ref).abs().max(-1).values.median() / scale
        off = (port - undropped).abs().max(-1).values.median() / scale
        assert row < 0.05 and off > 3 * row, (L, row, off)


def test_capacity_routing_drops_past_capacity():
    probs = torch.zeros(8, 4)
    probs[:, 0] = 0.9                      # every token wants expert 0
    probs[:, 1] = 0.1
    ids, wts = qwen3_moe.capacity_route(probs, 1, 1.0, 2)
    # 2 groups of 4 tokens, capacity max(int(4 * 1 * 1.0 / 4), 4) = 4
    assert (wts > 0).all()
    ids, wts = qwen3_moe.capacity_route(probs.repeat(4, 1), 1, 1.0, 1)
    # one group of 32 tokens: capacity 8 for expert 0
    assert int((wts > 0).sum()) == 8 and bool((wts[:8] > 0).all())


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(64, 64)
    e8 = (fp8_round(x, -1) - x).abs().max() / x.abs().max()
    e16 = (x.bfloat16().float() - x).abs().max() / x.abs().max()
    assert e8 > 4 * e16

