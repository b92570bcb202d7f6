"""The hybrid cell (``hybrid-chat-closed64``, driver ``serve_hybrid``) at
a small size on the CPU: sound runs are correct, a served token altered
where it is produced and the float8 control are not, the Mamba spans'
reader reads the engine's tracer, and the hybrid cost formulas count
what the weights hold."""
import contextlib
import io
import json

from perfbench import calibrate_hybrid, harness, run, weights_hybrid
from perfbench.costs import hybrid
from perfbench.drivers import port_config
from perfbench.drivers import serve_hybrid as sh
from perfbench.tests import tiny_hybrid


def _result(cell, trace="0") -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell["name"], "--seed", str(2**31 + 5),
                       "--seconds", "3", "--trace", trace], device="cpu",
                      cell=cell)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_runs_are_correct_and_read_the_mamba_spans():
    cell = tiny_hybrid.hybrid_cell()
    assert _result(cell)["correct"] is True
    r = _result(cell, trace="1")
    assert r["correct"] is True
    got = r["metrics"]
    assert 0 < got["mamba_enqueue_ms.chat"]["value"] < \
        got["decode_step_ms.chat"]["value"]


def test_a_served_token_altered_where_it_is_produced(monkeypatch):
    """Each decoded token replaced by the token the logits rank last."""
    from repro_torch.models import shardings
    orig = shardings.argmax

    def worst(logits):
        return shardings.gather(logits).argmin(dim=-1) \
            if logits.shape[0] > 1 else orig(logits)
    monkeypatch.setattr(shardings, "argmax", worst)
    r = _result(tiny_hybrid.hybrid_cell())
    assert r["correct"] is False, r["checks"]


def test_hybrid_control_fails_the_limit(capsys):
    """The control (the hybrid reference with float8 products,
    teacher-forced on the program's served tokens), its first-ranked
    tokens judged in the program's place by the run's check: on the CPU
    the program read 1.7e-4 - 1.1e-3 (seeds 11-15), the control
    3.2e-3 - 3.4e-3 (seeds 11-13), the tiny cell's limit
    ``tiny_hybrid.LIMIT``."""
    cell = tiny_hybrid.hybrid_cell()
    calibrate_hybrid.main(["--workload", cell["name"], "--control-seeds",
                           "11,12", "--seconds", "3"], device="cpu",
                          cell=cell)
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert len(rows) == 2
    for r in rows:
        assert r["correct"] is True, r
        assert r["control"]["correct"] is False, r


def test_serve_flops_count_the_weights_matrices():
    """Per token, 2 x every matrix a token passes through (its top-k of
    the experts), counted from the weight maker's tree, plus the SSM's
    4 H N P per Mamba layer."""
    m = dict(harness.cell("hybrid-chat-closed64")["config"]["model"],
             **tiny_hybrid.HYBRID_MODEL)
    w = weights_hybrid.make(m, 0, "cpu")
    E, K = m["n_experts"], m["top_k"]
    per_token = 0
    for lp in w["units"]["layers"]:
        U = lp["norm1"]["scale"].shape[0]
        for name, mats in lp.items():
            if name.startswith("norm"):
                continue
            for leaf, t in mats.items():
                if leaf in ("w_gate", "w_up", "w_down") and name == "moe":
                    per_token += U * t[0].numel() // E * K
                elif leaf in ("w_in", "w_out", "wq", "wk", "wv", "wo",
                              "router", "w_gate", "w_up", "w_down"):
                    per_token += U * t[0].numel()
    _, H, N, P, _ = hybrid.mamba_dims(m)
    n_mamba = m["n_layers"] - len(m["attn_layers"])
    want = 2 * per_token + 4 * n_mamba * H * N * P
    assert hybrid.serve_flops(m, 1, 0, 0) == want
    assert hybrid.serve_flops(m, 0, 1, 1) == (
        4 * len(m["attn_layers"]) * m["n_heads"] * m["head_dim"]
        + 2 * m["d_model"] * m["vocab"])


def test_ssm_bytes_are_the_state_twice_and_the_step():
    B, H, N, P, G = 64, 128, 128, 64, 1
    flops, nbytes = hybrid.ssm_state_update(B, H, N, P, G)
    state = B * H * N * P * 4
    assert 2 * state < nbytes < 2.02 * state
    assert flops == 5 * B * H * N * P + 2 * B * H * P
    calls = sh.HybridCalls.__new__(sh.HybridCalls)
    calls.expert, calls.paged, calls.flash = [], [], []
    calls.ssm = [(B, H, N, P, G)] * 3
    got = calls.bounds()["ssm_state_update"]
    assert abs(got - 3 * nbytes / 3.35e12) < 1e-15


def test_the_file_pattern_is_the_ports():
    """The configuration file's published ``layer_types`` put attention
    where its ``model`` and the port's registry pattern do."""
    conf = harness.cell("hybrid-chat-closed64")["config"]
    at = [i for i, t in enumerate(conf["layer_types"]) if t == "attention"]
    assert at == conf["model"]["attn_layers"]
    assert conf["reduced"] == [] and conf["published"]["layer_types"] == \
        conf["layer_types"]
    sh._check_pattern(port_config(conf), conf["model"])


def test_mamba_reader_needs_whole_spans():
    from repro_torch.obs.trace import TraceRecorder
    t = [0.0]
    rec = TraceRecorder(clock=lambda: t[0], hot_spans=True)
    for _ in range(2):
        with rec.span("engine.decode", cat="span"):
            with rec.span("engine.decode.forward", cat="span"):
                for _ in range(3):
                    with rec.span(sh.MAMBA_SPAN, cat="span"):
                        t[0] += 0.002
                    t[0] += 0.001
    assert abs(sh.mamba_enqueue_ms(rec, 0.0, 1.0) - 6.0) < 1e-9
    assert sh.mamba_enqueue_ms(rec, 0.5, 1.0) is None
    assert sh.mamba_enqueue_ms(TraceRecorder(hot_spans=True), 0, 1) is None
