"""Every run but the look for a card, at a small size on the CPU, with
the timed path broken underneath: ``correct`` has to come out false.
And the control, the plain reference one precision below the
configuration's put in the program's place, has to fail the limit too.
(The faults the cell cannot have are not planted: it runs on one chip,
so no exchange between chips can be left out.)"""
import contextlib
import io
import json

from perfbench import calibrate, run
from perfbench.tests import tiny


def _result(cell) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell["name"], "--seed", str(2**31 + 5),
                       "--seconds", "3", "--trace", "0"], device="cpu",
                      cell=cell)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_runs_are_correct():
    assert _result(tiny.serve_cell())["correct"] is True


def test_a_served_token_altered_where_it_is_produced(monkeypatch):
    """Each decoded token replaced by the token the logits rank last."""
    from repro_torch.models import shardings
    orig = shardings.argmax

    def worst(logits):
        return shardings.gather(logits).argmin(dim=-1) \
            if logits.shape[0] > 1 else orig(logits)
    monkeypatch.setattr(shardings, "argmax", worst)
    r = _result(tiny.serve_cell())
    assert r["correct"] is False, r["checks"]


def test_a_decode_step_that_leaves_the_cache_unchanged(monkeypatch):
    """Each decode step's new keys and values dropped: zeros written in
    their place, so later steps attend to a cache the step never
    filled."""
    from repro_torch.serving import engine
    orig = engine._fused_paged_decode

    def stale(*a, **kw):
        logits, nk, nv, routed = orig(*a, **kw)
        return logits, nk.zero_(), nv.zero_(), routed
    monkeypatch.setattr(engine, "_fused_paged_decode", stale)
    r = _result(tiny.serve_cell())
    assert r["correct"] is False, r["checks"]


def _calibrated(cell, capsys, **kw):
    args = ["--workload", cell["name"]]
    for k, v in kw.items():
        args += [f"--{k.replace('_', '-')}", v]
    calibrate.main(args, device="cpu", cell=cell)
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_serving_control_fails_the_limit(capsys):
    """The control (the reference with float8 products, teacher-forced
    on the program's own served tokens), its first-ranked tokens put in
    the program's place and judged by the run's check and
    ``Outcome.correct`` (the tiny cell's limit, see ``tiny``)."""
    cell = tiny.serve_cell()
    rows = _calibrated(cell, capsys, control_seeds="11,12,13,14",
                       seconds="3")
    assert len(rows) == 4
    for r in rows:
        assert r["correct"] is True, r
        assert r["control"]["correct"] is False, r
