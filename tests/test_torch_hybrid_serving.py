"""granite-4.0-h-small (Mamba-2 and attention layers, routed and shared
experts) on the port's continuous-batching engine, at a small size on
the CPU: the engine's prefill and fused paged decode over per-request
state slots against the benchmark's plain fp32 reference
(``perfbench/reference/granite_hybrid.py``), the decode state update's
plain version against a step of the recurrence, the reference's
quadratic SSD against the same recurrence, the slot pool through
finish, preemption and reuse, and the new config fields left off."""
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from perfbench import weights_hybrid  # noqa: E402
from perfbench.drivers import port_config  # noqa: E402
from perfbench.reference import granite_hybrid  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import modules as M  # noqa: E402
from repro_torch.serving import ServingConfig, ServingEngine  # noqa: E402
from repro_torch.serving.engine import check_paged_support  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-4.0-h-small"
# two periods of the published pattern at small widths; all 8 experts
# taken (top-8 of 8, capacity above every bucket): at top-2 a bf16
# routing near tie moves a token's whole expert path, and with it every
# later position, so the comparison would read near ties, not rounding
SMALL = {"n_layers": 20, "d_model": 128, "n_heads": 4, "n_kv": 2,
         "head_dim": 32, "d_ff": 64, "n_experts": 8, "top_k": 8,
         "vocab": 512, "moe_groups": 4, "mamba_head_dim": 32,
         "mamba_d_state": 16, "ssd_chunk": 16, "shared_expert_ff": 64,
         "attn_layers": [5, 15]}
# Each logit row's largest error over the vocabulary, as a share of the
# reference's largest logit.  bf16 rounding of the program (activations,
# weights read in bf16, the bf16 K/V and conv state) reads a median of
# 0.020-0.030 and a largest row of 0.033-0.047 (weight seeds 7-9, two
# prompt sets each); the limits leave 2x room.  The reference with
# float8 products (the control) reads a median of 0.20-0.26 and no row
# under 0.11, a decode whose state update is never written back a
# median of 0.28-0.49: both fail the median's limit twice over.
MEDIAN_ROW_TOL = 0.06
MAX_ROW_TOL = 0.1


def _model(**over):
    conf = json.loads((ROOT / "perfbench/configs/granite-4.0-h-small.json")
                      .read_text())
    conf["model"].update(SMALL, **over)
    return conf, port_config(conf)


def _weights(m, seed):
    """The benchmark's weight maker, with the recurrence made to matter:
    slow decays (A in [-1, -0.3]) and steps dt in [0.05, 0.3], so that a
    decode that loses its state reads far off."""
    w = weights_hybrid.make(m, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for lp in w["units"]["layers"]:
        if "mamba" in lp:
            mp = lp["mamba"]
            shape = mp["A_log"].shape
            mp["A_log"] = torch.log(torch.empty(shape).uniform_(
                0.3, 1.0, generator=g))
            dt = torch.empty(shape).uniform_(0.05, 0.3, generator=g)
            mp["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    return w


@pytest.fixture(scope="module")
def small():
    conf, cfg = _model()
    return conf["model"], cfg, _weights(conf["model"], 7)


def _serving(max_batch=4, num_blocks=64, **kw):
    return ServingConfig(block_tokens=16, max_batch=max_batch,
                         max_context=96, num_blocks=num_blocks,
                         fused_gather=True, **kw)


class Recorded:
    """An engine whose prefill and fused decode logits are kept per
    request, row by row (row j predicts served token j)."""

    def __init__(self, cfg, w, sv):
        self.eng = eng = ServingEngine(cfg, w, sv, device="cpu")
        self.rows = {}
        prefill, do, decode = (eng._prefill, eng._do_prefill,
                               eng._fused_decode_batch)

        def step(params, batch, units=None):
            logits, cache = prefill(params, batch, units=units)
            self._last = logits
            return logits, cache

        def do_prefill(req, now):
            self._last = None
            do(req, now)
            if self._last is not None:
                self.rows.setdefault(req.rid, []).append(self._last[0])

        def fused(batch):
            out = decode(batch)
            for i, r in enumerate(batch):
                self.rows.setdefault(r.rid, []).append(out[0][i])
            return out
        eng._prefill, eng._do_prefill = step, do_prefill
        eng._fused_decode_batch = fused

    def run(self, prompts, n_new):
        for p in prompts:
            self.eng.submit(p, n_new)
        self.eng.run()
        return {r.rid: r for r in self.eng.sched.finished}


def _prompts(seed=0, lens=(13, 40, 27)):
    g = np.random.default_rng(seed)
    return [g.integers(0, 512, n).astype(np.int32) for n in lens]


def _reference(w, m, req, fp8=False):
    seq = torch.as_tensor(np.concatenate(
        [req.prompt, np.asarray(req.out_tokens[:-1], np.int32)])).long()
    return granite_hybrid.served_logits(w, m, [seq], [len(req.prompt)],
                                        fp8=fp8)[0]


def _row_errors(pairs):
    """Each row's largest error, over the largest reference logit."""
    scale = max(float(r.abs().max()) for r, _ in pairs)
    return torch.cat([(got - r).abs().max(-1).values
                      for r, got in pairs]) / scale


def _served(small, prompts=None, n_new=10, **sv):
    m, cfg, w = small
    rec = Recorded(cfg, w, _serving(**sv))
    reqs = rec.run(prompts or _prompts(), n_new)
    return rec, reqs


def test_engine_prefill_and_slot_decode_follow_reference(small):
    """Prefill, then paged attention and slot-state decode, through the
    engine: every served logit row against the reference's full forward
    pass over the prompt and the served tokens (``MEDIAN_ROW_TOL``)."""
    m, _, w = small
    rec, reqs = _served(small)
    assert len(reqs) == 3
    pairs = []
    for rid, req in reqs.items():
        got = torch.stack(rec.rows[rid])
        assert got.shape[0] == len(req.out_tokens) == 10
        pairs.append((_reference(w, m, req), got))
    err = _row_errors(pairs)
    assert err.median() < MEDIAN_ROW_TOL and err.max() < MAX_ROW_TOL, err
    assert rec.eng.states.in_use() == 0


def test_float8_control_fails_the_limit(small):
    """The reference with float8 products, against the fp32 reference on
    the program's own served sequences, lies past the limit."""
    m, _, w = small
    _, reqs = _served(small)
    err = _row_errors([(_reference(w, m, r), _reference(w, m, r, fp8=True))
                       for r in reqs.values()])
    assert err.median() > 2 * MEDIAN_ROW_TOL, err


def test_a_state_update_never_written_back_fails(small, monkeypatch):
    """Each decode step's state update made on a copy: the slots keep
    the prefill's states, and the served logits leave the limit."""
    m, _, w = small
    orig = ops.ssm_state_update
    monkeypatch.setattr(ops, "ssm_state_update",
                        lambda state, *a: orig(state.clone(), *a))
    rec, reqs = _served(small)
    err = _row_errors([(_reference(w, m, r), torch.stack(rec.rows[rid]))
                       for rid, r in reqs.items()])
    assert err.median() > 2 * MEDIAN_ROW_TOL, err


def _recurrence(state, slots, x, Bm, Cm, dt, A, D):
    """The Mamba-2 recurrence element by element, in float64: for each
    row b and head h, s[n, p] <- exp(dt A) s[n, p] + dt B[n] x[p] and
    y[p] = sum_n C[n] s[n, p] + D x[p]."""
    st = state.double().clone()
    _, H, N, P = st.shape
    G = Bm.shape[1] // N
    y = torch.zeros(x.shape[0], H, P, dtype=torch.float64)
    for b in range(x.shape[0]):
        s = int(slots[b])
        for h in range(H):
            g = h // (H // G)
            xb = x[b, h * P:(h + 1) * P].double()
            Bn = Bm[b, g * N:(g + 1) * N].double()
            Cn = Cm[b, g * N:(g + 1) * N].double()
            a = math.exp(float(dt[b, h]) * float(A[h]))
            st[s, h] = a * st[s, h] + float(dt[b, h]) * Bn[:, None] * xb
            y[b, h] = (Cn[:, None] * st[s, h]).sum(0) + float(D[h]) * xb
    return st, y


@pytest.mark.parametrize("G", [1, 2])
def test_ssm_state_update_plain_version_is_a_step_of_the_recurrence(G):
    """Rows in permuted slots (one left untouched), the conv output's
    column slices as x, B and C, heads reading their group's B and C."""
    g = torch.Generator().manual_seed(3)
    n_slots, H, N, P, B = 5, 4, 8, 16, 3
    state = torch.randn(n_slots, H, N, P, generator=g)
    xbc = torch.randn(B, H * P + 2 * G * N, generator=g).bfloat16()
    x, Bm, Cm = xbc[:, :H * P], xbc[:, H * P:H * P + G * N], \
        xbc[:, H * P + G * N:]
    dt = torch.rand(B, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4
    D = torch.randn(H, generator=g)
    slots = torch.tensor([3, 0, 4], dtype=torch.int32)
    want_state, want_y = _recurrence(state, slots, x, Bm, Cm, dt, A, D)
    got_y = ref.ssm_state_update(state, slots, x, Bm, Cm, dt, A, D)
    torch.testing.assert_close(got_y.double(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state.double(), want_state, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(state[1], want_state[1].float())   # untouched


def test_reference_quadratic_ssd_matches_token_recurrence():
    """The reference's masked quadratic form, blocked over queries, is the
    recurrence run token by token (two groups, ragged last block, a
    long decay sum)."""
    g = torch.Generator().manual_seed(5)
    S, H, P, G, N = 45, 4, 8, 2, 6
    x = torch.randn(S, H, P, generator=g)
    dt = torch.rand(S, H, generator=g) * 0.4 + 0.01
    A = -torch.rand(H, generator=g) * 3
    Bm = torch.randn(S, G, N, generator=g)
    Cm = torch.randn(S, G, N, generator=g)
    got = granite_hybrid.ssd_quadratic(x, dt, A, Bm, Cm, block=16)
    state = torch.zeros(1, H, N, P)
    want = []
    for t in range(S):
        _, y = _recurrence(state, torch.zeros(1, dtype=torch.int32),
                           x[t].reshape(1, H * P), Bm[t].reshape(1, G * N),
                           Cm[t].reshape(1, G * N), dt[t:t + 1], A,
                           torch.zeros(H))
        state, _ = _recurrence(state, torch.zeros(1, dtype=torch.int32),
                               x[t].reshape(1, H * P),
                               Bm[t].reshape(1, G * N),
                               Cm[t].reshape(1, G * N), dt[t:t + 1], A,
                               torch.zeros(H))
        state = state.float()
        want.append(y[0])
    torch.testing.assert_close(got, torch.stack(want).float(), rtol=1e-4,
                               atol=1e-5)


def test_port_scan_and_slot_step_agree():
    """The port's whole-sequence Mamba-2 (grouped chunked scan) and its
    decode step over slots give the same outputs and final states, in
    fp32, from a split point on."""
    dims = M.mamba_dims(64, 2, 16, 8, 4, 8, groups=2)
    g = torch.Generator().manual_seed(1)
    p = lm.tree_map(lambda t: t.float(), M.init_mamba2(dims, g, "cpu"))
    p["dt_bias"] = torch.randn(dims.n_heads, generator=g) * 0.5 - 1.5
    p["conv_b"] = torch.randn(dims.conv_dim, generator=g) * 0.1
    x = torch.randn(2, 19, 64, generator=g)
    whole, (_, ss) = M.mamba2_fwd(p, x, dims)
    conv = torch.zeros(3, dims.d_conv - 1, dims.conv_dim)
    ssm = torch.zeros(3, dims.n_heads, dims.d_state, dims.head_dim)
    slots = torch.tensor([2, 0], dtype=torch.int32)
    steps = torch.cat([M.mamba2_step(p, x[:, t:t + 1], dims, conv, ssm,
                                     slots) for t in range(19)], 1)
    torch.testing.assert_close(steps, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ssm[slots.long()], ss, rtol=1e-5, atol=1e-6)
    assert not ssm[1].any()


def test_preemption_frees_the_slot_and_resume_gives_the_same_logits(small):
    """A request preempted mid-decode frees its slot, recomputes from a
    prefill into a fresh slot, and serves the logits of a run without
    preemption: bit for bit up to the preemption, within the limit from
    the recomputed prefill on (the chunked scan in place of the decode
    steps).  The other requests' logits are the unpreempted run's."""
    m, cfg, w = small
    base_rec, base = _served(small)
    rec = Recorded(cfg, w, _serving())
    eng = rec.eng
    for p in _prompts():
        eng.submit(p, 10)
    victim = None
    for _ in range(40):
        if not eng.sched.active:
            break
        now = eng._now()
        for req in eng.sched.admit(now_s=now):
            eng._do_prefill(req, now)
        eng._ensure_tail_blocks()
        eng._decode_iteration(now)
        eng._step += 1
        if victim is None and eng._step == 4:
            victim = eng.sched.running[-1]
            k = len(rec.rows[victim.rid])
            held = eng.states.in_use()
            eng.sched._evict(victim)
            assert eng.states.in_use() == held - 1
            assert eng.states.preempted_slots == 1
            assert victim.rid not in eng.states.slot
    done = {r.rid: r for r in eng.sched.finished}
    assert victim.preemptions == 1 and len(done) == 3
    assert eng.states.in_use() == 0
    assert eng.registry.counter("serving.state.preempted_slots").value == 1
    for rid, req in done.items():
        got = torch.stack(rec.rows[rid])
        want = torch.stack(base_rec.rows[rid])
        if rid != victim.rid:
            assert req.out_tokens == base[rid].out_tokens
            assert torch.equal(got, want)
            continue
        # the victim's k rows before its preemption, then the recompute's
        # prefill row and the decode rows after it
        assert req.out_tokens[:k] == base[rid].out_tokens[:k]
        assert torch.equal(got[:k], want[:k]) and len(got) == 10
        err = _row_errors([(_reference(w, m, req), got)])
        assert err[k:].max() < MAX_ROW_TOL, err


def test_a_reused_slot_serves_like_a_fresh_engine(small):
    """One slot, two requests in turn: the second prefill overwrites the
    first request's states, so its logits equal a fresh engine's."""
    _, cfg, w = small
    a, b = _prompts(1, (21, 30))
    rec, reqs = _served(small, [a, b], 6, max_batch=1)
    fresh, fresh_reqs = _served(small, [b], 6, max_batch=1)
    assert rec.eng.states.n_slots == 1
    assert torch.equal(torch.stack(rec.rows[1]), torch.stack(fresh.rows[0]))
    assert reqs[1].out_tokens == fresh_reqs[0].out_tokens


def test_spans_and_counters_of_the_state_slots(small):
    """``engine.decode.mamba`` once per Mamba layer and decode step,
    ``engine.prefill.state`` once per prefill; the slot counters in the
    tracer and the registry."""
    m, cfg, w = small
    rec, reqs = _served(small, n_new=4, trace_spans=True)
    eng = rec.eng
    spans = list(eng.tracer.spans)
    steps = [s for s in spans if s.name == "engine.decode"]
    mamba = [s for s in spans if s.name == "engine.decode.mamba"]
    n_mamba = cfg.n_units * len(cfg.unit_mamba_layers)
    assert len(mamba) == n_mamba * len(steps) and steps
    assert sum(s.name == "engine.prefill.state" for s in spans) == 3
    names = {e.name for e in eng.tracer.events if e.ph == "C"}
    assert {"state.slots_in_use", "state.bytes_in_use",
            "state.preempted_slots"} <= names
    snap = eng.registry.snapshot()
    assert snap["serving.state.slots_in_use"] == 0
    assert snap["serving.state.bytes_allocated"] == eng.states.nbytes
    peak = max(e.args["value"] for e in eng.tracer.events
               if e.name == "state.slots_in_use")
    assert 1 <= peak <= 3


def test_contiguous_decode_step_follows_prefill():
    """``lm.decode_step`` (the slot form over a contiguous cache's rows)
    continues ``lm.prefill`` as a longer prefill does."""
    cfg = get_smoke_config(ARCH)
    p = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(0))
    _, cache = lm.prefill(p, cfg, toks)
    buf = lm.make_decode_cache(cfg, 2, 32, device="cpu")
    buf["conv"].copy_(cache["conv"])
    buf["ssm"].copy_(cache["ssm"])
    buf["kv_k"][:, :, :, :21] = cache["kv_k"]
    buf["kv_v"][:, :, :, :21] = cache["kv_v"]
    buf["index"] = 21
    nxt = torch.tensor([[5], [9]])
    step, buf = lm.decode_step(p, cfg, buf, nxt)
    whole, _ = lm.prefill(p, cfg, torch.cat([toks, nxt], 1))
    torch.testing.assert_close(step, whole, rtol=0, atol=2e-3)
    assert buf["index"] == 22


def test_paged_support_and_state_budget():
    """Mamba-2 layers serve on the fused path only; the slots count
    against a device budget at construction."""
    cfg = get_smoke_config(ARCH)
    check_paged_support(cfg, fused=True)
    with pytest.raises(ValueError, match="fused paged path"):
        check_paged_support(cfg)
    with pytest.raises(ValueError, match="fused paged path"):
        ServingEngine(cfg, None, ServingConfig(), device="cpu")
    weights = 2 * cfg.param_count()
    with pytest.raises(ValueError, match="state slots"):
        ServingEngine(cfg, None, _serving(
            device_budget_bytes=weights + 1000), device="cpu")
    eng = ServingEngine(cfg, None, _serving(
        device_budget_bytes=4 * weights), device="cpu")
    assert eng.states.n_slots == eng.max_batch
    # the simplified SSD block (jamba) stays refused in the reference's
    # words, on either path
    for fused in (False, True):
        with pytest.raises(ValueError, match="FlexGenEngine"):
            check_paged_support(get_smoke_config("jamba-1.5-large-398b"),
                                fused=fused)


def test_the_padded_rows_slot_counts_in_the_state_budget():
    """The slot pool holds ``max_batch`` slots and the padded rows' one:
    a budget with room for the weights and ``max_batch`` slots only
    raises at construction (not later, in the pool's allocation), and
    the admission plan leaves room for every slot the pool allocates
    beside the KV blocks it puts on the device."""
    from repro_torch.serving.kv_pool import spec_from_config
    from repro_torch.serving.scheduler import plan_admission
    from repro_torch.serving.state_pool import pool_nbytes, slot_nbytes
    cfg = get_smoke_config(ARCH)
    weights, slot = 2 * cfg.param_count(), slot_nbytes(cfg)
    with pytest.raises(ValueError, match="2 state slots"):
        ServingEngine(cfg, None, _serving(
            max_batch=1, device_budget_bytes=weights + slot), device="cpu")
    eng = ServingEngine(cfg, None, _serving(
        max_batch=1, device_budget_bytes=weights + 2 * slot), device="cpu")
    assert eng.states.nbytes == pool_nbytes(cfg, 1) == 2 * slot
    # weights, 4 slots and 4 sequences' KV blocks of 96 tokens: the
    # padded rows' slot leaves room for fewer rows
    block = spec_from_config(cfg, 16).nbytes
    budget = weights + 4 * slot + 4 * 6 * block
    plan = plan_admission(cfg, 16, 96, budget, 0, max_batch_cap=4,
                          state_bytes_per_seq=slot)
    assert (weights + pool_nbytes(cfg, plan.max_batch)
            + plan.fast_blocks * block) <= budget


def test_new_fields_off_leave_the_other_models_as_they_were():
    """Every reference architecture keeps the new fields at their
    defaults and the reference's parameter count; with the fields off a
    Mamba layer is the reference's SSD block (``mamba_fwd``), bit for
    bit; granite's counts are the published 32B total, ~9B active."""
    from repro.configs import get_config as jget
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert (cfg.mamba_groups, cfg.shared_expert_ff,
                cfg.embedding_multiplier, cfg.residual_multiplier,
                cfg.logits_scaling, cfg.attention_multiplier,
                cfg.norm_eps) == (0, 0, 1.0, 1.0, 1.0, 0.0, 0.0)
        assert cfg.param_count() == jget(arch).param_count()
        assert cfg.active_param_count() == jget(arch).active_param_count()
    jamba = get_smoke_config("jamba-1.5-large-398b")
    p = lm.init_params(jamba, seed=0, device="cpu")
    mp = lm.unit_views(p, jamba)[0]["layers"][0]["mamba"]
    x = torch.randn(1, 9, jamba.d_model).bfloat16()
    got, (cs, ss) = lm.mamba_mixer(jamba, mp, x)
    want, (cs2, ss2) = M.mamba_fwd(mp, x, lm._mdims(jamba))
    assert torch.equal(got, want) and torch.equal(ss, ss2)
    g = get_config(ARCH)
    assert round(g.param_count() / 1e9, 1) == 32.2
    assert 8.5e9 < g.active_param_count() < 9.5e9


def test_serve_cli_continuous_granite(capsys):
    """``launch/serve.py --scheduler continuous --arch granite-4.0-h-small``
    (smoke, fused path) serves every request."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--scheduler", "continuous",
                "--fused-gather", "--device", "cpu", "--num-requests", "3",
                "--new-tokens", "4", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert "requests=3 finished=3" in out
