"""serve_hybrid: ``serve_continuous``'s closed loop of clients over a
hybrid Mamba-2 / attention model with routed and shared experts
(granite-4.0-h-small), served by ``repro_torch.serving.engine.
ServingEngine`` on the fused paged path with per-request state slots.

The loop, the engine's priming, the window's statistics, the checked
sample and the traced kernel calls are ``serve_continuous``'s; this
driver swaps in the hybrid's weights (``weights_hybrid``), its plain
reference (``reference/granite_hybrid.py``), its model FLOPs and the
decode state update's bound (``costs/hybrid.py``), and registers that
kernel's CUDA function for the trace summary.  In a traced run it also
turns the engine's spans on, and reads the Mamba layers' enqueue per
decode step from them (``mamba_enqueue_ms``).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from .. import devtrace, harness, weights_hybrid
from ..costs import hybrid as hcost
from ..costs import peaks
from . import Outcome, port_config, sync
from .serve_continuous import (_prime, _sample, _window_stats, Calls,
                               ctx_decodes, DRAIN_S, Loop, sequences)

devtrace.KERNELS.setdefault("ssm_state_update", ("ssm_state_update_kernel",))
MAMBA_SPAN = "engine.decode.mamba"


class HybridCalls(Calls):
    """``Calls`` with the Mamba-2 decode state update recorded too."""

    NAMES = Calls.NAMES + ("ssm_state_update",)

    def __init__(self):
        super().__init__()
        self.ssm: List[tuple] = []
        self.ops.ssm_state_update = self._ssm

    def _ssm(self, state, slots, x, Bm, Cm, dt, A, D):
        if self.on:
            _, H, N, P = state.shape
            self.ssm.append((x.shape[0], H, N, P, Bm.shape[1] // N))
        return self._orig["ssm_state_update"](state, slots, x, Bm, Cm, dt,
                                              A, D)

    def bounds(self) -> Dict[str, float]:
        out = super().bounds()
        if self.ssm:
            out["ssm_state_update"] = sum(
                peaks.bound_s(*hcost.ssm_state_update(*c)) for c in self.ssm)
        return out


def _engine(cfg, conf: Dict, params, device, spans: bool):
    from repro_torch.serving.engine import ServingConfig, ServingEngine
    s = conf["serving"]
    sv = ServingConfig(block_tokens=s["block_tokens"],
                       max_batch=s["max_batch"],
                       max_context=s["max_context"],
                       num_blocks=s["num_blocks"],
                       fused_gather=conf["path"] == "fused_gather",
                       trace_spans=spans)
    return ServingEngine(cfg, params, sv, device=device)


def _check_pattern(cfg, m: Dict) -> None:
    """The port's layer pattern puts attention where the file says."""
    per = len(cfg.pattern)
    at = {u * per + i for u in range(cfg.n_units)
          for i in cfg.unit_attn_layers}
    if per != m["period"] or at != set(m["attn_layers"]):
        raise ValueError(f"{cfg.name}: the port's attention layers {sorted(at)}"
                         f" (period {per}) are not the file's "
                         f"{m['attn_layers']} (period {m['period']})")


def mamba_enqueue_ms(tracer, t0: float, t1: float) -> Optional[float]:
    """Mean over the decode steps inside [t0, t1] of their summed
    ``engine.decode.mamba`` spans, in ms; None without spans, or where
    the ring dropped spans of the window."""
    spans = list(tracer.spans)
    if not spans or (tracer.spans_dropped and spans[0].ts_s > t0):
        return None
    parent = {s.id: s.parent for s in spans}
    steps = {s.id: 0.0 for s in spans if s.name == "engine.decode"
             and t0 <= s.ts_s and s.ts_s + s.dur_s <= t1}
    for s in spans:
        if s.name != MAMBA_SPAN:
            continue
        p = s.parent
        while p is not None and p not in steps:
            p = parent.get(p)
        if p is not None:
            steps[p] += s.dur_s
    return 1e3 * sum(steps.values()) / len(steps) if steps else None


def _model_flops(loop: Loop, m: Dict, t0: float, t1: float) -> float:
    """Model FLOPs of the prefills that ended and the tokens decoded in
    the window (``serve_continuous._model_flops``, hybrid costs)."""
    tokens = ctx = rows = 0
    for s, e, n, rid in loop.prefill_spans:
        if t0 <= e <= t1:
            tokens += n
            ctx += n * (n + 1) // 2
            rows += 1
    for r in loop.recs.values():
        P = len(r.prompt)
        for j, t in enumerate(r.times):
            if j and t0 <= t <= t1:
                tokens += 1
                ctx += P + j
                rows += 1
    return hcost.serve_flops(m, tokens, ctx, rows)


def check(w, m: Dict, sample, limit: float,
          served: Optional[List[torch.Tensor]] = None) -> Dict:
    """``serve_continuous.check`` against the hybrid's plain reference:
    the mean gap by which each served token's reference logit lies
    below the reference's best; ``served``: other tokens judged in the
    program's place (the control's)."""
    from ..reference import granite_hybrid as ref
    from ..reference.plain import strict_fp32
    strict_fp32()
    seqs, own = sequences(sample, w["embed"].device)
    with torch.no_grad():
        g = ref.gaps(ref.served_logits(w, m, seqs,
                                       [len(r.prompt) for r in sample]),
                     own if served is None else served)
    own_cat = torch.cat(own)
    repeats = int((own_cat == torch.cat([s[-n:] for s, n in zip(
        seqs, (len(o) for o in own))])).sum())
    harness.log(f"served logit gaps over {g.numel()} tokens: widest "
                f"{float(g.max())!r}, nonzero {int((g > 0).sum())}; "
                f"served tokens equal to their input token {repeats}")
    return {"served_logit_gap_mean": {"value": float(g.mean()),
                                      "limit": limit}}


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", keep: Optional[Dict] = None) -> Outcome:
    """``serve_continuous.run`` for the hybrid; ``keep`` as there."""
    conf, mix = cell["config"], cell["traffic"]
    m = conf["model"]
    cfg = port_config(conf)
    _check_pattern(cfg, m)
    w = weights_hybrid.make(m, harness.subseed(seed, harness.WEIGHTS), device)
    eng = _engine(cfg, conf, w, device, spans=trace)
    _prime(eng, mix, seed)
    harness.log(f"weights and engine: {time.perf_counter() - t_start:.2f} s, "
                f"state slots {eng.states.nbytes / 2**30:.2f} GiB, "
                f"{harness.memory(device)}")
    if trace:
        devtrace.prewarm(device)
    loop = Loop(eng, mix, seed, trace)
    loop.run_until(lambda: loop.finished >= mix["warmup"]["requests"])
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    waiting0 = len(eng.sched.waiting)
    harness.log(f"warm-up: {len(loop.recs)} requests, {eng._step} "
                f"iterations, set-up {setup_s:.2f} s, {harness.memory(device)}")
    while time.perf_counter() < t0 + seconds:
        loop.step()
    t1 = time.perf_counter()
    waiting1 = len(eng.sched.waiting)
    calls, sl = None, None
    if trace:
        calls = HybridCalls()
        calls.on = True
        with devtrace.Slice(device) as sl:
            for _ in range(mix["trace"]["iterations"]):
                loop.step()
        calls.on = False
    loop.accepting = False
    pending = lambda: [r for r in loop.recs.values()  # noqa: E731
                       if t0 <= r.due < t1 and not r.times]
    t_drain = time.perf_counter() + DRAIN_S
    while pending() and time.perf_counter() < t_drain:
        loop.step()
    sync(device)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    st = _window_stats(loop, t0, t1)
    harness.log(f"window: {t1 - t0:.2f} s, {len(ctx_decodes(loop, t0, t1))} "
                f"decode steps, {st['tokens']} tokens, {len(st['due'])} "
                f"requests due, waiting {waiting0} -> {waiting1} "
                f"(+{len(eng.sched.waiting)} after the drain), preemptions "
                f"{sum(r.prefills > 1 for r in loop.recs.values())}, "
                f"state slots freed by preemption "
                f"{eng.states.preempted_slots}, {harness.memory(device)}")
    failed = sum(1 for r in st["due"] if not r.times)
    e2e = {"setup_s": setup_s, "output_tok_s": st["tokens"] / (t1 - t0)}
    p95_gap = harness.percentile(st["gaps"], 95)
    harness.log(f"window: output {e2e['output_tok_s']!r} tokens/s, p95 "
                f"decode gap {p95_gap!r} s")
    ctx = {"window_s": t1 - t0, "decodes": ctx_decodes(loop, t0, t1),
           "p95_decode_gap_s": p95_gap,
           "prefills": [p for p in loop.prefill_spans
                        if t0 <= p[0] and p[1] <= t1],
           "flops": _model_flops(loop, m, t0, t1),
           "bounds": calls.bounds() if calls else {},
           "mamba_enqueue_ms": (mamba_enqueue_ms(eng.tracer, t0, t1)
                                if trace else None)}
    if calls is not None:
        calls.restore()
    sample = _sample(loop, t1, mix["check"]["served_tokens"], seed)
    ctx["sample"] = [(len(r.prompt), len(r.req.out_tokens)) for r in sample]
    del eng, loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = (check(w, m, sample, mix["check"]["served_logit_gap_mean"])
              if sample else {})
    harness.log(f"check: {len(sample)} requests, "
                f"{sum(n for _, n in ctx['sample'])} served tokens, "
                f"{time.perf_counter() - t_ref:.2f} s, {harness.memory(device)}")
    if keep is not None:
        keep.update(w=w, sample=sample)
    return Outcome(e2e=e2e, ctx=ctx, attempted=len(st["due"]), failed=failed,
                   checks=checks, memory_peak_bytes=int(peak),
                   trace=sl.finish() if sl is not None else None)
