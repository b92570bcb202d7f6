"""serve_continuous: ``repro_torch.serving.engine.ServingEngine`` under a
closed loop of clients, for a fixed window of wall clock.

``ServingEngine.run`` drives a whole trace to its end and fast-forwards
its clock over idle gaps, so neither a window of wall time nor a closed
loop can be expressed through it.  This driver runs the engine's
iteration itself, step for step as ``run`` does (the same calls in the
same order), on the wall clock: the engine's clock is
``time.perf_counter`` and its start and skew are 0 and never move, so
nothing fast-forwards.  The engine's methods it reaches into are listed
in ``PERF.md``.

A client's next request is due when its last one finished.  The
window's metrics take every token emitted in it; a request due in the
window that has no first token by the end of the drain counts as
failed.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import devtrace, gen, harness, weights
from ..costs import kernels as kcost
from ..costs import model as mcost
from ..costs import peaks
from . import Outcome, port_config, sync

DRAIN_S = 60.0


class Rec:
    """One request as the harness saw it."""
    __slots__ = ("rid", "due", "prompt", "times", "done", "req", "client",
                 "prefills")

    def __init__(self, rid, due, prompt, client):
        self.rid, self.due, self.prompt, self.client = rid, due, prompt, client
        self.done: Optional[float] = None
        self.times: List[float] = []
        self.req = None
        self.prefills = 0


class Loop:
    """The engine's iteration on the wall clock, with the load."""

    def __init__(self, eng, mix: Dict, seed: int, trace: bool):
        self.eng, self.trace = eng, trace
        eng.clock = time.perf_counter
        eng._t0 = 0.0
        eng._virtual_skew = 0.0
        self.src = gen.Requests(mix, eng.cfg.vocab,
                                harness.subseed(seed, harness.TRAFFIC))
        self.recs: Dict[int, Rec] = {}
        self.decodes: List[tuple] = []      # (t0, t1, rows)
        self.prefill_spans: List[tuple] = []   # (t0, t1, tokens, rid)
        if mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.accepting = True
        t_open = time.perf_counter()
        self.ready = [(c, t_open) for c in range(mix["clients"])]
        self.finished = 0
        self._hook()

    def _hook(self) -> None:
        m = self.eng.metrics
        on_token, on_finish = m.on_token, m.on_finish

        def token(rid, now):
            self.recs[rid].times.append(now)
            on_token(rid, now)

        def finish(rid, now, preemptions):
            r = self.recs[rid]
            r.done = now
            self.ready.append((r.client, now))
            self.finished += 1
            on_finish(rid, now, preemptions)

        m.on_token, m.on_finish = token, finish

    def _submit(self, due: float, client: int) -> None:
        prompt, new = self.src.next()
        eng = self.eng
        rid = eng.submit(prompt, new, arrival_s=due)
        rec = Rec(rid, due, prompt, client)
        rec.req = eng.sched.waiting[-1]
        self.recs[rid] = rec

    def _offer(self) -> None:
        if not self.accepting:
            return
        ready, self.ready = self.ready, []
        for c, due in ready:
            self._submit(due, c)

    def _prefill(self, req, now) -> None:
        t0 = time.perf_counter()
        n = len(req.prefill_tokens())
        with devtrace.span("prefill", self.trace):
            self.eng._do_prefill(req, now)
        self.recs[req.rid].prefills += 1
        self.prefill_spans.append((t0, time.perf_counter(), n, req.rid))

    def step(self) -> None:
        """One iteration of ``ServingEngine.run``'s loop."""
        eng, sched = self.eng, self.eng.sched
        self._offer()
        now = eng._now()
        for v in sched.preempt_over_budget():
            eng.metrics.on_preempt(v.rid, now)
        for v in sched.preempt_predicted_violation():
            eng.metrics.on_preempt(v.rid, now)
        admitted = sched.admit(now_s=now)
        if not admitted and not sched.running:
            if sched.waiting:
                raise RuntimeError("scheduler stalled: waiting requests "
                                   "cannot be admitted into an empty pool")
            time.sleep(0.001)
            return
        for req in admitted:
            self._prefill(req, now)
        eng._ensure_tail_blocks()
        rows = len(sched.running)
        t0 = time.perf_counter()
        with devtrace.span("decode", self.trace):
            eng._decode_iteration(now)
        if rows:
            self.decodes.append((t0, time.perf_counter(), rows))
        with devtrace.span("engine_epoch", self.trace):
            if eng.sv.migrate_every and eng._step % eng.sv.migrate_every == 0:
                eng.tierer.step([r.rid for r in sched.running], eng._step)
            eng._replan_step()
            eng.metrics.on_iteration(
                eng._step, eng.pool.used_block_count(), eng.pool.fast_used(),
                len(sched.running), len(sched.waiting))
            eng._step += 1

    def run_until(self, cond) -> None:
        while not cond():
            self.step()


# ---------------------------------------------------------------------- #
# kernel calls, recorded in the traced slice                             #
# ---------------------------------------------------------------------- #
class Calls:
    """Wraps ``repro_torch.kernels.ops`` entry points while ``on`` and
    keeps what each call's inputs need: expert ids, kv lengths, shapes."""

    NAMES = ("fused_expert_ffn", "paged_decode_attention", "flash_attention")

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.on = ops, False
        self.expert: List[torch.Tensor] = []
        self.expert_shape = None
        self.paged: List[torch.Tensor] = []
        self.paged_shape = None
        self.flash: List[tuple] = []
        self._orig = {n: getattr(ops, n) for n in self.NAMES}
        ops.fused_expert_ffn = self._expert
        ops.paged_decode_attention = self._paged
        ops.flash_attention = self._flash

    def restore(self) -> None:
        for n, f in self._orig.items():
            setattr(self.ops, n, f)

    def _expert(self, x, w_gate, w_up, w_down, ids, wts):
        if self.on:
            self.expert.append(ids.detach().clone())
            self.expert_shape = (x.shape[0], ids.shape[1], w_gate.shape[1],
                                 w_gate.shape[2])
        return self._orig["fused_expert_ffn"](x, w_gate, w_up, w_down, ids,
                                              wts)

    def _paged(self, q, k_pool, v_pool, tbl, kv_len, k_new, v_new, *,
               block_tokens):
        if self.on:
            self.paged.append(torch.as_tensor(kv_len).detach().clone())
            self.paged_shape = (q.shape[1], k_pool.shape[2], q.shape[2],
                                block_tokens)
        return self._orig["paged_decode_attention"](
            q, k_pool, v_pool, tbl, kv_len, k_new, v_new,
            block_tokens=block_tokens)

    def _flash(self, q, k, v, *, causal=True):
        if self.on:
            self.flash.append((q.shape[0], q.shape[1], k.shape[1],
                               q.shape[2], k.shape[2], q.shape[3], causal))
        return self._orig["flash_attention"](q, k, v, causal=causal)

    def bounds(self) -> Dict[str, float]:
        """Each kernel's summed roofline bound (s) over the calls."""
        out: Dict[str, float] = {}
        if self.expert:
            B, K, D, F = self.expert_shape
            ids = torch.stack(self.expert).reshape(len(self.expert), -1)
            s = ids.sort(dim=1).values
            distinct = (1 + (s[:, 1:] != s[:, :-1]).sum(1)).tolist()
            out["fused_expert_ffn"] = sum(
                peaks.bound_s(*kcost.fused_expert_ffn(n, B, K, D, F))
                for n in distinct)
        if self.paged:
            H, KV, hd, bt = self.paged_shape
            lens = torch.stack(self.paged).cpu().numpy()
            out["paged_decode_attention"] = sum(
                peaks.bound_s(*kcost.paged_decode_attention(r, bt, H, KV, hd))
                for r in lens)
        if self.flash:
            out["flash_attention"] = sum(
                peaks.bound_s(*kcost.flash_attention(*c)) for c in self.flash)
        return out


# ---------------------------------------------------------------------- #
def _engine(cfg, conf: Dict, params, device):
    from repro_torch.serving.engine import ServingConfig, ServingEngine
    s = conf["serving"]
    sv = ServingConfig(block_tokens=s["block_tokens"],
                       max_batch=s["max_batch"],
                       max_context=s["max_context"],
                       num_blocks=s["num_blocks"],
                       fused_gather=conf["path"] == "fused_gather")
    return ServingEngine(cfg, params, sv, device=device)


def _prime(eng, mix: Dict, seed: int) -> None:
    """Before the load starts: one request with the mix's longest prompt
    through prefill and a decode step, so that the kernels are built and
    loaded and the largest prefill has run once."""
    rng = np.random.default_rng(harness.subseed(seed, harness.TRAFFIC, 2))
    eng.submit(rng.integers(0, eng.cfg.vocab, mix["prompt"]["max"],
                            dtype=np.int64).astype(np.int32), 2)
    eng.run()


def _window_stats(loop: Loop, t0: float, t1: float) -> Dict[str, Any]:
    """Tokens emitted in [t0, t1], every gap ending there, and the
    requests due in the window."""
    toks, gaps = 0, []
    for r in loop.recs.values():
        ts = r.times
        for i, t in enumerate(ts):
            if t0 <= t <= t1:
                toks += 1
                if i:
                    gaps.append(t - ts[i - 1])
    due = [r for r in loop.recs.values() if t0 <= r.due < t1]
    return {"tokens": toks, "gaps": gaps, "due": due}


def ctx_decodes(loop: Loop, t0: float, t1: float) -> List[tuple]:
    return [d for d in loop.decodes if t0 <= d[0] and d[1] <= t1]


def _model_flops(loop: Loop, m: Dict, t0: float, t1: float) -> float:
    """Model FLOPs of the prefills that ended and the tokens decoded in
    the window."""
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
    return mcost.serve_flops(m, tokens, ctx, rows)


def _sample(loop: Loop, t1: float, want_tokens: int, seed: int) -> List[Rec]:
    """Requests finished by the window's end, drawn from the seed, the
    one with the most served tokens first, until ``want_tokens`` served
    tokens; a request that was prefilled twice (preempted) is left out."""
    done = [r for r in loop.recs.values()
            if r.done is not None and r.done <= t1 and r.prefills == 1]
    if not done:
        return []
    done.sort(key=lambda r: r.rid)
    longest = max(done, key=lambda r: (len(r.req.out_tokens), -r.rid))
    rng = np.random.default_rng(harness.subseed(seed, harness.SAMPLE))
    out, n = [longest], len(longest.req.out_tokens)
    for i in rng.permutation(len(done)):
        if n >= want_tokens:
            break
        r = done[i]
        if r is not longest:
            out.append(r)
            n += len(r.req.out_tokens)
    return out


def sequences(sample: List[Rec], device):
    """(prompt and served tokens but the last, served tokens) of each
    sampled request, on the device."""
    seqs, served = [], []
    for r in sample:
        out = np.asarray(r.req.out_tokens, np.int64)
        seqs.append(torch.as_tensor(np.concatenate(
            [r.prompt.astype(np.int64), out[:-1]]), device=device))
        served.append(torch.as_tensor(out, device=device))
    return seqs, served


def check(w, m: Dict, sample: List[Rec], limit: float,
          served: Optional[List[torch.Tensor]] = None) -> Dict:
    """The reference over each sampled prompt with its served tokens,
    and the number compared: the mean over the served positions of the
    gap by which the served token's logit lies below the reference's
    best.  (The widest such gap is logged: bf16 routing near ties make
    it swing as far as the float8 control's, see PERF.md.)  ``served``:
    other tokens judged at the same positions in the program's place
    (the control's, from ``perfbench/calibrate.py``)."""
    from ..reference import qwen3_moe as ref
    from ..reference.plain import strict_fp32
    strict_fp32()
    seqs, own = sequences(sample, w["embed"].device)
    with torch.no_grad():
        g = ref.gaps(ref.served_logits(w, m, seqs,
                                       [len(r.prompt) for r in sample]),
                     own if served is None else served)
    harness.log(f"served logit gaps over {g.numel()} tokens: widest "
                f"{float(g.max())!r}, nonzero {int((g > 0).sum())}")
    return {"served_logit_gap_mean": {"value": float(g.mean()),
                                      "limit": limit}}


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", keep: Optional[Dict] = None) -> Outcome:
    """``keep``: a dict that receives the weights and the checked sample
    (for ``perfbench/calibrate.py``)."""
    conf, mix = cell["config"], cell["traffic"]
    m = conf["model"]
    cfg = port_config(conf)
    w = weights.make(m, harness.subseed(seed, harness.WEIGHTS), device)
    eng = _engine(cfg, conf, w, device)
    _prime(eng, mix, seed)
    harness.log(f"weights and engine: {time.perf_counter() - t_start:.2f} s, "
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
    # the traced slice follows the window at the same load, so that the
    # profiler's cost falls on no metric of the window
    calls, sl = None, None
    if trace:
        calls = Calls()
        calls.on = True
        with devtrace.Slice(device) as sl:
            for _ in range(mix["trace"]["iterations"]):
                loop.step()
        calls.on = False
    # drain: every request due in the window gets its first token; the
    # clients send no more
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
                f"{harness.memory(device)}")
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
           "bounds": calls.bounds() if calls else {}}
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
