#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py             # every phase (needs one GPU)
    python3 chip_smoke.py --profile   # plus a torch.profiler breakdown

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``), build the
   CUDA kernels from ``src/repro_torch/csrc`` and print the build time;
2. kernels: each kernel against its plain PyTorch version on the card,
   at llama3-8b serving shapes, over ragged lengths (0, 15, 16, 17 and
   long), shared pool blocks and a ragged prefill length.  Inputs are
   bf16 with q and k of std ``QK_STD``, so the softmax is peaked and
   the outputs are O(1); the tolerance is ``ATOL`` absolute plus
   ``RTOL`` relative (at least two bf16 units in the last place), so a kernel
   that drops one tile of keys or mis-scales its running sums fails.
   Each kernel, its plain version and one PyTorch library call of the
   same function are timed with CUDA events, each call after a write
   that evicts the L2 (the regime of the bytes bound);
3. small reference: a small dense model with head_dim 128, served on
   the card (kernels) and on the CPU (plain versions) from the same
   weights — the greedy tokens must agree, up to near ties;
4. serve, staged: llama3-8b at full width and depth, random weights from
   a seeded generator on the card; 8 requests (prompts of 512 and 256
   tokens, 32 new tokens each), block_tokens 16, max_batch 4, policy
   tiering08, slow kind pinned_host;
5. serve, fused (``fused_gather``): the same requests; greedy tokens must
   equal the staged phase's, except where the first differing step is a
   near tie (top-2 logit margin below ``NEAR_TIE``);
6. print the ``kernels`` JSON line, then the device line last.

Launch counters are set to 0 just before each serve phase and read just
after it; a kernel of the path that did not launch fails the run.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

QK_STD = 1.5           # std of the q and k inputs (scores of std ~2.25)
ATOL, RTOL = 2e-3, 1.6e-2   # kernel vs plain: >= two bf16 ulps, relative
NEAR_TIE = 0.1         # top-2 logit margin under which a flip is a tie
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
L2_FLUSH_BYTES = 256 << 20     # written before each timed call (L2: 50 MB)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
SEED = 0

B, H, KV, HD, BT = 4, 32, 8, 128, 16
PROMPTS, NEW_TOKENS, N_REQ = (512, 256), 32, 8
MAX_CONTEXT = max(PROMPTS) + NEW_TOKENS + BT
NB = math.ceil(MAX_CONTEXT / BT)          # table slots per sequence
S_PAD = NB * BT
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:85",
    "paged_decode_attention": "src/repro/kernels/tiered_gather.py:157",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
}
SOURCES = {
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/csrc/paged_decode_attention.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


_flush: list = []


def time_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = True) -> float:
    """ms per call of ``fn``.  Cold (default): the median over calls that
    each follow a write of ``L2_FLUSH_BYTES``, so the inputs come from
    device memory as in the serve path.  Warm: the mean over calls back
    to back on the same inputs, which stay in the L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    if not _flush:
        _flush.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        _flush[0].zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        fail(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite output")
    err = (g - w).abs()
    bad = err > ATOL + RTOL * w.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off by up to "
             f"{err.max().item():.4g} (tolerance {ATOL} + {RTOL} |plain|)")
    log(f"  {name}: max_abs_err={err.max().item():.3g} "
        f"mean|plain|={w.abs().mean().item():.3g}")
    return err.max().item()


def sdpa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call over (B, heads, S, hd)
    inputs with grouped KV heads, as a timing closure (``enable_gqa``
    where this PyTorch has it, else KV expanded beforehand)."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        k2 = k.repeat_interleave(rep, 1)
        v2 = v.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(q, k2, v2, **kw)


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------- #
# phase 2: kernels against their plain versions                           #
# ---------------------------------------------------------------------- #
def kernel_phase(dev, gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.tiered_gather import paged_decode_attention

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    out = {}
    # cached lengths per decode row (the engine's ``lengths``): block
    # edges, an empty row, and the main path's longest contexts
    ragged = [[0, 15, 16, 17], [543, 287, 16, 1], [543, 543, 542, 0]]
    timed = [543, 287, 543, 287]       # the serve phases' last step

    # -- decode_attention (staged path: kv_len = lengths + 1) --------- #
    q = rnd(B, H, HD, std=QK_STD)
    kc, vc = rnd(B, S_PAD, KV, HD, std=QK_STD), rnd(B, S_PAD, KV, HD)
    err = 0.0
    for lens in ragged + [timed]:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev) + 1
        err = max(err, compare(
            f"decode_attention lens={lens}",
            decode_attention(q, kc, vc, kv_len),
            ref.decode_attention(q, kc, vc, kv_len)))
    kv_len = torch.tensor(timed, dtype=torch.int32, device=dev) + 1
    live = int(kv_len.sum())
    mask = (torch.arange(S_PAD, device=dev)[None, None, None, :]
            < kv_len[:, None, None, None])
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    t_b, by = bound(2 * live * KV * HD * 2 + 2 * B * H * HD * 2 + 4 * B,
                    4 * live * H * HD)
    out["decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: decode_attention(q, kc, vc, kv_len)),
        warm_ms=time_ms(lambda: decode_attention(q, kc, vc, kv_len),
                        cold=False),
        plain_ms=time_ms(lambda: ref.decode_attention(q, kc, vc, kv_len)),
        library_ms=time_ms(sdpa(q[:, :, None], kt, vt, attn_mask=mask)),
        bound_ms=t_b, bound_by=by)

    # -- paged_decode_attention (fused path) -------------------------- #
    num_blocks = B * NB
    kp = rnd(num_blocks, BT, KV, HD, std=QK_STD)
    vp = rnd(num_blocks, BT, KV, HD)
    kn, vn = rnd(B, KV, HD, std=QK_STD), rnd(B, KV, HD)
    perm = torch.randperm(num_blocks, generator=gen, device=dev)
    tbl = perm.reshape(B, NB).to(torch.int32).contiguous()
    tbl[2, :NB // 2] = tbl[0, :NB // 2]          # shared blocks

    def padded(lens):
        # pad slots past each row's blocks hold block 0, as the engine's
        t = tbl.clone()
        for i, n in enumerate(lens):
            t[i, math.ceil((n + 1) / BT):] = 0
        return t

    err = 0.0
    for lens in ragged + [timed]:
        t = padded(lens)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = max(err, compare(
            f"paged_decode_attention lens={lens}",
            paged_decode_attention(q, kp, vp, t, kv_len, kn, vn,
                                   block_tokens=BT),
            ref.paged_decode_attention(q, kp, vp, t, kv_len, kn, vn)))
    t = padded(timed)
    kv_len = torch.tensor(timed, dtype=torch.int32, device=dev)
    live = int(kv_len.sum()) + B
    staged_k = kp[t.long()].reshape(B, S_PAD, KV, HD).transpose(1, 2)
    staged_v = vp[t.long()].reshape(B, S_PAD, KV, HD).transpose(1, 2)
    pmask = (torch.arange(S_PAD, device=dev)[None, None, None, :]
             < kv_len[:, None, None, None] + 1)
    t_b, by = bound(2 * live * KV * HD * 2 + t.numel() * 4
                    + 2 * B * H * HD * 2 + 4 * B, 4 * live * H * HD)
    out["paged_decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: paged_decode_attention(
            q, kp, vp, t, kv_len, kn, vn, block_tokens=BT)),
        warm_ms=time_ms(lambda: paged_decode_attention(
            q, kp, vp, t, kv_len, kn, vn, block_tokens=BT), cold=False),
        plain_ms=time_ms(lambda: ref.paged_decode_attention(
            q, kp, vp, t, kv_len, kn, vn)),
        # SDPA over the cache staged beforehand: the attention alone,
        # without the gather the kernel does itself
        library_ms=time_ms(sdpa(q[:, :, None], staged_k, staged_v,
                                attn_mask=pmask)),
        bound_ms=t_b, bound_by=by)

    # -- flash_attention (prefill) ------------------------------------ #
    err = 0.0
    for L in (max(PROMPTS), min(PROMPTS), 300, 17):
        qq, kk = rnd(1, L, H, HD, std=QK_STD), rnd(1, L, KV, HD, std=QK_STD)
        vv = rnd(1, L, KV, HD)
        err = max(err, compare(f"flash_attention L={L}",
                               flash_attention(qq, kk, vv, causal=True),
                               ref.flash_attention(qq, kk, vv,
                                                   causal=True)))
    L = max(PROMPTS)
    qq, kk = rnd(1, L, H, HD, std=QK_STD), rnd(1, L, KV, HD, std=QK_STD)
    vv = rnd(1, L, KV, HD)
    qt, ktt, vtt = (x.transpose(1, 2) for x in (qq, kk, vv))
    t_b, by = bound((2 * L * H * HD + 2 * L * KV * HD) * 2,
                    4 * H * HD * L * (L + 1) / 2)
    out["flash_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention(qq, kk, vv, causal=True)),
        warm_ms=time_ms(lambda: flash_attention(qq, kk, vv, causal=True),
                        cold=False),
        plain_ms=time_ms(lambda: ref.flash_attention(qq, kk, vv,
                                                     causal=True)),
        library_ms=time_ms(sdpa(qt, ktt, vtt, is_causal=True)),
        bound_ms=t_b, bound_by=by)
    for name, row in out.items():
        log(f"kernel {name}: max_abs_err={row['max_abs_err']:.3g} "
            f"ms={row['ms']:.4f} (warm L2 {row['warm_ms']:.4f}) "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
    return out


# ---------------------------------------------------------------------- #
# serving phases                                                          #
# ---------------------------------------------------------------------- #
def prompts_for(cfg, n: int, lens) -> list:
    rs = np.random.RandomState(SEED)
    return [rs.randint(0, cfg.vocab, (lens[i % len(lens)],)).astype(
        np.int32) for i in range(n)]


def serve(cfg, params, prompts, new_tokens: int, device, **sv_kw):
    from repro_torch.serving import ServingConfig, ServingEngine
    sv = ServingConfig(block_tokens=BT, max_batch=B,
                       max_context=max(len(p) for p in prompts)
                       + new_tokens + BT,
                       policy="tiering08", slow_kind="pinned_host",
                       **sv_kw)
    eng = ServingEngine(cfg, params, sv, device=device)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    return eng


def run_engine(eng):
    from repro_torch.kernels import build
    build.reset_launches()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    tokens = {r.rid: list(r.out_tokens) for r in eng.sched.finished}
    return rep, wall, launches, tokens


def agree(name: str, a: dict, b: dict, margins: dict) -> list:
    """Tokens of two runs must match; a mismatch passes only if its
    first differing step is a near tie in run ``b``."""
    ties = []
    for rid in sorted(a):
        if a[rid] == b.get(rid):
            continue
        step = next(i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                    if x != y)
        margin = margins[rid][step]
        log(f"{name}: req{rid} differs from step {step}, top-2 margin "
            f"{margin:.4g} (near tie below {NEAR_TIE})")
        if margin >= NEAR_TIE:
            fail(f"{name}: req{rid} tokens differ at step {step} with a "
                 f"top-2 margin of {margin:.4g}")
        ties.append({"rid": rid, "step": step, "margin": margin})
    return ties


def small_reference_phase() -> dict:
    """Kernels (card) against plain versions (CPU) end to end, on a
    small dense model with the full model's head geometry."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), d_model=512,
                              n_heads=4, n_kv=2, head_dim=128, d_ff=1024)
    cpu = lm.init_params(cfg, seed=SEED, device="cpu")
    gpu = lm.tree_map(lambda t: t.cuda(), cpu)
    prompts = prompts_for(cfg, 3, (40, 23))
    toks = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        for fused in (False, True):
            eng = serve(cfg, params, prompts, 8, dev, fused_gather=fused)
            _, _, _, t = run_engine(eng)
            toks[(name, fused)] = (t, eng.margins)
    ties = []
    for fused in (False, True):
        ties += agree(f"small reference (fused={fused})",
                      toks[("cpu", fused)][0], *toks[("cuda", fused)])
    log(f"small reference: card and CPU tokens agree on both paths "
        f"({len(ties)} near tie(s))")
    return {"ties": ties}


def serve_phase(label: str, cfg, params, prompts, need: tuple,
                fused: bool) -> dict:
    eng = serve(cfg, params, prompts, NEW_TOKENS, "cuda",
                fused_gather=fused)
    rep, wall, launches, tokens = run_engine(eng)
    s = rep.summary
    for name in need:
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    n_units = cfg.n_units * len(cfg.pattern)
    dec = "paged_decode_attention" if fused else "decode_attention"
    if launches[dec] % n_units:
        fail(f"{label}: {launches[dec]} {dec} launches is not a multiple "
             f"of {n_units} layers")
    if s["finished"] != len(prompts) or any(
            len(t) != NEW_TOKENS for t in tokens.values()):
        fail(f"{label}: not every request finished with {NEW_TOKENS} "
             "tokens")
    for rid, ms in eng.margins.items():
        if not all(math.isfinite(m) for m in ms):
            fail(f"{label}: non-finite logits for req{rid}")
    log(f"serve {label}: wall={wall:.2f} s "
        f"throughput={s['throughput_tok_s']:.1f} tok/s "
        f"mean_ttft={s['mean_ttft_s'] * 1e3:.1f} ms "
        f"p95_ttft={s['p95_ttft_s'] * 1e3:.1f} ms "
        f"iterations={int(s['iterations'])} "
        f"promoted={rep.tiering['promoted']} "
        f"demoted={rep.tiering['demoted']} launches={launches} "
        f"(decode launches per iteration: {n_units})")
    return {"summary": s, "wall_s": wall, "launches": launches,
            "tokens": tokens, "margins": eng.margins,
            "tiering": rep.tiering}


def profile_phase(cfg, params) -> dict:
    """Where a serve run's time goes (``--profile``): one torch.profiler
    trace over a short run of each path (4 requests, prompts 512 and
    256, 8 new tokens); device time by category and the device's idle
    share of the run's wall time."""
    from torch.profiler import profile, ProfilerActivity
    groups = (("port kernels", ("decode_attention_kernel",
                                "flash_attention_kernel")),
              ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                          "cublas")),
              ("copy", ("memcpy", "copy")))
    out = {}
    for fused in (False, True):
        label = "fused" if fused else "staged"
        eng = serve(cfg, params, prompts_for(cfg, 4, PROMPTS), 8, "cuda",
                    fused_gather=fused)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels, memcpy, memset): the host
        # ops that launched them report the same time again
        rows = [(e.key, e.self_device_time_total / 1e6, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0]
        busy = sum(r[1] for r in rows)
        if busy <= 0:
            log(f"profile {label}: the profiler saw no device time")
            continue
        cats = {name: 0.0 for name, _ in groups}
        cats["other"] = 0.0
        for key, sec, _ in rows:
            low = key.lower()
            name = next((n for n, keys in groups
                         if any(k in low for k in keys)), "other")
            cats[name] += sec
        rows.sort(key=lambda r: -r[1])
        out[label] = {"wall_s": wall, "device_busy_s": busy,
                      "device_idle_share": 1.0 - busy / wall,
                      "iterations": eng._step,
                      "categories_s": cats, "top": rows[:15]}
        log(f"profile {label}: wall={wall:.3f} s device_busy={busy:.3f} s "
            f"idle_share={1.0 - busy / wall:.3f} "
            f"iterations={eng._step} "
            + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in cats.items()))
        for key, sec, n in rows[:8]:
            log(f"  {sec * 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace short serve runs with torch.profiler "
                         "(device time by category, idle share)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: n/a"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    record = {"card": card, "build_log": build.build_log}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    kernels = kernel_phase(dev, gen)
    record["kernels"] = kernels
    record["small_reference"] = small_reference_phase()
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"llama3-8b params ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on device")
    prompts = prompts_for(cfg, N_REQ, PROMPTS)
    staged = serve_phase("staged", cfg, params, prompts,
                         ("decode_attention", "flash_attention"),
                         fused=False)
    fused = serve_phase("fused", cfg, params, prompts,
                        ("paged_decode_attention", "flash_attention"),
                        fused=True)
    fused["ties"] = agree("fused vs staged", staged["tokens"],
                          fused["tokens"], fused["margins"])
    log(f"fused vs staged: {N_REQ - len(fused['ties'])}/{N_REQ} "
        "requests give identical tokens")
    record["serve"] = {"staged": staged, "fused": fused}
    if args.profile:
        record["profile"] = profile_phase(cfg, params)
    for name in kernels:
        kernels[name]["launches"] = (staged["launches"][name]
                                     + fused["launches"][name])
    rows = [{"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name],
             "launches": row["launches"],
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
            for name, row in kernels.items()]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(record, indent=1, default=str))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
