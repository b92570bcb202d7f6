#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py             # every phase (needs one GPU)
    python3 chip_smoke.py --profile   # plus a torch.profiler breakdown

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``), build the
   CUDA kernels from ``src/repro_torch/csrc``, print the build time and
   count each library's tensor-core (``HMMA``), ``ldmatrix`` (``LDSM``)
   and ``cp.async`` (``LDGSTS``) instructions in its SASS (``cuobjdump``);
2. kernels: each kernel against its plain PyTorch version on the card.
   The three attention kernels run at the serving shapes of llama3-8b
   (32 heads, 8 KV heads) and of qwen3-moe-30b-a3b (32 heads, 4 KV
   heads), over ragged lengths (0, 15, 16, 17, the decode kernels'
   64-token split edges and long; a raw kv_len of 0 for the contiguous
   kernel, whose reference then averages V over the whole cache),
   shared pool blocks and ragged prefill lengths (17, 256, 300, 512 and
   2048, where operations bind; L 2048 is timed beside SDPA on a line of
   its own); q and k have std ``QK_STD``, so the softmax is peaked and
   the outputs are O(1).  Each split-KV decode kernel's row gives the
   pass-1 plan its wrapper computes (``split_tokens``, ``n_split``,
   ``pass1_blocks``), and the run fails if that plan has fewer blocks
   than an H100's 132 SMs.  ``fused_expert_ffn``
   runs at qwen3-moe-30b-a3b's decode shapes (batch 4, d_model 2048,
   expert d_ff 768, 128 experts, top-8) on router-like ids, with one
   duplicated expert and one padded row, x of std 1 and weights at their
   init scales.  The tolerance is ``ATOL`` absolute plus ``RTOL``
   relative (at least two bf16 units in the last place), so a kernel
   that drops a tile of keys, a slot or a column tile fails.  Each
   kernel, its plain version and, where one exists, one PyTorch library
   call of the same function are timed with CUDA events, each call
   after a write that evicts the L2 (the regime of the bytes bound):
   ``ms`` and ``library_ms``; ``device_ms`` and ``library_device_ms``
   time the same calls with a spin on the card after the write, so the
   wrapper's host time is hidden and the card's time alone is read;
3. small references: a small dense model and a small MoE model with
   head_dim 128, each served on the card (kernels) and on the CPU (plain
   versions) from the same weights — the greedy tokens must agree, up
   to near ties;
4. serve llama3-8b, staged then fused (``fused_gather``): full width
   and depth, random weights from a seeded generator on the card; 8
   requests (prompts of 512 and 256 tokens, 32 new tokens each),
   block_tokens 16, max_batch 4, policy tiering08, slow kind
   pinned_host.  Fused tokens must equal staged ones, except where the
   first differing step is a near tie (top-2 logit margin below
   ``NEAR_TIE``);
4b. serve llama3-8b again, adaptive (``adaptive=True``, replans every
   ``REPLAN_EVERY`` iterations), staged then fused, on the same
   prompts, pool and policy.  First the transfer probes of the three
   memory kinds are printed (the engine's replanner plans over tiers
   built from such probes; its planning tiers are printed too).  Each
   adaptive run's tokens must equal its path's tokens of phase 4
   exactly (a replan moves blocks, never a value); it must consider at
   least one replan, its trace must hold an epoch with a replan
   decision, and its trace (JSONL), metrics (Prometheus text) and audit
   report, written to a temporary directory and read back, must not be
   empty.  tok/s, TTFT, decode gap, replans, moved bytes and, where
   blocks moved, the priced move time against the wall time are
   printed beside phase 4's numbers;
5. serve qwen3-moe-30b-a3b the same way, once llama3-8b's weights are
   freed: staged (``moe_fwd``) then fused (``fused_expert_ffn`` on every
   MoE layer of every decode step), the same requests and the same
   agreement rule; at a mismatch the fused path's smallest top-8 /
   top-9 router margin of that step is printed beside the logit margin;
6. train gpt2-xl-offload through ``ZeroOffloadEngine`` at full width and
   depth, once the serve phases' weights are freed: random weights from
   a seeded generator on the card, batches of 8 x 512 tokens from the
   port's ``DataIterator``, AdamW at the default learning rate scaled by
   the smoke width over the full one (``train_engine``); 4 steps with
   the fp32 optimizer state all on pinned host memory, then 2 steps
   from the same weights with it half on the device and half in
   pageable host memory (the paper's LDRAM+CXL).  Each step prints its loss and its four Fig. 9 phase
   times; ``fused_adam`` must launch once per parameter leaf per step,
   the losses must be finite and the loss must fall from step 1 to
   step 4;
7. print the ``kernels`` JSON line, then the device line last.  The
   line has one row per kernel build the main paths launch: each
   attention kernel at each model's KV geometry (``decode_attention@KV8``
   for llama3-8b, ``...@KV4`` for qwen3-moe-30b-a3b),
   ``fused_expert_ffn`` and ``fused_adam``; each row's times, bound and
   error come from its own build, and its launches from its own model's
   serve or train phases.

The kernel phase also holds ``fused_adam`` against its plain version at
gpt2-xl-offload's largest leaf (bf16 g) and at a ragged n of 70001 (fp32
g), aligned and at an odd storage offset; it holds the update
``master' - master`` (about lr = 3e-4 against masters of about 0.02),
m' and v' to ``ADAM_RTOL`` relative, plus two fp32 ulps of the master
for the update.  The small references also train the gpt2-xl-offload
and llama3-8b smoke configs for 3 steps on the card and on the CPU from
the same weights and batches: step-1 losses must agree within
``TRAIN_LOSS_ATOL``.

Launch counters are set to 0 just before each serve or train phase and
read just after it; a kernel of the path that did not launch fails the
run.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
LEAD_CYCLES = 200_000          # card spin for device_ms (~0.1 ms)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 peak outside the tensor cores
SEED = 0
# fused_adam vs plain: the two round the same operations in the same
# order, except that PyTorch divides by a scalar as a multiplication by
# its reciprocal (one ulp each for m'/b1c and v'/b2c): the update agrees
# to a few 1e-7 relative.  The master' itself may round one ulp apart.
ADAM_RTOL = 1e-6
ADAM_MASTER_ULPS = 2
# card vs CPU training of a smoke model: the step-1 loss is one bf16
# forward each (cuBLAS vs the CPU's bf16 matmuls; losses of ~6.2, whose
# bf16 ulp is 0.03)
TRAIN_LOSS_ATOL = 1e-2
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "gpt2-xl-offload", 512, 8
TRAIN_PLACEMENTS = (("pinned", (("pinned_host", 1.0),), 4),
                    ("ldram+cxl", (("device", 0.5), ("unpinned_host", 0.5)),
                     2))

B, H, HD, BT = 4, 32, 128, 16
MODELS = {"llama3-8b": 8, "qwen3-moe-30b-a3b": 4}   # served, and KV heads
D_MOE, F_MOE, E_MOE, K_MOE = 2048, 768, 128, 8   # qwen3-moe-30b-a3b
PROMPTS, NEW_TOKENS, N_REQ = (512, 256), 32, 8
ADAPTIVE_ARCH, REPLAN_EVERY = "llama3-8b", 8
PROBE_MB, PROBE_ITERS = 256, 5
MAX_CONTEXT = max(PROMPTS) + NEW_TOKENS + BT
NB = math.ceil(MAX_CONTEXT / BT)          # table slots per sequence
S_PAD = NB * BT
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:85",
    "paged_decode_attention": "src/repro/kernels/tiered_gather.py:157",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "fused_expert_ffn": "src/repro/kernels/tiered_gather.py:219",
    "fused_adam": "src/repro/kernels/fused_adam.py:68",
}
SOURCES = {
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/csrc/paged_decode_attention.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "fused_expert_ffn": "src/repro_torch/csrc/fused_expert_ffn.cu",
    "fused_adam": "src/repro_torch/csrc/fused_adam.cu",
}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


_flush: list = []


def time_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = True,
            lead: bool = False) -> float:
    """ms per call of ``fn``.  Cold (default): the median over calls that
    each follow a write of ``L2_FLUSH_BYTES``, so the inputs come from
    device memory as in the serve path.  Warm: the mean over calls back
    to back on the same inputs, which stay in the L2.

    A cold call's events span whatever host time of ``fn`` the write
    (~85 us on the card) does not hide.  ``lead`` adds a spin of
    ``LEAD_CYCLES`` on the card after the write, which keeps the host
    ahead of the card, so the events span the card's time alone: the
    ``device_ms`` readings, kept beside ``ms`` and not in its place."""
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
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
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


def randn_bf16(gen: torch.Generator, *shape, std: float = 1.0):
    """bf16 N(0, std^2) draws on ``gen``'s device."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * std).to(torch.bfloat16)


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def cold_times(fn, library) -> dict:
    """Cold times of a kernel's wrapper ``fn`` and of the ``library``
    closure (None where no single PyTorch call computes the function):
    ``ms`` and ``library_ms`` as ``time_ms`` reads them by default,
    ``device_ms`` and ``library_device_ms`` with its ``lead``."""
    times = dict(ms=time_ms(fn), device_ms=time_ms(fn, lead=True),
                 library_ms=None, library_device_ms=None)
    if library is not None:
        times.update(library_ms=time_ms(library),
                     library_device_ms=time_ms(library, lead=True))
    return times


# ---------------------------------------------------------------------- #
# phase 2: kernels against their plain versions                           #
# ---------------------------------------------------------------------- #
def attention_kernels(dev, gen, KV: int) -> dict:
    """The three attention kernels at H heads and ``KV`` KV heads."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.tiered_gather import paged_decode_attention

    rnd = functools.partial(randn_bf16, gen)

    out = {}
    tag = f"KV={KV}"
    # cached lengths per decode row (the engine's ``lengths``): block
    # edges, an empty row, the main path's longest contexts, the paged
    # kernel's split edges (64 tokens a split) and a full table
    ragged = [[0, 15, 16, 17], [543, 287, 16, 1], [543, 543, 542, 0],
              [63, 64, 65, S_PAD - 1]]
    timed = [543, 287, 543, 287]       # the serve phases' last step

    # -- decode_attention (staged path: kv_len = lengths + 1; and one
    #    raw row with kv_len 0: uniform weights over the whole cache) -- #
    q = rnd(B, H, HD, std=QK_STD)
    kc, vc = rnd(B, S_PAD, KV, HD, std=QK_STD), rnd(B, S_PAD, KV, HD)
    err = 0.0
    for lens, plus in [(lens, 1) for lens in ragged + [timed]] \
            + [(ragged[0], 0)]:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev) + plus
        err = max(err, compare(
            f"decode_attention {tag} kv_len={kv_len.tolist()}",
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
        max_abs_err=err, **cold_times(
            lambda: decode_attention(q, kc, vc, kv_len),
            sdpa(q[:, :, None], kt, vt, attn_mask=mask)),
        warm_ms=time_ms(lambda: decode_attention(q, kc, vc, kv_len),
                        cold=False),
        plain_ms=time_ms(lambda: ref.decode_attention(q, kc, vc, kv_len)),
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
            f"paged_decode_attention {tag} lens={lens}",
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
        max_abs_err=err, **cold_times(
            lambda: paged_decode_attention(q, kp, vp, t, kv_len, kn, vn,
                                           block_tokens=BT),
            # SDPA over the cache staged beforehand: the attention
            # alone, without the gather the kernel does itself
            sdpa(q[:, :, None], staged_k, staged_v, attn_mask=pmask)),
        warm_ms=time_ms(lambda: paged_decode_attention(
            q, kp, vp, t, kv_len, kn, vn, block_tokens=BT), cold=False),
        plain_ms=time_ms(lambda: ref.paged_decode_attention(
            q, kp, vp, t, kv_len, kn, vn)),
        bound_ms=t_b, bound_by=by)

    # -- flash_attention (prefill) ------------------------------------ #
    err = 0.0
    for L in (max(PROMPTS), min(PROMPTS), 300, 17):
        qq, kk = rnd(1, L, H, HD, std=QK_STD), rnd(1, L, KV, HD, std=QK_STD)
        vv = rnd(1, L, KV, HD)
        err = max(err, compare(f"flash_attention {tag} L={L}",
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
        max_abs_err=err, **cold_times(
            lambda: flash_attention(qq, kk, vv, causal=True),
            sdpa(qt, ktt, vtt, is_causal=True)),
        warm_ms=time_ms(lambda: flash_attention(qq, kk, vv, causal=True),
                        cold=False),
        plain_ms=time_ms(lambda: ref.flash_attention(qq, kk, vv,
                                                     causal=True)),
        bound_ms=t_b, bound_by=by)

    # -- flash_attention at L = 2048, where operations bind ------------ #
    L = 2048
    qq, kk = rnd(1, L, H, HD, std=QK_STD), rnd(1, L, KV, HD, std=QK_STD)
    vv = rnd(1, L, KV, HD)
    qt, ktt, vtt = (x.transpose(1, 2) for x in (qq, kk, vv))
    err = compare(f"flash_attention {tag} L={L}",
                  flash_attention(qq, kk, vv, causal=True),
                  ref.flash_attention(qq, kk, vv, causal=True))
    t_b, by = bound((2 * L * H * HD + 2 * L * KV * HD) * 2,
                    4 * H * HD * L * (L + 1) / 2)
    out["flash_attention"]["L2048"] = dict(
        max_abs_err=err, **cold_times(
            lambda: flash_attention(qq, kk, vv, causal=True),
            sdpa(qt, ktt, vtt, is_causal=True)),
        bound_ms=t_b, bound_by=by)
    return out


def split_plans(KV: int) -> dict:
    """The pass-1 plan of each split-KV decode kernel at the main path's
    shapes and ``KV`` KV heads: the plan call its wrapper makes, with
    the SM count it reads (the plan, not a readback of the launch).
    Fails below one pass-1 block per SM of an H100."""
    from repro_torch.kernels._launch import H100_SMS, sm_count, split_plan
    from repro_torch.kernels.decode_attention import decode_split_plan
    sms = sm_count(torch.cuda.current_device())
    plans = {"decode_attention": decode_split_plan(S_PAD, B, KV, sms),
             "paged_decode_attention": split_plan(NB, BT, B, KV, sms)}
    out = {}
    for name, (T, n_split) in plans.items():
        if B * KV * n_split < H100_SMS:
            fail(f"{name} KV={KV}: pass 1 has only {B * KV * n_split} "
                 "blocks")
        out[name] = dict(split_tokens=T, n_split=n_split,
                         pass1_blocks=B * KV * n_split)
    return out


def expert_kernel(dev, gen) -> dict:
    """``fused_expert_ffn`` at qwen3-moe-30b-a3b's decode shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_gather import fused_expert_ffn

    rnd = functools.partial(randn_bf16, gen)

    D, F, E, K = D_MOE, F_MOE, E_MOE, K_MOE
    x = rnd(B, D)
    x[3] = x[0]           # a padded row: token 0 again, routed the same
    wg, wu = rnd(E, D, F, std=D ** -0.5), rnd(E, D, F, std=D ** -0.5)
    wd = rnd(E, F, D, std=F ** -0.5)
    router = torch.randn(D, E, generator=gen, device=dev) * D ** -0.5
    wts, ids = torch.topk(torch.softmax(x.float() @ router, -1), K)
    wts = wts / wts.sum(-1, keepdim=True)
    ids = ids.to(torch.int32)
    ids[1, K - 1] = ids[1, 0]          # one duplicated expert id
    got = fused_expert_ffn(x, wg, wu, wd, ids, wts)
    err = compare("fused_expert_ffn B=4 D=2048 F=768 E=128 K=8", got,
                  ref.expert_ffn(x, wg, wu, wd, ids, wts))
    if not torch.equal(got[3], got[0]):
        fail("fused_expert_ffn: the padded row differs from row 0")
    distinct = int(torch.unique(ids).numel())
    # bytes: the distinct routed experts' weights once, x, out, ids, wts
    t_b, by = bound(distinct * 3 * D * F * 2 + 2 * B * D * 2 + 8 * B * K,
                    B * K * 6 * D * F)
    return dict(
        max_abs_err=err, **cold_times(
            lambda: fused_expert_ffn(x, wg, wu, wd, ids, wts),
            None),             # no single PyTorch call routes top-k
        warm_ms=time_ms(lambda: fused_expert_ffn(x, wg, wu, wd, ids, wts),
                        cold=False),
        plain_ms=time_ms(lambda: ref.expert_ffn(x, wg, wu, wd, ids, wts)),
        bound_ms=t_b, bound_by=by, distinct_experts=distinct)


def adam_inputs(gen, n: int, gdtype, offset: int = 0) -> tuple:
    """master ~ N(0, 0.02^2), step-3 moments of grads ~ N(0, 1e-6)
    (nonzero m and v) and g; ``offset`` > 0 views each of the four at
    that storage offset, contiguous but not 16-byte aligned."""
    def draw(std, dtype=torch.float32):
        t = torch.randn(n + offset, generator=gen, device=gen.device)
        return (t * std).to(dtype)[offset:]
    master, m, g = draw(0.02), draw(3e-4), draw(1e-3, gdtype)
    v = draw(1.0).square_().mul_(1.5e-7)
    return master, m, v, g


def adam_kwargs(step: int = 3) -> dict:
    return dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                b1c=1.0 - 0.9 ** step, b2c=1.0 - 0.95 ** step)


def poison(n: int, dev) -> None:
    """Fill three n-float blocks with NaN and free them, so the caching
    allocator hands them to the next outputs of that size: an element a
    kernel does not write stays NaN."""
    blocks = [torch.full((n,), float("nan"), device=dev) for _ in range(3)]
    del blocks


def check_adam(name: str, got: tuple, want: tuple,
               master: torch.Tensor) -> float:
    """Kernel against plain: the update ``master' - master`` to
    ``ADAM_RTOL`` of the plain update plus ``ADAM_MASTER_ULPS`` fp32
    ulps of the master; m' and v' to ``ADAM_RTOL`` plus that fraction of
    their rms.  Returns the largest absolute error of the three."""
    torch.cuda.synchronize()
    eps32 = torch.finfo(torch.float32).eps
    pairs = (("update", got[0] - master, want[0] - master,
              ADAM_MASTER_ULPS * eps32 * master.abs()),
             ("m'", got[1], want[1], None), ("v'", got[2], want[2], None))
    worst = 0.0
    for what, g, w, ulps in pairs:
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite {what} "
                 f"({int((~torch.isfinite(g)).sum())} elements)")
        err = (g - w).abs()
        tol = ADAM_RTOL * w.abs() + (
            ulps if ulps is not None
            else ADAM_RTOL * w.square().mean().sqrt())
        bad = err > tol
        if bad.any():
            fail(f"{name}: {what}: {int(bad.sum())} elements off by up to "
                 f"{err.max().item():.4g} (mean |plain| "
                 f"{w.abs().mean().item():.4g})")
        log(f"  {name} {what}: max_abs_err={err.max().item():.3g} "
            f"mean|plain|={w.abs().mean().item():.3g}")
        worst = max(worst, err.max().item())
    return worst


def adam_kernel(dev, gen) -> dict:
    """``fused_adam`` at gpt2-xl-offload's largest leaf (``mlp.w_up``,
    48 x 1600 x 6400, bf16 g) and at a ragged n of 70001 (fp32 g),
    aligned (vector loop and its tail) and at storage offset 1 (the
    scalar loop); step-3 bias corrections, weight decay 0.1."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam

    cfg = get_config(TRAIN_ARCH)
    kw = adam_kwargs()
    err = 0.0
    for n, gdtype, offset in ((70001, torch.float32, 0),
                              (70001, torch.float32, 1)):
        master, m, v, g = adam_inputs(gen, n, gdtype, offset)
        poison(n, dev)
        err = max(err, check_adam(
            f"fused_adam n={n} g={str(gdtype)[6:]} offset={offset}",
            fused_adam(master, m, v, g, **kw),
            ref.fused_adam(master, m, v, g, **kw), master))
    shape = (cfg.n_units, cfg.d_model, cfg.d_ff)
    n = math.prod(shape)
    master, m, v, g = (t.reshape(shape) for t in
                       adam_inputs(gen, n, torch.bfloat16))
    err = max(err, check_adam(
        f"fused_adam {shape} g=bfloat16", fused_adam(master, m, v, g, **kw),
        ref.fused_adam(master, m, v, g, **kw), master))
    gc.collect()
    # 12.8 GB per call: far past the L2, so back-to-back calls are cold
    t_b, by = bound(n * (3 * 4 + 2 + 3 * 4), n * 16, FP32_FLOP_PER_S)
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fused_adam(master, m, v, g, **kw), iters=10,
                   cold=False),
        plain_ms=time_ms(lambda: ref.fused_adam(master, m, v, g, **kw),
                         iters=5, warmup=1, cold=False),
        bound_ms=t_b, bound_by=by, library_ms=None, shape=list(shape))
    # yardstick: one torch._fused_adamw_ call over clones of the same
    # state (it updates in place, and takes g in the params' fp32)
    lib = [[master.clone()], [g.float()], [m.clone()], [v.clone()], [],
           [torch.tensor(3.0, device=dev)]]
    try:
        row["library_ms"] = time_ms(lambda: torch._fused_adamw_(
            *lib, lr=kw["lr"], beta1=kw["b1"], beta2=kw["b2"],
            weight_decay=kw["wd"], eps=kw["eps"], amsgrad=False,
            maximize=False), iters=10, cold=False)
        row["library"] = "torch._fused_adamw_ (fp32 g)"
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"  torch._fused_adamw_ not timed: {e}")
    del lib, master, m, v, g
    gc.collect()
    torch.cuda.empty_cache()
    return row


def kernel_phase(dev, gen) -> dict:
    """Rows of the ``kernels`` line, one per kernel build the main paths
    launch: each attention kernel at both models' KV geometry
    (``decode_attention@KV8``, ``...@KV4``), the expert kernel and the
    Adam kernel.  Each row names its ``kernel`` and the ``model`` whose
    serve or train phases run it."""
    rows = {}
    for arch, KV in MODELS.items():
        plans = split_plans(KV)
        for name, row in attention_kernels(dev, gen, KV).items():
            rows[f"{name}@KV{KV}"] = dict(row, **plans.get(name, {}),
                                          kernel=name, model=arch)
    rows["fused_expert_ffn"] = dict(expert_kernel(dev, gen),
                                    kernel="fused_expert_ffn",
                                    model="qwen3-moe-30b-a3b")
    rows["fused_adam"] = dict(adam_kernel(dev, gen), kernel="fused_adam",
                              model=TRAIN_ARCH)
    for name, row in rows.items():
        lib = row["library_ms"]
        log(f"kernel {name}: max_abs_err={row['max_abs_err']:.3g} "
            f"ms={row['ms']:.4f} (warm L2 {row.get('warm_ms', row['ms']):.4f}) "
            f"plain_ms={row['plain_ms']:.4f} library_ms="
            + ("none" if lib is None else f"{lib:.4f}")
            + f" bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
        if "device_ms" in row:
            dlib = row["library_device_ms"]
            log(f"  {name}: device_ms={row['device_ms']:.4f} "
                "library_device_ms="
                + ("none" if dlib is None else f"{dlib:.4f}"))
        if "n_split" in row:
            log(f"  {name}: pass 1 grid (KV, B, {row['n_split']}) = "
                f"{row['pass1_blocks']} blocks of {row['split_tokens']} "
                "tokens")
    long = {name: row["L2048"] for name, row in rows.items()
            if "L2048" in row}
    log("flash_attention at L=2048 (cold): " + json.dumps(long))
    return rows


def kernels_line(kernels: dict, runs: dict) -> list:
    """The ``kernels`` line's rows.  Each row's launches are those of
    its own model's serve phases (staged and fused) or train phases
    (both placements), the only runs that launch its build."""
    return [{"name": name, "route": "cuda",
             "source": SOURCES[row["kernel"]],
             "replaces": REPLACES[row["kernel"]],
             "launches": sum(phase["launches"][row["kernel"]]
                             for key, phase in runs[row["model"]].items()
                             if key != "profile"),
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
            for name, row in kernels.items()]


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


def agree(name: str, a: dict, b: dict, margins: dict,
          route_margins: dict = None) -> list:
    """Tokens of two runs must match; a mismatch passes only if its
    first differing step is a near tie in run ``b``.  ``route_margins``
    (run ``b``'s, MoE fused path): the step's smallest top-K / top-(K+1)
    router margin is logged beside the logit margin; it decides
    nothing."""
    ties = []
    for rid in sorted(a):
        if a[rid] == b.get(rid):
            continue
        step = next(i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                    if x != y)
        margin = margins[rid][step]
        tie = {"rid": rid, "step": step, "margin": margin}
        route = ""
        if route_margins:
            tie["route_margin"] = route_margins[rid][step]
            route = f", smallest router top-K/top-(K+1) margin " \
                f"{tie['route_margin']:.3g}"
        log(f"{name}: req{rid} differs from step {step}, top-2 margin "
            f"{margin:.4g} (near tie below {NEAR_TIE}){route}")
        if margin >= NEAR_TIE:
            fail(f"{name}: req{rid} tokens differ at step {step} with a "
                 f"top-2 margin of {margin:.4g}")
        ties.append(tie)
    return ties


def path_kernels(cfg, fused: bool) -> tuple:
    """The kernels a serve run of ``cfg`` launches on one decode path."""
    if not fused:
        return ("decode_attention", "flash_attention")
    if any(spec.moe for spec in cfg.pattern):
        return ("paged_decode_attention", "flash_attention",
                "fused_expert_ffn")
    return ("paged_decode_attention", "flash_attention")


def small_reference_phase(arch: str, **widen) -> dict:
    """Kernels (card) against plain versions (CPU) end to end, on
    ``arch``'s smoke config widened (``widen``) to the full model's head
    geometry."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config(arch), **widen)
    cpu = lm.init_params(cfg, seed=SEED, device="cpu")
    gpu = lm.tree_map(lambda t: t.cuda(), cpu)
    prompts = prompts_for(cfg, 3, (40, 23))
    toks = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        for fused in (False, True):
            eng = serve(cfg, params, prompts, 8, dev, fused_gather=fused)
            _, _, launches, t = run_engine(eng)
            if dev == "cuda":
                missing = [k for k in path_kernels(cfg, fused)
                           if not launches[k]]
                if missing:
                    fail(f"small reference {arch}: {missing} never "
                         "launched")
            toks[(name, fused)] = (t, eng.margins, eng.route_margins)
    ties = []
    for fused in (False, True):
        ties += agree(f"small reference {arch} (fused={fused})",
                      toks[("cpu", fused)][0], *toks[("cuda", fused)])
    log(f"small reference {arch}: card and CPU tokens agree on both paths "
        f"({len(ties)} near tie(s))")
    return {"ties": ties}


def serve_phase(label: str, cfg, params, prompts, fused: bool) -> dict:
    eng = serve(cfg, params, prompts, NEW_TOKENS, "cuda",
                fused_gather=fused)
    rep, wall, launches, tokens = run_engine(eng)
    s = rep.summary
    for name in path_kernels(cfg, fused):
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    n_units = cfg.n_units * len(cfg.pattern)
    dec = "paged_decode_attention" if fused else "decode_attention"
    if launches[dec] % n_units:
        fail(f"{label}: {launches[dec]} {dec} launches is not a multiple "
             f"of {n_units} layers")
    n_moe = cfg.n_units * sum(spec.moe for spec in cfg.pattern)
    experts = launches["fused_expert_ffn"]
    if (fused and n_moe) and experts % n_moe:
        fail(f"{label}: {experts} fused_expert_ffn launches is not a "
             f"multiple of {n_moe} MoE layers")
    if not (fused and n_moe) and experts:
        fail(f"{label}: fused_expert_ffn launched {experts} times off "
             "the fused MoE path")
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
        f"p95_decode_gap={s['p95_decode_gap_s'] * 1e3:.1f} ms "
        f"iterations={int(s['iterations'])} "
        f"promoted={rep.tiering['promoted']} "
        f"demoted={rep.tiering['demoted']} launches={launches} "
        f"(decode launches per iteration: {n_units})")
    return {"summary": s, "wall_s": wall, "launches": launches,
            "tokens": tokens, "margins": eng.margins,
            "route_margins": eng.route_margins, "tiering": rep.tiering}


def probe_phase() -> dict:
    """Copy bandwidth from the card into each memory kind, the probe the
    adaptive engine builds its planning tiers from."""
    from repro_torch.obs import measure_transfer_probes
    probes = measure_transfer_probes(
        ("device", "pinned_host", "unpinned_host"), n_mb=PROBE_MB,
        iters=PROBE_ITERS, device="cuda")
    for p in probes:
        log(f"probe device -> {p.tier}: {p.bw_GBps:.2f} GB/s "
            f"({PROBE_ITERS} copies of {PROBE_MB} MiB, CUDA events)")
    return {p.tier: p.bw_GBps for p in probes}


def read_back_artifacts(label: str, eng) -> dict:
    """Write the run's trace (JSONL), metrics (Prometheus text) and audit
    report into a temporary directory, read them back, and fail if any
    is empty."""
    from repro_torch.obs import TraceRecorder
    with tempfile.TemporaryDirectory() as tmp:
        trace, prom, audit = (Path(tmp) / n for n in
                              ("t.jsonl", "m.prom", "a.json"))
        n = eng.tracer.to_jsonl(str(trace))
        prom.write_text(eng.registry.to_prometheus_text())
        audit.write_text(json.dumps(eng.audit_report(), sort_keys=True))
        events = TraceRecorder.read_jsonl(str(trace))
        text = prom.read_text()
        report = json.loads(audit.read_text())
    if not events or len(events) != n:
        fail(f"{label}: the trace read back {len(events)} of {n} events")
    if "# TYPE" not in text or "serving_" not in text:
        fail(f"{label}: the metrics text has no serving_ series")
    if not report.get("audit", {}).get("totals"):
        fail(f"{label}: the audit report is empty")
    log(f"{label}: artifacts read back: {len(events)} trace events, "
        f"{text.count('# TYPE')} metric series, audit models "
        f"{sorted(report['audit']['models'])}")
    return {"trace_events": len(events), "series": text.count("# TYPE"),
            "audit_models": sorted(report["audit"]["models"])}


def adaptive_phase(label: str, cfg, params, prompts, fused: bool,
                   plain: dict) -> dict:
    """One adaptive serve of the prompts of ``plain`` (the same path's
    non-adaptive phase): the tokens must be ``plain``'s exactly."""
    from repro_torch.obs import replan_chains
    eng = serve(cfg, params, prompts, NEW_TOKENS, "cuda",
                fused_gather=fused, adaptive=True,
                replan_every=REPLAN_EVERY)
    for kind, t in eng.replanner.tiers.items():
        log(f"{label}: planning tier {kind}: {t.peak_bw_GBps:.2f} GB/s "
            f"(probed), capacity {t.capacity_GiB * 1024:.1f} MiB (pool budget)")
    rep, wall, launches, tokens = run_engine(eng)
    for name in path_kernels(cfg, fused):
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    if tokens != plain["tokens"]:
        bad = sorted(r for r in plain["tokens"]
                     if tokens.get(r) != plain["tokens"][r])
        fail(f"{label}: tokens differ from the non-adaptive run for "
             f"requests {bad}")
    t, s, s0 = rep.telemetry, rep.summary, plain["summary"]
    if t.get("replans_considered", 0) < 1:
        fail(f"{label}: no replan was considered")
    chains = replan_chains(eng.tracer.events)
    decided = sorted(e for e, c in chains.items() if c["decisions"])
    if not decided:
        fail(f"{label}: the trace holds no epoch with a replan decision")
    moves = [(r.predicted, r.realized)
             for r in eng.audit.records("migration.move_time")
             if r.realized is not None]
    artifacts = read_back_artifacts(label, eng)
    log(f"serve {label}: wall={wall:.2f} s "
        f"throughput={s['throughput_tok_s']:.1f} tok/s "
        f"(non-adaptive {s0['throughput_tok_s']:.1f}) "
        f"mean_ttft={s['mean_ttft_s'] * 1e3:.1f} ms "
        f"({s0['mean_ttft_s'] * 1e3:.1f}) "
        f"p95_decode_gap={s['p95_decode_gap_s'] * 1e3:.1f} ms "
        f"({s0['p95_decode_gap_s'] * 1e3:.1f}) "
        f"replans={int(t['replans_applied'])}/"
        f"{int(t['replans_considered'])} at epochs {decided} "
        f"moved_bytes={int(t['moved_bytes'])} "
        f"denied_bytes={int(t['denied_bytes'])} "
        f"migrated_bytes={rep.tiering['migrated_bytes']} "
        f"({plain['tiering']['migrated_bytes']}) launches={launches}")
    if moves:
        pred, real = (sum(m[i] for m in moves) for i in (0, 1))
        log(f"{label}: migration.move_time over {len(moves)} executions: "
            f"predicted {pred * 1e3:.3f} ms, realized {real * 1e3:.3f} ms "
            f"(wall clock around blocking copies)")
    else:
        log(f"{label}: no physical block moves to audit "
            + ("(no replan moved bytes)"
               if eng.replanner.executor.physical_moves
               else "(this layout moves residency only)"))
    return {"summary": s, "wall_s": wall, "launches": launches,
            "telemetry": t, "decided_epochs": decided,
            "move_time": moves, "artifacts": artifacts}


def profile_phase(cfg, params) -> dict:
    """Where a serve run's time goes (``--profile``): one torch.profiler
    trace over a short run of each path (4 requests, prompts 512 and
    256, 8 new tokens); device time by category and the device's idle
    share of the run's wall time."""
    from torch.profiler import profile, ProfilerActivity
    groups = (("port kernels", ("decode_split_kernel",
                                "decode_merge_kernel",
                                "paged_decode_split_kernel",
                                "paged_decode_merge_kernel",
                                "flash_attention_kernel",
                                "expert_up_kernel", "expert_down_kernel")),
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
            log(f"profile {cfg.name} {label}: the profiler saw no device time")
            continue
        cats = {name: 0.0 for name, _ in groups}
        cats["other"] = 0.0
        port = []
        for key, sec, n in rows:
            low = key.lower()
            name = next((g for g, keys in groups
                         if any(k in low for k in keys)), "other")
            cats[name] += sec
            if name == "port kernels":
                port.append((key, sec, n))
        rows.sort(key=lambda r: -r[1])
        out[label] = {"wall_s": wall, "device_busy_s": busy,
                      "device_idle_share": 1.0 - busy / wall,
                      "iterations": eng._step,
                      "categories_s": cats, "top": rows[:15],
                      "port_kernels": port}
        log(f"profile {cfg.name} {label}: wall={wall:.3f} s "
            f"device_busy={busy:.3f} s "
            f"idle_share={1.0 - busy / wall:.3f} "
            f"iterations={eng._step} "
            + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in cats.items()))
        for key, sec, n in rows[:8]:
            log(f"  {sec * 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
        for key, sec, n in port:
            log(f"  port kernel {sec * 1e3:8.3f} ms  {n:6d}x  {key[:70]}")
    return out


def serve_model(arch: str, profile: bool) -> dict:
    """Serve ``arch`` at full width and depth on both paths; fused tokens
    must equal staged ones up to near ties.  The weights are freed when
    this returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"{arch} params ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}): {time.perf_counter() - t0:.1f} s, "
        f"{memory()}")
    prompts = prompts_for(cfg, N_REQ, PROMPTS)
    out = {}
    for fused in (False, True):
        label = f"{arch} {'fused' if fused else 'staged'}"
        out["fused" if fused else "staged"] = serve_phase(
            label, cfg, params, prompts, fused=fused)
        log(f"after serve {label}: {memory()}")
    staged, fused = out["staged"], out["fused"]
    fused["ties"] = agree(f"{arch} fused vs staged", staged["tokens"],
                          fused["tokens"], fused["margins"],
                          fused["route_margins"])
    log(f"{arch} fused vs staged: {N_REQ - len(fused['ties'])}/{N_REQ} "
        "requests give identical tokens")
    if arch == ADAPTIVE_ARCH:
        for path in ("staged", "fused"):
            out[f"adaptive {path}"] = adaptive_phase(
                f"{arch} adaptive {path}", cfg, params, prompts,
                path == "fused", out[path])
    if profile:
        out["profile"] = profile_phase(cfg, params)
    return out


# ---------------------------------------------------------------------- #
# training phases                                                         #
# ---------------------------------------------------------------------- #
def train_engine(cfg, params, shares, device):
    """A ``ZeroOffloadEngine`` whose AdamW learning rate is the default
    one scaled by the smoke width over ``cfg``'s width: AdamW's first
    steps move every weight by about lr, so a layer's output moves in
    proportion to lr x fan-in, and the default rate, which the smoke
    configs (d_model 64) learn at, makes the full widths diverge."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.offload import OffloadConfig, ZeroOffloadEngine
    from repro_torch.optim import AdamConfig
    lr = AdamConfig.lr * get_smoke_config(cfg.name).d_model / cfg.d_model
    return ZeroOffloadEngine(cfg, params, OffloadConfig(
        opt_state_shares=list(shares), adam=AdamConfig(lr=lr)),
        device=device)


def run_train(eng, batches) -> tuple:
    """``eng`` through one step per batch, the launch counters set to 0
    just before; returns (step timings, launches, wall s)."""
    from repro_torch.kernels import build
    build.reset_launches()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    timings = [eng.train_step(b) for b in batches]
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return timings, dict(build.LAUNCHES), time.perf_counter() - t0


def n_leaves(params) -> int:
    import torch.utils._pytree as pytree
    return len(pytree.tree_leaves(params))


def small_train_reference(arch: str) -> dict:
    """``arch``'s smoke config trained 3 steps by ``ZeroOffloadEngine``
    on the card (``fused_adam``) and on the CPU (plain versions) from the
    same weights and batches: finite losses, step-1 losses within
    ``TRAIN_LOSS_ATOL``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import batch_for_step, DataConfig
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    cpu = lm.init_params(cfg, seed=SEED, device="cpu")
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    batches = [batch_for_step(dc, step) for step in range(3)]
    losses = {}
    for dev, params in (("cpu", cpu),
                        ("cuda", lm.tree_map(lambda t: t.cuda(), cpu))):
        eng = train_engine(cfg, params, (("pinned_host", 1.0),), dev)
        timings, launches, _ = run_train(eng, batches)
        losses[dev] = [t.loss for t in timings]
        want = len(batches) * n_leaves(params) if dev == "cuda" else 0
        if launches["fused_adam"] != want:
            fail(f"small train reference {arch} on {dev}: "
                 f"{launches['fused_adam']} fused_adam launches, "
                 f"expected {want}")
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        fail(f"small train reference {arch}: non-finite loss {losses}")
    d = abs(losses["cuda"][0] - losses["cpu"][0])
    if d > TRAIN_LOSS_ATOL:
        fail(f"small train reference {arch}: step-1 loss {losses['cuda'][0]}"
             f" on the card, {losses['cpu'][0]} on the CPU")
    log(f"small train reference {arch}: card {losses['cuda']} CPU "
        f"{losses['cpu']} (step 1 differs by {d:.3g})")
    return losses


def train_model(arch: str) -> dict:
    """Train ``arch`` at full width and depth under each of
    ``TRAIN_PLACEMENTS``, each from the same seeded weights and the same
    first batches.  The weights are freed when this returns."""
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.core import LOGICAL_KINDS
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.models import lm
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    leaves = n_leaves(params)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    log(f"{arch} params ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}; {n_params} parameters in {leaves} leaves): "
        f"{time.perf_counter() - t0:.1f} s, {memory()}")
    out = {}
    for label, shares, n_steps in TRAIN_PLACEMENTS:
        t0 = time.perf_counter()
        eng = train_engine(cfg, params, shares, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        on = {kind: eng.opt_state_bytes_on(kind) for kind in LOGICAL_KINDS}
        log(f"train {arch} {label}: engine {init_s:.1f} s, opt state bytes "
            + " ".join(f"{k}={v}" for k, v in on.items())
            + f" (12 x params = {12 * n_params}), {memory()}")
        if label == "pinned" and (on["pinned_host"] != 12 * n_params
                                  or on["device"]):
            fail(f"train {arch} {label}: the fp32 state is not all on "
                 "pinned host memory")
        it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH, seed=SEED))
        timings, launches, wall = run_train(
            eng, [next(it) for _ in range(n_steps)])
        for i, t in enumerate(timings):
            log(f"  step {i + 1}: loss={t.loss:.5f} "
                f"fwd_bwd={t.fwd_bwd_s:.3f} s grad_xfer={t.grad_xfer_s:.3f} "
                f"s optimizer={t.optimizer_s:.3f} s "
                f"param_xfer={t.param_xfer_s:.4f} s total={t.total_s:.3f} s")
        losses = [t.loss for t in timings]
        if not all(math.isfinite(x) for x in losses):
            fail(f"train {arch} {label}: non-finite loss {losses}")
        if launches["fused_adam"] != leaves * n_steps:
            fail(f"train {arch} {label}: {launches['fused_adam']} fused_adam"
                 f" launches, expected {leaves} leaves x {n_steps} steps")
        others = {k: v for k, v in launches.items()
                  if v and k != "fused_adam"}
        if others:
            fail(f"train {arch} {label}: serving kernels launched {others}")
        log(f"train {arch} {label}: wall={wall:.2f} s launches={launches} "
            f"{memory()}")
        out[label] = {"shares": shares, "init_s": init_s, "wall_s": wall,
                      "opt_state_bytes": on, "launches": launches,
                      "losses": losses,
                      "steps": [dataclasses.asdict(t) for t in timings]}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    losses = out["pinned"]["losses"]
    if not losses[3] < losses[0]:
        fail(f"train {arch}: the loss did not fall from step 1 to step 4 "
             f"({losses})")
    d = abs(out["ldram+cxl"]["losses"][0] - losses[0])
    if d > TRAIN_LOSS_ATOL:
        fail(f"train {arch}: step-1 loss depends on the placement ({d:.3g})")
    log(f"train {arch}: step-1 loss under LDRAM+CXL differs from pinned by "
        f"{d:.3g}")
    return out


def sass_counts(libs: dict) -> dict:
    """Per kernel library: how many tensor-core mma (``HMMA``), ldmatrix
    (``LDSM``), ``cp.async`` (``LDGSTS``) and fp32 FMA (``FFMA``)
    instructions its SASS holds, over all its instantiations
    (``cuobjdump -sass``); None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        log("cuobjdump not found: SASS not counted")
        return {name: None for name in libs}
    out = {}
    for name, path in libs.items():
        sass = subprocess.run([str(tool), "-sass", str(path)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        out[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                     for op in ("HMMA", "LDSM", "LDGSTS", "FFMA")}
        log(f"  sass {name}: " + " ".join(f"{k}={v}"
                                         for k, v in out[name].items()))
    return out


def memory() -> str:
    return (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on device "
            f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace short serve runs with torch.profiler "
                         "(device time by category, idle share)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    from repro_torch.kernels import build

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
    record = {"card": card, "build_log": build.build_log,
              "sass": sass_counts(libs)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    record["kernels"] = kernels = kernel_phase(dev, gen)
    record["small_reference"] = small_reference_phase(
        "llama3-8b", d_model=512, n_heads=4, n_kv=2, head_dim=128,
        d_ff=1024)
    record["small_moe_reference"] = small_reference_phase(
        "qwen3-moe-30b-a3b", d_model=512, n_kv=2, head_dim=128)
    record["small_train_reference"] = {
        arch: small_train_reference(arch)
        for arch in (TRAIN_ARCH, "llama3-8b")}
    record["probes_GBps"] = probe_phase()
    record["serve"] = {}
    for arch in MODELS:              # one model's weights on the card
        record["serve"][arch] = serve_model(arch, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
    record["train"] = {TRAIN_ARCH: train_model(TRAIN_ARCH)}
    rows = kernels_line(kernels, {**record["serve"], **record["train"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(record, indent=1, default=str))
    # the result lines, unprefixed: card, kernels, and the device line last
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
