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
   than an H100's 132 SMs.  ``decode_attention`` and
   ``flash_attention`` also run at the one-shot phase's own shapes
   (``oneshot_kernels``: 8 rows of llama3-8b's geometry; the prefill
   over 512 causal tokens, and the decode over the 544-position cache
   at each step's kv_len, 513 to 543, the same on every row), each
   timed and bounded there as a row of its own.  ``fused_expert_ffn``
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
4c. serve llama3-8b staged once more under every control plane
   (``adaptive``, ``predictive``, ``calibrate``, ``topology="h100-node"``
   with its rates probed on this card, ``qos``), with a p99 decode SLO
   of ``SLO_FRACTION`` of phase 4's staged p95 decode gap, so that
   violations fire.  Tokens must equal phase 4's staged tokens; a
   request that QoS preempted and recomputed may part from them only at
   a near tie.  The trace, read back, must hold a replan chain with a
   grant and a decision; the run must rebalance the arbiter at least
   once, flush at least one move-scheduler round and blame at least one
   excursion.  The calibrator's slow-tier rate is printed beside the
   topology's probe;
4c'. serve llama3-8b through the serve CLI's multi-host cluster plane
   (``launch.serve.parse_args`` of ``--scheduler continuous --replicas 2
   --router headroom-distance`` and the same prompts, pool and policy,
   then ``run_cluster`` over the weights on the card): two logical
   replicas on the card, each its own paged pool over one namespaced
   ledger, staged.  Both replicas must get sessions, every session must
   finish with its tokens equal to phase 4's staged tokens up to near
   ties, building the plane must add less than ``CLUSTER_MEMORY_SHARE``
   of the weights' bytes (both replicas' ``embed`` the card's one
   tensor), the bytes by replica namespace must sum to the ``*/*``
   aggregate after every iteration, only ``decode_attention`` (a
   multiple of 32 layers) and ``flash_attention`` may launch, ``--replicas
   2 --fused-gather`` must be refused and ``launch.train --mesh 1x2``
   must raise naming the ROADMAP item that splits work over several
   devices.  Routed counts, each replica's tok/s, their sum, tokens per
   wall second, the worst p95 latency and the bytes are printed; the
   phase's launches count in the ``@KV8`` rows;
4d. serve llama3-8b one-shot (``offload.FlexGenEngine``, the serve
   CLI's default path) on the same weights: 8 prompts of 512 tokens
   (seed 0), 32 new tokens, under three placements: all on the device,
   the KV cache half on pinned host memory, and the weights and the KV
   cache each half on pinned host memory.  Each prints prefill ms,
   decode tok/s, the bytes on each kind and the seconds; prefill must
   launch ``flash_attention`` once per layer and the decode
   ``decode_attention`` once per layer per step, and nothing else; the
   tokens must be the same under every placement, and the last decode
   step's logits must match a prefill over the prompt and the tokens
   before the last (relative error below ``FLEXGEN_REL``, argmax equal
   up to a near tie).  ``decode_witness`` then shows what that check
   sees: one decode step from a prefill cache on the kernels (below
   ``FLEXGEN_REL``) and on the plain attention (printed: the bf16
   model's own rounding), and under four planted cache and position
   faults, each of which must read above ``FLEXGEN_REL``;
4e. the analysis phase on the same weights: llama3-8b's prefill step
   (``launch.steps.make_prefill_step``, 8 x 512 tokens, ``flash_attention``
   on every layer) and decode step (``make_serve_step`` over that
   prefill's cache padded to 544 positions, index 512, B 8,
   ``decode_attention`` on every layer), each timed on the card (median
   of ``ANALYSIS_CALLS`` calls with CUDA events, after
   ``ANALYSIS_WARMUP``), costed by ``launch.jaxpr_cost`` over fake CPU
   tensors of the same shapes and bounded by
   ``launch.hlo_analysis.roofline_terms`` (the larger of the compute and
   memory terms at the H100's rates).  A step faster than its bound
   fails the run (the count is wrong), and so does a step whose
   ``FlopCounterMode`` count on the card (which cannot see the ctypes
   kernels) differs by more than ``FLOP_MATCH`` from the walker's
   matrix-product FLOPs outside its kernel leaves.  ms, bound, the
   binding term and bound / ms are printed and go to ``"analysis"`` in
   the JSON record; the steps' launches count in the ``/oneshot`` rows;
5. serve qwen3-moe-30b-a3b the same way, once llama3-8b's weights are
   freed: staged (``moe_fwd``) then fused (``fused_expert_ffn`` on every
   MoE layer of every decode step), the same requests and the same
   agreement rule; at a mismatch the fused path's smallest top-8 /
   top-9 router margin of that step is printed beside the logit margin;
5b. serve qwen3-moe-30b-a3b fused once more with MoE expert residency
   (``expert_policy="predictive"``, ``EXPERT_FAST_FRACTION`` of the
   48 x 128 expert blocks fast) under the predictive control plane.
   Residency is ledger bookkeeping, so the tokens must equal phase 5's
   fused tokens exactly; the pool must promote at least one expert, and
   ``record_routing`` must be called once per live row per MoE layer of
   every decode iteration.  Accesses, the fast-hit ratio, prefetch
   promotes and hits, promotions, demotions, move-scheduler rounds,
   arbiter rebalances and the host time of the routing feed are
   printed;
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
6'. the analysis phase's train step on the same weights:
   ``make_train_step`` of gpt2-xl-offload over 8 x 128 tokens with a
   fresh fp32 AdamW state on the card and ``use_fused_kernel``
   (``fused_adam`` once per leaf), held as 4e holds its steps; its
   launches count in the ``fused_adam`` row;
6b. the training launcher (``launch.train``, as ``python -m
   repro_torch.launch.train`` runs it) on gpt2-xl-offload at full width
   and depth, ``--adaptive --replan-every 2``, 6 steps of 8 x 128
   tokens, with its trace, metrics and audit report written to a
   temporary directory and read back: a replan beyond the initial one
   must move the fp32 optimizer state's blocks, each block must sit on
   the kind its tier label names, the ledger must hold the store's
   bytes with the plan's fast share (within 0.05), the loss must fall
   from step 0 to step 5, and no hand-written kernel may launch (the
   launcher's step is the plain AdamW, as the reference's);
6c. checkpoints through the launcher on bert-large-offload at full
   width and depth: run A takes 4 steps, checkpointing every 2; run B
   resumes A's directory to step 6 and must print ``restored step 4``;
   run C takes 6 steps in a fresh directory; B's losses at steps 4-5
   must equal C's within ``CKPT_RTOL`` relative, and A's checkpoint
   resumed under each of three planted restore faults must not.  Bytes
   written, save and restore seconds and the checksum-verified leaves
   are printed;
7. print the ``kernels`` JSON line, then the device line last.  The
   line has one row per kernel build the main paths launch: each
   attention kernel at each model's KV geometry (``decode_attention@KV8``
   for llama3-8b, ``...@KV4`` for qwen3-moe-30b-a3b), the two one-shot
   kernels at that phase's shapes (``decode_attention@KV8/oneshot``,
   ``flash_attention@KV8/oneshot``), ``fused_expert_ffn`` and
   ``fused_adam``; each row's times, bound and error come from its own
   build and shapes, and its launches from the phases that run it at
   those shapes: a ``/oneshot`` row's from the one-shot phase, the other
   attention rows' from their model's other serve phases.

The kernel phase also holds ``fused_adam`` against its plain version at
gpt2-xl-offload's largest leaf (bf16 g) and at a ragged n of 70001 (fp32
g), aligned and at an odd storage offset; it holds the update
``master' - master`` (about lr = 3e-4 against masters of about 0.02),
m' and v' to ``ADAM_RTOL`` relative, plus two fp32 ulps of the master
for the update.  The small references also train the gpt2-xl-offload
and llama3-8b smoke configs for 3 steps on the card and on the CPU from
the same weights and batches: step-1 losses must agree within
``TRAIN_LOSS_ATOL``.

The families phase follows the serve phases: llama-3.2-vision-11b (8
prompts of 512 over 1600 stubbed image embeddings, its tanh gates drawn
away from 0), rwkv6-7b (8 prompts of 512) and whisper-large-v3 (8
prompts of 128 over 1500 stubbed frames; the encoder's own ms printed),
each at full width and depth through ``FlexGenEngine.run(prompts,
frames)`` under two placements (``FAMILY_ARCHS``), with random weights
from ``SEED``.  Each run must launch the flash kernel once per causal
self-attention layer and the decode kernel once per self- and
cross-attention layer and step (rwkv6-7b: none); tokens must not depend
on the placement; the last decode step must match a prefill as in the
one-shot phase, except rwkv6-7b's, whose recurrent state carries each
step's bf16 rounding forward: it is printed, and one step from a prefill
cache is held to the limit beside three planted state faults
(``recurrent_witness``), and so is the last of the same steps
teacher-forced with the whole model in fp32 (``recurrent_drift``).
Vision and Whisper hold one step from a prefill cache beside three
planted cross-cache faults (``cross_witness``).  Then jamba's smoke
variant (widened to head_dim 64, one unit; two units printed) one-shot
on the card against the CPU, tokens equal up to near ties; jamba's Mamba layer alone at full width, its
chunked scan over 8 x 512 tokens and 32 one-token steps against one
scan of all (``MAMBA_TOL``); and an int8 KV cache at the model level
(``INT8_REL``).
The kernel phase adds the attention kernels at these shapes
(``family_kernels``: ``flash_attention@whisper``,
``decode_attention@whisper-self``, ``@whisper-cross`` and
``@vision-cross``); a row with a ``shape`` also counts the families
phase's launches at that shape (``build.SHAPE_LAUNCHES``), so the
vision model's self-attention adds to the ``/oneshot`` rows.

Launch counters are set to 0 just before each serve or train phase and
read just after it; a kernel of the path that did not launch fails the
run.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100's data-sheet rates: one source for every bound of this script
from repro_torch.launch.hlo_analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOP_PER_S,
    PEAK_FLOPS_FP32 as FP32_FLOP_PER_S)

QK_STD = 1.5           # std of the q and k inputs (scores of std ~2.25)
ATOL, RTOL = 2e-3, 1.6e-2   # kernel vs plain: >= two bf16 ulps, relative
NEAR_TIE = 0.1         # top-2 logit margin under which a flip is a tie
L2_FLUSH_BYTES = 256 << 20     # written before each timed call (L2: 50 MB)
LEAD_CYCLES = 200_000          # card spin for device_ms (~0.1 ms)
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
# the one-shot FlexGen phase: weight and KV share lists per placement
FLEXGEN_ARCH, FLEXGEN_BATCH, FLEXGEN_PROMPT = "llama3-8b", 8, 512
HALF_PINNED = (("device", 0.5), ("pinned_host", 0.5))
FLEXGEN_PLACEMENTS = (("all device", (("device", 1.0),), (("device", 1.0),)),
                      ("kv half pinned", (("device", 1.0),), HALF_PINNED),
                      ("weights+kv half pinned", HALF_PINNED, HALF_PINNED))
FLEXGEN_REL = 2e-2     # test_decode_matches_prefill's tolerance; each of
# decode_witness's planted cache and position faults must read above it
# the families phase: one-shot at full width and depth, (prompt length,
# placements) per model
FAMILY_BATCH, WHISPER_PROMPT = 8, 128
ALL_DEVICE = (("device", 1.0),)
FAMILY_ARCHS = {
    "llama-3.2-vision-11b": (512, (
        ("all device", ALL_DEVICE, ALL_DEVICE),
        ("kv half pinned", ALL_DEVICE, HALF_PINNED))),
    "rwkv6-7b": (512, (
        ("all device", ALL_DEVICE, ALL_DEVICE),
        ("weights half pinned", HALF_PINNED, ALL_DEVICE))),
    "whisper-large-v3": (WHISPER_PROMPT, (
        ("all device", ALL_DEVICE, ALL_DEVICE),
        ("kv half pinned", ALL_DEVICE, HALF_PINNED))),
}
JAMBA_ARCH, JAMBA_SMOKE_PROMPT, MAMBA_PROMPT = "jamba-1.5-large-398b", 64, 512
DRIFT_STEPS = (1, 2, 5, 16, NEW_TOKENS - 1)   # recurrent_drift's readings
MAMBA_TOL = 2e-2       # test_mamba_chunk_vs_step_recurrence's rtol = atol
INT8_REL = 0.1         # test_int8_kv_cache_decode's limit
# the training launcher (adaptive) and its checkpoints, at full size
LAUNCHER_ARCH, LAUNCHER_STEPS = "gpt2-xl-offload", 6
CKPT_ARCH = "bert-large-offload"
# resumed vs uninterrupted loss, relative: rounding headroom (8 fp32
# ulps of a loss near 10) over runs that read equal; every planted
# restore fault of checkpoint_phase must read above it
CKPT_RTOL = 1e-6
EXPERT_ARCH, EXPERT_FAST_FRACTION = "qwen3-moe-30b-a3b", 0.25
# the cluster phase: the serve CLI's multi-host plane, two logical
# replicas on the one card over its staged path; building the plane may
# add less than this share of the weights' bytes (no second copy)
CLUSTER_ARCH, CLUSTER_REPLICAS = "llama3-8b", 2
CLUSTER_MEMORY_SHARE = 0.1
# the control-plane phase's p99 decode SLO, as a fraction of the p95
# decode gap its path's non-adaptive phase measured in the same call:
# below the gaps, so violations fire and the blame plane runs
SLO_FRACTION = 0.5
PROBE_MB, PROBE_ITERS = 256, 5
# the analysis phase: whole steps held against their roofline bound
# (launch.jaxpr_cost's count at launch.hlo_analysis's H100 rates)
ANALYSIS_WARMUP, ANALYSIS_CALLS = 2, 10   # calls before / timed (median)
ANALYSIS_TRAIN_SEQ = 128                  # gpt2-xl-offload train: 8 x 128
FLOP_MATCH = 0.01     # FlopCounterMode vs the walker's non-leaf dot FLOPs
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


def decode_row(gen, Bd: int, S: int, Hd: int, KV: int, hd: int,
               lens: range, tag: str) -> dict:
    """``decode_attention`` over (Bd, S) caches of ``KV`` heads with
    ``Hd`` query heads of ``hd``: held against its plain version at
    every ``kv_len`` of ``lens`` (the same on every row), and timed,
    bounded and set beside SDPA at the last."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_split_plan)
    from repro_torch.kernels._launch import sm_count

    dev = gen.device
    rnd = functools.partial(randn_bf16, gen)
    q = rnd(Bd, Hd, hd, std=QK_STD)
    kc, vc = rnd(Bd, S, KV, hd, std=QK_STD), rnd(Bd, S, KV, hd)
    err = 0.0
    for n in lens:
        kv_len = torch.full((Bd,), n, dtype=torch.int32, device=dev)
        err = max(err, compare(f"decode_attention {tag} S={S} kv_len={n}",
                               decode_attention(q, kc, vc, kv_len),
                               ref.decode_attention(q, kc, vc, kv_len)))
    n = lens[-1]
    kv_len = torch.full((Bd,), n, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            < kv_len[:, None, None, None])
    t_b, by = bound(2 * Bd * n * KV * hd * 2 + 2 * Bd * Hd * hd * 2
                    + 4 * Bd, 4 * Bd * n * Hd * hd)
    T, n_split = decode_split_plan(S, Bd, KV,
                                   sm_count(torch.cuda.current_device()))
    return dict(
        max_abs_err=err, **cold_times(
            lambda: decode_attention(q, kc, vc, kv_len),
            sdpa(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                 attn_mask=mask)),
        warm_ms=time_ms(lambda: decode_attention(q, kc, vc, kv_len),
                        cold=False),
        plain_ms=time_ms(lambda: ref.decode_attention(q, kc, vc, kv_len)),
        bound_ms=t_b, bound_by=by, split_tokens=T, n_split=n_split,
        pass1_blocks=Bd * KV * n_split, shape=(Bd, S, Hd, KV, hd))


def flash_row(gen, Bf: int, L: int, Hf: int, KV: int, hd: int,
              tag: str) -> dict:
    """``flash_attention`` over ``Bf`` causal prompts of ``L`` tokens:
    held against its plain version, timed, bounded and set beside SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    rnd = functools.partial(randn_bf16, gen)
    qq, kk = rnd(Bf, L, Hf, hd, std=QK_STD), rnd(Bf, L, KV, hd, std=QK_STD)
    vv = rnd(Bf, L, KV, hd)
    err = compare(f"flash_attention {tag} L={L}",
                  flash_attention(qq, kk, vv, causal=True),
                  ref.flash_attention(qq, kk, vv, causal=True))
    t_b, by = bound(Bf * (2 * L * Hf * hd + 2 * L * KV * hd) * 2,
                    Bf * 4 * Hf * hd * L * (L + 1) / 2)
    return dict(
        max_abs_err=err, **cold_times(
            lambda: flash_attention(qq, kk, vv, causal=True),
            sdpa(*(x.transpose(1, 2) for x in (qq, kk, vv)),
                 is_causal=True)),
        warm_ms=time_ms(lambda: flash_attention(qq, kk, vv, causal=True),
                        cold=False),
        plain_ms=time_ms(lambda: ref.flash_attention(qq, kk, vv,
                                                     causal=True)),
        bound_ms=t_b, bound_by=by, shape=(Bf, L, L, Hf, KV, hd, 1))


def oneshot_kernels(dev, gen, KV: int) -> dict:
    """``decode_attention`` and ``flash_attention`` at the one-shot
    FlexGen phase's shapes (``FLEXGEN_BATCH`` rows, H heads, ``KV`` KV
    heads): the prefill over ``FLEXGEN_PROMPT`` causal tokens, and every
    decode step over the ``pad_to`` cache, whose ``kv_len`` is the same
    on every row (``FLEXGEN_PROMPT + 1`` to ``FLEXGEN_PROMPT + NEW_TOKENS
    - 1``); timed at the last step.  The vision model's self-attention
    (``FAMILY_ARCHS``) runs at these shapes too."""
    Bf, L = FLEXGEN_BATCH, FLEXGEN_PROMPT
    tag = f"KV={KV} B={Bf}"
    return {"decode_attention": decode_row(gen, Bf, L + NEW_TOKENS, H, KV,
                                           HD, range(L + 1, L + NEW_TOKENS),
                                           tag),
            "flash_attention": flash_row(gen, Bf, L, H, KV, HD, tag)}


def family_kernels(gen) -> dict:
    """The attention kernels at the shapes the families phase adds:
    Whisper's prefill (``FAMILY_BATCH`` x ``WHISPER_PROMPT``, 20 heads of
    64, one query head per KV head) and one-token steps over its
    self-attention cache (``pad_to`` = prompt + ``NEW_TOKENS``, every
    step's kv_len) and its 1500-frame cross cache, and the vision
    model's one-token steps over its 1600-token cross cache (32 heads,
    8 KV heads, hd 128).  Rows keyed ``<kernel>@<model>-<use>``."""
    from repro_torch.configs import get_config
    w = get_config("whisper-large-v3")
    v = get_config("llama-3.2-vision-11b")
    Bf, L = FAMILY_BATCH, WHISPER_PROMPT
    Hw, Kw, hw = w.n_heads, w.n_kv, w.head_dim
    rows = {
        "flash_attention@whisper": (
            "flash_attention", w.name,
            flash_row(gen, Bf, L, Hw, Kw, hw, "whisper")),
        "decode_attention@whisper-self": (
            "decode_attention", w.name,
            decode_row(gen, Bf, L + NEW_TOKENS, Hw, Kw, hw,
                       range(L + 1, L + NEW_TOKENS), "whisper self")),
        "decode_attention@whisper-cross": (
            "decode_attention", w.name,
            decode_row(gen, Bf, w.n_frontend_tokens, Hw, Kw, hw,
                       [w.n_frontend_tokens], "whisper cross")),
        "decode_attention@vision-cross": (
            "decode_attention", v.name,
            decode_row(gen, Bf, v.n_frontend_tokens, v.n_heads, v.n_kv,
                       v.head_dim, [v.n_frontend_tokens], "vision cross")),
    }
    return {name: dict(row, kernel=kernel, model=model)
            for name, (kernel, model, row) in rows.items()}


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
    """Rows of the ``kernels`` line, one per kernel build and shape the
    main paths launch: each attention kernel at both models' KV geometry
    and the continuous paths' shapes (``decode_attention@KV8``,
    ``...@KV4``), the two the one-shot path runs at its own shapes
    (``decode_attention@KV8/oneshot``, ``flash_attention@KV8/oneshot``),
    the expert kernel and the Adam kernel.  Each row names its
    ``kernel`` and the ``model`` whose serve or train phases run it;
    ``oneshot`` rows count the one-shot phases' launches, the others
    the rest of the model's phases."""
    rows = {}
    for arch, KV in MODELS.items():
        plans = split_plans(KV)
        for name, row in attention_kernels(dev, gen, KV).items():
            rows[f"{name}@KV{KV}"] = dict(row, **plans.get(name, {}),
                                          kernel=name, model=arch)
        if arch == FLEXGEN_ARCH:
            for name, row in oneshot_kernels(dev, gen, KV).items():
                rows[f"{name}@KV{KV}/oneshot"] = dict(
                    row, kernel=name, model=arch, oneshot=True)
    rows.update(family_kernels(gen))
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


def kernels_line(kernels: dict, runs: dict, shape_launches: dict) -> list:
    """The ``kernels`` line's rows.  Each row's launches are those of
    its own model's serve phases (staged, fused, adaptive, control
    planes and experts; or, for an ``oneshot`` row, the one-shot FlexGen
    placements and the analysis phase's decode and prefill steps, which
    run at those shapes) or train phases (both placements and the
    analysis phase's train step), the only runs that launch its build
    at its shapes; plus, for a row with a ``shape``,
    the families phase's launches at that shape (``shape_launches``,
    (kernel, shape) -> count)."""
    def launches(row):
        n = sum(phase["launches"][row["kernel"]]
                for label, phase in runs.get(row["model"], {}).items()
                if "launches" in phase
                and phase.get("oneshot", label.startswith("flexgen "))
                == row.get("oneshot", False))
        if "shape" in row:
            n += shape_launches.get((row["kernel"], tuple(row["shape"])),
                                    0)
        return n

    return [{"name": name, "route": "cuda",
             "source": SOURCES[row["kernel"]],
             "replaces": REPLACES[row["kernel"]],
             "launches": launches(row),
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


def read_back_artifacts(label: str, eng) -> tuple:
    """Write the run's trace (JSONL), metrics (Prometheus text) and audit
    report into a temporary directory, read them back, and fail if any
    is empty.  Returns (what was read, in counts; the trace's events as
    read back)."""
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
            "audit_models": sorted(report["audit"]["models"])}, events


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
    artifacts, _ = read_back_artifacts(label, eng)
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


def control_planes_phase(label: str, cfg, params, prompts,
                         plain: dict) -> dict:
    """The staged path under every control plane of the engine: the
    predictive arbiter and move scheduler, calibration, the ``h100-node``
    topology (rates probed on this card) and QoS with a p99 decode SLO
    of ``SLO_FRACTION`` of ``plain``'s p95 decode gap, so that
    violations fire and are blamed.  Tokens must be ``plain``'s; a
    request that QoS preempted and recomputed may part from them only
    at a near tie."""
    from repro_torch.obs import replan_chains
    slo = SLO_FRACTION * plain["summary"]["p95_decode_gap_s"]
    eng = serve(cfg, params, prompts, NEW_TOKENS, "cuda",
                adaptive=True, replan_every=REPLAN_EVERY, predictive=True,
                calibrate=True, topology="h100-node", qos=True,
                slo_p99_decode_s=slo)
    link = eng.topo.links[("chip0", "host0")]
    fitted0 = eng.calibrator.calibrated_tiers()[eng.pool.slow_kind]
    log(f"{label}: h100-node PCIe link {link.bw_GBps:.2f} GB/s "
        f"(probed), calibrated {eng.pool.slow_kind} at start-up "
        f"{fitted0.peak_bw_GBps:.2f} GB/s (its own probe, 16 MiB x 2); "
        f"p99 decode SLO {slo * 1e3:.2f} ms")
    rep, wall, launches, tokens = run_engine(eng)
    for name in path_kernels(cfg, False):
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    preempted = {r.rid: r.preemptions for r in eng.sched.finished}
    exact = {rid: t for rid, t in tokens.items() if not preempted[rid]}
    if any(exact[rid] != plain["tokens"][rid] for rid in exact):
        fail(f"{label}: a request QoS never preempted has other tokens "
             "than the non-adaptive run")
    ties = agree(label, plain["tokens"], tokens, eng.margins)
    t, s, s0 = rep.telemetry, rep.summary, plain["summary"]
    blame = rep.slo["blame"]
    _, events = read_back_artifacts(label, eng)
    chains = replan_chains(events)
    granted = sorted(e for e, c in chains.items()
                     if c["decisions"] and c["grants"])
    if not granted:
        fail(f"{label}: the trace read back holds no replan chain with "
             "a grant and a decision")
    for key, what in (("arbiter_rebalances", "arbiter rebalance"),
                      ("movesched.rounds", "move-scheduler round")):
        if t.get(key, 0) < 1:
            fail(f"{label}: no {what}")
    if blame["total_excursions"] < 1:
        fail(f"{label}: no SLO violation was blamed")
    fitted = eng.calibrator.calibrated_tiers()[eng.pool.slow_kind]
    log(f"serve {label}: wall={wall:.2f} s "
        f"throughput={s['throughput_tok_s']:.1f} tok/s "
        f"(non-adaptive {s0['throughput_tok_s']:.1f}) "
        f"p95_decode_gap={s['p95_decode_gap_s'] * 1e3:.1f} ms "
        f"({s0['p95_decode_gap_s'] * 1e3:.1f}) "
        f"replans={int(t['replans_applied'])}/"
        f"{int(t['replans_considered'])} chains with grants {granted} "
        f"arbiter_rebalances={int(t['arbiter_rebalances'])} "
        f"movesched_rounds={int(t['movesched.rounds'])} "
        f"moved_bytes={int(t['moved_bytes'])} "
        f"denied_bytes={int(t['denied_bytes'])} "
        f"link_deferrals={int(t['link_deferrals'])} "
        f"qos_deferrals={int(t['qos_deferrals'])} "
        f"slo_preemptions={int(t['slo_preemptions'])} "
        f"preempted={sorted(r for r, n in preempted.items() if n)} "
        f"violations={rep.slo['targets'][0]['violations']} "
        f"excursions={blame['total_excursions']} "
        f"top_link={blame.get('top_link')} launches={launches}")
    log(f"{label}: calibrated {eng.pool.slow_kind} {fitted.peak_bw_GBps:.2f}"
        f" GB/s after {int(t['calibration.observations'])} online "
        f"observations (start-up {fitted0.peak_bw_GBps:.2f}, h100-node "
        f"probe {link.bw_GBps:.2f})")
    return {"summary": s, "wall_s": wall, "launches": launches,
            "telemetry": t, "ties": ties, "granted_epochs": granted,
            "slo_s": slo, "blame": blame, "preempted": preempted,
            "link_GBps": link.bw_GBps,
            "calibrated_GBps": (fitted0.peak_bw_GBps, fitted.peak_bw_GBps)}


def cluster_phase(label: str, cfg, params, prompts, staged: dict) -> dict:
    """The multi-host cluster plane through the serve CLI: its own
    parser (``--scheduler continuous --replicas 2 --router
    headroom-distance``, the continuous phases' prompts, pool and
    policy) and ``run_cluster`` over the weights on the card.  Every
    session must finish with ``NEW_TOKENS`` tokens, both replicas must
    get sessions, each session's tokens must be ``staged``'s for its
    prompt up to near ties, building the plane must copy no weights
    (``CLUSTER_MEMORY_SHARE``; both replicas' ``embed`` one tensor),
    the per-replica ledger bytes must sum to the ``*/*`` aggregate over
    ``host0/serving`` and ``host1/serving``, and only the staged path's
    kernels may launch.  ``--replicas 2 --fused-gather`` must be refused,
    and the training launcher's ``--mesh 1x2`` on one card must raise
    naming the ROADMAP item that splits work over several devices."""
    import torch.utils._pytree as pytree
    from repro_torch.cluster import plane as plane_mod
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import MULTI_DEVICE_ITEM
    argv = ["--arch", cfg.name, "--scheduler", "continuous", "--replicas",
            str(CLUSTER_REPLICAS), "--router", "headroom-distance",
            "--num-requests", str(len(prompts)), "--prompt-len",
            str(max(PROMPTS)), "--new-tokens", str(NEW_TOKENS),
            "--block-tokens", str(BT), "--batch", str(B), "--policy",
            "tiering08", "--device", "cuda"]
    args = serve.parse_args(argv)
    weights = sum(t.numel() * t.element_size()
                  for t in pytree.tree_leaves(params))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    built, samples = {}, []
    init = plane_mod.ClusterPlane.__init__

    def measured_init(plane, *a, **kw):
        init(plane, *a, **kw)
        torch.cuda.synchronize()
        built["bytes"] = torch.cuda.memory_allocated() - before
        build.reset_launches()             # the run's launches only
        # the namespaces' bytes on both kinds, after every iteration of
        # either replica, while their blocks are live
        for rep in plane.replicas.values():
            metrics = rep.engine.metrics
            step = metrics.on_iteration

            def sampled(*a, _step=step, **kw):
                _step(*a, **kw)
                samples.append({kind: plane.namespace_conservation(kind)
                                for kind in ("device", "pinned_host")})
            metrics.on_iteration = sampled

    with mock.patch.object(plane_mod.ClusterPlane, "__init__",
                           measured_init):
        t0 = time.perf_counter()
        plane = serve.run_cluster(args, cfg, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    after = torch.cuda.memory_allocated() - before
    reps = list(plane.replicas.values())
    if built["bytes"] >= CLUSTER_MEMORY_SHARE * weights:
        fail(f"{label}: building the plane allocated {built['bytes']} B, "
             f"not under {CLUSTER_MEMORY_SHARE} of the {weights} B of "
             "weights")
    ptrs = {r.engine.params["embed"].data_ptr() for r in reps}
    if len(ptrs) != 1 or ptrs != {params["embed"].data_ptr()}:
        fail(f"{label}: the replicas' embed are not the card's one tensor")
    routed = plane.router.routed_counts()
    if sum(routed.values()) != len(prompts) or not all(routed.values()):
        fail(f"{label}: routed {routed}: not all {len(prompts)} sessions, "
             "or a replica without one")
    tokens, margins = {}, {}
    for rep in reps:
        for req in rep.engine.sched.finished:
            i = next(j for j, p in enumerate(prompts)
                     if np.array_equal(p, req.prompt))
            tokens[i] = list(req.out_tokens)
            margins[i] = rep.engine.margins[req.rid]
    if sorted(tokens) != list(range(len(prompts))) or any(
            len(t) != NEW_TOKENS for t in tokens.values()):
        fail(f"{label}: not every session finished with {NEW_TOKENS} "
             "tokens")
    ties = agree(f"{label} vs single engine", staged["tokens"], tokens,
                 margins)
    tenants = sorted(str(t) for t in plane.ledger.tenants)
    if tenants != [f"host{i}/serving" for i in range(CLUSTER_REPLICAS)]:
        fail(f"{label}: ledger tenants {tenants}")
    for sample in samples + [{"device": plane.namespace_conservation()}]:
        for kind, cons in sample.items():
            if sum(v for h, v in cons.items() if h != "total") \
                    != cons["total"]:
                fail(f"{label}: {kind} bytes by replica {cons} do not sum "
                     "to the */* aggregate")
    peak = max(samples, key=lambda c: c["device"]["total"]
               + c["pinned_host"]["total"])
    for name in path_kernels(cfg, False):
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    n_layers = cfg.n_units * len(cfg.pattern)
    if launches["decode_attention"] % n_layers:
        fail(f"{label}: {launches['decode_attention']} decode launches is "
             f"not a multiple of {n_layers} layers")
    off = {k: launches[k] for k in ("paged_decode_attention",
                                    "fused_expert_ffn") if launches[k]}
    if off:
        fail(f"{label}: kernels off the staged path launched: {off}")
    refused = ""
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            serve.parse_args(argv + ["--fused-gather"])
    except SystemExit:
        refused = err.getvalue().strip().splitlines()[-1]
    if not refused:
        fail(f"{label}: --replicas 2 --fused-gather was accepted")
    try:
        train.main(["--arch", cfg.name, "--steps", "1", "--mesh", "1x2"])
        fail(f"{label}: train --mesh 1x2 ran on one card")
    except ValueError as e:
        if MULTI_DEVICE_ITEM not in str(e):
            fail(f"{label}: train --mesh 1x2 raised without the ROADMAP "
                 f"item: {e}")
        mesh_error = str(e)
    # each replica's run summary, as its engine published it
    s = {h: {k: r.engine.registry.gauge(f"serving.summary.{k}").value
             for k in ("throughput_tok_s", "p95_latency_s")}
         for h, r in plane.replicas.items()}
    agg_tok = sum(v["throughput_tok_s"] for v in s.values())
    worst = max(v["p95_latency_s"] for v in s.values())
    log(f"serve {label}: wall={wall:.2f} s routed={routed} "
        + " ".join(f"{h}={v['throughput_tok_s']:.1f}" for h, v in s.items())
        + f" tok/s, aggregate {agg_tok:.1f} tok/s (the replicas' rates "
        f"summed; they ran in turn: "
        f"{len(prompts) * NEW_TOKENS / wall:.1f} tok/s over the wall) "
        f"worst_p95_latency={worst * 1e3:.1f} ms "
        f"(single engine {staged['summary']['throughput_tok_s']:.1f} tok/s, "
        f"{staged['wall_s']:.2f} s) built={built['bytes']} B "
        f"after run={after} B of {weights} B weights, ledger conserved "
        f"over {len(samples)} iterations (fullest: {peak}), "
        f"launches={launches}")
    log(f"{label}: --fused-gather refused ({refused}); train --mesh 1x2: "
        f"{mesh_error}")
    return {"wall_s": wall, "launches": launches, "routed": routed,
            "throughput_tok_s": {h: v["throughput_tok_s"]
                                 for h, v in s.items()},
            "aggregate_tok_s": agg_tok, "worst_p95_latency_s": worst,
            "built_bytes": built["bytes"], "run_bytes": after,
            "weights_bytes": weights, "ledger_fullest": peak,
            "ledger_samples": len(samples), "ties": ties,
            "refused": refused, "mesh_error": mesh_error}


def experts_phase(label: str, cfg, params, prompts, plain: dict) -> dict:
    """The fused MoE path with expert residency (``expert_policy``
    predictive, ``EXPERT_FAST_FRACTION`` of the (layer, expert) blocks
    fast) under the predictive control plane.  Residency is ledger
    bookkeeping, so the tokens must be ``plain``'s exactly; every live
    row of every decode iteration must feed each MoE layer's routed ids
    to the pool once."""
    from repro_torch.serving.expert_pool import (expert_nbytes_from_config,
                                                 moe_layers_from_config)
    eng = serve(cfg, params, prompts, NEW_TOKENS, "cuda",
                fused_gather=True, adaptive=True, predictive=True,
                replan_every=REPLAN_EVERY, expert_policy="predictive",
                expert_fast_fraction=EXPERT_FAST_FRACTION)
    pool, n_moe = eng.expert_pool, moe_layers_from_config(cfg)
    nbytes = expert_nbytes_from_config(cfg)
    log(f"{label}: {pool.fast_expert_budget} of {n_moe * cfg.n_experts} "
        f"experts of {nbytes / 1e6:.2f} MB fast "
        f"({pool.fast_expert_budget * nbytes / 1e9:.2f} GB grant)")
    count = {"calls": 0, "rows": 0, "record_s": 0.0, "step_s": 0.0}
    record, step, decode = (pool.record_routing, pool.step,
                            eng._fused_decode_batch)

    def counted_record(*a, **kw):
        t0 = time.perf_counter()
        record(*a, **kw)
        count["calls"] += 1
        count["record_s"] += time.perf_counter() - t0

    def timed_step(*a, **kw):
        t0 = time.perf_counter()
        step(*a, **kw)
        count["step_s"] += time.perf_counter() - t0

    def counted_decode(batch):
        count["rows"] += len(batch)
        return decode(batch)
    pool.record_routing, pool.step = counted_record, timed_step
    eng._fused_decode_batch = counted_decode
    rep, wall, launches, tokens = run_engine(eng)
    for name in path_kernels(cfg, True):
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    if tokens != plain["tokens"]:
        bad = sorted(r for r in plain["tokens"]
                     if tokens.get(r) != plain["tokens"][r])
        fail(f"{label}: tokens differ from the fused run for requests "
             f"{bad}")
    if count["calls"] != count["rows"] * n_moe:
        fail(f"{label}: {count['calls']} record_routing calls, not "
             f"{count['rows']} live rows x {n_moe} MoE layers")
    t, s, s0 = rep.telemetry, rep.summary, plain["summary"]
    if t["expert.promoted"] < 1:
        fail(f"{label}: no expert was promoted")
    # the routing feed's one copy an iteration, alone: a tensor of the
    # routed ids' shape and dtype copied to the host from an idle card
    ids = torch.zeros((cfg.n_units, n_moe // cfg.n_units, B, cfg.top_k),
                      dtype=torch.int32, device="cuda")
    copies = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids.cpu()
        copies.append(time.perf_counter() - t0)
    count["copy_ms"] = statistics.median(copies[1:]) * 1e3
    log(f"serve {label}: wall={wall:.2f} s "
        f"throughput={s['throughput_tok_s']:.1f} tok/s "
        f"(fused {s0['throughput_tok_s']:.1f}) "
        f"p95_decode_gap={s['p95_decode_gap_s'] * 1e3:.1f} ms "
        f"({s0['p95_decode_gap_s'] * 1e3:.1f}) "
        f"accesses={int(t['expert.accesses'])} "
        f"fast_hit_ratio={t.get('expert.fast_hit_ratio', 0.0):.4f} "
        f"prefetch_promotes={int(t['expert.prefetch_promotes'])} "
        f"prefetch_hits={int(t['expert.prefetch_hits'])} "
        f"promoted={int(t['expert.promoted'])} "
        f"demoted={int(t['expert.demoted'])} "
        f"movesched_rounds={int(t['movesched.rounds'])} "
        f"arbiter_rebalances={int(t['arbiter_rebalances'])} "
        f"record_routing={count['calls']} calls over {count['rows']} "
        f"live rows ({count['record_s']:.3f} s) "
        f"expert steps {count['step_s']:.3f} s; one routed-ids copy "
        f"({ids.numel() * 4} bytes) from an idle card "
        f"{count['copy_ms']:.4f} ms (median of 20) launches={launches}")
    return {"summary": s, "wall_s": wall, "launches": launches,
            "telemetry": t, "routing": count}


def flexgen_phase(cfg, params) -> dict:
    """The one-shot FlexGen path (``offload.FlexGenEngine``) under each
    of ``FLEXGEN_PLACEMENTS``, in turns (each placement, then each again
    in reverse order, so that every placement has one reading before
    and one after the others): ``FLEXGEN_BATCH`` prompts of
    ``FLEXGEN_PROMPT`` tokens, ``NEW_TOKENS`` new tokens each.  Prefill
    must launch ``flash_attention`` once per layer and the decode
    ``decode_attention`` once per layer per step; the tokens must not
    depend on the placement; the last decode step's logits must match a
    prefill over the prompt and the tokens before the last (relative
    error below ``FLEXGEN_REL``, equal argmax up to a near tie)."""
    import torch.utils._pytree as pytree

    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.offload import FlexGenEngine, ServeConfig
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (FLEXGEN_BATCH, FLEXGEN_PROMPT)).astype(np.int32)
    layers = cfg.n_units * len(cfg.pattern)
    want = {"flash_attention": layers,
            "decode_attention": layers * (NEW_TOKENS - 1)}
    out, first = {}, None
    base = FLEXGEN_PLACEMENTS[0][0]
    turns = FLEXGEN_PLACEMENTS + FLEXGEN_PLACEMENTS[::-1]
    for turn, (name, w_shares, kv_shares) in enumerate(turns):
        label = f"{name} ({1 + turn // len(FLEXGEN_PLACEMENTS)})"
        t0 = time.perf_counter()
        eng = FlexGenEngine(cfg, params, ServeConfig(
            max_new_tokens=NEW_TOKENS, prompt_len=FLEXGEN_PROMPT,
            weight_shares=w_shares, kv_shares=kv_shares), device="cuda")
        last = {}
        step = eng.decode_step

        def recording_step(*a, **kw):
            logits, cache = step(*a, **kw)
            last["logits"] = logits
            return logits, cache
        eng.decode_step = recording_step
        w_on = {k: sum(ta.bytes_on(k)
                       for ta in pytree.tree_leaves(eng.params_tiered))
                for k in ("device", "pinned_host")}
        torch.cuda.synchronize()
        build.reset_launches()
        st = eng.run(prompts)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        secs = time.perf_counter() - t0
        kv_on = {k: eng.kv_home.bytes_on(k)
                 for k in ("device", "pinned_host", "unpinned_host")}
        log(f"flexgen {cfg.name} {label}: prefill={st.prefill_s * 1e3:.2f} ms"
            f" decode={st.decode_tok_s:.2f} tok/s "
            f"(decode {st.decode_s:.3f} s for {NEW_TOKENS - 1} steps x "
            f"{FLEXGEN_BATCH}) weights on {w_on} KV ledger {kv_on} "
            f"decode_attention={launches['decode_attention']} "
            f"flash_attention={launches['flash_attention']} "
            f"{secs:.1f} s, {memory()}")
        for name, n in want.items():
            if launches[name] != n:
                fail(f"flexgen {label}: {launches[name]} {name} launches, "
                     f"expected {n}")
        others = {k: v for k, v in launches.items() if v and k not in want}
        if others:
            fail(f"flexgen {label}: other kernels launched {others}")
        tokens = eng.tokens
        if tuple(tokens.shape) != (FLEXGEN_BATCH, NEW_TOKENS):
            fail(f"flexgen {label}: tokens of shape {tuple(tokens.shape)}")
        if not torch.isfinite(last["logits"]).all():
            fail(f"flexgen {label}: non-finite logits")
        if first is None:
            first = (tokens, last["logits"])
        elif not torch.equal(tokens, first[0]):
            bad = (tokens != first[0]).nonzero()[0].tolist()
            fail(f"flexgen {label}: tokens differ from {base} (1)'s first at "
                 f"(row, step) {bad}")
        else:
            log(f"flexgen {label}: tokens equal {base} (1)'s; "
                f"last logits bit-equal: "
                f"{torch.equal(last['logits'], first[1])}")
        out[label] = {"weight_shares": w_shares, "kv_shares": kv_shares,
                      "prefill_s": st.prefill_s, "decode_s": st.decode_s,
                      "decode_tok_s": st.decode_tok_s, "seconds": secs,
                      "weights_on": w_on, "kv_on": kv_on,
                      "launches": launches}
        del eng, step, recording_step, last
        gc.collect()
        torch.cuda.empty_cache()
    # decode against prefill: the prompt and the tokens before the last
    tokens, logits_d = first
    seq = torch.cat([torch.from_numpy(prompts).long().cuda(),
                     tokens[:, :-1]], dim=1)
    logits_p, _ = lm.prefill(params, cfg, seq)
    out["decode_vs_prefill"] = decode_vs_prefill(
        f"flexgen {cfg.name}", logits_d, logits_p, seq.shape[1])
    out["decode_witness"] = decode_witness(cfg, params, seq, logits_p)
    return out


def decode_vs_prefill(label: str, logits_d, logits_p, n: int) -> dict:
    """The last decode step's logits against a prefill of the ``n``
    tokens before it: relative error below ``FLEXGEN_REL``, and equal
    argmax except where the prefill's top-2 margin is a near tie."""
    a, b = logits_d.float(), logits_p.float()
    rel = rel_err(a, b)
    top = torch.topk(b, 2, dim=-1).values
    margin = (top[:, 0] - top[:, 1])
    flips = (a.argmax(-1) != b.argmax(-1)).nonzero().flatten().tolist()
    log(f"{label}: last decode step vs prefill of {n} tokens: rel err "
        f"{rel:.3g} (limit {FLEXGEN_REL}), argmax differs in rows "
        f"{flips}, smallest top-2 margin {margin.min().item():.4g}")
    if not rel < FLEXGEN_REL:
        fail(f"{label}: decode vs prefill rel err {rel:.4g}")
    for r in flips:
        if margin[r].item() >= NEAR_TIE:
            fail(f"{label}: row {r} argmax differs from the prefill's with "
                 f"a top-2 margin of {margin[r].item():.4g}")
    return {"rel_err": rel, "argmax_flips": flips,
            "min_margin": margin.min().item()}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|: the decode-vs-prefill measure."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()


def decode_witness(cfg, params, seq: torch.Tensor, logits_p) -> dict:
    """What the decode-vs-prefill check of ``flexgen_phase`` sees.  From
    a prefill of ``seq`` but its last token, its cache padded to the
    engine's ``pad_to``, one decode step of the last token is held
    against ``logits_p``, the prefill of the whole ``seq``: on the
    kernels (below ``FLEXGEN_REL``, like the engine's reading); on the
    plain attention of ``kernels.ref`` for both the prefill and the step
    (printed: the part of the reading that the bf16 model makes without
    any kernel); and under planted cache and position faults, each of
    which must read above ``FLEXGEN_REL``: the RoPE position one late,
    the step's K/V written one slot late (the index one ahead), the
    previous position's K/V lost (a stale restore) and ``kv_len`` one
    short (the step does not see its own K/V)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.models import modules as M
    idx = seq.shape[1] - 1
    pad_to = FLEXGEN_PROMPT + NEW_TOKENS

    def cache_of(c):
        out = {"index": c["index"]}
        for k in ("kv_k", "kv_v"):
            shape = list(c[k].shape)
            shape[3] = pad_to
            out[k] = c[k].new_zeros(shape)
            out[k][:, :, :, :idx] = c[k]
        return out

    def step(c, index=idx):
        c = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in c.items()}
        c["index"] = index
        return lm.decode_step(params, cfg, c, seq[:, -1:])[0]

    plain = (mock.patch.object(ops, "flash_attention", ref.flash_attention),
             mock.patch.object(ops, "decode_attention",
                               ref.decode_attention))
    cache = cache_of(lm.prefill(params, cfg, seq[:, :-1])[1])
    readings = {"kernels": rel_err(step(cache), logits_p)}
    with plain[0], plain[1]:
        plain_p = lm.prefill(params, cfg, seq)[0]
        plain_cache = cache_of(lm.prefill(params, cfg, seq[:, :-1])[1])
        readings["plain"] = rel_err(step(plain_cache), plain_p)
        readings["plain prefill vs kernel prefill"] = rel_err(plain_p,
                                                              logits_p)
    del plain_cache
    rope, dec = M.apply_rope, ops.decode_attention
    stale = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in cache.items()}
    stale["kv_k"][:, :, :, idx - 1] = 0
    stale["kv_v"][:, :, :, idx - 1] = 0
    faults = {}
    with mock.patch.object(M, "apply_rope", lambda x, pos, *a, **kw:
                           rope(x, pos + 1, *a, **kw)):
        faults["rope position + 1"] = rel_err(step(cache), logits_p)
    faults["K/V one slot late"] = rel_err(step(cache, idx + 1), logits_p)
    faults["previous K/V lost"] = rel_err(step(stale), logits_p)
    with mock.patch.object(ops, "decode_attention", lambda q, k, v, n:
                           dec(q, k, v, n - 1)):
        faults["kv_len - 1"] = rel_err(step(cache), logits_p)
    log(f"flexgen {cfg.name} decode witness (one step at index {idx} vs "
        f"the prefill of {idx + 1}): "
        + " ".join(f"{k}={v:.4g}" for k, v in readings.items())
        + "; planted faults: "
        + " ".join(f"{k}={v:.4g}" for k, v in faults.items())
        + f" (limit {FLEXGEN_REL})")
    if not readings["kernels"] < FLEXGEN_REL:
        fail(f"flexgen: one decode step vs prefill rel err "
             f"{readings['kernels']:.4g}")
    for name, r in faults.items():
        if not r > FLEXGEN_REL:
            fail(f"flexgen: the decode-vs-prefill check does not see the "
                 f"planted fault '{name}' (rel err {r:.4g})")
    return {"readings": readings, "faults": faults}


# ---------------------------------------------------------------------- #
# families phase: vision, RWKV6, Whisper, jamba, int8 KV                  #
# ---------------------------------------------------------------------- #
def family_params(cfg):
    """Random weights of ``cfg`` from ``SEED`` on the card.  The vision
    model's tanh gates, 0 at init (which silences every cross layer),
    are drawn from N(0, 1)."""
    from repro_torch.models import lm
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    for lp in params["units"]["layers"]:
        for k in ("gate_attn", "gate_mlp"):
            if k in lp:
                lp[k] = torch.randn(lp[k].shape, generator=g, device="cuda")
    return params


def family_frames(cfg):
    """(``FAMILY_BATCH``, n_frontend_tokens, d_model) bf16 N(0, 1)
    stubbed image embeddings or encoder frames on the card, as a bf16
    frontend emits them; None for a model without cross-attention.
    (fp32 embeddings give the prefill fp32 cross K/V against the decode
    steps' bf16 cross cache: the reference's design, which adds that
    rounding to the decode-vs-prefill reading.)"""
    if not cfg.n_frontend_tokens:
        return None
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    return randn_bf16(g, FAMILY_BATCH, cfg.n_frontend_tokens, cfg.d_model)


def path_launches(cfg) -> dict:
    """The attention launches of one one-shot run of ``cfg``: a prefill
    flash launch per causal self-attention layer, and per decode step a
    decode launch per self-attention and per cross-attention layer."""
    n_attn = cfg.n_units * len(cfg.unit_attn_layers)
    n_cross = cfg.n_units * sum(s.kind == "cross" or s.cross_attn
                                for s in cfg.pattern)
    return {"flash_attention": n_attn,
            "decode_attention": (NEW_TOKENS - 1) * (n_attn + n_cross)}


def family_phase(arch: str) -> dict:
    """``arch`` at full width and depth through ``FlexGenEngine.run(
    prompts, frames)`` under each of its placements in
    ``FAMILY_ARCHS``: ``FAMILY_BATCH`` prompts, ``NEW_TOKENS`` new
    tokens each.  Each run must launch ``path_launches`` and nothing
    else; the tokens must not depend on the placement; the last decode
    step must match a prefill (``decode_vs_prefill``).  Prints prefill
    ms, decode tok/s and the bytes placed on each memory kind, and, for
    Whisper, the encoder's own ms."""
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.offload import FlexGenEngine, ServeConfig
    cfg = get_config(arch)
    prompt, placements = FAMILY_ARCHS[arch]
    t0 = time.perf_counter()
    params = family_params(cfg)
    frames = family_frames(cfg)
    torch.cuda.synchronize()
    log(f"{arch} params ({cfg.n_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers"
           if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, vocab {cfg.vocab}): "
        f"{time.perf_counter() - t0:.1f} s, {memory()}")
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (FAMILY_BATCH, prompt)).astype(np.int32)
    want = path_launches(cfg)
    out, first, shapes = {}, None, Counter()
    for name, w_shares, kv_shares in placements:
        t0 = time.perf_counter()
        eng = FlexGenEngine(cfg, params, ServeConfig(
            max_new_tokens=NEW_TOKENS, prompt_len=prompt,
            weight_shares=w_shares, kv_shares=kv_shares), device="cuda")
        last = {}
        step = eng.decode_step

        def recording_step(*a, **kw):
            logits, cache = step(*a, **kw)
            last["logits"] = logits
            return logits, cache
        eng.decode_step = recording_step
        w_on = {k: sum(ta.bytes_on(k)
                       for ta in pytree.tree_leaves(eng.params_tiered))
                for k in ("device", "pinned_host")}
        torch.cuda.synchronize()
        build.reset_launches()
        st = eng.run(prompts, frames)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        shapes.update(build.SHAPE_LAUNCHES)
        secs = time.perf_counter() - t0
        kv_on = {k: eng.kv_home.bytes_on(k)
                 for k in ("device", "pinned_host", "unpinned_host")}
        label = f"{arch} {name}"
        log(f"family {label}: prefill={st.prefill_s * 1e3:.2f} ms "
            f"decode={st.decode_tok_s:.2f} tok/s (decode {st.decode_s:.3f}"
            f" s for {NEW_TOKENS - 1} steps x {FAMILY_BATCH}) weights on "
            f"{w_on} KV ledger {kv_on} launches "
            f"{ {k: v for k, v in launches.items() if v} } "
            f"(expected {want}) {secs:.1f} s, {memory()}")
        for kernel, n in want.items():
            if launches[kernel] != n:
                fail(f"family {label}: {launches[kernel]} {kernel} "
                     f"launches, expected {n}")
        others = {k: v for k, v in launches.items() if v and k not in want}
        if others:
            fail(f"family {label}: other kernels launched {others}")
        tokens = eng.tokens
        if tuple(tokens.shape) != (FAMILY_BATCH, NEW_TOKENS):
            fail(f"family {label}: tokens of shape {tuple(tokens.shape)}")
        if not torch.isfinite(last["logits"]).all():
            fail(f"family {label}: non-finite logits")
        if first is None:
            first = (tokens, last["logits"])
        elif not torch.equal(tokens, first[0]):
            bad = (tokens != first[0]).nonzero()[0].tolist()
            fail(f"family {label}: tokens differ from "
                 f"{placements[0][0]}'s first at (row, step) {bad}")
        else:
            log(f"family {label}: tokens equal {placements[0][0]}'s")
        out[name] = {"weight_shares": w_shares, "kv_shares": kv_shares,
                     "prefill_s": st.prefill_s, "decode_s": st.decode_s,
                     "decode_tok_s": st.decode_tok_s, "seconds": secs,
                     "weights_on": w_on, "kv_on": kv_on,
                     "launches": launches}
        del eng, step, recording_step, last
        gc.collect()
        torch.cuda.empty_cache()
    tokens, logits_d = first
    seq = torch.cat([torch.from_numpy(prompts).long().cuda(),
                     tokens[:, :-1]], dim=1)
    logits_p, _ = lm.prefill(params, cfg, seq, frames)
    if cfg.unit_rwkv_layers:
        # the recurrent state carries every step's bf16 rounding forward:
        # the last step's reading is printed; one step from a prefill
        # cache is held to the limit (recurrent_witness), and so is the
        # last step with the whole model in fp32 (recurrent_drift)
        out["last_step_vs_prefill"] = rel_err(logits_d, logits_p)
        log(f"family {arch}: last decode step vs prefill of "
            f"{seq.shape[1]} tokens: rel err "
            f"{out['last_step_vs_prefill']:.4g} ({NEW_TOKENS - 1} steps "
            "of the recurrence's bf16 rounding; held in fp32 below)")
        out["decode_vs_prefill"] = recurrent_witness(cfg, params, seq,
                                                     logits_p)
        out["drift"] = recurrent_drift(cfg, params, seq, prompt, logits_p)
    else:
        out["decode_vs_prefill"] = decode_vs_prefill(
            f"family {arch}", logits_d, logits_p, seq.shape[1])
    if frames is not None:
        out["cross_witness"] = cross_witness(cfg, params, seq, frames,
                                             logits_p)
    if cfg.encoder_layers:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                lm.encode(params, cfg, frames)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["encoder_ms"] = times
        log(f"family {arch}: encoder over {cfg.n_frontend_tokens} frames x "
            f"{FAMILY_BATCH}: {min(times):.2f} ms (of {times})")
    out["shape_launches"] = [[k, list(s), n] for (k, s), n in shapes.items()]
    return out


def recurrent_witness(cfg, params, seq, logits_p) -> dict:
    """Decode vs prefill for a recurrent model, one step at a time: from
    a prefill of ``seq`` but its last token, one decode step of the last
    token against ``logits_p``, the prefill of the whole ``seq``: below
    ``FLEXGEN_REL`` (argmax equal up to a near tie, as
    ``decode_vs_prefill`` reads it), and every planted state fault above
    it: the middle unit's wkv state lost, the token-shift states lost,
    and a state one token stale (the prefill cache of ``seq`` but its
    last two tokens)."""
    from repro_torch.models import lm

    def step(c):
        c = {k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}
        c["index"] = seq.shape[1] - 1
        return lm.decode_step(params, cfg, c, seq[:, -1:])[0]

    cache = lm.prefill(params, cfg, seq[:, :-1])[1]
    reading = decode_vs_prefill(f"family {cfg.name} one step",
                                step(cache), logits_p, seq.shape[1])
    lost = dict(cache, wkv=cache["wkv"].clone())
    lost["wkv"][cfg.n_units // 2] = 0
    shifts = dict(cache, shift_t=torch.zeros_like(cache["shift_t"]),
                  shift_c=torch.zeros_like(cache["shift_c"]))
    faults = {"wkv state of one unit lost": rel_err(step(lost), logits_p),
              "token-shift states lost": rel_err(step(shifts), logits_p),
              "state one token stale": rel_err(step(
                  lm.prefill(params, cfg, seq[:, :-2])[1]), logits_p)}
    log(f"family {cfg.name} planted state faults: "
        + " ".join(f"{k}={v:.4g}" for k, v in faults.items())
        + f" (limit {FLEXGEN_REL})")
    for name, r in faults.items():
        if not r > FLEXGEN_REL:
            fail(f"family {cfg.name}: the one-step check does not see the "
                 f"planted fault '{name}' (rel err {r:.4g})")
    return dict(reading, faults=faults)


@contextlib.contextmanager
def fp32_activations():
    """The model's activations in fp32 (with fp32 weights, the whole
    model): the token embeddings, which the model rounds to bf16, kept
    fp32, and the RWKV layers' token-shift states carried in the input's
    dtype, not rounded to the cache's bf16."""
    from repro_torch.models import lm
    from repro_torch.models import modules as M
    embed, tmix, cmix = lm._embed_tokens, M.rwkv_tmix_fwd, M.rwkv_cmix_fwd

    def tmix_fp32(p, x, dims, **kw):
        out, (state, _) = tmix(p, x, dims, **kw)
        return out, (state, x[:, -1])

    def cmix_fp32(p, x, shift_state=None):
        return cmix(p, x, shift_state)[0], x[:, -1]
    with mock.patch.object(lm, "_embed_tokens",
                           lambda *a, **kw: embed(*a, **kw).float()), \
            mock.patch.object(M, "rwkv_tmix_fwd", tmix_fp32), \
            mock.patch.object(M, "rwkv_cmix_fwd", cmix_fp32):
        yield


def recurrent_drift(cfg, params, seq, prompt: int, logits_p) -> dict:
    """Decode vs prefill for a recurrent model over the served run's
    steps, teacher-forced: from a prefill of ``seq``'s first ``prompt``
    tokens, the model decodes the rest of ``seq`` one token at a time,
    and after each of ``DRIFT_STEPS`` steps its logits are read against
    a prefill of the sequence so far.  In bf16, as served (printed), and
    with the whole model in fp32 (``fp32_activations``), where the last
    step must read below ``FLEXGEN_REL``: the witness that the bf16
    reading is each step's rounding carried forward in the state, not a
    fault of the recurrence."""
    from repro_torch.models import lm

    def readings(p, last):
        _, cache = lm.prefill(p, cfg, seq[:, :prompt])
        out = {}
        for i in range(prompt, seq.shape[1]):
            logits, cache = lm.decode_step(p, cfg, cache, seq[:, i:i + 1])
            n = i + 1 - prompt
            if n in DRIFT_STEPS:
                want = (last if i + 1 == seq.shape[1]
                        else lm.prefill(p, cfg, seq[:, :i + 1])[0])
                out[n] = rel_err(logits, want)
        return out

    with torch.no_grad():
        out = {"bf16": readings(params, logits_p)}
        p32 = lm.tree_map(lambda t: t.float(), params)
        with fp32_activations():
            out["fp32"] = readings(p32, lm.prefill(p32, cfg, seq)[0])
        del p32
    torch.cuda.empty_cache()
    log(f"family {cfg.name} teacher-forced decode vs prefill after steps "
        + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.4g}" for n, v in r.items())
                    for k, r in out.items())
        + f" (fp32's last step held to {FLEXGEN_REL})")
    last = out["fp32"][max(DRIFT_STEPS)]
    if not last < FLEXGEN_REL:
        fail(f"family {cfg.name}: fp32 decode vs prefill after "
             f"{max(DRIFT_STEPS)} steps rel err {last:.4g}")
    return out


def cross_witness(cfg, params, seq, frames, logits_p) -> dict:
    """What the decode-vs-prefill check sees on the cross-attention path.
    From a prefill of ``seq`` but its last token over ``frames``, one
    decode step of the last token is held against ``logits_p``, the
    prefill of the whole ``seq``: on the kernels (as
    ``decode_vs_prefill`` reads it); on the plain attention of
    ``kernels.ref`` for both the prefill and the step (printed: the part
    of the reading that the bf16 model makes without any kernel); and
    under planted cross-cache faults, each of which must read above
    ``FLEXGEN_REL``: every cross layer reading the next unit's cross
    K/V, the cross cache left at zero, and the cross ``kv_len`` set to
    the self-attention's.  The cross ``kv_len`` one short (one of the
    S_enc frames lost) is printed beside them."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    idx, S_enc = seq.shape[1] - 1, frames.shape[1]

    def cache_of(c):
        return dict(c, **{k: torch.nn.functional.pad(
            c[k], (0, 0, 0, 0, 0, 1)) for k in ("kv_k", "kv_v")})

    def step(c):
        c = {k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}
        return lm.decode_step(params, cfg, c, seq[:, -1:])[0]

    dec = ops.decode_attention

    def cross_len(fn):
        """``ops.decode_attention`` with the cross layers' kv_len
        ``fn(kv_len)``; a self-attention cache is shorter than S_enc."""
        return mock.patch.object(
            ops, "decode_attention", lambda q, k, v, n: dec(
                q, k, v, fn(n) if k.shape[1] == S_enc else n))

    with torch.no_grad():
        cache = cache_of(lm.prefill(params, cfg, seq[:, :-1], frames)[1])
        reading = decode_vs_prefill(f"family {cfg.name} one step",
                                    step(cache), logits_p, seq.shape[1])
        with mock.patch.object(ops, "flash_attention",
                               ref.flash_attention), \
                mock.patch.object(ops, "decode_attention",
                                  ref.decode_attention):
            plain_p = lm.prefill(params, cfg, seq, frames)[0]
            plain = rel_err(step(cache_of(lm.prefill(
                params, cfg, seq[:, :-1], frames)[1])), plain_p)
        faults = {
            "next unit's cross K/V": rel_err(step(dict(
                cache, cross_k=cache["cross_k"].roll(1, 0),
                cross_v=cache["cross_v"].roll(1, 0))), logits_p),
            "cross cache zero": rel_err(step(dict(
                cache, cross_k=torch.zeros_like(cache["cross_k"]),
                cross_v=torch.zeros_like(cache["cross_v"]))), logits_p)}
        with cross_len(lambda n: torch.full_like(n, idx + 1)):
            faults["cross kv_len = self's"] = rel_err(step(cache), logits_p)
        with cross_len(lambda n: n - 1):
            one_short = rel_err(step(cache), logits_p)
    log(f"family {cfg.name} cross witness (one step at index {idx} over "
        f"{S_enc} frames): plain attention {plain:.4g}; planted faults: "
        + " ".join(f"{k}={v:.4g}" for k, v in faults.items())
        + f" (limit {FLEXGEN_REL}); cross kv_len - 1 {one_short:.4g} "
        "(not held)")
    for name, r in faults.items():
        if not r > FLEXGEN_REL:
            fail(f"family {cfg.name}: the one-step check does not see the "
                 f"planted fault '{name}' (rel err {r:.4g})")
    return dict(reading, plain=plain, faults=faults,
                cross_kv_len_one_short=one_short)


def greedy_run(cfg, params, prompts, device) -> tuple:
    """One-shot greedy tokens of ``cfg`` on ``device``, each step's top-2
    logit margin per row ((B, NEW_TOKENS) each), and the prefill's
    logits (on the CPU)."""
    from repro_torch.offload import FlexGenEngine, ServeConfig
    eng = FlexGenEngine(cfg, params, ServeConfig(
        max_new_tokens=NEW_TOKENS, prompt_len=prompts.shape[1]),
        device=device)
    margins, first = [], []

    def recording(fn):
        def run(*a, **kw):
            logits, cache = fn(*a, **kw)
            if not first:
                first.append(logits.float().cpu())
            top = torch.topk(logits.float(), 2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu())
            return logits, cache
        return run
    eng.prefill_step = recording(eng.prefill_step)
    eng.decode_step = recording(eng.decode_step)
    eng.run(prompts)
    return eng.tokens.cpu(), torch.stack(margins, dim=1), first[0]


def jamba_smoke_phase() -> dict:
    """jamba's smoke variant (Mamba-2, MoE and attention layers),
    widened to head_dim 64 for the attention kernels and cut to one unit
    (its whole 8-layer pattern), one-shot on the card (kernels) and on
    the CPU (plain versions) from the same weights: each row's tokens
    must agree up to its first near tie (a top-2 margin below
    ``NEAR_TIE`` on the card).  At two units (the smoke variant's depth)
    rounding alone parts the logits further than a near tie: the stacked
    Mamba blocks amplify it, and the MoE routing flips on it.  The
    prefill logits of two units, card against CPU, are printed beside
    the one unit's; the JAX package's own compiled and op-by-op runs of
    two units part further still on the CPU (``tests/
    test_torch_families.py::test_jamba_reference_rounding_spread``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.models import lm
    smoke = get_smoke_config(JAMBA_ARCH)
    cfg = dataclasses.replace(smoke, head_dim=64,
                              n_layers=len(smoke.pattern))
    cpu = lm.init_params(cfg, seed=SEED, device="cpu")
    gpu = lm.tree_map(lambda t: t.cuda(), cpu)
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (FAMILY_BATCH, JAMBA_SMOKE_PROMPT)).astype(np.int32)
    want_toks, _, want_logits = greedy_run(cfg, cpu, prompts, "cpu")
    build.reset_launches()
    toks, margins, logits = greedy_run(cfg, gpu, prompts, "cuda")
    prefill_rel = rel_err(logits, want_logits)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = path_launches(cfg)
    if {k: launches[k] for k in want} != want:
        fail(f"jamba smoke: launches {launches}, expected {want}")
    ties = []
    for r in range(FAMILY_BATCH):
        diff = (toks[r] != want_toks[r]).nonzero().flatten().tolist()
        if not diff:
            continue
        m = margins[r, diff[0]].item()
        if m >= NEAR_TIE:
            fail(f"jamba smoke: row {r} differs from the CPU's at step "
                 f"{diff[0]} with a top-2 margin of {m:.4g}")
        ties.append({"row": r, "step": diff[0], "margin": m})
    two = dataclasses.replace(cfg, n_layers=2 * len(smoke.pattern))
    cpu = lm.init_params(two, seed=SEED, device="cpu")
    toks = torch.from_numpy(prompts).long()
    with torch.no_grad():
        two_rel = rel_err(lm.prefill(lm.tree_map(lambda t: t.cuda(), cpu),
                                     two, toks.cuda())[0].cpu(),
                          lm.prefill(cpu, two, toks)[0])
    del cpu
    log(f"jamba smoke (head_dim 64, one unit) card vs CPU: prefill logits "
        f"rel err {prefill_rel:.4g} (two units: {two_rel:.4g}, not held); "
        f"{FAMILY_BATCH - len(ties)}/"
        f"{FAMILY_BATCH} rows identical, near ties {ties}, smallest "
        f"margin {margins.min().item():.4g}, "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return {"ties": ties, "launches": launches, "prefill_rel": prefill_rel,
            "two_units_prefill_rel": two_rel,
            "min_margin": margins.min().item()}


def mamba_layer_phase() -> dict:
    """jamba's Mamba-2 layer alone at full width (d_model 8192, d_inner
    16384, 256 heads of 64, d_state 16, chunk 128): ``mamba_fwd``'s
    chunked scan over ``FAMILY_BATCH`` x ``MAMBA_PROMPT`` tokens, then
    ``NEW_TOKENS`` one-token steps from its states, against one chunked
    scan of all the tokens; y and the final ssm state within the
    reference test's chunk-vs-step limit (``MAMBA_TOL`` absolute plus
    relative).  Prints the prefill's ms and one step's."""
    from repro_torch.configs import get_config
    from repro_torch.models import modules as M
    cfg = get_config(JAMBA_ARCH)
    dims = M.mamba_dims(cfg.d_model, cfg.mamba_expand, cfg.mamba_head_dim,
                        cfg.mamba_d_state, cfg.mamba_d_conv, cfg.ssd_chunk)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    p = M.init_mamba(dims, g, "cuda")
    P, n = MAMBA_PROMPT, NEW_TOKENS
    x = randn_bf16(g, FAMILY_BATCH, P + n, cfg.d_model)
    with torch.no_grad():
        prefill_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_pre, (cs, ss) = M.mamba_fwd(p, x[:, :P], dims)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        ys = []
        t0 = time.perf_counter()
        for t in range(P, P + n):
            y, (cs, ss) = M.mamba_fwd(p, x[:, t:t + 1], dims,
                                      conv_state=cs, ssm_state=ss)
            ys.append(y)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        y_full, (_, ss_full) = M.mamba_fwd(p, x, dims)
    errs = {}
    for name, got, want in (("y steps", torch.cat(ys, dim=1),
                             y_full[:, P:]),
                            ("y prefill", y_pre, y_full[:, :P]),
                            ("ssm state", ss, ss_full)):
        g_, w_ = got.float(), want.float()
        if not torch.isfinite(g_).all():
            fail(f"mamba layer: non-finite {name}")
        excess = ((g_ - w_).abs() - MAMBA_TOL * w_.abs()).max().item()
        errs[name] = {"max_abs_err": (g_ - w_).abs().max().item(),
                      "max_abs": w_.abs().max().item(), "excess": excess}
        if excess > MAMBA_TOL:
            fail(f"mamba layer: {name} off by more than {MAMBA_TOL} + "
                 f"{MAMBA_TOL} |want| (excess {excess:.4g})")
    log(f"mamba layer (d_inner {dims.d_inner}, {dims.n_heads} heads, "
        f"chunk {dims.chunk}) over {FAMILY_BATCH} x {P} tokens: prefill "
        f"{prefill_ms[-1]:.2f} ms (first {prefill_ms[0]:.2f}), one step "
        f"{step_ms:.3f} ms; chunk vs step: "
        + " ".join(f"{k} max_abs_err={v['max_abs_err']:.3g} "
                   f"(|want| <= {v['max_abs']:.3g})"
                   for k, v in errs.items()) + f", {memory()}")
    return {"prefill_ms": prefill_ms, "step_ms": step_ms, "errors": errs}


def int8_phase() -> dict:
    """An int8 KV cache at the model level on the card: llama3-8b's
    smoke variant (widened to head_dim 64 for the kernels) with
    ``kv_cache_dtype="int8"``: prefill, the caches and scales padded by
    8 positions, one decode step (over the dequantized cache, through
    the decode kernel) against a prefill of the longer sequence, rel
    below ``INT8_REL`` (the reference test's limit)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              kv_cache_dtype="int8", head_dim=64)
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (2, 32))).cuda()
    build.reset_launches()
    logits_p, cache = lm.prefill(params, cfg, toks)
    for k in ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale"):
        pad = [0, 0] * (cache[k].dim() - 4) + [0, 8]
        cache[k] = torch.nn.functional.pad(cache[k], pad)
    nxt = torch.argmax(logits_p, -1)[:, None]
    logits_d, _ = lm.decode_step(params, cfg, cache, nxt)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    n_attn = cfg.n_units * len(cfg.unit_attn_layers)
    if (launches["flash_attention"], launches["decode_attention"]) != \
            (n_attn, n_attn):
        fail(f"int8: launches {launches}, expected {n_attn} of each")
    if cache["kv_k"].dtype != torch.int8:
        fail(f"int8: cache of {cache['kv_k'].dtype}")
    logits_full, _ = lm.prefill(params, cfg, torch.cat([toks, nxt], 1))
    rel = rel_err(logits_d, logits_full)
    log(f"int8 KV (llama3-8b smoke, head_dim 64): one decode step vs "
        f"prefill rel err {rel:.4g} (limit {INT8_REL}), launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not rel < INT8_REL:
        fail(f"int8: decode vs prefill rel err {rel:.4g}")
    return {"rel_err": rel, "launches": launches}


def families_phase() -> dict:
    """The other model families: vision, RWKV6 and Whisper at full width
    and depth (one model's weights on the card at a time), jamba's smoke
    variant and its full-width Mamba layer, and an int8 KV cache."""
    out = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out[arch] = family_phase(arch)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"family {arch}: {time.perf_counter() - t0:.1f} s, {memory()}")
    for name, phase in (("jamba smoke", jamba_smoke_phase),
                        ("mamba layer", mamba_layer_phase),
                        ("int8", int8_phase)):
        t0 = time.perf_counter()
        out[name] = phase()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s, {memory()}")
    return out


PROFILE_GROUPS = (("port kernels", ("decode_split_kernel",
                                     "decode_merge_kernel",
                                     "paged_decode_split_kernel",
                                     "paged_decode_merge_kernel",
                                     "flash_attention_kernel",
                                     "expert_up_kernel",
                                     "expert_down_kernel")),
                  ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas")),
                  ("copy", ("memcpy", "copy")))


def profiled(label: str, run) -> dict:
    """``run()`` under torch.profiler: device time by category
    (``PROFILE_GROUPS``), the top kernels, and the device's idle share
    of the run's wall time.  Returns {} where the profiler saw no device
    time."""
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, memcpy, memset): the host ops
    # that launched them report the same time again
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        log(f"profile {label}: the profiler saw no device time")
        return {}
    cats = {name: 0.0 for name, _ in PROFILE_GROUPS}
    cats["other"] = 0.0
    port = []
    for key, sec, n in rows:
        low = key.lower()
        name = next((g for g, keys in PROFILE_GROUPS
                     if any(k in low for k in keys)), "other")
        cats[name] += sec
        if name == "port kernels":
            port.append((key, sec, n))
    rows.sort(key=lambda r: -r[1])
    log(f"profile {label}: wall={wall:.3f} s device_busy={busy:.3f} s "
        f"idle_share={1.0 - busy / wall:.3f} iterations={iterations} "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in cats.items()))
    for key, sec, n in rows[:8]:
        log(f"  {sec * 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
    for key, sec, n in port:
        log(f"  port kernel {sec * 1e3:8.3f} ms  {n:6d}x  {key[:70]}")
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "iterations": iterations, "categories_s": cats,
            "top": rows[:15], "port_kernels": port}


def profile_phase(cfg, params) -> dict:
    """Where a serve run's time goes (``--profile``): one torch.profiler
    trace over a short run of each path (4 requests, prompts 512 and
    256, 8 new tokens) and, for ``FLEXGEN_ARCH``, over a one-shot run
    (all on the device, ``FLEXGEN_BATCH`` prompts of ``FLEXGEN_PROMPT``,
    8 new tokens); device time by category and the device's idle share
    of the run's wall time."""
    out = {}
    for fused in (False, True):
        label = "fused" if fused else "staged"
        eng = serve(cfg, params, prompts_for(cfg, 4, PROMPTS), 8, "cuda",
                    fused_gather=fused)

        def run():
            eng.run()
            return eng._step
        got = profiled(f"{cfg.name} {label}", run)
        if got:
            out[label] = got
    if cfg.name == FLEXGEN_ARCH:
        from repro_torch.offload import FlexGenEngine, ServeConfig
        eng = FlexGenEngine(cfg, params, ServeConfig(
            max_new_tokens=8, prompt_len=FLEXGEN_PROMPT), device="cuda")
        prompts = np.random.RandomState(SEED).randint(
            0, cfg.vocab, (FLEXGEN_BATCH, FLEXGEN_PROMPT)).astype(np.int32)

        def run():
            eng.run(prompts)
            return 8
        got = profiled(f"{cfg.name} one-shot", run)
        if got:
            out["one-shot"] = got
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
        out["control planes"] = control_planes_phase(
            f"{arch} staged, control planes", cfg, params, prompts,
            out["staged"])
    if arch == CLUSTER_ARCH:
        t0 = time.perf_counter()
        out["cluster"] = cluster_phase(
            f"{arch} cluster x{CLUSTER_REPLICAS}", cfg, params, prompts,
            out["staged"])
        log(f"cluster {arch}: {time.perf_counter() - t0:.1f} s, "
            f"{memory()}")
    if arch == FLEXGEN_ARCH:
        t0 = time.perf_counter()
        flex = flexgen_phase(cfg, params)
        out.update({f"flexgen {k}": v for k, v in flex.items()})
        log(f"flexgen {arch}: {time.perf_counter() - t0:.1f} s, "
            f"{memory()}")
        t0 = time.perf_counter()
        out.update(analysis_serve_phase(cfg, params))
        log(f"analysis {arch}: {time.perf_counter() - t0:.1f} s, "
            f"{memory()}")
    if arch == EXPERT_ARCH:
        out["experts"] = experts_phase(f"{arch} fused, experts", cfg,
                                       params, prompts, out["fused"])
    if profile:
        out["profile"] = profile_phase(cfg, params)
    return out


# ---------------------------------------------------------------------- #
# analysis phase: whole steps against their roofline bound                #
# ---------------------------------------------------------------------- #
def fake_cpu(tree, mode):
    """``tree`` with each tensor as a fake CPU tensor of its shape and
    dtype under ``mode``, except 0-d ones (AdamW's step count, read on
    the host), which stay real, copied to the CPU."""
    import torch.utils._pytree as pytree

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dim() == 0:
            return t.detach().cpu()
        with mode:
            return torch.empty(t.shape, dtype=t.dtype)
    return pytree.tree_map(one, tree)


def step_analysis(label: str, cfg, fn, args, shape, want: dict,
                  check) -> dict:
    """One whole step ``fn(*args)`` on the card against its roofline
    bound: ``launch.jaxpr_cost.walk`` over fake CPU tensors of the same
    shapes gives its FLOPs and bytes, ``hlo_analysis.roofline_terms``
    the bound (the larger of the compute and memory terms).  One real
    step under ``FlopCounterMode`` must count the walker's matrix-product
    FLOPs outside the kernel leaves within ``FLOP_MATCH`` (the ctypes
    kernels are invisible to it); then ``ANALYSIS_WARMUP`` calls and
    ``ANALYSIS_CALLS`` calls each timed with CUDA events, whose median
    must not be below the bound.  Each call must launch ``want``
    (kernel -> launches per call) and nothing else; ``check(out)``
    fails on a wrong output."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import build
    from repro_torch.launch import hlo_analysis as HLO
    from repro_torch.launch import jaxpr_cost as JC
    t0 = time.perf_counter()
    w = JC.walk(fn, *fake_cpu(args, FakeTensorMode()))
    trace_s = time.perf_counter() - t0
    roof = HLO.roofline_terms(w.flops, w.bytes, HLO.CollectiveStats(), 1,
                              HLO.model_flops_estimate(cfg, shape))
    bound_ms = max(roof.compute_s, roof.memory_s) * 1e3
    binds = "compute" if roof.compute_s >= roof.memory_s else "memory"

    build.reset_launches()
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
        torch.cuda.synchronize()
    check(out)
    card_flops, dots = fc.get_total_flops(), JC.dot_flops(w)
    if abs(card_flops - dots) > FLOP_MATCH * dots:
        fail(f"analysis {label}: FlopCounterMode counts {card_flops} FLOPs "
             f"on the card, the walker {dots:.0f} outside its kernel leaves")
    for _ in range(ANALYSIS_WARMUP):
        out = None
        out = fn(*args)
    events = []
    for _ in range(ANALYSIS_CALLS):
        out = None
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    check(out)
    del out
    launches = dict(build.LAUNCHES)
    calls = 1 + ANALYSIS_WARMUP + ANALYSIS_CALLS
    for name, n in want.items():
        if launches[name] != n * calls:
            fail(f"analysis {label}: {launches[name]} {name} launches over "
                 f"{calls} calls, expected {n} per call")
    others = {k: v for k, v in launches.items() if v and k not in want}
    if others:
        fail(f"analysis {label}: other kernels launched {others}")
    times = [s.elapsed_time(e) for s, e in events]
    ms = statistics.median(times)
    if ms < bound_ms:
        fail(f"analysis {label}: {ms:.4f} ms measured, faster than its "
             f"bound {bound_ms:.4f} ms: the count is wrong")
    row = {"ms": ms, "times_ms": times, "bound_ms": bound_ms,
           "binds": binds, "fraction": bound_ms / ms,
           "compute_ms": roof.compute_s * 1e3,
           "memory_ms": roof.memory_s * 1e3, "flops": w.flops,
           "bytes": w.bytes, "leaf_flops": JC.leaf_flops(w),
           "dot_flops": dots, "card_dot_flops": card_flops,
           "by_rule": w.by_rule, "model_flops": roof.model_flops,
           "trace_s": trace_s, "launches": launches}
    log(f"analysis {label}: {ms:.4f} ms (median of {ANALYSIS_CALLS}) vs "
        f"bound {bound_ms:.4f} ms ({binds}: {w.flops / 1e12:.4f} TFLOP, "
        f"{w.bytes / 1e9:.4f} GB) = {bound_ms / ms:.3f} of the bound; "
        f"FlopCounterMode {card_flops} vs walker {dots:.0f} dot FLOPs "
        f"(+{JC.leaf_flops(w):.0f} in kernel leaves); trace {trace_s:.1f} s;"
        f" launches {launches} (counted in the kernels line's rows of "
        "these shapes)")
    return row


def analysis_serve_phase(cfg, params) -> dict:
    """The analysis phase's serving steps on ``FLEXGEN_ARCH``'s weights
    on the card, at the one-shot phase's shapes: ``make_prefill_step``
    over ``FLEXGEN_BATCH`` x ``FLEXGEN_PROMPT`` tokens (``flash_attention``
    on every layer), then ``make_serve_step`` over that prefill's cache
    padded to the ``pad_to`` of ``NEW_TOKENS`` (index ``FLEXGEN_PROMPT``;
    ``decode_attention`` on every layer).  Both are one-shot rows'
    launches (``"oneshot"``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import lm
    B, L = FLEXGEN_BATCH, FLEXGEN_PROMPT
    layers = cfg.n_units * len(cfg.pattern)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=gen,
                                     device="cuda", dtype=torch.int32)}

    def logits_ok(name):
        def check(out):
            if tuple(out[0].shape) != (B, cfg.vocab) \
                    or not torch.isfinite(out[0]).all():
                fail(f"analysis {name}: logits of shape "
                     f"{tuple(out[0].shape)}, finite "
                     f"{bool(torch.isfinite(out[0]).all())}")
        return check

    out = {}
    prefill = steps.make_prefill_step(cfg)
    out["analysis prefill"] = step_analysis(
        f"{cfg.name} prefill {B}x{L}", cfg, prefill, (params, batch),
        ShapeConfig("analysis_prefill", L, B, "prefill"),
        {"flash_attention": layers}, logits_ok("prefill"))
    _, pcache = prefill(params, batch)
    cache = lm.make_decode_cache(cfg, B, L + NEW_TOKENS, device="cuda")
    for k, t in pcache.items():
        if k != "index":
            cache[k][:, :, :, :L] = t
    cache["index"] = L
    del pcache
    tokens = batch["tokens"][:, -1:]
    out["analysis decode"] = step_analysis(
        f"{cfg.name} decode B={B} cache {L + NEW_TOKENS} index {L}", cfg,
        steps.make_serve_step(cfg), (params, cache, tokens),
        ShapeConfig("analysis_decode", L, B, "decode"),
        {"decode_attention": layers}, logits_ok("decode"))
    for row in out.values():
        row["oneshot"] = True
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def analysis_train_phase(cfg, params) -> dict:
    """The analysis phase's train step: ``make_train_step`` of
    ``TRAIN_ARCH`` with everything on the card (the weights the train
    phase used, a fresh fp32 AdamW state, ``use_fused_kernel``: one
    ``fused_adam`` per leaf) over ``TRAIN_BATCH`` x ``ANALYSIS_TRAIN_SEQ``
    tokens.  Each call starts from the same weights and state."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    acfg = adam.AdamConfig(lr=launcher_lr(cfg.name), use_fused_kernel=True)
    opt = adam.init_state(params, acfg)
    b = next(DataIterator(DataConfig(vocab=cfg.vocab,
                                     seq_len=ANALYSIS_TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH, seed=SEED)))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in b.items()}

    def loss_ok(out):
        if not math.isfinite(float(out[2])):
            fail(f"analysis train: non-finite loss {float(out[2])}")

    row = step_analysis(
        f"{cfg.name} train {TRAIN_BATCH}x{ANALYSIS_TRAIN_SEQ}", cfg,
        steps.make_train_step(cfg, acfg), (params, opt, batch),
        ShapeConfig("analysis_train", ANALYSIS_TRAIN_SEQ, TRAIN_BATCH,
                    "train"),
        {"fused_adam": n_leaves(params)}, loss_ok)
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    return row


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
    t0 = time.perf_counter()
    out["analysis train"] = analysis_train_phase(cfg, params)
    log(f"analysis {arch}: {time.perf_counter() - t0:.1f} s, {memory()}")
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


def launcher_lr(arch: str) -> float:
    """The launcher's ``--lr`` at ``arch``'s full width: AdamW's default
    rate scaled by the smoke width over the full one (``train_engine``);
    the launcher's own default (3e-3) diverges at full width."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.optim import AdamConfig
    return AdamConfig.lr * get_smoke_config(arch).d_model \
        / get_config(arch).d_model


def run_launcher(argv) -> tuple:
    """``launch.train`` on ``argv``, the launch counters set to 0 just
    before; returns (its ``TrainRun``, launches, wall s, its standard
    output, which is also echoed)."""
    import io

    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(argv)
    build.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = train_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    return res, dict(build.LAUNCHES), wall, text


def prefetch_check(leaves) -> dict:
    """``TieredArray.prefetch_blocks`` on the card: the largest leaf of
    the launcher's optimizer state, re-placed in 8 blocks alternating
    pinned and pageable host memory, streamed to the device while each
    block is reduced on the current stream; the blocks must come out in
    order and equal the leaf.  The stream's time is printed beside that
    of ``gather`` and one reduction of the same blocks."""
    from repro_torch.core import TieredArray
    ta = max((ta for ta, _ in leaves), key=lambda t: t.nbytes)
    x = ta.gather()
    rows = math.ceil(x.shape[0] / 8)
    host = TieredArray.place(x, [("pinned_host", 0.5),
                                 ("unpinned_host", 0.5)], rows,
                             device="cuda")
    times = {}
    for name, fn in (("prefetch", lambda: [b.sum() for b in
                                           host.prefetch_blocks()]),
                     ("gather", lambda: host.gather().sum())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    got = torch.cat(list(host.prefetch_blocks()))
    if not torch.equal(got, x.reshape(got.shape)):
        fail("prefetch_blocks: the streamed blocks differ from the leaf")
    log(f"prefetch_blocks: {len(host.blocks)} blocks of {x.nbytes / 1e6:.1f}"
        f" MB ({host.kinds}) equal the leaf; streamed {times['prefetch']:.4f}"
        f" s, gathered {times['gather']:.4f} s")
    return {"nbytes": x.nbytes, "kinds": host.kinds, **times}


def launcher_phase() -> dict:
    """``launch.train --adaptive`` on ``LAUNCHER_ARCH`` at full width and
    depth: the fp32 optimizer state starts on pinned host memory in a
    ``TieredStateStore`` and the replanner's moves copy its blocks to
    the card.  At least one replan must be applied beyond the initial
    plan and move bytes; every block must sit on the kind its tier label
    names; the ledger must hold the store's bytes, its fast share within
    0.05 of the plan's; the trace, metrics and audit report must read
    back non-empty; the loss at the last step must be below step 0's; no
    hand-written kernel may launch (the launcher's step is the plain
    AdamW and attention, as the reference's)."""
    from repro_torch.obs import TraceRecorder
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        arts = {n: str(Path(tmp) / n) for n in ("t.jsonl", "m.prom",
                                                 "a.json")}
        res, launches, wall, text = run_launcher([
            "--arch", LAUNCHER_ARCH, "--steps", str(LAUNCHER_STEPS),
            "--batch", "8", "--seq", "128", "--adaptive",
            "--replan-every", "2", "--lr", repr(launcher_lr(LAUNCHER_ARCH)),
            "--trace-out", arts["t.jsonl"], "--metrics-out", arts["m.prom"],
            "--audit-out", arts["a.json"]])
        events = TraceRecorder.read_jsonl(arts["t.jsonl"])
        prom = Path(arts["m.prom"]).read_text()
        audit = json.loads(Path(arts["a.json"]).read_text())
    peak = torch.cuda.max_memory_allocated()
    telem, label = res.telem, f"launcher {LAUNCHER_ARCH}"
    prefetch = prefetch_check(telem.store.leaves(telem.OPT_OBJ))
    if any(launches.values()):
        fail(f"{label}: hand-written kernels launched {launches}")
    moved = [d for d in telem.replanner.decisions
             if d.applied and d.reason != "initial" and d.moved_bytes > 0]
    if not moved:
        fail(f"{label}: no replan beyond the initial one moved bytes")
    led, store, obj = telem.ledger, telem.store, telem.OPT_OBJ
    if led.counters.migrated_bytes <= 0:
        fail(f"{label}: the ledger recorded no migrated bytes")
    kinds = {"device": 0, "pinned_host": 0, "unpinned_host": 0}
    for ta, labels in store.leaves(obj):
        for blk, kind, tier in zip(ta.blocks, ta.kinds, labels):
            where = ("device" if blk.is_cuda else
                     "pinned_host" if blk.is_pinned() else "unpinned_host")
            if kind != store._kind(tier) or where != kind:
                fail(f"{label}: a block labelled {tier} is on {where} "
                     f"(kind {kind})")
            kinds[where] += blk.nbytes
    place = led.placement(telem.tenant, obj)
    if sum(place.values()) != store.nbytes(obj):
        fail(f"{label}: ledger {place} != store {store.nbytes(obj)} bytes")
    plan_fast = telem.replanner.plan.fraction_on(obj, telem.fast)
    got_fast = telem.opt_bytes_on(telem.fast) / store.nbytes(obj)
    if abs(got_fast - plan_fast) > 0.05:
        fail(f"{label}: fast share {got_fast:.3f}, plan {plan_fast:.3f}")
    if not events or "# TYPE" not in prom or not audit.get("audit"):
        fail(f"{label}: an artifact read back empty")
    losses = res.losses
    last = LAUNCHER_STEPS - 1
    if not all(math.isfinite(x) for x in losses.values()) \
            or not losses[last] < losses[0]:
        fail(f"{label}: losses {losses}")
    tiers = {k: (t.peak_bw_GBps, t.capacity_GiB)
             for k, t in telem.replanner.tiers.items()}
    log(f"{label}: wall={wall:.2f} s step_s="
        + " ".join(f"{res.step_s[i]:.3f}" for i in sorted(res.step_s))
        + f" losses={[round(losses[i], 5) for i in sorted(losses)]} "
        f"replans applied={telem.replanner.replans_applied}/"
        f"{len(telem.replanner.decisions)} moved "
        f"{[(d.epoch, d.moved_bytes) for d in moved]} "
        f"migrated_bytes={led.counters.migrated_bytes} placement={place} "
        f"fast share {got_fast:.4f} (plan {plan_fast:.4f}) blocks by kind "
        f"{kinds} planning tiers (GB/s, GiB) {tiers} "
        f"max_memory_allocated={peak / 2**30:.2f} GiB; artifacts: "
        f"{len(events)} trace events, {prom.count('# TYPE')} series, "
        f"audit models {sorted(audit['audit'].get('models', {}))}")
    out = {"wall_s": wall, "step_s": res.step_s, "losses": losses,
           "launches": launches, "moved": [(d.epoch, d.moved_bytes)
                                           for d in moved],
           "migrated_bytes": led.counters.migrated_bytes,
           "placement": place, "fast_share": got_fast,
           "plan_fast_share": plan_fast, "blocks_by_kind": kinds,
           "planning_tiers": tiers, "peak_bytes": peak,
           "prefetch": prefetch}
    del res, telem, store, led
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launcher_profile() -> dict:
    """Where a launcher step's time goes (``--profile``): the train step
    the launcher runs (``launch.steps.make_train_step``, plain AdamW) on
    ``LAUNCHER_ARCH`` at full size, batches of 8 x 128, one warm-up
    step, then two steps under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, init_state
    cfg = get_config(LAUNCHER_ARCH)
    acfg = AdamConfig(lr=launcher_lr(LAUNCHER_ARCH))
    state = {"params": lm.init_params(cfg, seed=SEED, device="cuda")}
    state["opt"] = init_state(state["params"], acfg)
    step = steps.make_train_step(cfg, acfg)
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=128,
                                 global_batch=8))

    def one():
        b = next(it)
        state["params"], state["opt"], loss = step(
            state["params"], state["opt"],
            {k: torch.from_numpy(b[k]).cuda() for k in ("tokens", "labels")})
        return float(loss)

    one()

    def run():
        one()
        one()
        return 2
    out = profiled(f"launcher step {LAUNCHER_ARCH}", run)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def checkpoint_phase() -> dict:
    """Checkpoints through the launcher on ``CKPT_ARCH`` at full width
    and depth: run A takes 4 steps, checkpointing every 2; run B resumes
    from A's directory to step 6 and must print ``restored step 4``; run
    C takes the 6 steps uninterrupted in a fresh directory.  B's losses
    at steps 4-5 must equal C's within ``CKPT_RTOL`` relative (rounding
    headroom; the CPU tests ask for equality).  Every save and restore
    is timed; a restore verifies every leaf's checksum.  Before B, A's
    last checkpoint is resumed to step 6 under each planted restore
    fault (the optimizer's m and v lost, its step counter lost, the data
    iterator left at step 0; nothing saved), and each must part from C's
    losses by more than ``CKPT_RTOL``.  Runs resume from A's last
    checkpoint, never from a periodic one: as in the reference, the
    checkpoint taken every ``--ckpt-every`` steps at step i holds the
    state after step i's update, so a resume from it takes step i
    again."""
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as train_cli
    saves, restores = [], []
    save, restore = store.save, store.restore

    def timed_save(ckpt_dir, step, tree, *a, **kw):
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, tree, *a, **kw)
        nbytes = sum(p.stat().st_size for p in Path(path).iterdir())
        saves.append((step, nbytes, time.perf_counter() - t0))
        return path

    def timed_restore(ckpt_dir, target, *a, **kw):
        t0 = time.perf_counter()
        got = restore(ckpt_dir, target, *a, **kw)
        torch.cuda.synchronize()
        step = store.latest_step(ckpt_dir)
        manifest = json.loads((Path(ckpt_dir) / f"step_{step:08d}"
                               / "manifest.json").read_text())
        restores.append((step, len(manifest["leaves"]),
                         kw.get("verify", True), time.perf_counter() - t0))
        return got

    lr = repr(launcher_lr(CKPT_ARCH))
    base = ["--arch", CKPT_ARCH, "--batch", "8", "--seq", "128",
            "--ckpt-every", "2", "--lr", lr]
    label = f"checkpoint {CKPT_ARCH}"
    store.save, store.restore = timed_save, timed_restore
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ab, c = str(Path(tmp) / "ab"), str(Path(tmp) / "c")
            runs, faulty = {}, {}

            def launch(name, steps, d):
                runs[name] = run_launcher(
                    base + ["--steps", str(steps), "--ckpt-dir", d])
                log(f"{label} run {name}: {runs[name][2]:.1f} s, "
                    f"{memory()}")
            launch("A", 4, ab)
            # A's last checkpoint under each planted fault, saving nothing
            store.save, store.restore = (lambda *a, **kw: None), restore
            for name, patch in planted_restore_faults(restore, train_cli):
                with patch:
                    faulty[name] = run_launcher(
                        base + ["--steps", "6", "--ckpt-dir", ab])[0]
            store.save, store.restore = timed_save, timed_restore
            launch("B", 6, ab)
            if "restored step 4" not in runs["B"][3]:
                fail(f"{label}: run B did not print 'restored step 4'")
            shutil.rmtree(ab)
            launch("C", 6, c)
    finally:
        store.save, store.restore = save, restore
    faults = {name: max(abs(got.losses[i] - runs["C"][0].losses[i])
                        / abs(runs["C"][0].losses[i]) for i in (4, 5))
              for name, got in faulty.items()}
    if any(v for r in runs.values() for v in r[1].values()):
        fail(f"{label}: hand-written kernels launched")
    b, c = runs["B"][0], runs["C"][0]
    if b.start != 4 or sorted(b.losses) != [4, 5]:
        fail(f"{label}: run B resumed at {b.start} with steps "
             f"{sorted(b.losses)}")
    rel = {i: abs(b.losses[i] - c.losses[i]) / abs(c.losses[i])
           for i in (4, 5)}
    if not all(r <= CKPT_RTOL for r in rel.values()):
        fail(f"{label}: resumed losses {b.losses} vs uninterrupted "
             f"{c.losses}")
    if not restores or not all(r[2] for r in restores):
        fail(f"{label}: no verified restore")
    log(f"{label}: B losses {b.losses} vs C "
        f"{ {i: c.losses[i] for i in (4, 5)} } (rel {rel}); saves (step, "
        f"bytes, s) {saves}; restores (step, leaves checksum-verified, "
        f"verify, s) {restores}; bytes written "
        f"{sum(s[1] for s in saves)}; planted restore faults, largest "
        f"rel at steps 4-5: {faults} (limit {CKPT_RTOL})")
    for name, r in faults.items():
        if not r > CKPT_RTOL:
            fail(f"{label}: resuming under the planted fault '{name}' "
                 f"reads rel {r:.4g}, inside the limit")
    return {"saves": saves, "restores": restores, "rel": rel,
            "faults": faults,
            "losses": {k: r[0].losses for k, r in runs.items()},
            "wall_s": {k: r[2] for k, r in runs.items()},
            "launches": {k: r[1] for k, r in runs.items()}}


def planted_restore_faults(restore, train_cli) -> list:
    """(name, patch) pairs of ``checkpoint_phase``'s planted faults: the
    checkpoint ``restore`` returning the optimizer state without its m
    and v or without its step counter, and the launcher's data iterator
    ignoring the restored step."""
    def faulty(*keys):
        def wrapped(*a, **kw):
            state, meta = restore(*a, **kw)
            for key in keys:
                for t in torch.utils._pytree.tree_leaves(state["opt"][key]):
                    t.zero_()
            return state, meta
        return wrapped
    from repro_torch.checkpoint import store
    return [("m and v lost", mock.patch.object(store, "restore",
                                               faulty("m", "v"))),
            ("step counter lost", mock.patch.object(store, "restore",
                                                    faulty("step"))),
            ("data iterator at step 0", mock.patch.object(
                train_cli.DataIterator, "restore",
                lambda self, state: None))]


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
                    help="also trace short serve runs and two launcher "
                         "train steps with torch.profiler (device time "
                         "by category, idle share)")
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
    t0 = time.perf_counter()
    record["families"] = families = families_phase()
    log(f"families phase: {time.perf_counter() - t0:.1f} s, {memory()}")
    record["train"] = {TRAIN_ARCH: train_model(TRAIN_ARCH)}
    for name, phase in (("launcher", launcher_phase),
                        ("checkpoint", checkpoint_phase)):
        t0 = time.perf_counter()
        record[name] = phase()
        log(f"{name} phase: {time.perf_counter() - t0:.1f} s, {memory()}")
    if args.profile:
        record["launcher_profile"] = launcher_profile()
    record["analysis"] = {
        "decode": record["serve"][FLEXGEN_ARCH]["analysis decode"],
        "prefill": record["serve"][FLEXGEN_ARCH]["analysis prefill"],
        "train": record["train"][TRAIN_ARCH]["analysis train"]}
    shape_launches = Counter()
    for arch in FAMILY_ARCHS:
        for kernel, shape, n in families[arch]["shape_launches"]:
            shape_launches[(kernel, tuple(shape))] += n
    rows = kernels_line(kernels, {**record["serve"], **record["train"]},
                        shape_launches)
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
