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
   init scales; and over ``EXPERT_RANGES`` (2 and 4) expert ranges, the
   range form the sharded phase runs once per expert shard: each
   range's fp32 partial summed in order and rounded once, against the
   whole kernel and the plain version, with the first range's boundary
   expert dropped as a planted fault that must fail
   (``expert_range_kernel``; its row in the ``kernels`` line is the 4
   ranges', each range also timed alone); then its edges
   (``expert_range_edges``): ranges that no slot routes into give exact
   zeros, an id outside [0, E) NaN on its token only in every range, 3
   unequal ranges, and a batch of 32 whole and over 4 ranges.  The
   tolerance is ``ATOL`` absolute plus ``RTOL`` relative (at least two
   bf16 units in the last place), so a kernel that drops a tile of keys,
   a slot or a column tile fails.  Each
   kernel, its plain version and, where one exists, one PyTorch library
   call of the same function are timed with CUDA events, each call
   after a write that evicts the L2 (the regime of the bytes bound):
   ``ms`` and ``library_ms``; ``device_ms`` and ``library_device_ms``
   time the same calls with a spin on the card after the write, so the
   wrapper's host time is hidden and the card's time alone is read;
3. small references: a small dense model and a small MoE model with
   head_dim 128, each served on the card (kernels) and on the CPU (plain
   versions) from the same weights — the greedy tokens must agree, up
   to near ties; and granite-4.0-h-small's smoke variant at one unit
   (``HYBRID_WIDEN``: head_dim 128, Mamba heads of P 64 and N 128, an
   untied head and unscaled logits, so that the tokens vary) on
   the fused path alone, the only one that serves its Mamba-2 layers
   over state slots: the card run must launch ``ssm_state_update`` a
   whole number of times per Mamba layer, and its launches are the
   ``ssm_state_update`` rows' in the ``kernels`` line;
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
   must raise naming the ROADMAP item that trains over several devices
   (11b).  Routed counts, each replica's tok/s, their sum, tokens per
   wall second, the worst p95 latency and the bytes are printed; the
   phase's launches count in the ``@KV8`` rows;
4c''. the sharded-serving phase, first half: llama3-8b through
   ``cluster.ClusterPlane`` over ``SHARDED_DEVICES`` logical devices of
   the card (``["cuda:0"] * 4``; on a machine with several cards the
   first min(4, n) cards, printed), ``SHARDED_DENSE_REPLICAS`` replicas
   of two, ``embed`` and ``lm_head`` split over vocab
   (``SHARDED_DENSE_MAPPING``), staged, the same prompts and pool.
   Sessions must equal phase 4's staged tokens up to near ties, placing
   each replica's params must add 0 B (``torch.cuda.memory_allocated``
   around the placement: the shards are views), and the bytes by
   replica namespace must sum to the ``*/*`` aggregate after every
   iteration (``sharded_plane``);
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
5b'. the sharded-serving phase, second half: qwen3-moe-30b-a3b through
   the plane, one replica over ``SHARDED_DEVICES`` logical devices of
   the card, experts and vocab split (``SHARDED_MOE_MAPPING``), staged
   then fused on the weights phase 5 holds: tokens equal to phase 5's
   of the same path up to near ties, 0 B added by the placement, the
   ledger conserved; the fused run must launch the range form of
   ``fused_expert_ffn`` once per expert shard per MoE layer and decode
   step (4 x 48 a step) and never the whole kernel.  Greedy argmax over
   the four vocab blocks of the head is held against ``torch.argmax``
   of the gathered row, and with the blocks' offsets off by one (a
   planted fault) must disagree (``vocab_argmax_check``);
5b''. qwen3-moe-30b-a3b through the plane as 5b' fused (one replica over
   ``SHARDED_DEVICES`` logical devices, experts and vocab split) with
   expert residency over the split store (``expert_policy="predictive"``
   at ``EXPERT_FAST_FRACTION``) under every control plane of 4c, QoS
   with a p99 decode SLO of ``SLO_FRACTION`` of 5b' fused's p95 decode
   gap (``sharded_experts_phase``).  Tokens must equal 5b' fused tokens
   exactly for every request QoS never preempted; a preempted one must
   equal them up to its recompute and may part after it (the recompute
   is a prefill, whose ``moe_fwd`` drops by capacity at full size, as
   the reference's does); ``record_routing`` must be called once per
   live row per MoE layer of every decode step; an expert must be
   promoted; the range form of ``fused_expert_ffn`` must launch 4 x 48
   times a decode step and the whole kernel never; placement adds 0 B
   and the ledger is conserved at every iteration.  Where the routing
   feed equals 5b's call for call (layer, step and ids digested in
   order), the expert counters must equal 5b's exactly; otherwise both
   are printed side by side.  Fast-hit and prefetch-hit ratios, replans
   and moved bytes, QoS violations and blame, the calibrated slow-tier
   rate, the routing feed's host time and tok/s beside 5b' fused and 5b
   are printed;
5c. train rwkv6-7b through ``ZeroOffloadEngine`` at full width and
   ``RECURRENT_TRAIN_LAYERS`` of its 32 layers (a host of 101 GiB, as
   the single-H100 machines this script runs on have, holds the pinned
   state of 16, not of 32), once the serve and
   families phases' weights are freed and the pinned host blocks their
   runs left cached are released: batches of 8 x 512, the learning rate
   of ``train_engine``, the fp32 state all on pinned host memory,
   ``RECURRENT_TRAIN_STEPS`` steps.  Each step prints its loss and its
   four Fig. 9 phases; the losses must be finite and fall from the first
   step to the last, ``fused_adam`` must launch once per leaf per step
   and nothing else may launch, and the state must be 12 bytes a
   parameter on pinned host memory and none on the device.  The peak
   device memory is printed beside the card's, and the host's memory
   before, during and after;
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
   launcher's step is the plain AdamW, as the reference's).  Then the
   same on rwkv6-7b at full width and ``RECURRENT_LAUNCHER_LAYERS``
   layers (``launch.train.run`` on the arguments of ``parse_args``,
   with ``get_config`` giving the cut config for the call; the launcher
   keeps the live fp32 state on the card),
   with the same checks, and the launcher on jamba's smoke variant for
   ``JAMBA_LAUNCHER_STEPS`` steps (finite, falling losses; no
   hand-written kernel);
6c. checkpoints through the launcher on bert-large-offload at full
   width and depth: run A takes 4 steps, checkpointing every 2; run B
   resumes A's directory to step 6 and must print ``restored step 4``;
   run C takes 6 steps in a fresh directory; B's losses at steps 4-5
   must equal C's within ``CKPT_RTOL`` relative, and A's checkpoint
   resumed under each of three planted restore faults must not.  Bytes
   written, save and restore seconds and the checksum-verified leaves
   are printed;
6d. training over FSDP x TP meshes of logical devices of the card
   (``sharded_train_phase``): llama3-8b at full width, its depth cut to
   ``SHARDED_TRAIN_LAYERS`` layers, 8 x 128 tokens, ``SHARDED_TRAIN_STEPS``
   steps at 1x1 and at 2x4, through ``make_train_step`` with
   ``fused_adam`` (once per distinct block of every leaf, each block's
   update held against the plain update of the same block on the card
   at the first step) and through the launcher (``launch.train.run``
   over ``["cuda:0"] * 8``, the plain AdamW); a second 2x4 run
   checkpointed after two steps, restored onto 4x2 (every leaf's
   checksum verified, then bit-equal to the saved state, still on the
   card) and stepped once more; then gpt2-xl-offload at full width and
   depth through the launcher at 1x1 and 2x2 (its 25 heads split off
   head boundaries).  Each mesh's losses must equal the 1x1 run's
   within ``SHARDED_TRAIN_LOSS_ATOL``, and two planted faults (one
   shard's update skipped: the first mesh entry's block of every leaf;
   one data shard's gradient dropped) must read above it; placement
   must add 0 B of distinct storage; step ms and peak device memory
   are printed;
7. print the ``kernels`` JSON line, then the device line last.  The
   line has one row per kernel build the main paths launch: each
   attention kernel at each model's KV geometry (``decode_attention@KV8``
   for llama3-8b, ``...@KV4`` for qwen3-moe-30b-a3b), the two one-shot
   kernels at that phase's shapes (``decode_attention@KV8/oneshot``,
   ``flash_attention@KV8/oneshot``), ``fused_expert_ffn``, its range
   form (``fused_expert_ffn@4 expert ranges``), ``fused_adam``,
   ``fused_adam@rwkv6-7b`` and ``fused_adam@llama3-8b 2x4 shard`` (the
   sharded-train phase's ``mlp.w_gate`` block); each row's times, bound
   and error come from its own build and shapes, and its launches from
   the phases that run
   it at those shapes: a ``/oneshot`` row's from the one-shot phase, the
   range row's from the sharded phase, the other attention rows' from
   their model's other serve phases, an Adam row's from its model's
   train phases (the shard row's: the sharded-train phase's 2x4 run,
   every block).

The kernel phase also holds ``fused_adam`` against its plain version at
gpt2-xl-offload's largest leaf and at rwkv6-7b's ``tmix.wr`` at the
depth its ZeRO-Offload phase trains (16 x 4096 x 4096; bf16 g each,
outputs NaN-poisoned), and at a
ragged n of 70001 (fp32
g), aligned and at an odd storage offset; it holds the update
``master' - master`` (about lr = 3e-4 against masters of about 0.02),
m' and v' to ``ADAM_RTOL`` relative, plus two fp32 ulps of the master
for the update.  The small references also train the smoke configs of
``SMALL_TRAIN_ARCHS`` (gpt2-xl-offload, llama3-8b, rwkv6-7b and jamba)
for 3 steps through ``ZeroOffloadEngine`` on the card and on the CPU
from the same weights and batches: finite losses, ``fused_adam`` once
per leaf per step on the card, step-1 losses within
``TRAIN_LOSS_ATOL``.

The kernel phase also holds the Mamba-2 decode state update
(``ssm_state_update@B64`` and ``@B32``, ``ssm_kernels``) at
granite-4.0-h-small's heads over 65 slots, rows in permuted slots: y
and the whole state store against the plain version within
``SSM_RTOL``, the slots no row names unchanged bit for bit.

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
(``INT8_REL``).  Before the int8 cache, the recurrent layers' backward
at full width in fp32 (``recurrent_backward_phase``): rwkv6-7b's
time-mix layer over 4 x 256 tokens and jamba's Mamba-2 layer over 2 x
256, every leaf's gradient of ``sum(out * w)`` through the chunked scan
(one call, and two halves with the states carried) against the
one-token recurrence's within ``RECURRENT_GRAD_REL``, and three planted
faults above it (the carried states detached, the bonus or skip
detached, the decay's inputs detached); the ms of both forms printed.
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
import hashlib
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
# the small train references: the dense smoke models and the recurrent
# families' (jamba's hybrid: Mamba-2, MoE and attention)
SMALL_TRAIN_ARCHS = (TRAIN_ARCH, "llama3-8b", "rwkv6-7b",
                     "jamba-1.5-large-398b")
# ZeRO-Offload training of rwkv6-7b at full width, all of its fp32 state
# on pinned host memory.  The depth is cut to what a single-H100 host
# of 101 GiB holds.  At 32 layers the state (83.98 GB) and
# the grad buffers (14.00 GB) take 98.24 GiB once PyTorch's pinned
# allocator has rounded each leaf's block up to a power of two; at 16
# layers 52.62 GiB.  The width is the model's own.
RECURRENT_ARCH, RECURRENT_TRAIN_LAYERS, RECURRENT_TRAIN_STEPS = \
    "rwkv6-7b", 16, 3
# the recurrent layers' backward at full width in fp32: the chunked
# scan's gradients against the one-token recurrence's, per leaf, by
# relative norm.  fp32 sums in another order part by ~1e-6 (the port
# against the reference's jax.grad: 1e-6 or less on the CPU); a fault
# that drops or detaches a gradient path reads ~1e-2 or more
RECURRENT_GRAD_REL = 1e-3
RWKV_GRAD_BATCH, MAMBA_GRAD_BATCH, RECURRENT_GRAD_SEQ = 4, 2, 256
# leaves each planted fault detaches: the current-token bonus (RWKV6) or
# the skip (Mamba-2), and the inputs of the data-dependent decay
RECURRENT_FAULT_LEAVES = {"rwkv": (("u",), ("mix_w", "wA", "wB")),
                          "mamba": (("D",), ("dt_bias", "A_log"))}

B, H, HD, BT = 4, 32, 128, 16
MODELS = {"llama3-8b": 8, "qwen3-moe-30b-a3b": 4}   # served, and KV heads
D_MOE, F_MOE, E_MOE, K_MOE = 2048, 768, 128, 8   # qwen3-moe-30b-a3b
# the prefill MoE's bucket kernels at the serving cell's routing (capacity
# 1.25, up to 32 groups) over a median prompt, 1020 tokens (30 groups of
# 34, C 4), and a long prime one, 5003 (one group, C 390)
BUCKET_TOKENS, BUCKET_CF, BUCKET_GROUPS = (1020, 5003), 1.25, 32
# the Mamba-2 decode state update at granite-4.0-h-small's heads (128 of
# P 64, N 128, one group) over the serving cell's max_batch slots and the
# padded rows' one, at 64 and 32 rows in permuted slots; y and the state
# to SSM_RTOL relative (fp32 throughout: the kernel and its plain
# version part by summation order and exp's rounding alone)
HYBRID_ARCH = "granite-4.0-h-small"
SSM_HEADS, SSM_N, SSM_P, SSM_GROUPS, SSM_SLOTS = 128, 128, 64, 1, 65
SSM_ROWS, SSM_RTOL = (64, 32), 1e-4
# the small hybrid reference: granite's smoke variant at one unit (its
# 10-layer pattern, one attention layer) widened to its head geometry,
# with an untied head and unscaled logits: at random init the tied head
# serves each input token back (its 12x embedding wins), which no state
# fault could move, and at logits / 16 the logits spread by ~0.03, so
# every margin would pass as a near tie; so changed, the tokens vary and
# the logits spread by ~0.45 (std), the bf16 rounding of the CPU run
# moving them by under 0.07 (fp32 weights against bf16)
HYBRID_WIDEN = dict(n_layers=10, d_model=512, n_kv=2, head_dim=128,
                    mamba_head_dim=SSM_P, mamba_d_state=SSM_N,
                    tie_embeddings=False, logits_scaling=1.0)
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
# the launcher keeps the live fp32 AdamW state on the card: rwkv6-7b at
# full width runs 4 of its 32 layers (1.345 G parameters, 16.1 GB of
# state); jamba runs its smoke variant
RECURRENT_LAUNCHER_LAYERS, JAMBA_LAUNCHER_STEPS = 4, 4
CKPT_ARCH = "bert-large-offload"
# resumed vs uninterrupted loss, relative: rounding headroom (8 fp32
# ulps of a loss near 10) over runs that read equal; every planted
# restore fault of checkpoint_phase must read above it
CKPT_RTOL = 1e-6
# training over meshes of logical devices of the card: llama3-8b at full
# width cut to 4 layers (at 32 its fp32 master, m and v alone are 96 GB;
# at 4, 1.92 G parameters: 23 GB of state, 3.8 GB of bf16 params), 8 x
# 128 tokens, 1x1 against 2x4 and a restore onto 4x2; gpt2-xl-offload
# at full width and depth, 1x1 against 2x2 (25 heads of 64: wq splits
# at column 800, off head boundaries), through the launcher
SHARDED_TRAIN_ARCH, SHARDED_TRAIN_LAYERS = "llama3-8b", 4
SHARDED_TRAIN_STEPS, SHARDED_TRAIN_MESH, SHARDED_RESTORE_MESH = \
    3, "2x4", "4x2"
SHARDED_GPT2_MESH, SHARDED_GPT2_STEPS = "2x2", 2
# a mesh run's loss at each step against the 1x1 run's: the reference's
# own spread between its 1x1 and 2x4 runs of llama3-8b's smoke model
# (6.7e-4 at step 2) plus test_torch_train.LOSS_ATOL (2e-4), rounded up
# (CPU readings of tests/test_torch_sharded_train.py's reference runs)
SHARDED_TRAIN_LOSS_ATOL = 1e-3
EXPERT_ARCH, EXPERT_FAST_FRACTION = "qwen3-moe-30b-a3b", 0.25
# the cluster phase: the serve CLI's multi-host plane, two logical
# replicas on the one card over its staged path; building the plane may
# add less than this share of the weights' bytes (no second copy)
CLUSTER_ARCH, CLUSTER_REPLICAS = "llama3-8b", 2
CLUSTER_MEMORY_SHARE = 0.1
# the sharded-serving phase: replicas over meshes of logical devices of
# the card (the first cards of a machine with several), params split by
# the axis mapping; qwen3-moe-30b-a3b one replica over 4, llama3-8b two
# replicas over 2 each.  The kernel phase holds fused_expert_ffn over
# EXPERT_RANGES expert ranges; the path runs SHARDED_DEVICES of them
SHARDED_DEVICES = 4
SHARDED_MOE_MAPPING = {"experts": "model", "vocab": "model"}
SHARDED_DENSE_MAPPING, SHARDED_DENSE_REPLICAS = {"vocab": "model"}, 2
EXPERT_RANGES = (2, SHARDED_DEVICES)
# the range form's edge cases in the kernel phase: 3 unequal ranges
# (42 / 43 / 43 of 128 experts) and a decode batch of 32 rows (max_batch
# 32, top-8: 256 slots), whole and over SHARDED_DEVICES ranges
EXPERT_UNEQUAL_RANGES, EXPERT_WIDE_BATCH = 3, 32
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
    # the reference's moe_fwd dispatches and combines in plain JAX
    "moe_bucket_positions": "none",
    "moe_bucket_scatter": "none",
    "moe_bucket_combine": "none",
    "ssm_state_update": "none",
}
SOURCES = {
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/csrc/paged_decode_attention.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "fused_expert_ffn": "src/repro_torch/csrc/fused_expert_ffn.cu",
    "fused_adam": "src/repro_torch/csrc/fused_adam.cu",
    "moe_bucket_positions": "src/repro_torch/csrc/moe_bucket.cu",
    "moe_bucket_scatter": "src/repro_torch/csrc/moe_bucket.cu",
    "moe_bucket_combine": "src/repro_torch/csrc/moe_bucket.cu",
    "ssm_state_update": "src/repro_torch/csrc/ssm_state_update.cu",
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


def holds(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether ``got`` is finite and within ``compare``'s tolerance of
    ``want`` (a planted fault must not)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    return bool(g.shape == w.shape and torch.isfinite(g).all()
                and ((g - w).abs() <= ATOL + RTOL * w.abs()).all())


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


def expert_inputs(gen, batch: int = B) -> tuple:
    """x, w_gate, w_up, w_down, ids, wts at qwen3-moe-30b-a3b's decode
    shapes (``batch`` rows): router-like ids over x of std 1, weights at
    their init scales, a padded row (row 3 = row 0) and a duplicated
    expert id."""
    rnd = functools.partial(randn_bf16, gen)
    D, F, E, K = D_MOE, F_MOE, E_MOE, K_MOE
    x = rnd(batch, D)
    x[3] = x[0]           # a padded row: token 0 again, routed the same
    wg, wu = rnd(E, D, F, std=D ** -0.5), rnd(E, D, F, std=D ** -0.5)
    wd = rnd(E, F, D, std=F ** -0.5)
    router = torch.randn(D, E, generator=gen, device=gen.device) * D ** -0.5
    wts, ids = torch.topk(torch.softmax(x.float() @ router, -1), K)
    wts = wts / wts.sum(-1, keepdim=True)
    ids = ids.to(torch.int32)
    ids[1, K - 1] = ids[1, 0]          # one duplicated expert id
    return x, wg, wu, wd, ids, wts


def expert_bound(ids, D: int, F: int) -> tuple:
    """The bytes bound of the routed expert FFN: the distinct routed
    experts' weights once, x, the bf16 output, ids and wts."""
    distinct = int(torch.unique(ids).numel())
    Bx, K = ids.shape
    t_b, by = bound(distinct * 3 * D * F * 2 + 2 * Bx * D * 2 + 8 * Bx * K,
                    Bx * K * 6 * D * F)
    return t_b, by, distinct


def expert_kernel(dev, gen) -> dict:
    """``fused_expert_ffn`` at qwen3-moe-30b-a3b's decode shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_gather import fused_expert_ffn

    x, wg, wu, wd, ids, wts = expert_inputs(gen)
    got = fused_expert_ffn(x, wg, wu, wd, ids, wts)
    err = compare("fused_expert_ffn B=4 D=2048 F=768 E=128 K=8", got,
                  ref.expert_ffn(x, wg, wu, wd, ids, wts))
    if not torch.equal(got[3], got[0]):
        fail("fused_expert_ffn: the padded row differs from row 0")
    t_b, by, distinct = expert_bound(ids, D_MOE, F_MOE)
    return dict(
        max_abs_err=err, **cold_times(
            lambda: fused_expert_ffn(x, wg, wu, wd, ids, wts),
            None),             # no single PyTorch call routes top-k
        warm_ms=time_ms(lambda: fused_expert_ffn(x, wg, wu, wd, ids, wts),
                        cold=False),
        plain_ms=time_ms(lambda: ref.expert_ffn(x, wg, wu, wd, ids, wts)),
        bound_ms=t_b, bound_by=by, distinct_experts=distinct)


def expert_ranges(E: int, n: int, drop_boundary: bool = False) -> list:
    """The [lo, hi) of ``n`` expert shards of ``E`` (``i * E // n``: equal
    where n divides E); with ``drop_boundary`` (a planted fault) the
    first shard loses its last expert."""
    out = [(i * E // n, (i + 1) * E // n) for i in range(n)]
    if drop_boundary:
        out[0] = (out[0][0], out[0][1] - 1)
    return out


def ranged_experts(fn, x, wg, wu, wd, ids, wts, ranges) -> torch.Tensor:
    """The sharded path's expert FFN (``serving.engine._routed_experts``
    over split experts): ``fn`` (the range kernel or its plain version)
    once per range on that range's stacks, the fp32 partials summed in
    range order and rounded to bf16 once."""
    E, acc = wg.shape[0], None
    for lo, hi in ranges:
        part = fn(x, wg[lo:hi], wu[lo:hi], wd[lo:hi], ids, wts, lo, hi, E)
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def expert_range_kernel(dev, gen) -> dict:
    """``fused_expert_ffn`` over ``EXPERT_RANGES`` expert ranges (the
    range form, ``fused_expert_ffn_partial``) at qwen3-moe-30b-a3b's
    decode shapes, the ids routing one token to the last expert of the
    first range of each split: the sum of the ranges against the whole
    kernel and against the plain version; the first range's boundary
    expert dropped (a planted fault) must fail.  The row's numbers are
    the path's (``SHARDED_DEVICES`` ranges): ``ms`` the whole sharded
    call, ``ranges`` each range alone (with its routed slots); bound:
    each range's distinct routed experts' bytes (together the whole
    kernel's).  Then the edge cases of ``expert_range_edges``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_gather import (fused_expert_ffn,
                                                   fused_expert_ffn_partial)
    x, wg, wu, wd, ids, wts = expert_inputs(gen)
    E = wg.shape[0]
    for k, n in enumerate(EXPERT_RANGES):
        ids[2, K_MOE - 1 - k] = E // n - 1      # a first-range boundary
    whole = fused_expert_ffn(x, wg, wu, wd, ids, wts)
    plain = ref.expert_ffn(x, wg, wu, wd, ids, wts)
    out = {}
    for n in EXPERT_RANGES:
        ranges = expert_ranges(E, n)
        name = f"fused_expert_ffn over {n} expert ranges"
        got = ranged_experts(fused_expert_ffn_partial, x, wg, wu, wd, ids,
                             wts, ranges)
        compare(f"{name} vs the whole kernel", got, whole)
        err = compare(f"{name} vs plain", got, plain)
        dropped = ranged_experts(fused_expert_ffn_partial, x, wg, wu, wd,
                                 ids, wts, expert_ranges(E, n, True))
        if holds(dropped, plain):
            fail(f"{name}: the planted fault (expert {E // n - 1} dropped "
                 "from the first range) passed the check")
        fault = (dropped.float() - plain.float()).abs().max().item()
        log(f"  {name}: the planted fault (expert {E // n - 1} dropped) "
            f"reads {fault:.3g} and fails the check")
        call = functools.partial(ranged_experts, fused_expert_ffn_partial,
                                 x, wg, wu, wd, ids, wts, ranges)
        per = []
        for lo, hi in ranges:
            one = functools.partial(fused_expert_ffn_partial, x, wg[lo:hi],
                                    wu[lo:hi], wd[lo:hi], ids, wts, lo, hi,
                                    E)
            mine = ids[(ids >= lo) & (ids < hi)]
            d = int(torch.unique(mine).numel())
            per.append(dict(lo=lo, hi=hi, slots=int(mine.numel()),
                            distinct_experts=d, ms=time_ms(one),
                            device_ms=time_ms(one, lead=True)))
        t_b, by, distinct = expert_bound(ids, D_MOE, F_MOE)
        if sum(r["distinct_experts"] for r in per) != distinct:
            fail(f"{name}: the ranges' distinct experts do not add up")
        out[n] = dict(
            max_abs_err=err, **cold_times(call, None),
            plain_ms=time_ms(functools.partial(
                ranged_experts, ref.expert_ffn_partial, x, wg, wu, wd, ids,
                wts, ranges)),
            bound_ms=t_b, bound_by=by, distinct_experts=distinct,
            ranges=per, fault_abs_err=fault)
        log(f"  {name}: ms={out[n]['ms']:.4f} "
            f"device_ms={out[n]['device_ms']:.4f}; per range "
            + " ".join(f"[{r['lo']},{r['hi']}) {r['slots']} slots, "
                       f"{r['distinct_experts']} experts {r['ms']:.4f} "
                       f"({r['device_ms']:.4f})" for r in per))
    row = dict(out[SHARDED_DEVICES])
    row["by_ranges"] = {str(n): out[n] for n in EXPERT_RANGES}
    expert_range_edges(gen, x, wg, wu, wd, ids, wts, whole, plain)
    return row


def expert_range_edges(gen, x, wg, wu, wd, ids, wts, whole, plain) -> None:
    """The range form's edge cases at the main path's shapes, each held
    to the plain version at ``compare``'s tolerance: a range that no
    slot routes into (the ids folded into the first half of the
    experts) and a range of no experts give exact zeros, with their
    stacks NaN, so that any weight read would show; an id outside
    [0, E) makes its token's row NaN in the whole kernel and in every
    range, the other rows held; ``EXPERT_UNEQUAL_RANGES`` unequal
    ranges; and a batch of ``EXPERT_WIDE_BATCH`` rows, whole and over
    ``SHARDED_DEVICES`` ranges."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_gather import (fused_expert_ffn,
                                                   fused_expert_ffn_partial)
    E = wg.shape[0]
    lo, hi = E // 2, E // 2 + E // SHARDED_DEVICES
    nan = [torch.full_like(w[lo:hi], math.nan) for w in (wg, wu, wd)]
    for name, top, routed in (("no slot routed", hi, ids % lo),
                              ("no experts", lo, ids)):
        got = fused_expert_ffn_partial(x, *(w[:top - lo] for w in nan),
                                       routed, wts, lo, top, E)
        torch.cuda.synchronize()
        if not torch.equal(got, torch.zeros_like(got)):
            fail(f"fused_expert_ffn range [{lo}, {top}), {name}: not exact "
                 "zeros")
        log(f"  fused_expert_ffn range [{lo}, {top}), {name}: exact zeros")
    bad = ids.clone()
    bad[2, 3] = E
    for n in (1, SHARDED_DEVICES):
        ranges = expert_ranges(E, n)
        got = (fused_expert_ffn(x, wg, wu, wd, bad, wts) if n == 1 else
               ranged_experts(fused_expert_ffn_partial, x, wg, wu, wd, bad,
                              wts, ranges))
        parts = ([got] if n == 1 else
                 [fused_expert_ffn_partial(x, wg[a:b], wu[a:b], wd[a:b],
                                           bad, wts, a, b, E)
                  for a, b in ranges])
        torch.cuda.synchronize()
        if not all(torch.isnan(p[2]).all() for p in parts):
            fail(f"fused_expert_ffn over {n} ranges: an id outside "
                 f"[0, {E}) did not make its token's row NaN in every "
                 "range")
        keep = [0, 1, 3]
        form = "whole" if n == 1 else f"over {n} ranges"
        compare(f"fused_expert_ffn {form}, id {E} on row 2: the other rows",
                got[keep], plain[keep])
    n = EXPERT_UNEQUAL_RANGES
    got = ranged_experts(fused_expert_ffn_partial, x, wg, wu, wd, ids, wts,
                         expert_ranges(E, n))
    label = "/".join(str(b - a) for a, b in expert_ranges(E, n))
    compare(f"fused_expert_ffn over {n} ranges ({label}) vs the whole "
            "kernel", got, whole)
    compare(f"fused_expert_ffn over {n} ranges ({label}) vs plain", got,
            plain)
    wide = expert_inputs(gen, EXPERT_WIDE_BATCH)
    want = ref.expert_ffn(*wide)
    tag = f"fused_expert_ffn B={EXPERT_WIDE_BATCH}"
    compare(f"{tag} whole vs plain", fused_expert_ffn(*wide), want)
    compare(f"{tag} over {SHARDED_DEVICES} ranges vs plain",
            ranged_experts(fused_expert_ffn_partial, *wide,
                           expert_ranges(E, SHARDED_DEVICES)), want)


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
               master: torch.Tensor, quiet: bool = False) -> float:
    """Kernel against plain: the update ``master' - master`` to
    ``ADAM_RTOL`` of the plain update plus ``ADAM_MASTER_ULPS`` fp32
    ulps of the master; m' and v' to ``ADAM_RTOL`` plus that fraction of
    their rms.  Returns the largest absolute error of the three (logged
    unless ``quiet``)."""
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
        if not quiet:
            log(f"  {name} {what}: max_abs_err={err.max().item():.3g} "
                f"mean|plain|={w.abs().mean().item():.3g}")
        worst = max(worst, err.max().item())
    return worst


def adam_kernel(dev, gen, shape: tuple, ragged: bool) -> dict:
    """``fused_adam`` at one leaf of ``shape`` (bf16 g), and with
    ``ragged`` at n 70001 (fp32 g) too, aligned (vector loop and its
    tail) and at storage offset 1 (the scalar loop); step-3 bias
    corrections, weight decay 0.1."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam

    kw = adam_kwargs()
    err = 0.0
    for offset in (0, 1) if ragged else ():
        n = 70001
        master, m, v, g = adam_inputs(gen, n, torch.float32, offset)
        poison(n, dev)
        err = max(err, check_adam(
            f"fused_adam n={n} g=float32 offset={offset}",
            fused_adam(master, m, v, g, **kw),
            ref.fused_adam(master, m, v, g, **kw), master))
    n = math.prod(shape)
    master, m, v, g = (t.reshape(shape) for t in
                       adam_inputs(gen, n, torch.bfloat16))
    poison(n, dev)
    err = max(err, check_adam(
        f"fused_adam {shape} g=bfloat16", fused_adam(master, m, v, g, **kw),
        ref.fused_adam(master, m, v, g, **kw), master))
    gc.collect()
    # 26 B an element per call (12.8 GB at gpt2-xl-offload's leaf, 7.0
    # at rwkv6-7b's): far past the L2, so back-to-back calls are cold
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


def sharded_adam_row(dev, gen) -> dict:
    """``fused_adam`` at the block of ``mlp.w_gate`` that each mesh
    entry holds at ``SHARDED_TRAIN_MESH`` in the sharded-train phase
    (units x d_model / data x d_ff / model); its launches are that
    phase's mesh run's, every block."""
    from repro_torch.launch import train
    from repro_torch.models import shardings as sh
    cfg = sharded_cfg()
    mesh = train.parse_mesh(SHARDED_TRAIN_MESH, "cuda",
                            devices=mesh_devices(SHARDED_TRAIN_MESH))
    shape = (cfg.n_units, cfg.d_model, cfg.d_ff)
    spec = sh.param_pspecs({"units": {"layers": ({"mlp": {
        "w_gate": torch.empty(shape, device="meta")}},)}}, mesh)
    st = sh.ShardedTensor(shape, spec["units"]["layers"][0]["mlp"]["w_gate"],
                          mesh, [None] * mesh.size)
    block = tuple(n // st.parts(d) for d, n in enumerate(shape))
    return {f"fused_adam@{SHARDED_TRAIN_ARCH} {SHARDED_TRAIN_MESH} shard":
            dict(adam_kernel(dev, gen, block, ragged=False),
                 kernel="fused_adam", model=f"{SHARDED_TRAIN_ARCH} sharded",
                 sharded=True)}


def same_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``got`` must equal ``want`` bit for bit (so -0 is not +0);
    returns the largest difference, 0."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
             f"{tuple(want.shape)}")
    if got.is_floating_point():
        view = torch.int16 if got.element_size() == 2 else torch.int32
        same = torch.equal(got.contiguous().view(view),
                           want.contiguous().view(view))
    else:
        same = torch.equal(got, want)
    if not same:
        fail(f"{name}: differs from its plain version, largest difference "
             f"{(got.double() - want.double()).abs().max().item():.4g}")
    log(f"  {name}: equal bit for bit")
    return 0.0


def bucket_kernels(gen) -> dict:
    """The prefill MoE's three ``moe_bucket_*`` kernels at
    qwen3-moe-30b-a3b's widths and the serving cell's routing, at each of
    ``BUCKET_TOKENS``, each against its plain version
    (``ref.moe_bucket_*``) on the same inputs, bit for bit; ``plain_ms``
    times that plain version alone.  Bound: device-memory bytes, what
    each kernel must read and write once (the scatter's buffer written
    whole, its memset included in ``ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_bucket import (moe_bucket_combine,
                                                moe_bucket_positions,
                                                moe_bucket_scatter)
    D, E, K = D_MOE, E_MOE, K_MOE
    router = torch.randn(D, E, generator=gen, device=gen.device) * D ** -0.5
    rows = {}
    for N in BUCKET_TOKENS:
        G = max(g for g in range(1, BUCKET_GROUPS + 1) if N % g == 0)
        T = N // G
        C = max(int(T * K * BUCKET_CF / E), 4)         # moe_fwd's capacity
        xt = randn_bf16(gen, G, T, D)
        topw, topi = torch.topk(torch.softmax(xt.float() @ router, -1), K)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        eo = randn_bf16(gen, E, G, C, D)
        tag = f"N={N} (G {G}, C {C})"
        pos = moe_bucket_positions(topi, E)
        plain_pos = ref.moe_bucket_positions(topi, E)
        slots, es = N * K, xt.element_size()
        cases = {
            "moe_bucket_positions": (
                same_bits(f"moe_bucket_positions {tag}", pos.long(),
                          plain_pos),
                lambda: moe_bucket_positions(topi, E),
                lambda: ref.moe_bucket_positions(topi, E),
                slots * (8 + 4)),
            "moe_bucket_scatter": (
                same_bits(f"moe_bucket_scatter {tag}",
                          moe_bucket_scatter(xt, topi, pos, E, C),
                          ref.moe_bucket_scatter(xt, topi, plain_pos, E, C)),
                lambda: moe_bucket_scatter(xt, topi, pos, E, C),
                lambda: ref.moe_bucket_scatter(xt, topi, plain_pos, E, C),
                E * G * C * D * es + N * D * es + slots * (8 + 4)),
            "moe_bucket_combine": (
                same_bits(f"moe_bucket_combine {tag}",
                          moe_bucket_combine(eo, topi, topw, pos),
                          ref.moe_bucket_combine(eo, topi, topw, plain_pos)),
                lambda: moe_bucket_combine(eo, topi, topw, pos),
                lambda: ref.moe_bucket_combine(eo, topi, topw, plain_pos),
                slots * D * es + N * D * es + slots * (8 + 4 + 4))}
        for kernel, (err, fn, plain, nbytes) in cases.items():
            t_b, by = bound(nbytes, 0)
            rows[f"{kernel}@N{N}"] = dict(
                max_abs_err=err, **cold_times(fn, None),
                plain_ms=time_ms(plain), bound_ms=t_b, bound_by=by,
                kernel=kernel, model="qwen3-moe-30b-a3b")
    return rows


def ssm_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """fp32 ``got`` against ``want``: finite, and each element within
    ``SSM_RTOL`` of ``|want|`` plus the mean ``|want|`` (so an element
    near 0 is held to the tensor's scale)."""
    torch.cuda.synchronize()
    err = (got - want).abs()
    lim = SSM_RTOL * (want.abs() + want.abs().mean())
    if not torch.isfinite(got).all() or (err > lim).any():
        fail(f"{name}: {int((err > lim).sum())} elements off by up to "
             f"{err.max().item():.4g} (tolerance {SSM_RTOL} x (|plain| + "
             "mean |plain|))")
    log(f"  {name}: max_abs_err={err.max().item():.3g} "
        f"mean|plain|={want.abs().mean().item():.3g}")
    return err.max().item()


def ssm_kernels(gen, rows=SSM_ROWS) -> dict:
    """``ssm_state_update`` at granite-4.0-h-small's decode shapes
    (``SSM_HEADS`` heads of P ``SSM_P``, N ``SSM_N``, ``SSM_GROUPS``
    group) over ``SSM_SLOTS`` slots, at each of ``rows`` rows in
    permuted slots, with x, B and C column slices of one conv output as
    the engine passes them, dt, A and D in the published init's ranges.
    y and the whole state store are held to the plain version
    (``ref.ssm_state_update``) on the same inputs (``ssm_close``); the
    slots no row names must keep their bits.  ``plain_ms`` times the
    plain version alone.  Bound: device-memory bytes, each row's fp32
    state read and written once and its inputs and y
    (``perfbench/costs/hybrid.py``)."""
    from perfbench.costs import hybrid
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_state_update import ssm_state_update
    H, N, P, G = SSM_HEADS, SSM_N, SSM_P, SSM_GROUPS
    dev = gen.device
    out = {}
    for B in rows:
        state = torch.randn(SSM_SLOTS, H, N, P, generator=gen, device=dev)
        xbc = randn_bf16(gen, B, H * P + 2 * G * N)
        args = (xbc[:, :H * P], xbc[:, H * P:H * P + G * N],
                xbc[:, H * P + G * N:],
                torch.exp(torch.empty(B, H, device=dev).uniform_(
                    -6.9, -2.3, generator=gen)),
                -torch.empty(H, device=dev).uniform_(1, 16, generator=gen),
                torch.ones(H, device=dev))
        slots = torch.randperm(SSM_SLOTS, generator=gen, device=dev)[
            :B].to(torch.int32)
        want_state, before = state.clone(), state.clone()
        want = ref.ssm_state_update(want_state, slots, *args)
        got = ssm_state_update(state, slots, *args)
        tag = f"B={B} (H {H}, N {N}, P {P}, {SSM_SLOTS} slots)"
        err = max(ssm_close(f"ssm_state_update y {tag}", got, want),
                  ssm_close(f"ssm_state_update state {tag}", state,
                            want_state))
        idle = torch.ones(SSM_SLOTS, dtype=torch.bool, device=dev)
        idle[slots.long()] = False
        if not torch.equal(state[idle], before[idle]):
            fail(f"ssm_state_update {tag}: a slot no row names changed")
        flops, nbytes = hybrid.ssm_state_update(B, H, N, P, G)
        t_b, by = bound(nbytes, flops, FP32_FLOP_PER_S)
        out[f"ssm_state_update@B{B}"] = dict(
            max_abs_err=err,
            **cold_times(lambda: ssm_state_update(state, slots, *args),
                         None),
            plain_ms=time_ms(lambda: ref.ssm_state_update(
                want_state, slots, *args)),
            bound_ms=t_b, bound_by=by, kernel="ssm_state_update",
            model=HYBRID_ARCH)
    return out


def kernel_phase(dev, gen) -> dict:
    """Rows of the ``kernels`` line, one per kernel build and shape the
    main paths launch: each attention kernel at both models' KV geometry
    and the continuous paths' shapes (``decode_attention@KV8``,
    ``...@KV4``), the two the one-shot path runs at its own shapes
    (``decode_attention@KV8/oneshot``, ``flash_attention@KV8/oneshot``),
    the expert kernel, the prefill MoE's bucket kernels at two prompt
    lengths (``moe_bucket_scatter@N1020``: each row counts its kernel's
    launches at every length), the hybrid's decode state update at two
    row counts (``ssm_state_update@B64``; launches from the small hybrid
    reference) and the Adam kernel.  Each row names its
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
    rows[f"fused_expert_ffn@{SHARDED_DEVICES} expert ranges"] = dict(
        expert_range_kernel(dev, gen), kernel="fused_expert_ffn",
        model="qwen3-moe-30b-a3b", sharded=True)
    rows.update(bucket_kernels(gen))
    rows.update(ssm_kernels(gen))
    # a leaf of each train model's Adam launches, at the shape its phase
    # runs: gpt2-xl-offload's mlp.w_up (its largest), and rwkv6-7b's
    # tmix.wr at the ZeRO-Offload phase's RECURRENT_TRAIN_LAYERS
    from repro_torch.configs import get_config
    gpt2 = get_config(TRAIN_ARCH)
    rwkv = dataclasses.replace(get_config(RECURRENT_ARCH),
                               n_layers=RECURRENT_TRAIN_LAYERS)
    rows["fused_adam"] = dict(
        adam_kernel(dev, gen, (gpt2.n_units, gpt2.d_model, gpt2.d_ff),
                    ragged=True), kernel="fused_adam", model=TRAIN_ARCH)
    rows[f"fused_adam@{RECURRENT_ARCH}"] = dict(
        adam_kernel(dev, gen, (rwkv.n_units, rwkv.d_model, rwkv.d_model),
                    ragged=False), kernel="fused_adam", model=RECURRENT_ARCH)
    rows.update(sharded_adam_row(dev, gen))
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
    run at those shapes; for a ``sharded`` row, the sharded-serving
    phase's, whose expert launches are the range form's) or train
    phases (both placements and the analysis phase's train step), the
    only runs that launch its build
    at its shapes; plus, for a row with a ``shape``,
    the families phase's launches at that shape (``shape_launches``,
    (kernel, shape) -> count)."""
    def launches(row):
        n = sum(phase["launches"][row["kernel"]]
                for label, phase in runs.get(row["model"], {}).items()
                if "launches" in phase
                and phase.get("oneshot", label.startswith("flexgen "))
                == row.get("oneshot", False)
                and phase.get("sharded", False)
                == row.get("sharded", False))
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


def serving_config(prompts, new_tokens: int, **sv_kw):
    from repro_torch.serving import ServingConfig
    return ServingConfig(block_tokens=BT, max_batch=B,
                         max_context=max(len(p) for p in prompts)
                         + new_tokens + BT,
                         policy="tiering08", slow_kind="pinned_host",
                         **sv_kw)


def serve(cfg, params, prompts, new_tokens: int, device, **sv_kw):
    from repro_torch.serving import ServingEngine
    sv = serving_config(prompts, new_tokens, **sv_kw)
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
    """The kernels a serve run of ``cfg`` launches on one decode path;
    an MoE model's prefill (``moe_fwd``) also runs the bucket kernels,
    and a hybrid's fused decode (published Mamba-2 layers, which serve
    on that path only) the state update."""
    moe = any(spec.moe for spec in cfg.pattern)
    bucket = ("moe_bucket_positions", "moe_bucket_scatter",
              "moe_bucket_combine") if moe else ()
    if not fused:
        return ("decode_attention", "flash_attention") + bucket
    mamba2 = ("ssm_state_update",) if (
        cfg.mamba_groups and cfg.unit_mamba_layers) else ()
    if moe:
        return ("paged_decode_attention", "flash_attention",
                "fused_expert_ffn") + bucket + mamba2
    return ("paged_decode_attention", "flash_attention") + mamba2


def small_reference_phase(arch: str, paths=(False, True), **widen) -> dict:
    """Kernels (card) against plain versions (CPU) end to end, on
    ``arch``'s smoke config widened (``widen``) to the full model's head
    geometry, on each decode path of ``paths`` (``fused_gather``).  The
    launch counters are reset just before each run; the card's fused
    run's launches are returned.  A hybrid's card run must launch the
    state update a whole number of times per Mamba layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config(arch), **widen)
    cpu = lm.init_params(cfg, seed=SEED, device="cpu")
    gpu = lm.tree_map(lambda t: t.cuda(), cpu)
    prompts = prompts_for(cfg, 3, (40, 23))
    n_mamba = cfg.n_units * len(cfg.unit_mamba_layers)
    toks, card = {}, {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        for fused in paths:
            eng = serve(cfg, params, prompts, 8, dev, fused_gather=fused)
            _, _, launches, t = run_engine(eng)
            if dev == "cuda":
                missing = [k for k in path_kernels(cfg, fused)
                           if not launches[k]]
                if missing:
                    fail(f"small reference {arch}: {missing} never "
                         "launched")
                if launches["ssm_state_update"] % max(n_mamba, 1):
                    fail(f"small reference {arch}: "
                         f"{launches['ssm_state_update']} ssm_state_update "
                         f"launches is not a multiple of {n_mamba} Mamba "
                         "layers")
                card[fused] = launches
            toks[(name, fused)] = (t, eng.margins, eng.route_margins)
    ties = []
    for fused in paths:
        ties += agree(f"small reference {arch} (fused={fused})",
                      toks[("cpu", fused)][0], *toks[("cuda", fused)])
    log(f"small reference {arch}: card and CPU tokens agree on "
        f"{len(paths)} path(s) ({len(ties)} near tie(s)), card launches "
        f"{ {k: v for k, v in card[paths[-1]].items() if v} }")
    return {"ties": ties, "launches": card[paths[-1]]}


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


def sharded_devices() -> list:
    """The sharded phase's mesh devices: ``SHARDED_DEVICES`` logical
    devices of the one card, or the first min(4, n) cards of a machine
    with n > 1."""
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i)
                for i in range(min(SHARDED_DEVICES, n))]
    return [torch.device("cuda", 0)] * SHARDED_DEVICES


def sharded_plane(label: str, cfg, params, prompts, mapping: dict,
                  n_replicas: int, fused: bool, want: dict, prepare=None,
                  **sv_kw) -> dict:
    """One run of the cluster plane over ``sharded_devices`` under the
    axis mapping ``mapping``, with the serving options ``sv_kw`` beside
    ``fused``: every session must finish with ``NEW_TOKENS`` tokens
    equal to ``want``'s for its prompt up to near ties; a session that
    was preempted and recomputed must equal them up to its recompute
    and may part after it (the recompute is a prefill over the prompt
    and the tokens so far, whose ``moe_fwd`` drops by capacity, as the
    reference's does: another function than the decode steps it
    replaces); placing each replica's params must add 0 B on the card (a
    split leaf's shards are views, a replicated leaf is the card's one
    tensor) where the mesh is one card's logical devices; the bytes by
    replica namespace must sum to the ``*/*`` aggregate after every
    iteration.  ``prepare(plane)`` runs once the sessions are queued.
    Launch counters are set to 0 just before the run and read just
    after."""
    import torch.utils._pytree as pytree
    from repro_torch.cluster import plane as plane_mod
    from repro_torch.cluster import replica as replica_mod
    from repro_torch.cluster import sharding as sh
    from repro_torch.kernels import build
    from repro_torch.models import shardings as msh
    devices = sharded_devices()
    one_card = len(set(devices)) == 1
    placed = []
    place = replica_mod.shard_lm_params

    def measured(*a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = place(*a, **kw)
        torch.cuda.synchronize()
        placed.append(torch.cuda.memory_allocated() - before)
        return out

    t0 = time.perf_counter()
    with mock.patch.object(replica_mod, "shard_lm_params", measured), \
            sh.axis_mapping(mapping):
        plane = plane_mod.ClusterPlane(
            cfg, params, serving=serving_config(prompts, NEW_TOKENS,
                                                fused_gather=fused,
                                                **sv_kw),
            n_replicas=n_replicas, devices=devices)
    build_s = time.perf_counter() - t0
    if one_card and any(placed):
        fail(f"{label}: placing the replicas' params added {placed} B")

    def index(req):
        return next(j for j, p in enumerate(prompts)
                    if np.array_equal(p, req.prompt))

    samples = []
    recomputed = {}       # prompt index -> tokens held at its recompute
    for rep in plane.replicas.values():
        def sampled(*a, _step=rep.engine.metrics.on_iteration, **kw):
            _step(*a, **kw)
            samples.append({kind: plane.namespace_conservation(kind)
                            for kind in ("device", "pinned_host")})

        def prefill(req, now, _prefill=rep.engine._do_prefill):
            if req.out_tokens:
                recomputed.setdefault(index(req), len(req.out_tokens))
            _prefill(req, now)
        rep.engine.metrics.on_iteration = sampled
        rep.engine._do_prefill = prefill
    for p in prompts:
        plane.submit(p, NEW_TOKENS)
    if prepare is not None:
        prepare(plane)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = plane.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    shapes = {f"{k}{list(shape)}": n
              for (k, shape), n in build.SHAPE_LAUNCHES.items()}
    tokens, margins, preempted = {}, {}, {}
    for rep in plane.replicas.values():
        for req in rep.engine.sched.finished:
            i = index(req)
            tokens[i] = list(req.out_tokens)
            margins[i] = rep.engine.margins[req.rid]
            preempted[i] = req.preemptions
    if sorted(tokens) != list(range(len(prompts))) or any(
            len(t) != NEW_TOKENS for t in tokens.values()):
        fail(f"{label}: not every session finished with {NEW_TOKENS} "
             "tokens")
    ties = agree(f"{label} vs single engine",
                 {i: t for i, t in want["tokens"].items()
                  if i not in recomputed}, tokens, margins)
    for i, n in sorted(recomputed.items()):
        ours, theirs = tokens[i], want["tokens"][i]
        if ours[:n] != theirs[:n]:
            fail(f"{label}: session {i} parts from the single engine "
                 f"before its recompute after {n} tokens")
        step = next((k for k, (x, y) in enumerate(zip(ours, theirs))
                     if x != y), None)
        log(f"{label}: session {i} recomputed after {n} tokens; "
            + ("equal to the single engine" if step is None else
               f"parts from the single engine at step {step}, top-2 "
               f"margin {margins[i][step]:.4g}"))
    for sample in samples:
        for kind, cons in sample.items():
            if sum(v for h, v in cons.items() if h != "total") \
                    != cons["total"]:
                fail(f"{label}: {kind} bytes by replica {cons} do not sum "
                     "to the */* aggregate")
    split = sorted("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
                   for path, leaf in pytree.tree_flatten_with_path(
                       plane.replicas[next(iter(plane.replicas))].params,
                       is_leaf=lambda t: isinstance(t, msh.ShardedTensor))[0]
                   if msh.is_split(leaf))
    s = report.summary
    log(f"serve {label}: mesh {[str(d) for d in devices]} "
        f"({'logical devices of one card' if one_card else 'cards'}), "
        f"{n_replicas} replica(s) of {len(devices) // n_replicas} "
        f"device(s), mapping {mapping}: wall={wall:.2f} s "
        f"throughput={s['throughput_tok_s']:.1f} tok/s "
        f"({len(prompts) * NEW_TOKENS / wall:.1f} over the wall; single "
        f"engine {want['summary']['throughput_tok_s']:.1f}) "
        f"worst_p95_latency={s['worst_p95_latency_s'] * 1e3:.1f} ms "
        f"plane built in {build_s:.2f} s, placement added {placed} B, "
        f"split leaves {len(split)} ({split[:3]}...), ledger conserved "
        f"over {len(samples)} iterations, {len(ties)} near tie(s), "
        f"launches={launches} by shape {shapes}")
    return {"summary": s, "wall_s": wall, "launches": launches,
            "shape_launches": shapes, "sharded": True, "ties": ties,
            "tokens": tokens, "preempted": preempted,
            "recomputed": recomputed,
            "replicas": {h: {"summary": r.summary,
                             "telemetry": r.telemetry, "slo": r.slo}
                         for h, r in report.per_replica.items()},
            "placed_bytes": placed,
            "ledger_samples": len(samples), "split_leaves": split,
            "devices": [str(d) for d in devices], "plane": plane}


def vocab_argmax_check(label: str, head, gen) -> dict:
    """Greedy argmax over a vocab-split head's blocks
    (``models.shardings.argmax``) against ``torch.argmax`` over the
    gathered row, on 8 rows of hidden states; then with the offset of
    every block after the first off by one (a planted fault), which
    must disagree."""
    from repro_torch.models import shardings as msh
    x = randn_bf16(gen, 8, head.shape[1])
    logits = msh.vocab_logits(x, head)
    want = torch.argmax(msh.gather(logits), dim=-1)
    if not torch.equal(msh.argmax(logits), want):
        fail(f"{label}: argmax over vocab blocks != torch.argmax")
    blocks = msh.ShardedTensor.blocks

    def shifted(self, dim):
        return [(lo + (1 if lo else 0), hi, d, t)
                for lo, hi, d, t in blocks(self, dim)]

    with mock.patch.object(msh.ShardedTensor, "blocks", shifted):
        bad = msh.argmax(logits)
    wrong = int((bad != want).sum())
    if not wrong:
        fail(f"{label}: the planted shard-offset fault passed the argmax "
             "check")
    log(f"{label}: argmax over {len(head.blocks(0))} vocab blocks equals "
        f"torch.argmax on 8 rows; with the offsets off by one {wrong} of "
        "8 rows differ")
    return {"rows": 8, "fault_rows": wrong}


def sharded_moe_phase(cfg, params, prompts, staged: dict,
                      fused: dict) -> dict:
    """qwen3-moe-30b-a3b over ``SHARDED_DEVICES`` logical devices (one
    replica), experts and vocab split (``SHARDED_MOE_MAPPING``), staged
    then fused on the weights the MoE phases hold: tokens equal to
    those phases' up to near ties; the fused run launches the range form
    of ``fused_expert_ffn`` once per expert shard per MoE layer and
    step, and never the whole kernel; the staged run none."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n_moe = cfg.n_units * sum(spec.moe for spec in cfg.pattern)
    out = {}
    for path, want in (("staged", staged), ("fused", fused)):
        label = f"{cfg.name} sharded x{SHARDED_DEVICES} {path}"
        run = sharded_plane(label, cfg, params, prompts,
                            SHARDED_MOE_MAPPING, 1, path == "fused", want)
        plane = run.pop("plane")
        experts = run["launches"]["fused_expert_ffn"]
        shards = len(plane.replicas["host0"].mesh.devices.flat)
        whole = sum(n for k, n in run["shape_launches"].items()
                    if k.startswith("fused_expert_ffn")
                    and k.endswith(f", {cfg.n_experts}]"))
        if path == "fused":
            if not experts or experts % (shards * n_moe) or whole:
                fail(f"{label}: {experts} fused_expert_ffn launches "
                     f"({whole} of the whole kernel), not a multiple of "
                     f"{shards} shards x {n_moe} MoE layers")
            log(f"{label}: fused_expert_ffn {experts} launches = "
                f"{shards} x {n_moe} MoE layers x "
                f"{experts // (shards * n_moe)} decode steps")
            head = plane.replicas["host0"].engine.params[
                "embed" if cfg.tie_embeddings else "lm_head"]
            run["argmax"] = vocab_argmax_check(label, head, gen)
        elif experts:
            fail(f"{label}: fused_expert_ffn launched off the fused path")
        out[f"sharded {path}"] = run
        del plane
    return out


def sharded_experts_phase(cfg, params, prompts, fused: dict,
                          experts: dict, sharded: dict) -> dict:
    """qwen3-moe-30b-a3b through the plane as ``sharded_moe_phase``'s
    fused run (one replica over ``SHARDED_DEVICES`` logical devices,
    experts and vocab split) with expert residency over the split store
    (``expert_policy="predictive"``, ``EXPERT_FAST_FRACTION`` fast)
    under every control plane of ``control_planes_phase``, QoS with a
    p99 decode SLO of ``SLO_FRACTION`` of the sharded fused run's p95
    decode gap.  Tokens must equal ``sharded``'s exactly for every
    request QoS never preempted, and up to its recompute for one it did
    (``sharded_plane``); the routing feed must see every live
    row of every decode step once per MoE layer; an expert must be
    promoted; the range form of ``fused_expert_ffn`` must launch once
    per expert shard per MoE layer and decode step, the whole kernel
    never.  Where the routing feed equals ``experts``' (one device) call
    for call, so must the expert counters: residency reads the routed
    ids and the epochs only."""
    from repro_torch.serving.expert_pool import moe_layers_from_config
    label = (f"{cfg.name} sharded x{SHARDED_DEVICES} fused, experts "
             "+ control planes")
    n_moe = moe_layers_from_config(cfg)
    slo = SLO_FRACTION * sharded["replicas"]["host0"]["summary"][
        "p95_decode_gap_s"]
    hooks = {}

    def prepare(plane):
        eng = plane.replicas["host0"].engine
        hooks["engine"] = eng
        hooks["count"], hooks["feed"] = count_routing(eng)
        hooks["fitted0"] = eng.calibrator.calibrated_tiers()[
            eng.pool.slow_kind].peak_bw_GBps

    run = sharded_plane(
        label, cfg, params, prompts, SHARDED_MOE_MAPPING, 1, True, sharded,
        prepare=prepare, adaptive=True, replan_every=REPLAN_EVERY,
        predictive=True, calibrate=True, topology="h100-node", qos=True,
        slo_p99_decode_s=slo, expert_policy="predictive",
        expert_fast_fraction=EXPERT_FAST_FRACTION)
    plane = run.pop("plane")
    eng, count = hooks["engine"], hooks["count"]
    count["feed"] = hooks["feed"].hexdigest()
    shards = len(plane.replicas["host0"].mesh.devices.flat)
    for name in path_kernels(cfg, True)[:2]:
        if run["launches"][name] <= 0:
            fail(f"{label}: kernel {name} was never launched")
    ranged = run["launches"]["fused_expert_ffn"]
    whole = sum(n for k, n in run["shape_launches"].items()
                if k.startswith("fused_expert_ffn")
                and k.endswith(f", {cfg.n_experts}]"))
    if ranged != shards * n_moe * count["decodes"] or whole:
        fail(f"{label}: {ranged} fused_expert_ffn launches ({whole} of "
             f"the whole kernel), not {shards} shards x {n_moe} MoE "
             f"layers x {count['decodes']} decode steps")
    preempted = run["preempted"]
    bad = sorted(i for i, t in run["tokens"].items()
                 if not preempted[i] and t != sharded["tokens"][i])
    if bad:
        fail(f"{label}: requests {bad}, never preempted, have other "
             "tokens than the sharded fused run")
    if count["calls"] != count["rows"] * n_moe:
        fail(f"{label}: {count['calls']} record_routing calls, not "
             f"{count['rows']} live rows x {n_moe} MoE layers")
    rp = run["replicas"]["host0"]
    t, s = rp["telemetry"], rp["summary"]
    if t["expert.promoted"] < 1:
        fail(f"{label}: no expert was promoted")
    keys = ("expert.accesses", "expert.fast_hits", "expert.promoted",
            "expert.demoted", "expert.prefetch_promotes",
            "expert.prefetch_hits")
    ours = {k: int(t[k]) for k in keys}
    one = {k: int(experts["telemetry"][k]) for k in keys}
    same_feed = count["feed"] == experts["routing"]["feed"]
    if same_feed and ours != one:
        fail(f"{label}: the routing feed equals the one-device run's, "
             f"call for call, but the expert counters {ours} differ from "
             f"its {one}")
    log(f"{label}: expert counters {ours}, one device (5b) {one}; "
        f"5b' fused tokens "
        f"{'equal' if sharded['tokens'] == fused['tokens'] else 'differ from'}"
        f" phase 5's, {sum(map(bool, preempted.values()))} request(s) "
        f"preempted, routing feed {'equal to' if same_feed else 'unlike'}"
        f" the one-device run's ({count['calls']} calls against "
        f"{experts['routing']['calls']})")
    blame = rp["slo"]["blame"]
    fitted = eng.calibrator.calibrated_tiers()[eng.pool.slow_kind]
    s0, s1 = sharded["replicas"]["host0"]["summary"], experts["summary"]
    log(f"serve {label}: wall={run['wall_s']:.2f} s "
        f"throughput={s['throughput_tok_s']:.1f} tok/s (5b' sharded fused "
        f"{s0['throughput_tok_s']:.1f}, 5b one device "
        f"{s1['throughput_tok_s']:.1f}) "
        f"p95_decode_gap={s['p95_decode_gap_s'] * 1e3:.1f} ms "
        f"({s0['p95_decode_gap_s'] * 1e3:.1f}; p99 SLO {slo * 1e3:.2f} ms) "
        f"fast_hit_ratio={t.get('expert.fast_hit_ratio', 0.0):.4f} "
        f"prefetch_hit_ratio={t.get('expert.prefetch_hit_ratio', 0.0):.4f} "
        f"replans={int(t['replans_applied'])}/"
        f"{int(t['replans_considered'])} "
        f"moved_bytes={int(t['moved_bytes'])} "
        f"arbiter_rebalances={int(t['arbiter_rebalances'])} "
        f"movesched_rounds={int(t['movesched.rounds'])} "
        f"qos_deferrals={int(t['qos_deferrals'])} "
        f"slo_preemptions={int(t['slo_preemptions'])} "
        f"preempted={sorted(i for i, n in preempted.items() if n)} "
        f"violations={rp['slo']['targets'][0]['violations']} "
        f"excursions={blame['total_excursions']} "
        f"top_link={blame.get('top_link')} "
        f"calibrated {eng.pool.slow_kind} {fitted.peak_bw_GBps:.2f} GB/s "
        f"(start-up {hooks['fitted0']:.2f}) "
        f"record_routing={count['calls']} calls over {count['rows']} live "
        f"rows in {count['decodes']} decode steps ({count['record_s']:.3f} "
        f"s on the host) expert steps {count['step_s']:.3f} s")
    run.update(telemetry=t, routing=count, counters=ours,
               one_device_counters=one, same_feed=same_feed,
               slo_s=slo, blame=blame,
               calibrated_GBps=(hooks["fitted0"], fitted.peak_bw_GBps))
    return run


def sharded_dense_phase(cfg, params, prompts, staged: dict) -> dict:
    """llama3-8b through the plane: ``SHARDED_DENSE_REPLICAS`` replicas
    of ``SHARDED_DEVICES // SHARDED_DENSE_REPLICAS`` logical devices,
    vocab split, staged: sessions equal to the single engine's up to
    near ties."""
    run = sharded_plane(
        f"{cfg.name} sharded plane {SHARDED_DENSE_REPLICAS}x"
        f"{SHARDED_DEVICES // SHARDED_DENSE_REPLICAS}", cfg, params,
        prompts, SHARDED_DENSE_MAPPING, SHARDED_DENSE_REPLICAS, False,
        staged)
    run["routed"] = run.pop("plane").router.routed_counts()
    if not all(run["routed"].values()):
        fail(f"{cfg.name} sharded plane: routed {run['routed']}")
    return run


def count_routing(eng) -> tuple:
    """Wrap the routing feed of ``eng``'s expert pool, its expert epochs
    and its fused decode: counts ``record_routing`` calls, live rows and
    decode calls, times the feed and the epochs on the host, and digests
    the feed in order, each call's (layer, step, routed ids), so that
    two runs' feeds compare.  Returns (counts, digest)."""
    pool = eng.expert_pool
    count = {"calls": 0, "rows": 0, "decodes": 0, "record_s": 0.0,
             "step_s": 0.0}
    feed = hashlib.sha256()
    record, step, decode = (pool.record_routing, pool.step,
                            eng._fused_decode_batch)

    def counted_record(layer, ids, at):
        t0 = time.perf_counter()
        record(layer, ids, at)
        count["calls"] += 1
        count["record_s"] += time.perf_counter() - t0
        feed.update(np.asarray([layer, at, *ids], np.int64).tobytes())

    def timed_step(*a, **kw):
        t0 = time.perf_counter()
        step(*a, **kw)
        count["step_s"] += time.perf_counter() - t0

    def counted_decode(batch):
        count["rows"] += len(batch)
        count["decodes"] += 1
        return decode(batch)
    pool.record_routing, pool.step = counted_record, timed_step
    eng._fused_decode_batch = counted_decode
    return count, feed


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
    count, feed = count_routing(eng)
    rep, wall, launches, tokens = run_engine(eng)
    count["feed"] = feed.hexdigest()
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
    fp32, and the RWKV layers' token-shift states and the Mamba layers'
    conv states carried in the input's dtype, not rounded to the cache's
    bf16 (the conv state: the last d_conv - 1 rows of the in-projection,
    taken again through ``_mamba_split``)."""
    from repro_torch.models import lm
    from repro_torch.models import modules as M
    embed, tmix, cmix = lm._embed_tokens, M.rwkv_tmix_fwd, M.rwkv_cmix_fwd
    mamba = M.mamba_fwd

    def tmix_fp32(p, x, dims, **kw):
        out, (state, _) = tmix(p, x, dims, **kw)
        return out, (state, x[:, -1])

    def cmix_fp32(p, x, shift_state=None):
        return cmix(p, x, shift_state)[0], x[:, -1]

    def mamba_fp32(p, x, dims, conv_state=None, ssm_state=None):
        out, (_, ssm) = mamba(p, x, dims, conv_state, ssm_state)
        xs = M._mamba_split(p, x, dims)[0]
        pad = (xs.new_zeros((x.shape[0], dims.d_conv - 1, dims.d_inner))
               if conv_state is None else conv_state.to(xs.dtype))
        return out, (torch.cat([pad, xs], dim=1)[:, -(dims.d_conv - 1):],
                     ssm)
    with mock.patch.object(lm, "_embed_tokens",
                           lambda *a, **kw: embed(*a, **kw).float()), \
            mock.patch.object(M, "rwkv_tmix_fwd", tmix_fp32), \
            mock.patch.object(M, "rwkv_cmix_fwd", cmix_fp32), \
            mock.patch.object(M, "mamba_fwd", mamba_fp32):
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


def recurrent_forms(kind: str, dims) -> tuple:
    """The forms of one recurrent layer's forward (``kind`` "rwkv":
    RWKV6's time-mix, "mamba": Mamba-2), each ``fn(p, x) -> out``:
    (the step form, the checked forms, the planted faults).  The step
    form runs the decode recurrence, one token a call, its states
    carried from zeros; the checked forms are the chunked scan over all
    tokens, and over two halves with the states carried between them;
    the faults are the two halves with the carried states detached, and
    the chunked scan with ``RECURRENT_FAULT_LEAVES`` detached (the bonus
    or skip, and the inputs of the data-dependent decay).  None of the
    faults changes the forward.  The modules are looked up when called,
    so ``fp32_activations`` reaches them."""
    from repro_torch.models import modules as M

    def fwd(p, x, state=None):
        if kind == "rwkv":
            ws, sh = state if state is not None else (None, None)
            return M.rwkv_tmix_fwd(p, x, dims, wkv_state=ws, shift_state=sh)
        cs, ss = state if state is not None else (None, None)
        return M.mamba_fwd(p, x, dims, conv_state=cs, ssm_state=ss)

    def step(p, x):
        B = x.shape[0]
        state = None if kind == "rwkv" else (
            x.new_zeros((B, dims.d_conv - 1, dims.d_inner)),
            torch.zeros((B, dims.n_heads, dims.d_state, dims.head_dim),
                        device=x.device))
        outs = []
        for t in range(x.shape[1]):
            out, state = fwd(p, x[:, t:t + 1], state)
            outs.append(out)
        return torch.cat(outs, dim=1)

    def halves(detach: bool):
        def run(p, x):
            h = x.shape[1] // 2
            first, state = fwd(p, x[:, :h])
            if detach:
                state = tuple(s.detach() for s in state)
            return torch.cat([first, fwd(p, x[:, h:], state)[0]], dim=1)
        return run

    def detached(names):
        def run(p, x):
            return fwd({k: v.detach() if k in names else v
                        for k, v in p.items()}, x)[0]
        return run

    bonus, decay = RECURRENT_FAULT_LEAVES[kind]
    return step, {"chunked": lambda p, x: fwd(p, x)[0],
                  "two halves": halves(False)}, {
        "state detached between halves": halves(True),
        "/".join(bonus) + " detached": detached(bonus),
        "/".join(decay) + " detached": detached(decay)}


def layer_grads(fn, p, x, w) -> tuple:
    """Gradients of ``sum(fn(p, x) * w)`` with respect to x and every
    leaf of ``p``, by name ("x", "mix_r", "ln_x.scale", ...; a leaf the
    function does not reach gets zeros), and the forward and backward
    seconds, each ended by a synchronize on a card."""
    import torch.utils._pytree as pytree
    flat, spec = pytree.tree_flatten_with_path(p)
    names = ["x"] + [".".join(str(getattr(k, "key", k)) for k in path)
                     for path, _ in flat]
    wrt = [x.detach().requires_grad_()] + [
        t.detach().requires_grad_() for _, t in flat]

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize()
        return time.perf_counter()
    with torch.enable_grad():
        t0 = sync()
        loss = (fn(pytree.tree_unflatten(wrt[1:], spec), wrt[0]).float()
                * w).sum()
        t1 = sync()
        got = torch.autograd.grad(loss, wrt, allow_unused=True)
        t2 = sync()
    return ({n: torch.zeros_like(t) if g is None else g
             for n, t, g in zip(names, wrt, got)}, t1 - t0, t2 - t1)


def grad_errors(got: dict, want: dict) -> dict:
    """Per leaf: ||got - want|| / ||want||."""
    return {n: ((got[n].float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
            for n, w in want.items()}


def recurrent_grad_readings(kind: str, dims, p, x, w) -> dict:
    """Each checked form's and each planted fault's largest per-leaf
    gradient error against the step form (``grad_errors``), with its
    leaf, and the forward and backward ms of the chunked and the step
    forms; all under ``fp32_activations`` (states carried in fp32)."""
    step, forms, faults = recurrent_forms(kind, dims)
    out = {"forms": {}, "faults": {}, "ms": {}}
    with fp32_activations():
        want, *t_step = layer_grads(step, p, x, w)
        for group, fns in (("forms", forms), ("faults", faults)):
            for name, fn in fns.items():
                got, *t = layer_grads(fn, p, x, w)
                errs = grad_errors(got, want)
                leaf = max(errs, key=errs.get)
                out[group][name] = {"max": errs[leaf], "leaf": leaf}
                if name == "chunked":
                    out["ms"]["chunked"] = [s * 1e3 for s in t]
                    out["leaves"] = errs
                del got
    out["ms"]["step"] = [s * 1e3 for s in t_step]
    return out


def recurrent_backward_phase() -> dict:
    """The recurrent layers' backward at full width, in fp32: rwkv6-7b's
    time-mix layer (d_model 4096, 64 heads of 64, chunk 64) over
    ``RWKV_GRAD_BATCH`` x ``RECURRENT_GRAD_SEQ`` tokens, and jamba's
    Mamba-2 layer as ``mamba_layer_phase`` builds it over
    ``MAMBA_GRAD_BATCH`` x ``RECURRENT_GRAD_SEQ``, weights from ``SEED``
    upcast to fp32, x and w ~ N(0, 1): every leaf's gradient of
    ``sum(out * w)`` through the chunked scan (all tokens in one call,
    and in two halves) within ``RECURRENT_GRAD_REL`` of the one-token
    recurrence's, and every planted fault of ``recurrent_forms`` above
    it.  Prints each reading, the forward and backward ms of both forms
    and each layer's wall seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models import modules as M
    rwkv, jamba = get_config(RECURRENT_ARCH), get_config(JAMBA_ARCH)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    layers = {
        "rwkv": (M.rwkv_dims(rwkv.d_model, rwkv.d_ff, rwkv.rwkv_head_dim,
                             rwkv.rwkv_chunk), M.init_rwkv_tmix,
                 RWKV_GRAD_BATCH, rwkv.d_model),
        "mamba": (M.mamba_dims(jamba.d_model, jamba.mamba_expand,
                               jamba.mamba_head_dim, jamba.mamba_d_state,
                               jamba.mamba_d_conv, jamba.ssd_chunk),
                  M.init_mamba, MAMBA_GRAD_BATCH, jamba.d_model)}
    out = {}
    for kind, (dims, init, batch, d) in layers.items():
        p = lm.tree_map(lambda t: t.float(), init(dims, g, "cuda"))
        shape = (batch, RECURRENT_GRAD_SEQ, d)
        x = torch.randn(shape, generator=g, device="cuda")
        w = torch.randn(shape, generator=g, device="cuda")
        t0 = time.perf_counter()
        r = recurrent_grad_readings(kind, dims, p, x, w)
        r["wall_s"] = time.perf_counter() - t0
        log(f"recurrent backward {kind} ({dims}) over {batch} x "
            f"{RECURRENT_GRAD_SEQ}, fp32, against the one-token "
            "recurrence: "
            + " ".join(f"{k}={v['max']:.3g} ({v['leaf']})"
                       for k, v in r["forms"].items())
            + "; planted faults: "
            + " ".join(f"{k}={v['max']:.3g} ({v['leaf']})"
                       for k, v in r["faults"].items())
            + f" (limit {RECURRENT_GRAD_REL}); fwd/bwd ms chunked "
            + "/".join(f"{t:.1f}" for t in r["ms"]["chunked"]) + ", step "
            + "/".join(f"{t:.1f}" for t in r["ms"]["step"])
            + f"; {r['wall_s']:.1f} s, {memory()}")
        for name, v in r["forms"].items():
            if not v["max"] < RECURRENT_GRAD_REL:
                fail(f"recurrent backward {kind}: {name} vs the one-token "
                     f"recurrence: {v['leaf']} off by {v['max']:.4g}")
        for name, v in r["faults"].items():
            if not v["max"] > RECURRENT_GRAD_REL:
                fail(f"recurrent backward {kind}: the check does not see "
                     f"the planted fault '{name}' ({v['max']:.4g})")
        out[kind] = r
        del p, x, w
        gc.collect()
        torch.cuda.empty_cache()
    return out


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
    variant and its full-width Mamba layer, the recurrent layers'
    backward at full width, and an int8 KV cache."""
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
                        ("recurrent backward", recurrent_backward_phase),
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
    (``PROFILE_GROUPS``) and the top kernels.  Returns {} where the
    profiler saw no device time."""
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
        f"iterations={iterations} "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in cats.items()))
    for key, sec, n in rows[:8]:
        log(f"  {sec * 1e3:9.2f} ms  {n:6d}x  {key[:90]}")
    for key, sec, n in port:
        log(f"  port kernel {sec * 1e3:8.3f} ms  {n:6d}x  {key[:70]}")
    return {"wall_s": wall, "device_busy_s": busy,
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
        t0 = time.perf_counter()
        out["sharded plane"] = sharded_dense_phase(cfg, params, prompts,
                                                   out["staged"])
        log(f"sharded {arch}: {time.perf_counter() - t0:.1f} s, "
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
        t0 = time.perf_counter()
        out.update(sharded_moe_phase(cfg, params, prompts, out["staged"],
                                     out["fused"]))
        log(f"sharded {arch}: {time.perf_counter() - t0:.1f} s, "
            f"{memory()}")
        t0 = time.perf_counter()
        out["sharded experts"] = sharded_experts_phase(
            cfg, params, prompts, out["fused"], out["experts"],
            out["sharded fused"])
        log(f"sharded experts {arch}: {time.perf_counter() - t0:.1f} s, "
            f"{memory()}")
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


def log_steps(timings) -> None:
    for i, t in enumerate(timings):
        log(f"  step {i + 1}: loss={t.loss:.5f} "
            f"fwd_bwd={t.fwd_bwd_s:.3f} s grad_xfer={t.grad_xfer_s:.3f} "
            f"s optimizer={t.optimizer_s:.3f} s "
            f"param_xfer={t.param_xfer_s:.4f} s total={t.total_s:.3f} s")


def check_train_run(label: str, timings, launches, leaves: int) -> None:
    """Finite losses; ``fused_adam`` once per leaf per step, and no
    other kernel."""
    losses = [t.loss for t in timings]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    if launches["fused_adam"] != leaves * len(timings):
        fail(f"{label}: {launches['fused_adam']} fused_adam launches, "
             f"expected {leaves} leaves x {len(timings)} steps")
    others = {k: v for k, v in launches.items() if v and k != "fused_adam"}
    if others:
        fail(f"{label}: serving kernels launched {others}")


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


def host_meminfo_gib(key: str) -> float:
    """``key`` of the host's ``/proc/meminfo`` (``MemTotal``,
    ``MemAvailable``), GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def release_pinned_cache() -> None:
    """Hand the pinned host blocks that PyTorch's host allocator keeps
    after their tensors are freed back to the OS, so an earlier phase's
    pinned memory does not count against the next one's."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._host_emptyCache()


def host_pinned() -> str:
    """The pinned host memory PyTorch's host allocator holds, and the
    host's available memory (the OS takes freed pinned pages back some
    seconds after the allocator releases them)."""
    held = torch.cuda.host_memory_stats().get("allocated_bytes.current", 0)
    return (f"pinned host allocator holds {held / 2**30:.2f} GiB, host "
            f"MemAvailable {host_meminfo_gib('MemAvailable'):.2f} of "
            f"{host_meminfo_gib('MemTotal'):.2f} GiB")


def pinned_need_gib(cfg) -> float:
    """GiB of pinned host memory ``ZeroOffloadEngine`` takes for
    ``cfg`` with its state all pinned: per leaf, the fp32 master, m and
    v and the grad buffer, each a block that PyTorch's pinned allocator
    rounds up to a power of two (its shapes from fake tensors)."""
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import lm

    def block(n: int) -> int:
        return 1 << (n - 1).bit_length()
    with FakeTensorMode():
        leaves = pytree.tree_leaves(lm.init_params(cfg, device="cpu"))
    return sum(3 * block(4 * t.numel()) + block(t.nbytes)
               for t in leaves) / 2**30


def train_recurrent() -> dict:
    """ZeRO-Offload training of ``RECURRENT_ARCH`` at full width and
    ``RECURRENT_TRAIN_LAYERS`` layers, once the serve phases' weights
    are freed: random weights from ``SEED`` on the card, batches of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` from the port's ``DataIterator``,
    the learning rate of ``train_engine``, the fp32 state all on pinned
    host memory; ``RECURRENT_TRAIN_STEPS`` steps.  Each step prints its
    loss and its Fig. 9 phases; the losses must be finite and fall from
    the first step to the last, ``fused_adam`` must launch once per leaf
    per step and no other kernel at all, and the state must be 12 bytes
    a parameter on pinned host memory and none on the device.  Prints
    the peak device memory beside the card's, and the host's memory."""
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.core import LOGICAL_KINDS
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.models import lm
    arch, n_steps = RECURRENT_ARCH, RECURRENT_TRAIN_STEPS
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=RECURRENT_TRAIN_LAYERS)
    release_pinned_cache()
    log(f"train {arch}: pinned host memory of the state and grad buffers"
        f" at {cfg.n_layers} layers {pinned_need_gib(cfg):.2f} GiB, at "
        f"{get_config(arch).n_layers} {pinned_need_gib(get_config(arch)):.2f}"
        f" GiB; before, {host_pinned()}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    leaves = n_leaves(params)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    eng = train_engine(cfg, params, (("pinned_host", 1.0),), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    on = {kind: eng.opt_state_bytes_on(kind) for kind in LOGICAL_KINDS}
    log(f"train {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters in "
        f"{leaves} leaves): params and engine {init_s:.1f} s, opt state "
        f"bytes " + " ".join(f"{k}={v}" for k, v in on.items())
        + f" (12 x params = {12 * n_params}), lr {eng.off.adam.lr:.4g}, "
        f"{memory()}; {host_pinned()}")
    if on["pinned_host"] != 12 * n_params or on["device"] \
            or on["unpinned_host"]:
        fail(f"train {arch}: the fp32 state is not all on pinned host "
             "memory")
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=SEED))
    timings, launches, wall = run_train(eng,
                                        [next(it) for _ in range(n_steps)])
    log_steps(timings)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    check_train_run(f"train {arch}", timings, launches, leaves)
    losses = [t.loss for t in timings]
    if not losses[-1] < losses[0]:
        fail(f"train {arch}: the loss did not fall ({losses})")
    log(f"train {arch}: wall={wall:.2f} s launches={launches} peak device "
        f"memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB "
        f"({(total - peak) / 2**30:.2f} GiB free at the peak); "
        f"{host_pinned()}")
    out = {"pinned": {
        "n_layers": cfg.n_layers, "n_params": n_params, "leaves": leaves,
        "init_s": init_s, "wall_s": wall, "opt_state_bytes": on,
        "launches": launches, "losses": losses, "peak_bytes": peak,
        "total_memory": total,
        "steps": [dataclasses.asdict(t) for t in timings]}}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned_cache()
    log(f"train {arch}: after, {host_pinned()}")
    return out


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
        log_steps(timings)
        check_train_run(f"train {arch} {label}", timings, launches, leaves)
        losses = [t.loss for t in timings]
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


def run_launcher(argv, cfg=None, devices=None) -> tuple:
    """``launch.train.run`` on ``argv`` (its ``--mesh`` over ``devices``,
    where given), the launch counters set to 0 just before; with
    ``cfg``, the ``--arch``'s config is ``cfg`` (its cut in depth) for
    the call.  Returns (its ``TrainRun``, launches,
    wall s, its standard output, which is also echoed)."""
    import io

    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(argv)
    build.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    cut = contextlib.nullcontext() if cfg is None else \
        mock.patch.object(train_cli, "get_config", lambda arch: cfg)
    with contextlib.redirect_stdout(buf), cut:
        res = train_cli.run(args, devices)
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


def launcher_phase(arch: str, n_layers: int = 0) -> dict:
    """``launch.train --adaptive`` on ``arch`` at full width and depth
    (``n_layers`` > 0: cut to that many layers, through ``run_launcher``'s
    ``cfg``): the fp32 optimizer state starts on pinned host memory in a
    ``TieredStateStore`` and the replanner's moves copy its blocks to
    the card.  At least one replan must be applied beyond the initial
    plan and move bytes; every block must sit on the kind its tier label
    names; the ledger must hold the store's bytes, its fast share within
    0.05 of the plan's; the trace, metrics and audit report must read
    back non-empty; the loss at the last step must be below step 0's; no
    hand-written kernel may launch (the launcher's step is the plain
    AdamW and attention, as the reference's)."""
    from repro_torch.configs import get_config
    from repro_torch.obs import TraceRecorder
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers) \
        if n_layers else None
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        arts = {n: str(Path(tmp) / n) for n in ("t.jsonl", "m.prom",
                                                 "a.json")}
        res, launches, wall, text = run_launcher([
            "--arch", arch, "--steps", str(LAUNCHER_STEPS),
            "--batch", "8", "--seq", "128", "--adaptive",
            "--replan-every", "2", "--lr", repr(launcher_lr(arch)),
            "--trace-out", arts["t.jsonl"], "--metrics-out", arts["m.prom"],
            "--audit-out", arts["a.json"]], cfg)
        events = TraceRecorder.read_jsonl(arts["t.jsonl"])
        prom = Path(arts["m.prom"]).read_text()
        audit = json.loads(Path(arts["a.json"]).read_text())
    peak = torch.cuda.max_memory_allocated()
    telem = res.telem
    label = f"launcher {arch}" + (f" ({n_layers} layers)" if n_layers
                                  else "")
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
    release_pinned_cache()
    return out


def jamba_launcher_phase() -> dict:
    """The launcher on jamba's smoke variant (Mamba-2, MoE and attention;
    ``--smoke``, the launcher's own learning rate) on the card,
    ``JAMBA_LAUNCHER_STEPS`` steps of 8 x 128 tokens: the losses must be
    finite and fall from the first step to the last, and no hand-written
    kernel may launch."""
    label = f"launcher {JAMBA_ARCH} smoke"
    res, launches, wall, _ = run_launcher([
        "--arch", JAMBA_ARCH, "--smoke", "--steps",
        str(JAMBA_LAUNCHER_STEPS), "--batch", "8", "--seq", "128"])
    losses = [res.losses[i] for i in sorted(res.losses)]
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"{label}: losses {losses}")
    if any(launches.values()):
        fail(f"{label}: hand-written kernels launched {launches}")
    log(f"{label}: wall={wall:.2f} s step_s="
        + " ".join(f"{res.step_s[i]:.3f}" for i in sorted(res.step_s))
        + f" losses={[round(x, 5) for x in losses]}")
    return {"wall_s": wall, "step_s": res.step_s, "losses": losses,
            "launches": launches}


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


# ---------------------------------------------------------------------- #
# training over FSDP x TP meshes of logical devices                       #
# ---------------------------------------------------------------------- #
def mesh_devices(spec: str) -> list:
    """The card named once per entry of the ``--mesh`` spec."""
    return [torch.device("cuda", 0)] * math.prod(
        int(d) for d in spec.split("x"))


def distinct_bytes(*trees) -> int:
    """Bytes of the distinct storages the trees' tensors (each placed
    leaf's blocks) hold."""
    import torch.utils._pytree as pytree

    from repro_torch.models import shardings as sh
    seen = {}
    for tree in trees:
        for leaf in pytree.tree_leaves(tree):
            for t in sh.local_tensors(leaf):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def sharded_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SHARDED_TRAIN_ARCH),
                               n_layers=SHARDED_TRAIN_LAYERS)


def sharded_batches(cfg, n: int) -> list:
    """The launcher's first ``n`` batches of 8 x 128 on the card."""
    from repro_torch.data import DataConfig, DataIterator
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=128,
                                 global_batch=8))
    return [{k: torch.from_numpy(b[k]).cuda() for k in ("tokens", "labels")}
            for b in (next(it) for _ in range(n))]


def first_blocks(params) -> set:
    """The positions, among one step's ``fused_adam`` calls (leaves in
    tree order, each leaf's distinct blocks in mesh order), of the
    blocks the mesh's first entry holds: each leaf's first."""
    import torch.utils._pytree as pytree

    from repro_torch.models import shardings as sh
    out, i = set(), 0
    for x in pytree.tree_leaves(params):
        out.add(i)
        i += len(sh.local_tensors(x))
    return out


def step_route(cfg, spec: str, batches, first: int = 0, state=None,
               check: bool = False, save=None, fault=None,
               keep: bool = False) -> dict:
    """``launch.steps.make_train_step`` with ``fused_adam`` on ``cfg``
    placed on ``spec`` over logical devices of the card (seeded weights,
    or ``state``, a restored {"params", "opt"}), one step per batch from
    step ``first``, the launch counters set to 0 just before.  ``check``:
    at the first step every ``fused_adam`` call's result is held against
    the plain update of the same block (``check_adam``).  ``save``: (dir,
    n) checkpoints after n steps.  ``fault``: "skip" leaves the first
    mesh entry's shard (its block of every leaf) unupdated at every
    step; "drop" drops data shard 1's gradient (its loss still
    counted).  ``keep``: the final state stays on the card, in the
    result's "state"."""
    import torch.utils._pytree as pytree

    from repro_torch.checkpoint import store
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, shardings as sh
    from repro_torch.optim import AdamConfig, init_state
    acfg = AdamConfig(lr=launcher_lr(SHARDED_TRAIN_ARCH),
                      use_fused_kernel=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = train.parse_mesh(spec, "cuda", devices=mesh_devices(spec))
    if state is None:
        params = lm.init_params(cfg, seed=SEED, device="cuda")
        params = sh.to_named(params, sh.param_pspecs(params, mesh), mesh)
        opt = init_state(params, acfg)
    else:
        params, opt = state["params"], state["opt"]
        state.clear()
    torch.cuda.synchronize()
    out = {"bytes": distinct_bytes(params, opt),
           "resident": torch.cuda.memory_allocated(),
           "blocks": sum(len(sh.local_tensors(x))
                         for x in pytree.tree_leaves(params))}
    step_fn = steps.make_train_step(cfg, acfg)
    real, calls, worst = ops.fused_adam, [0], [0.0]
    skip = first_blocks(params) if fault == "skip" else set()

    def checking(master, m, v, g, **kw):
        got = real(master, m, v, g, **kw)
        worst[0] = max(worst[0], check_adam(
            f"sharded train {spec} fused_adam block {calls[0]}", got,
            ref.fused_adam(master, m, v, g, **kw), master, quiet=True))
        calls[0] += 1
        return got

    def skipping(master, m, v, g, **kw):
        calls[0] += 1
        if (calls[0] - 1) % out["blocks"] in skip:
            return master, m, v
        return real(master, m, v, g, **kw)

    shard_loss = lm._shard_loss

    def dropping(p, cfg_, shard, *a):
        ce, terms = shard_loss(p, cfg_, shard, *a)
        return (ce.detach() if shard.index == 1 else ce), terms

    losses, ms = {}, []
    build.reset_launches()
    for i, b in enumerate(batches, start=first):
        patch = contextlib.ExitStack()
        if check and i == first:
            patch.enter_context(mock.patch.object(ops, "fused_adam",
                                                  checking))
        if fault == "skip":
            patch.enter_context(mock.patch.object(ops, "fused_adam",
                                                  skipping))
        if fault == "drop":
            patch.enter_context(mock.patch.object(lm, "_shard_loss",
                                                  dropping))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patch:
            params, opt, loss = step_fn(params, opt, b)
        losses[i] = float(loss)
        ms.append((time.perf_counter() - t0) * 1e3)
        if save is not None and i + 1 == save[1]:
            t1 = time.perf_counter()
            path = store.save(save[0], i + 1, {"params": params,
                                               "opt": opt},
                              metadata={"step": i + 1})
            out["save"] = {"s": time.perf_counter() - t1, "bytes": sum(
                f.stat().st_size for f in Path(path).iterdir())}
    torch.cuda.synchronize()
    out.update(losses=losses, step_ms=ms,
               launches=dict(build.LAUNCHES),
               peak=torch.cuda.max_memory_allocated())
    if check:
        out.update(checked=calls[0], max_abs_err=worst[0])
    if keep:
        out["state"] = {"params": params, "opt": opt}
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_restore(cfg, ckpt_dir: str, spec: str, saved) -> tuple:
    """The checkpoint of ``ckpt_dir`` restored onto ``spec`` over logical
    devices of the card (``store.restore`` with named shardings; every
    leaf's checksum verified), each leaf then held bit for bit against
    the global array of ``saved``, the state that was saved, still on
    the card; ``saved`` is emptied after.  Returns (the restored state,
    its metadata, restore s, compare s)."""
    import torch.utils._pytree as pytree

    from repro_torch.checkpoint import store
    from repro_torch.launch import specs, train
    from repro_torch.models import lm, shardings as sh
    from repro_torch.optim import AdamConfig, init_state_shapes
    mesh = train.parse_mesh(spec, "cuda", devices=mesh_devices(spec))
    shapes = specs.eval_shape(lm.init_params, cfg, device="cpu")
    p_specs = sh.param_pspecs(shapes, mesh)
    template = {"params": shapes,
                "opt": init_state_shapes(shapes, AdamConfig())}
    placement = sh.named_shardings(
        {"params": p_specs, "opt": sh.opt_state_pspecs(p_specs, mesh)},
        mesh)
    t0 = time.perf_counter()
    state, meta = store.restore(ckpt_dir, template, placement=placement)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    for (path, x), w in zip(pytree.tree_flatten_with_path(state)[0],
                            pytree.tree_leaves(saved)):
        got, want = sh.gather(x), sh.gather(w).to(x.device)
        if got.shape != want.shape or not torch.equal(
                got.view(bits[got.dtype]), want.view(bits[want.dtype])):
            fail(f"elastic restore onto {spec}: {store._leaf_key(path)} "
                 "differs from the saved global array")
        if isinstance(x, sh.ShardedTensor) and x.mesh is not mesh:
            fail(f"elastic restore onto {spec}: {store._leaf_key(path)} "
                 "is not on the mesh")
    saved.clear()
    torch.cuda.synchronize()
    return state, meta, restore_s, time.perf_counter() - t0


def mesh_gaps(label: str, got: dict, want: dict) -> float:
    """The largest |loss difference| over the steps both ran; fails past
    ``SHARDED_TRAIN_LOSS_ATOL`` or on a non-finite loss."""
    steps_ = sorted(set(got) & set(want))
    if not steps_ or not all(math.isfinite(got[i]) for i in steps_):
        fail(f"{label}: losses {got}")
    gap = max(abs(got[i] - want[i]) for i in steps_)
    log(f"{label}: losses {[round(got[i], 6) for i in steps_]} vs 1x1 "
        f"{[round(want[i], 6) for i in steps_]}, largest gap {gap:.3g} "
        f"(limit {SHARDED_TRAIN_LOSS_ATOL})")
    if gap > SHARDED_TRAIN_LOSS_ATOL:
        fail(f"{label}: the losses part from 1x1 by {gap:.3g}")
    return gap


def sharded_train_phase() -> dict:
    """Phase 6d (the module docstring): the step route, its planted
    faults and the elastic restore on llama3-8b at full width, then the
    launcher route on it and on gpt2-xl-offload."""
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    cfg = sharded_cfg()
    steps_ = SHARDED_TRAIN_STEPS
    batches = sharded_batches(cfg, steps_)
    label = f"sharded train {SHARDED_TRAIN_ARCH} ({SHARDED_TRAIN_LAYERS} "\
        "layers)"
    out = {}
    one = out["step 1x1"] = step_route(cfg, "1x1", batches)
    split = out[f"step {SHARDED_TRAIN_MESH}"] = step_route(
        cfg, SHARDED_TRAIN_MESH, batches, check=True)
    with tempfile.TemporaryDirectory() as tmp:
        log(f"{label}: checkpoint directory free "
            f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")
        saved = out[f"step {SHARDED_TRAIN_MESH} saved"] = step_route(
            cfg, SHARDED_TRAIN_MESH, batches[:steps_ - 1],
            save=(tmp, steps_ - 1), keep=True)
        state, meta, restore_s, compare_s = elastic_restore(
            cfg, tmp, SHARDED_RESTORE_MESH, saved.pop("state"))
    if int(meta["step"]) != steps_ - 1:
        fail(f"{label}: restored step {meta['step']}")
    resumed = out[f"step {SHARDED_RESTORE_MESH} restored"] = step_route(
        cfg, SHARDED_RESTORE_MESH, batches[-1:], first=steps_ - 1,
        state=state)
    resumed.update(restore_s=restore_s, compare_s=compare_s)
    for name, run in out.items():
        want = run["blocks"] * len(run["losses"])
        others = {k: v for k, v in run["launches"].items()
                  if v and k != "fused_adam"}
        if run["launches"]["fused_adam"] != want or others:
            fail(f"{label} {name}: launches {run['launches']}, expected "
                 f"fused_adam x {want} alone")
    if split["bytes"] != one["bytes"]:
        fail(f"{label}: placement at {SHARDED_TRAIN_MESH} holds "
             f"{split['bytes']} B of distinct storage, 1x1 {one['bytes']}")
    if not one["losses"][steps_ - 1] < one["losses"][0]:
        fail(f"{label}: the loss did not fall ({one['losses']})")
    gaps = {name: mesh_gaps(f"{label} {name}", run["losses"],
                            one["losses"])
            for name, run in out.items() if name != "step 1x1"}
    faults = {}
    for fault in ("skip", "drop"):
        run = step_route(cfg, SHARDED_TRAIN_MESH, batches[:2], fault=fault)
        faults[fault] = max(abs(run["losses"][i] - one["losses"][i])
                            for i in run["losses"])
    log(f"{label}: planted faults (the first mesh entry's shard not "
        f"updated; data shard 1's gradient dropped), largest gap to 1x1 "
        f"{faults} (limit {SHARDED_TRAIN_LOSS_ATOL})")
    for fault, gap in faults.items():
        if not gap > SHARDED_TRAIN_LOSS_ATOL:
            fail(f"{label}: the planted fault '{fault}' reads {gap:.3g}, "
                 "inside the limit")
    for name, run in out.items():
        mid = statistics.median(run["step_ms"][1:] or run["step_ms"])
        log(f"{label} {name}: step ms {[round(x, 1) for x in run['step_ms']]}"
            f" (median after the first {mid:.1f}), fused_adam x "
            f"{run['launches']['fused_adam']} over {run['blocks']} blocks, "
            f"distinct storage {run['bytes']} B, resident "
            f"{run['resident'] / 2**30:.2f} GiB, peak "
            f"{run['peak'] / 2**30:.2f} GiB")
    log(f"{label}: every fused_adam block at the first {SHARDED_TRAIN_MESH} "
        f"step held against the plain update ({split['checked']} blocks, "
        f"max_abs_err {split['max_abs_err']:.3g}); saved after "
        f"{steps_ - 1} steps ({saved['save']['bytes']} B in "
        f"{saved['save']['s']:.1f} s), restored onto "
        f"{SHARDED_RESTORE_MESH} in {restore_s:.1f} s, bit-equal "
        f"(compared in {compare_s:.1f} s); placement adds "
        f"{split['bytes'] - one['bytes']} B")
    # the launcher (plain AdamW, as the reference's) at 1x1 and the mesh
    launcher = {}
    for arch, spec, n, cut in (
            (SHARDED_TRAIN_ARCH, "1x1", steps_, cfg),
            (SHARDED_TRAIN_ARCH, SHARDED_TRAIN_MESH, steps_, cfg),
            (TRAIN_ARCH, "1x1", SHARDED_GPT2_STEPS, None),
            (TRAIN_ARCH, SHARDED_GPT2_MESH, SHARDED_GPT2_STEPS, None)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches, wall, _ = run_launcher(
            ["--arch", arch, "--steps", str(n), "--batch", "8", "--seq",
             "128", "--lr", repr(launcher_lr(arch)), "--mesh", spec], cut,
            mesh_devices(spec))
        if any(launches.values()):
            fail(f"launcher {arch} {spec}: hand-written kernels launched "
                 f"{launches}")
        launcher[f"{arch} {spec}"] = {
            "losses": res.losses, "step_s": res.step_s, "wall_s": wall,
            "bytes": distinct_bytes(res.params, res.opt),
            "peak": torch.cuda.max_memory_allocated()}
        del res
    for arch, spec in ((SHARDED_TRAIN_ARCH, SHARDED_TRAIN_MESH),
                       (TRAIN_ARCH, SHARDED_GPT2_MESH)):
        a, b = launcher[f"{arch} 1x1"], launcher[f"{arch} {spec}"]
        gaps[f"launcher {arch} {spec}"] = mesh_gaps(
            f"launcher {arch} {spec}", b["losses"], a["losses"])
        if a["bytes"] != b["bytes"]:
            fail(f"launcher {arch} {spec}: {b['bytes']} B of distinct "
                 f"storage, 1x1 {a['bytes']}")
    for name, run in launcher.items():
        st = [run["step_s"][i] * 1e3 for i in sorted(run["step_s"])]
        log(f"launcher {name}: step ms {[round(x, 1) for x in st]} "
            f"(median after the first "
            f"{statistics.median(st[1:] or st):.1f}), wall "
            f"{run['wall_s']:.1f} s, distinct storage {run['bytes']} B, "
            f"peak {run['peak'] / 2**30:.2f} GiB")
    gpt2 = get_config(TRAIN_ARCH)
    log(f"{TRAIN_ARCH}: {gpt2.n_heads} heads of {gpt2.head_dim} over "
        f"{SHARDED_GPT2_MESH}: wq's {gpt2.n_heads * gpt2.head_dim} columns "
        "split off head boundaries")
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": out, "launcher": launcher, "gaps": gaps,
            "faults": faults,
            SHARDED_TRAIN_MESH: {"launches": split["launches"],
                                 "sharded": True}}


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
    record["small_hybrid_reference"] = small_reference_phase(
        HYBRID_ARCH, paths=(True,), **HYBRID_WIDEN)
    record["small_train_reference"] = {
        arch: small_train_reference(arch) for arch in SMALL_TRAIN_ARCHS}
    record["probes_GBps"] = probe_phase()
    record["serve"] = {}
    for arch in MODELS:              # one model's weights on the card
        record["serve"][arch] = serve_model(arch, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record["families"] = families = families_phase()
    log(f"families phase: {time.perf_counter() - t0:.1f} s, {memory()}")
    t0 = time.perf_counter()
    record["train"] = {RECURRENT_ARCH: train_recurrent()}
    log(f"train {RECURRENT_ARCH} phase: {time.perf_counter() - t0:.1f} s, "
        f"{memory()}")
    record["train"][TRAIN_ARCH] = train_model(TRAIN_ARCH)
    for name, phase in (
            ("launcher", lambda: launcher_phase(LAUNCHER_ARCH)),
            (f"launcher {RECURRENT_ARCH}", lambda: launcher_phase(
                RECURRENT_ARCH, n_layers=RECURRENT_LAUNCHER_LAYERS)),
            (f"launcher {JAMBA_ARCH} smoke", jamba_launcher_phase),
            ("checkpoint", checkpoint_phase),
            ("sharded train", sharded_train_phase)):
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
    rows = kernels_line(kernels, {
        **record["serve"], **record["train"],
        HYBRID_ARCH: {"small reference": record["small_hybrid_reference"]},
        f"{SHARDED_TRAIN_ARCH} sharded": record["sharded train"]},
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
