"""ServingEngine: continuous batching over the paged, tiered KV pool
(counterpart of ``repro.serving.engine``, attention-only models, dense
or MoE; and, port only, hybrids of published Mamba-2 and attention
layers on the fused path).

Each iteration admits requests (prefill through the flash kernel, K/V
written into the pool), then decodes one token for every running
request in one batch, on one of two paths:

  * **staged** (default): every running request's blocks are gathered
    from their tiers into a contiguous device buffer (``gather_seq``),
    the new token's K/V is written at each sequence's own length, and
    attention runs through the ``decode_attention`` kernel over
    ``kv_len + 1`` positions;
  * **fused** (``fused_gather=True``): the pool keeps its pooled
    layout and the ``paged_decode_attention`` kernel reads blocks
    straight from it through a block table, folding the new token in.

MoE layers run ``moe_fwd`` (capacity and drop) in prefill and on the
staged path; on the fused path they route top-k without drop and run
the ``fused_expert_ffn`` kernel over the routed experts only, as the
reference does.

Then greedy argmax, ``append_token``, one ``KVBlockTierer`` epoch and
one telemetry epoch.  Padded batch rows carry ``lens = 0`` and a zero
block table, exactly as in the reference.

A hybrid model (``ModelConfig.mamba_groups``: granite-4.0-h-small)
pages its attention layers' K/V as above and keeps each running
request's Mamba-2 states in a ``StateSlotPool`` slot beside the pool
(``serving/state_pool.py``), one slot per row of ``max_batch``, whose
bytes count against the device at construction.  Prefill writes its
final states into the request's new slot (span
``engine.prefill.state``); the fused decode steps each Mamba layer in
place on the rows' slots (``models/modules.py::mamba2_step``, the
``ssm_state_update`` kernel on the card), one ``engine.decode.mamba``
span a layer; finish and preemption free the slot, and a preempted
request recomputes its states by a new prefill.  The staged path does
not serve such a model.

With ``trace_spans=True`` the engine's tracer also records spans
(``cat="span"``, on the engine's clock, each with its id and its
parent's) at the boundaries between the host enqueuing work, the host
waiting on the device and the host's bookkeeping:

  * ``engine.prefill`` (``rid``, ``tokens``) over ``.forward`` (the
    prefill step), ``.write`` (``pool.write_prefill``) and ``.read``
    (the margins and the first token, where the host waits);
  * ``engine.decode`` (``step``, ``rows``) over ``.inputs`` (block
    tables or the staged gather, the batch's host-to-device copies),
    ``.forward`` (the decode step; a hybrid's ``.mamba`` spans inside
    it), ``.read`` (the routing feed, the
    tokens and margins, where the host waits) and ``.commit`` (each
    row's ``append_token``, ``touch_seq``, token and finish);
  * ``engine.tier_epoch`` and ``engine.replan_epoch`` (``epoch``).

The spans keep a ring of their own in the tracer (``tracer.spans``),
so they never evict a control-plane event.  While a ``torch.profiler``
profile records, each span also opens the profiler's range
``repro_torch.<name>``; with spans off a site opens nothing
(``obs.trace.hot_span``).

Every engine builds the observability plane (a control-plane trace, a
metrics registry, a prediction-audit ledger and SLO monitors) and the
telemetry plane (the pool's access events through a sampler, phase
detection).  With ``adaptive=True`` an ``AdaptiveReplanner`` re-plans
the live sequences' KV placement every ``replan_every`` iterations from
the measured traffic (``ObjectLevelInterleave`` gated by the cost
model) and moves their blocks through ``_move_seq_blocks``.  It plans
over tiers built from transfer probes of this machine's memory kinds
(``kind_bases``), or over the testbed's tiers under a ``topology``.
Replans change residency only, never a value: the tokens are those of
the same run without ``adaptive``.

The other control planes, wired as the reference wires them:

  * ``topology``: a testbed graph (``topology.build_topology``) whose
    fast and capacity nodes carry the pool's memory kinds; the
    scheduler admits under a shared-link budget, and moves are priced
    over the graph's paths;
  * ``predictive``: a predictive ``TierBudgetArbiter`` rebalances this
    tenant's fast-tier grant each replan epoch, replans key their plan
    cache by phase signature and pre-stage the predicted next phase,
    and replan deltas run through a ``MoveScheduler`` round;
  * ``calibrate``: a ``CostModelCalibrator`` fitted at start-up to one
    transfer probe of the slow kind, refreshed from audit residuals;
  * ``qos``: blame attribution of decode-latency violations and
    violation-predictive admission and preemption;
  * ``expert_policy``: MoE expert residency (``ExpertPool``), fed with
    the routed expert ids of the fused path.  Residency is ledger
    bookkeeping: expert weights never move.

The multi-host plane (``cluster.ClusterPlane``) runs one engine per
replica over one shared, namespaced ledger; ``ServingConfig.cluster``
is its options section, which the engine itself does not read.  A
replica's parameters may be split over its mesh (vocab and experts,
``cluster.sharding.shard_lm_params``): the embedding, the head, greedy argmax over the
vocab blocks and the MoE layers then run block by block, the rest (and
the KV pool) on the mesh's first device.  Expert residency runs over a
split expert store as over a whole one: the router is gathered whole
before top-k, so the pool is fed global expert ids, and it keeps one
block per (layer, expert) at the whole expert's bytes, as the
reference's does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.migration import MigrationExecutor
from ..core.tiered_array import DeviceLike, resolve_device
from ..core.tiers import GiB, MemoryTier
from ..kernels import ops
from ..launch import steps as steps_mod
from ..models import lm
from ..models import modules as M
from ..models import shardings as SH
from ..obs import (BlameLedger, CostModelCalibrator, LagRatioMonitor,
                   measure_transfer_probes, MetricsRegistry, PredictionLedger,
                   probed_kind_bases, SLOMonitor, SLOTarget, TraceRecorder,
                   ViolationPredictor)
from ..obs.trace import hot_span
from ..pool import MoveScheduler, TierBudgetArbiter
from ..telemetry import (AccessSampler, AccessTrace, AdaptiveReplanner,
                         PhaseDetector, ReplanConfig, SamplerConfig)
from ..topology import build_topology
from . import config as config_mod
from .expert_pool import (expert_nbytes_from_config, ExpertPool,
                          moe_layers_from_config)
from .kv_pool import FAST_KIND, PagedKVPool, spec_from_config
from .metrics import ServingMetrics
from .scheduler import (ContinuousBatchingScheduler, plan_admission, Request,
                        RequestState, SchedulerConfig)
from .state_pool import pool_nbytes, slot_nbytes, StateSlotPool
from .tiering import KVBlockTierer

def check_paged_support(cfg: ModelConfig, fused: bool = False) -> None:
    """Raise if the config can't run on the paged decode path (``fused``:
    the fused path, which alone serves the published Mamba-2 layers of
    a hybrid model, from per-request state slots)."""
    for spec in cfg.pattern:
        if spec.kind == "mamba" and cfg.mamba_groups and not spec.cross_attn:
            if not fused:
                raise ValueError(
                    f"{cfg.name}: its Mamba-2 layers keep per-request state "
                    "slots on the fused paged path only; set fused_gather")
            continue
        if spec.kind != "attn" or spec.cross_attn:
            raise ValueError(
                f"{cfg.name}: paged serving supports attention-only "
                f"patterns (got {spec.kind}"
                f"{'+cross' if spec.cross_attn else ''}); use the "
                f"one-shot FlexGenEngine for hybrid architectures")
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: encoder-decoder serving is not "
                         "paged; use FlexGenEngine")
    if cfg.kv_cache_dtype != "bf16":
        raise ValueError(f"{cfg.name}: paged pool stores bf16 KV "
                         f"(got {cfg.kv_cache_dtype})")
    if cfg.pos_emb not in ("rope", "learned", "none"):
        raise ValueError(f"{cfg.name}: unsupported pos_emb "
                         f"{cfg.pos_emb!r} for paged decode")


# ---------------------------------------------------------------------- #
# Paged decode steps                                                     #
# ---------------------------------------------------------------------- #
def _qkv_tok(cfg: ModelConfig, lp, x: torch.Tensor, lengths: torch.Tensor):
    """Norm, projections and per-sequence rotary embedding for one
    decode token: q (B, 1, H, hd), k/v (B, 1, KV, hd)."""
    h = lm.norm(cfg, lp["norm1"], x)
    q, k, v = lm.project_qkv(cfg, lp["attn"], h)
    if cfg.pos_emb == "rope":
        pos = lengths[:, None]                     # per-seq positions
        q = M.apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
        k = M.apply_rope(k, pos, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def _attn_out(cfg: ModelConfig, lp, x: torch.Tensor,
              att: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output projection and residual; returns (x, the second norm of
    x), the MLP's or MoE's input."""
    B = x.shape[0]
    x = lm.residual(cfg, x, att.reshape(B, 1, cfg.n_heads * cfg.head_dim)
                    @ lp["attn"]["wo"])
    return x, lm.norm(cfg, lp["norm2"], x)


def _finish_layer(cfg: ModelConfig, spec, lp, x: torch.Tensor,
                  att: torch.Tensor) -> torch.Tensor:
    """Staged path: the layer after attention, MoE layers through
    ``moe_fwd``."""
    x, h = _attn_out(cfg, lp, x, att)
    return x + lm.ffn(cfg, spec, lp, h)[0]


def _routed_experts(cfg: ModelConfig, mp, h: torch.Tensor):
    """Fused path's MoE sublayer for h (B, 1, D): token-choice top-k in
    fp32, weights renormalised over the chosen experts, no capacity or
    drop (the reference's fused routing), then the ``fused_expert_ffn``
    kernel over the routed experts.

    Expert stacks split over ``experts`` run the kernel once per shard
    (``fused_expert_ffn_partial``).

    Returns (out (B, 1, D), ids (B, K) int32, near (B, 2)): near holds
    the router probabilities of each token's K-th and (K+1)-th experts
    (0 where there is no (K+1)-th), whose difference says how near the
    routing came to a tie."""
    K = cfg.top_k
    router = SH.gather(mp["router"])
    probs = torch.softmax(h[:, 0].float() @ router, dim=-1)
    vals, idx = torch.topk(probs, min(K + 1, probs.shape[-1]), dim=-1)
    topw, topi = vals[:, :K], idx[:, :K].to(torch.int32)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    if vals.shape[-1] == K:
        vals = torch.nn.functional.pad(vals, (0, 1))
    x = h[:, 0].contiguous()
    ws = (mp["w_gate"], mp["w_up"], mp["w_down"])
    if not SH.is_split(ws[0]):
        out = ops.fused_expert_ffn(x, *ws, topi, topw)
    else:
        # the kernel once per expert shard over its range; the fp32
        # partials are summed on the first device in shard order and
        # rounded to bf16 once
        acc = None
        for lo, hi, dev, local in SH.expert_blocks(*ws):
            part = ops.fused_expert_ffn_partial(
                x.to(dev), *local, topi.to(dev), topw.to(dev), lo, hi,
                router.shape[1]).to(x.device)
            acc = part if acc is None else acc + part
        out = acc.to(x.dtype)
    return out[:, None], topi, vals[:, K - 1:]


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    x = SH.embed_rows(params["embed"], tokens[:, 0]).to(
        torch.bfloat16)[:, None]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][lengths].to(x.dtype)[:, None]
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor):
    """fp32 logits (B, V); a ``ShardedTensor`` of vocab blocks under a
    vocab-split head."""
    x = lm.norm(cfg, params["final_norm"], x)
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return lm.head_logits(cfg, x[:, 0], W)


def _paged_unit_fwd(cfg: ModelConfig, up, x, kv_k, kv_v, lengths):
    """One unit over the gathered caches.  x (B, 1, D); kv_k/kv_v
    (n_attn, B, S_pad, KV, hd), this iteration's staging buffers, which
    receive the new token in place; lengths (B,) int32.  Returns (x,
    new_k, new_v) with new_k/new_v (n_attn, B, KV, hd)."""
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    pos = lengths.long()
    new_ks, new_vs = [], []
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        q, k, v = _qkv_tok(cfg, lp, x, lengths)
        ck, cv = kv_k[li], kv_v[li]                # (B, S_pad, KV, hd)
        k_tok = k[:, 0].to(ck.dtype)
        v_tok = v[:, 0].to(cv.dtype)
        # scatter-then-attend over kv_len + 1 positions, as the
        # reference's staged step does
        ck[rows, pos] = k_tok
        cv[rows, pos] = v_tok
        att = ops.decode_attention(q[:, 0].contiguous(), ck, cv,
                                   lengths + 1)    # (B, H, hd)
        x = _finish_layer(cfg, spec, lp, x, att)
        new_ks.append(k_tok)
        new_vs.append(v_tok)
    return x, torch.stack(new_ks), torch.stack(new_vs)


@torch.no_grad()
def _paged_decode(cfg: ModelConfig, units, params, tokens, kv_k, kv_v,
                  lengths):
    """tokens (B, 1); kv_k/kv_v (U, n_attn, B, S_pad, KV, hd); lengths
    (B,) int32 — tokens already cached per sequence.

    Returns (logits (B, V) (``_logits``), new_k, new_v (U, n_attn, B,
    KV, hd))."""
    x = _embed(cfg, params, tokens, lengths)
    new_k, new_v = [], []
    for u, up in enumerate(units):
        x, nk, nv = _paged_unit_fwd(cfg, up, x, kv_k[u], kv_v[u], lengths)
        new_k.append(nk)
        new_v.append(nv)
    return _logits(cfg, params, x), torch.stack(new_k), torch.stack(new_v)


def _fused_unit_fwd(cfg: ModelConfig, up, x, k_pool, v_pool, block_tbl,
                    lengths, block_tokens: int, states=None, spans=None):
    """One unit on the fused path: k_pool/v_pool (n_attn, num_blocks,
    bt, KV, hd) are the pool's resident stores; block_tbl (B, nb)
    int32.  The kernel reads blocks through the table and folds the
    step's K/V in, so no gather or scatter happens.  A hybrid model's
    Mamba-2 layers step their states in place in the unit's state slots,
    ``states`` = (conv (n_mamba, n_slots + 1, ...), ssm (n_mamba,
    n_slots + 1, ...), slots (B,) int32), each layer in the span
    ``engine.decode.mamba`` of ``spans`` (a tracer, or None).  Returns
    (x, new_k, new_v, routed ids (n_moe, B, K) or None without MoE
    layers, nears: one (B, 2) ``_routed_experts`` pair per MoE
    layer)."""
    new_ks, new_vs, routed, nears = [], [], [], []
    i_attn = i_mamba = 0
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        if spec.kind == "mamba":
            conv, ssm, slots = states
            with hot_span(spans, "engine.decode.mamba"):
                h = lm.norm(cfg, lp["norm1"], x)
                out = lm.mamba_step(cfg, lp["mamba"], h, conv[i_mamba],
                                    ssm[i_mamba], slots)
                x = lm.residual(cfg, x, out)
            h = lm.norm(cfg, lp["norm2"], x)
            i_mamba += 1
        else:
            q, k, v = _qkv_tok(cfg, lp, x, lengths)
            k_tok = k[:, 0].to(k_pool.dtype).contiguous()
            v_tok = v[:, 0].to(v_pool.dtype).contiguous()
            att = ops.paged_decode_attention(
                q[:, 0].contiguous(), k_pool[i_attn], v_pool[i_attn],
                block_tbl, lengths, k_tok, v_tok, block_tokens=block_tokens)
            x, h = _attn_out(cfg, lp, x, att)
            new_ks.append(k_tok)
            new_vs.append(v_tok)
            i_attn += 1
        if spec.moe:
            out, ids, near = _routed_experts(cfg, lp["moe"], h)
            routed.append(ids)
            nears.append(near)
        else:
            out = M.mlp_fwd(lp["mlp"], h, cfg.act)
        if "shared" in lp:
            out = out + M.mlp_fwd(lp["shared"], h, cfg.act)
        x = lm.residual(cfg, x, out)
    ids = torch.stack(routed) if routed else None
    return x, torch.stack(new_ks), torch.stack(new_vs), ids, nears


@torch.no_grad()
def _fused_paged_decode(cfg: ModelConfig, block_tokens: int, units, params,
                        tokens, k_store, v_store, block_tbl, lengths,
                        route_margins: Optional[list] = None,
                        states: Optional[tuple] = None, spans=None):
    """tokens (B, 1); k_store/v_store (U, n_attn, num_blocks, bt, KV,
    hd) — the pooled layout itself; block_tbl (B, nb) int32; lengths
    (B,) int32.  Returns (logits (B, V), new_k, new_v (U, n_attn, B,
    KV, hd), routed expert ids (U, n_moe, B, K) int32).  Where
    ``route_margins`` is a list, every MoE layer's (B, 2) K-th and
    (K+1)-th router probabilities (``_routed_experts``) are appended to
    it.  A hybrid model's Mamba-2 layers take ``states`` = (conv, ssm,
    slots): the ``StateSlotPool``'s (U, n_mamba, n_slots + 1, ...)
    stores and each row's slot (B,) int32; ``spans`` as for
    ``_fused_unit_fwd``."""
    x = _embed(cfg, params, tokens, lengths)
    new_k, new_v, routed = [], [], []
    for u, up in enumerate(units):
        x, nk, nv, ids, nears = _fused_unit_fwd(
            cfg, up, x, k_store[u], v_store[u], block_tbl, lengths,
            block_tokens, None if states is None else
            (states[0][u], states[1][u], states[2]), spans)
        new_k.append(nk)
        new_v.append(nv)
        routed.append(ids)
        if route_margins is not None:
            route_margins.extend(nears)
    routed = (torch.stack(routed) if routed[0] is not None else torch.empty(
        (len(units), 0, x.shape[0], max(cfg.top_k, 1)), dtype=torch.int32,
        device=x.device))
    return (_logits(cfg, params, x), torch.stack(new_k),
            torch.stack(new_v), routed)


# ---------------------------------------------------------------------- #
# Engine                                                                 #
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ServingConfig:
    block_tokens: int = 16
    max_batch: int = 4
    max_context: int = 128            # prompt + generated cap per request
    policy: str = "tiering08"         # static | autonuma | tiering08 | tpp
    num_blocks: Optional[int] = None  # default: max_batch * blocks/seq
    fast_block_budget: Optional[int] = None   # default: half the pool
    slow_kind: str = "pinned_host"
    max_prefill_per_iter: int = 2
    migrate_every: int = 1
    # optional cost-model sizing: overrides num_blocks/fast budget/batch
    device_budget_bytes: Optional[int] = None
    host_budget_bytes: Optional[int] = None
    # telemetry + adaptive object-level re-interleaving (telemetry/):
    # sample_rate 1.0 = full instrumentation; lower it toward PEBS-like
    # rates for production-sized pools
    adaptive: bool = False
    replan_every: int = 8   # iterations between replans (<= 0 disables)
    sample_rate: float = 1.0
    # residency-ledger tenant namespace of this engine's pool
    tenant: str = "serving"
    # observability plane (obs/): ring bound on the control-plane trace
    # and optional SLO thresholds (seconds) on TTFT and the inter-token
    # decode latency, checked live by the rolling-window SLOMonitor
    trace_max_events: int = 65536
    # hot-path spans in the trace (engine.prefill, engine.decode and
    # their parts, the tier and replan epochs); off, the trace holds
    # the control plane alone
    trace_spans: bool = False
    slo_p95_ttft_s: Optional[float] = None
    slo_p95_decode_s: Optional[float] = None
    slo_p99_decode_s: Optional[float] = None
    slo_p999_decode_s: Optional[float] = None
    slo_window: int = 512
    # fused decode: pooled KV layout read through block tables by the
    # paged_decode_attention kernel (no staging copy)
    fused_gather: bool = False
    # predictive control plane: arbiter + move scheduler in-engine,
    # plans keyed by phase signature (requires adaptive)
    predictive: bool = False
    # topology testbed (topology.TOPOLOGY_CHOICES): link-budget
    # admission and path-priced moves
    topology: Optional[str] = None
    # interference-class QoS: blame + violation-predictive admission
    # (requires topology and a decode SLO)
    qos: bool = False
    qos_class: str = "read"
    # cost-model calibration from a start-up probe and audit residuals
    # (requires adaptive)
    calibrate: bool = False
    # MoE expert residency: "lru" | "predictive" (None = off), with the
    # fraction of all (layer, expert) blocks the fast tier may hold
    expert_policy: Optional[str] = None
    expert_fast_fraction: float = 0.25
    # nested sections (serving.config): the grouped view of the flat
    # fields above, kept coherent with them by __post_init__; cluster
    # is the multi-host plane's (cluster.ClusterPlane)
    tiering: Optional[config_mod.TieringOptions] = None
    qos_options: Optional[config_mod.QoSOptions] = None
    experts: Optional[config_mod.ExpertOptions] = None
    cluster: Optional[config_mod.ClusterOptions] = None

    def __post_init__(self):
        config_mod.sync_sections(self)

    @classmethod
    def from_args(cls, args) -> "ServingConfig":
        """Build from a serve-CLI-shaped namespace, running every
        cross-field validation (``config.validate_args``) first; raises
        :class:`~repro_torch.serving.config.ConfigError` on a violated
        constraint."""
        config_mod.validate_args(args)
        get = lambda name, default=None: getattr(args, name, default)  # noqa: E731
        replicas = int(get("replicas", 1) or 1)
        cluster = None
        if replicas > 1 or get("router") is not None:
            cluster = config_mod.ClusterOptions(
                replicas=replicas,
                router=get("router") or "headroom-distance",
                shard_model=bool(get("shard_model", True)))
        return cls(
            block_tokens=get("block_tokens", 16),
            max_batch=get("batch", 4),
            max_context=(get("prompt_len", 32) + get("new_tokens", 16)
                         + get("block_tokens", 16)),
            policy=get("policy", "tiering08"),
            num_blocks=get("num_blocks"),
            fast_block_budget=get("fast_blocks"),
            adaptive=bool(get("adaptive")),
            replan_every=get("replan_every", 8),
            sample_rate=get("sample_rate", 1.0),
            predictive=bool(get("predictive")),
            calibrate=bool(get("calibrate")),
            topology=get("topology"),
            tenant=get("tenant") or "serving",
            slo_p95_ttft_s=get("slo_p95_ttft"),
            slo_p95_decode_s=get("slo_p95_decode"),
            slo_p99_decode_s=get("slo_p99_decode"),
            slo_p999_decode_s=get("slo_p999_decode"),
            slo_window=get("slo_window", 512),
            qos=bool(get("qos")),
            fused_gather=bool(get("fused_gather")),
            expert_policy=get("expert_policy"),
            expert_fast_fraction=get("expert_fast_frac", 0.25),
            trace_spans=bool(get("trace_out")),
            cluster=cluster)


@dataclasses.dataclass
class ServingReport:
    summary: Dict[str, float]
    per_request: List[Tuple[int, Dict[str, float]]]
    tiering: Dict[str, int]
    policy: str
    telemetry: Dict[str, float] = dataclasses.field(default_factory=dict)
    slo: Dict[str, object] = dataclasses.field(default_factory=dict)


def kind_bases(pool: PagedKVPool) -> Dict[str, MemoryTier]:
    """MemoryTier descriptors of the pool's fast and slow memory kinds,
    built from transfer probes of this machine on the pool's device
    (``obs.probed_kind_bases``: on the card, copies from the device into
    each kind, timed with CUDA events; every field follows from the
    probed rate).  Capacities are 0 here; ``kind_tiers`` sets them from
    the pool's block budgets."""
    return probed_kind_bases((FAST_KIND, pool.slow_kind), pool.device)


def kind_tiers(pool: PagedKVPool,
               fast_base: Optional[MemoryTier] = None,
               slow_base: Optional[MemoryTier] = None
               ) -> Dict[str, MemoryTier]:
    """MemoryTier descriptors for the pool's memory kinds, with
    capacities set from the pool's block budgets — what the adaptive
    replanner plans against.  ``fast_base``/``slow_base`` default to
    the probed ``kind_bases(pool)``."""
    if fast_base is None or slow_base is None:
        base = kind_bases(pool)
        fast_base = fast_base or base[FAST_KIND]
        slow_base = slow_base or base[pool.slow_kind]
    bn = pool.block_nbytes()
    fast = dataclasses.replace(
        fast_base, name=FAST_KIND,
        capacity_GiB=max(pool.fast_block_budget, 1) * bn / GiB)
    slow = dataclasses.replace(
        slow_base, name=pool.slow_kind, kind="host",
        capacity_GiB=max(pool.num_blocks, 1) * bn / GiB)
    return {FAST_KIND: fast, pool.slow_kind: slow}


class ServingEngine:
    """Continuous-batching serving over a tier-resident paged KV pool.

    ``device``: CUDA unless ``"cpu"`` is asked for; the parameters must
    already live there (``lm.init_params`` / ``lm.params_from_numpy``
    with the same device), or be placed on a mesh whose first device it
    is (``cluster.sharding.shard_lm_params``; the engine computes on
    their ``compute_view``).  The paged KV pool lives on ``device``:
    the counterpart of the reference's ``pool_sharding`` on a replica
    mesh, whose first device the engine runs on."""

    def __init__(self, cfg: ModelConfig, params,
                 serving: Optional[ServingConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 ledger=None, device: DeviceLike = None):
        self.sv = sv = serving or ServingConfig()
        check_paged_support(cfg, fused=sv.fused_gather)
        self.cfg = cfg
        self.clock = clock
        self.device = resolve_device(device)
        if params is not None:
            params = SH.compute_view(params)
            if params["embed"].device != self.device:
                raise ValueError(f"params live on {params['embed'].device}"
                                 f", the engine runs on {self.device}")
        self.params = params
        bt = sv.block_tokens
        self.max_seq_blocks = max(1, math.ceil(sv.max_context / bt))
        hybrid = bool(cfg.unit_mamba_layers)
        state_seq = slot_nbytes(cfg) if hybrid else 0
        if sv.device_budget_bytes is not None:
            plan = plan_admission(
                cfg, bt, sv.max_context, sv.device_budget_bytes,
                sv.host_budget_bytes or 0, max_batch_cap=sv.max_batch,
                state_bytes_per_seq=state_seq)
            num_blocks, fast_budget = plan.total_blocks, plan.fast_blocks
            max_batch = plan.max_batch
        else:
            num_blocks = sv.num_blocks or sv.max_batch * self.max_seq_blocks
            fast_budget = (sv.fast_block_budget
                           if sv.fast_block_budget is not None
                           else max(1, num_blocks // 2))
            max_batch = sv.max_batch
        self.max_batch = max_batch
        self._moe = any(spec.moe for spec in cfg.pattern)
        if sv.fused_gather and self._moe and cfg.act != "silu":
            raise ValueError(f"{cfg.name}: fused MoE decode needs silu "
                             "(gated) experts")
        self._static_split = sv.policy in ("static", "none", "no_balance")
        self.pool = PagedKVPool(
            num_blocks, bt, spec=spec_from_config(cfg, bt),
            fast_block_budget=fast_budget, slow_kind=sv.slow_kind,
            default_kind=sv.slow_kind, ledger=ledger, tenant=sv.tenant,
            pooled=sv.fused_gather, device=self.device)
        self.ledger = self.pool.ledger
        if hybrid:
            self._check_state_fits(pool_nbytes(cfg, max_batch))
        self.tierer = KVBlockTierer(self.pool, sv.policy)
        topo = None
        tb = None
        if sv.topology:
            tb = build_topology(sv.topology, device=self.device)
            topo = tb.graph
            # the pool's memory kinds ride the testbed's fast node and
            # its capacity-expander (CXL-class) node
            topo.alias_tier(tb.fast, FAST_KIND)
            topo.alias_tier(tb.capacity_tier, self.pool.slow_kind)
        self.topo = topo
        # observability plane: one tracer + registry + audit ledger +
        # SLO monitor per engine, on the engine's run clock (_now),
        # created before the components they instrument
        self._t0 = 0.0
        self._virtual_skew = 0.0
        self._step = 0
        self.tracer = TraceRecorder(clock=self._now,
                                    max_events=sv.trace_max_events,
                                    hot_spans=sv.trace_spans)
        # the recorder hot-path spans go into, None while they are off
        self._spans = self.tracer if sv.trace_spans else None
        self.registry = MetricsRegistry()
        self.audit = PredictionLedger(registry=self.registry,
                                      tracer=self.tracer)
        slo_targets = [SLOTarget(metric, q, thr) for metric, q, thr in (
            ("ttft", 0.95, sv.slo_p95_ttft_s),
            ("decode_latency", 0.95, sv.slo_p95_decode_s),
            ("decode_latency", 0.99, sv.slo_p99_decode_s),
            ("decode_latency", 0.999, sv.slo_p999_decode_s))
            if thr is not None]
        self.slo = SLOMonitor(slo_targets, clock=self._now,
                              registry=self.registry, tracer=self.tracer,
                              window=sv.slo_window)
        self.lag = LagRatioMonitor()
        self._lag_tokens = 0          # decode tokens at last epoch close
        self._lag_time = 0.0          # _now() at last epoch close
        # interference-class QoS plane: blame attribution + predictive
        # admission, both priced on the topology's class-aware
        # contention model
        self.blame = None
        self.predictor = None
        self._qos_last_key: Optional[int] = None
        if sv.qos:
            if topo is None:
                raise ValueError("qos requires a topology (the blame "
                                 "plane attributes violations to links)")
            decode_slo = sv.slo_p99_decode_s or sv.slo_p95_decode_s
            if decode_slo is None:
                raise ValueError("qos requires a decode SLO "
                                 "(slo_p99_decode_s or slo_p95_decode_s)")
            self.blame = BlameLedger(topo, registry=self.registry,
                                     tracer=self.tracer, clock=self._now)
            self.predictor = ViolationPredictor(topo, blame=self.blame,
                                                audit=self.audit)
            self.predictor.set_target(sv.tenant, decode_slo)
            # every decode-latency excursion is joined to its
            # bottleneck link and antagonist when it fires
            self.slo.add_violation_hook(
                lambda t, v, now: self.blame.on_violation(
                    sv.tenant, t.key, v, t.threshold_s, now=now)
                if t.metric == "decode_latency" else None)
        self.sched = ContinuousBatchingScheduler(
            self.pool, SchedulerConfig(
                max_batch=max_batch,
                max_prefill_per_iter=sv.max_prefill_per_iter,
                flow_class=sv.qos_class),
            topology=topo, tracer=self.tracer, predictor=self.predictor)
        self.tierer.spans = self._spans
        # a hybrid model's per-request recurrent state: one slot per
        # running row, taken at prefill, freed on finish and preemption
        self.states: Optional[StateSlotPool] = None
        if hybrid:
            self.states = StateSlotPool(cfg, max_batch, self.device,
                                        tracer=self.tracer,
                                        registry=self.registry)
            self.sched.on_release = (
                lambda req, preempted: self.states.release(req.rid,
                                                           preempted))
        self.metrics = ServingMetrics(registry=self.registry,
                                      slo=self.slo)
        # telemetry: the pool emits access events through a sampling
        # front-end; phase detection and (with adaptive) the replanner
        # read the shared trace, which is also this tenant's namespace
        # in the ledger
        self.trace = AccessTrace()
        self.sampler = AccessSampler(
            self.trace, SamplerConfig(sample_rate=sv.sample_rate))
        self.pool.attach_telemetry(self.sampler)
        self.ledger.attach_trace(sv.tenant, self.trace)
        self.phases = PhaseDetector(self.trace)
        self.replanner: Optional[AdaptiveReplanner] = None
        if sv.predictive and not sv.adaptive:
            raise ValueError("predictive serving requires adaptive=True "
                             "(prediction pre-stages the replanner's "
                             "phase-cached plans)")
        if sv.calibrate and not sv.adaptive:
            raise ValueError("calibrate requires adaptive=True (the "
                             "corrections feed the replanner's cost "
                             "model)")
        self.calibrator = None
        if sv.adaptive:
            if tb is not None:
                tiers = kind_tiers(self.pool,
                                   fast_base=tb.tiers[tb.fast],
                                   slow_base=tb.tiers[tb.capacity_tier])
            else:
                tiers = kind_tiers(self.pool)
            if sv.calibrate:
                self.calibrator = CostModelCalibrator(tiers, graph=topo)
                # start-up fit: one transfer probe of the pool's slow
                # kind (tiers are named by memory kind, so the probe
                # maps directly); the fast tier keeps its numbers
                self.calibrator.fit_probes(measure_transfer_probes(
                    kinds=(self.pool.slow_kind,), n_mb=16, iters=2,
                    device=self.device))
            executor = MigrationExecutor(tiers,
                                         move_fn=self._move_seq_blocks,
                                         topology=topo)
            # the staged path on the card moves block payloads between
            # HBM and host memory: audit each priced move time against
            # its wall time.  Pooled and CPU-engine moves are residency
            # bookkeeping, whose wall time prices nothing
            executor.physical_moves = (self.device.type == "cuda"
                                       and not self.pool.pooled)
            self.replanner = AdaptiveReplanner(
                self.trace, tiers, FAST_KIND,
                cfg=ReplanConfig(replan_every=max(sv.replan_every, 1),
                                 window_epochs=max(sv.replan_every, 1)),
                executor=executor, default_tier=self.pool.slow_kind,
                topology=topo, ledger=self.ledger, tenant=sv.tenant,
                tracer=self.tracer, audit=self.audit,
                calibrator=self.calibrator)
            executor.tracer = self.tracer
            executor.audit = self.audit
            executor.calibrator = self.calibrator
            executor.recalibrate()
        # predictive engines run the control plane in-engine: a
        # predictive TierBudgetArbiter rebalances this tenant's
        # fast-tier grant each replan epoch (capacity = the configured
        # fast-block budget), and replan deltas defer to a MoveScheduler
        # round so the trace shows the scheduled batch
        self.arbiter = None
        self.movesched = None
        if sv.predictive:
            self.arbiter = TierBudgetArbiter(
                self.ledger, FAST_KIND,
                capacity_bytes=fast_budget * self.pool.block_nbytes(),
                objective="fair_share", predictive=True,
                tracer=self.tracer, audit=self.audit)
            self.movesched = MoveScheduler(
                self.replanner.executor, self.ledger, tracer=self.tracer)
            self.movesched.audit = self.audit
            self.movesched.calibrator = self.calibrator
            self.replanner.move_scheduler = self.movesched
        # MoE expert tier residency: every (layer, expert) weight block
        # is a tiered object with routing-driven heat, sharing the move
        # scheduler when there is one but keeping its own residency
        # namespace (the KV arbiter's grant is not split against expert
        # bytes)
        self.expert_pool = None
        self._moe_per_unit = sum(1 for s in cfg.pattern if s.moe)
        if sv.expert_policy:
            n_moe = moe_layers_from_config(cfg)
            if n_moe == 0:
                raise ValueError(f"{cfg.name}: expert_policy set but "
                                 "the model has no MoE layers")
            total = n_moe * cfg.n_experts
            budget = max(1, int(round(total * sv.expert_fast_fraction)))
            self.expert_pool = ExpertPool(
                n_moe, cfg.n_experts, expert_nbytes_from_config(cfg),
                fast_expert_budget=budget, policy=sv.expert_policy,
                tenant=f"{sv.tenant}.experts", slow_kind=sv.slow_kind,
                movesched=self.movesched, tracer=self.tracer)
        self._units = (lm.unit_views(params, cfg)
                       if params is not None else None)
        self._prefill = steps_mod.make_prefill_step(cfg)
        self._next_rid = 0
        # each generated token's top-1 minus top-2 logit margin, per
        # request: tells a near tie from a real disagreement when two
        # decode paths are compared
        self.margins: Dict[int, List[float]] = {}
        # MoE models on the fused path: each generated token's smallest
        # top-K minus top-(K+1) router probability over the MoE layers
        # (NaN for a token from prefill), per request — tells a routing
        # near tie where two decode paths' tokens part.  Filled when
        # run() ends from ``_route_log``: per step (rids, the MoE layers'
        # (n_moe, B, 2) K-th and (K+1)-th router probabilities on the
        # device, or None for a prefill token), so no step waits on it.
        self.route_margins: Dict[int, List[float]] = {}
        self._track_routes = self._moe and sv.fused_gather
        self._route_log: List[Tuple[List[int], Optional[torch.Tensor]]] = []

    def _check_state_fits(self, nbytes: int) -> None:
        """Raise unless ``nbytes`` of state slots (``max_batch`` and the
        padded rows' slot) fit the device budget beside the weights, or,
        on the card, its free memory."""
        sv = self.sv
        if sv.device_budget_bytes is not None:
            need = 2 * self.cfg.param_count() + nbytes
            if need > sv.device_budget_bytes:
                raise ValueError(
                    f"{self.cfg.name}: weights and {self.max_batch + 1} "
                    f"state slots need {need / GiB:.2f} GiB, over the device "
                    f"budget of {sv.device_budget_bytes / GiB:.2f} GiB")
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes > free:
                raise ValueError(
                    f"{self.cfg.name}: {self.max_batch + 1} state slots "
                    f"need {nbytes / GiB:.2f} GiB; {free / GiB:.2f} GiB of "
                    "the card are free (lower max_batch)")

    def _record_margins(self, rids: Sequence[int], logits) -> None:
        top2 = torch.topk(SH.gather(logits)[:len(rids)], 2, dim=-1).values
        for rid, m in zip(rids, (top2[:, 0] - top2[:, 1]).tolist()):
            self.margins.setdefault(rid, []).append(m)

    def _flush_route_margins(self) -> None:
        """Reduce the logged router probabilities to each token's smallest
        margin over the MoE layers and move them into ``route_margins``
        with one device-to-host copy."""
        steps = [t for _, t in self._route_log if t is not None]
        if steps:
            near = torch.stack(steps)             # (steps, n_moe, B, 2)
            steps = (near[..., 0] - near[..., 1]).amin(1).tolist()
        rows = iter(steps)
        for rids, t in self._route_log:
            vals = next(rows) if t is not None else [math.nan]
            for rid, m in zip(rids, vals):
                self.route_margins.setdefault(rid, []).append(m)
        self._route_log.clear()

    # ------------------------------------------------------------------ #
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               arrival_s: float = 0.0, priority: float = 0.0) -> int:
        """Queue one request; returns its request id.  ``priority``
        orders budget preemption (lowest evicted first)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = min(max_new_tokens,
                      self.sv.max_context - prompt.shape[0])
        if max_new <= 0:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens leaves no room "
                f"under max_context={self.sv.max_context}")
        need = self.pool.blocks_for_tokens(prompt.shape[0] + 1)
        margin = self.sched.cfg.admission_margin_blocks
        if need + margin > self.pool.num_blocks:
            raise ValueError(
                f"prompt needs {need} blocks (+{margin} margin) but the "
                f"pool only has {self.pool.num_blocks}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                      arrival_s=arrival_s, priority=priority)
        self.sched.submit(req)
        self.metrics.on_submit(rid, arrival_s, prompt.shape[0])
        return rid

    # ------------------------------------------------------------------ #
    def _alloc_kind(self) -> Optional[str]:
        """Per-block allocation kind.  Static policy: a fixed split at
        the fast budget's share of the pool, never migrated.  Dynamic
        policies: first touch in the slow tier; promotion earns fast
        residency from observed heat."""
        pool = self.pool
        if self._static_split:
            target = pool.fast_block_budget / max(pool.num_blocks, 1)
            if pool.fast_used() < pool.fast_block_budget and \
                    pool.fast_used() < target * (pool.used_block_count()
                                                 + 1):
                return FAST_KIND
        return None           # pool default (slow kind)

    def _do_prefill(self, req: Request, now: float) -> None:
        toks = req.prefill_tokens()[None]          # (1, L)
        L = toks.shape[1]
        need = self.pool.blocks_for_tokens(L + 1)
        if not self.pool.can_alloc(need):
            for v in self.sched.preempt_for_blocks(need, protect=req):
                self.metrics.on_preempt(v.rid, now)
        if req.state is not RequestState.RUNNING:
            return                     # pool too tight: preempted itself
        sp = self._spans
        with hot_span(sp, "engine.prefill", rid=req.rid, tokens=L):
            with hot_span(sp, "engine.prefill.forward"):
                tokens = torch.as_tensor(toks, dtype=torch.int64,
                                         device=self.device)
                logits, cache = self._prefill(
                    self.params, {"tokens": tokens}, units=self._units)
            with hot_span(sp, "engine.prefill.write"):
                self.pool.write_prefill(req.rid, cache["kv_k"][:, :, 0],
                                        cache["kv_v"][:, :, 0], L,
                                        kind=self._alloc_kind)
            if self.states is not None:
                with hot_span(sp, "engine.prefill.state"):
                    self.states.take(req.rid)
                    self.states.write_prefill(req.rid,
                                              cache["conv"][:, :, 0],
                                              cache["ssm"][:, :, 0])
            self.metrics.on_admit(req.rid, now)
            with hot_span(sp, "engine.prefill.read"):
                self._record_margins([req.rid], logits)
                if self._track_routes:
                    self._route_log.append(([req.rid], None))
                req.out_tokens.append(int(SH.argmax(logits)[0]))
            self.metrics.on_token(req.rid, self._now())
            if req.done:
                self.sched.finish(req)
                self.metrics.on_finish(req.rid, self._now(),
                                       req.preemptions)

    def _ensure_tail_blocks(self) -> None:
        """Every running request needs a block for its next KV write."""
        for req in list(self.sched.running):
            if req.state is not RequestState.RUNNING:
                continue               # evicted by an earlier iteration
            n = self.pool.seq_len[req.rid]
            if n % self.pool.block_tokens != 0:
                continue
            if n // self.pool.block_tokens < len(
                    self.pool.table[req.rid]):
                continue
            if not self.pool.can_alloc(1):
                for v in self.sched.preempt_for_blocks(1, protect=req):
                    self.metrics.on_preempt(v.rid, self._now())
            if req.state is not RequestState.RUNNING:
                continue               # preempted itself
            self.pool.alloc(req.rid, 1, kind=self._alloc_kind)

    def _batch_inputs(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens (B, 1) int64, lengths (B,) int32), padded to
        max_batch with token 0 and length 0 (fixed batch shape)."""
        n_pad = self.max_batch - len(batch)
        toks = [r.out_tokens[-1] for r in batch] + [0] * n_pad
        lens = [self.pool.seq_len[r.rid] for r in batch] + [0] * n_pad
        return (torch.as_tensor(toks, dtype=torch.int64,
                                device=self.device)[:, None],
                torch.as_tensor(lens, dtype=torch.int32,
                                device=self.device))

    def _staged_decode_batch(self, batch):
        """Returns (logits, new_k, new_v, None)."""
        with hot_span(self._spans, "engine.decode.inputs"):
            kv_ks, kv_vs = [], []
            for req in batch:
                k, v = self.pool.gather_seq(req.rid, self.max_seq_blocks)
                kv_ks.append(k)
                kv_vs.append(v)
            n_pad = self.max_batch - len(batch)
            if n_pad:
                z = torch.zeros_like(kv_ks[0])
                kv_ks.extend([z] * n_pad)
                kv_vs.extend([z] * n_pad)
            kv_k = torch.stack(kv_ks, dim=2)   # (U, n_attn, B, S_pad, ...)
            kv_v = torch.stack(kv_vs, dim=2)
            tokens, lengths = self._batch_inputs(batch)
        with hot_span(self._spans, "engine.decode.forward"):
            return _paged_decode(self.cfg, self._units, self.params,
                                 tokens, kv_k, kv_v, lengths) + (None,)

    def _fused_decode_batch(self, batch):
        """Fused decode: no staging copy — the kernel reads the pooled
        stores through each sequence's block table.  Returns (logits,
        new_k, new_v, routed expert ids (U, n_moe, B, K)); router
        margins are logged."""
        with hot_span(self._spans, "engine.decode.inputs"):
            tbl, _ = self.pool.gather_tables([r.rid for r in batch],
                                             self.max_seq_blocks)
            n_pad = self.max_batch - len(batch)
            if n_pad:
                tbl = np.concatenate(
                    [tbl, np.zeros((n_pad, tbl.shape[1]), np.int32)])
            tokens, lengths = self._batch_inputs(batch)
            tbl = torch.as_tensor(tbl, device=self.device)
            states = None
            if self.states is not None:
                st = self.states
                states = (st.conv, st.ssm,
                          st.rows([r.rid for r in batch], self.max_batch))
        with hot_span(self._spans, "engine.decode.forward"):
            nears = [] if self._track_routes else None
            logits, new_k, new_v, routed = _fused_paged_decode(
                self.cfg, self.sv.block_tokens, self._units, self.params,
                tokens, self.pool.k_store, self.pool.v_store, tbl, lengths,
                route_margins=nears, states=states, spans=self._spans)
            if nears:
                self._route_log.append(([r.rid for r in batch],
                                        torch.stack(nears)))
        return logits, new_k, new_v, routed

    def _feed_routing(self, batch, routed) -> None:
        """The routed expert ids of the live rows feed per-expert heat
        (one device-to-host copy)."""
        if self.expert_pool is None or routed is None or \
                not routed.shape[1]:
            return
        ids = routed.cpu().numpy()     # (U, n_moe, B, K), one copy
        for u in range(ids.shape[0]):
            for m in range(ids.shape[1]):
                gl = u * self._moe_per_unit + m
                for i in range(len(batch)):
                    self.expert_pool.record_routing(
                        gl, ids[u, m, i], self._step)

    def _decode_iteration(self, now: float) -> None:
        batch = list(self.sched.running)
        if not batch:
            return
        sp = self._spans
        with hot_span(sp, "engine.decode", step=self._step, rows=len(batch)):
            if self.sv.fused_gather:
                logits, new_k, new_v, routed = self._fused_decode_batch(
                    batch)
            else:
                logits, new_k, new_v, routed = self._staged_decode_batch(
                    batch)
            with hot_span(sp, "engine.decode.read"):
                self._feed_routing(batch, routed)
                next_toks = SH.argmax(logits).tolist()
                self._record_margins([r.rid for r in batch], logits)
            with hot_span(sp, "engine.decode.commit"):
                now_tok = self._now()
                for i, req in enumerate(batch):
                    self.pool.append_token(req.rid, new_k[:, :, i],
                                           new_v[:, :, i])
                    self.pool.touch_seq(req.rid, self._step)
                    req.out_tokens.append(int(next_toks[i]))
                    self.metrics.on_token(req.rid, now_tok)
                    if req.done:
                        self.sched.finish(req)
                        self.metrics.on_finish(req.rid, now_tok,
                                               req.preemptions)

    # ------------------------------------------------------------------ #
    def _move_seq_blocks(self, obj: str, src: str, dst: str,
                         nbytes: int) -> int:
        """MigrationExecutor move_fn: realize an object-level byte move
        as pool-block migrations.  Returns bytes actually moved (the
        fast-block budget may deny promotions).  Every payload copy is
        complete when this returns (``to_kind`` blocks), so the
        executor's wall-clock audit times the moves, not their
        enqueueing; pooled blocks move in the ledger only."""
        if not obj.startswith("seq"):
            return 0
        try:
            sid = int(obj[3:])
        except ValueError:
            return 0
        bn = self.pool.block_nbytes()
        want = int(round(nbytes / max(bn, 1)))
        moved = 0
        for b in self.pool.seq_blocks(sid):
            if moved >= want:
                break
            if b.kind == src and self.pool.migrate(b.bid, dst):
                moved += 1
        return moved * bn

    def _replan_step(self) -> None:
        """One telemetry epoch (``_replan_epoch``), in the span
        ``engine.replan_epoch``."""
        with hot_span(self._spans, "engine.replan_epoch", epoch=self._step):
            self._replan_epoch()

    def _replan_epoch(self) -> None:
        """One telemetry epoch: close the bucket, track phases, and (in
        adaptive mode) attempt an object-level replan over live
        sequences.  Predictive mode keys the plan cache by recurrence
        signature and pre-stages the proven plan of a predicted
        next-epoch phase during the current one's slack."""
        self.sampler.advance_epoch()
        self.phases.update()
        # live lag monitor: one (phase, tokens, time) sample per epoch
        now = self._now()
        self.lag.observe_epoch(str(self.phases.label),
                               self.metrics.decode_tokens
                               - self._lag_tokens,
                               now - self._lag_time)
        self._lag_tokens = self.metrics.decode_tokens
        self._lag_time = now
        self.tracer.event("phase.update", cat="phase",
                          epoch=self._step, label=str(self.phases.label),
                          shifts=len(self.phases.shifts))
        if self.expert_pool is not None:
            # close the expert heat epoch and run promote/demote (and,
            # under the predictive policy, next-phase prefetch)
            self.expert_pool.step(self._step)
        if self.blame is not None:
            # keep this tenant's class-tagged offered flows current in
            # the blame book *before* the SLO check, so a firing
            # violation attributes against fresh loads
            self.blame.publish_flows(self.sv.tenant,
                                     self.sched._running_flows(),
                                     now=now)
            if self.expert_pool is not None:
                # expert-gather traffic rides the same tier link as KV
                # gathers: published class-tagged under the expert
                # namespace, so blame splits demand reads from prefetch
                self.blame.publish_flows(
                    self.expert_pool.tenant,
                    self.expert_pool.gather_flows(self.topo), now=now)
        if self.slo.targets and self._step % 16 == 0:
            self.slo.check()
            if self.predictor is not None:
                self._qos_audit_step()
        if (self.replanner is None or self.sv.replan_every <= 0
                or self._step == 0
                or self._step % self.sv.replan_every != 0):
            return
        if self.arbiter is not None:
            self.arbiter.rebalance(epoch=self._step)
        if self.calibrator is not None:
            # refresh the replanner's planning view from the online
            # scale corrections the audit loop accumulated this epoch
            self.replanner.recalibrate()
        bn = self.pool.block_nbytes()
        nbytes = {f"seq{sid}": len(tbl) * bn
                  for sid, tbl in self.pool.table.items() if tbl}
        if not nbytes:
            return
        try:
            if self.sv.predictive and self.phases.signature is not None:
                cur = self.phases.expected_signature(1)
                nxt = self.phases.expected_signature(2)
                if nxt is not None and nxt != cur:
                    d = self.replanner.prefetch_phase(self._step, nbytes,
                                                      nxt)
                    if d is not None:
                        return
                self.replanner.maybe_replan(self._step, nbytes,
                                            force=True, phase=cur)
                return
            # phase-conditioned plan cache: recurring detector labels
            # reuse their plan
            self.replanner.maybe_replan(self._step, nbytes, force=True,
                                        phase=self.phases.label)
        finally:
            # deferred applies land this epoch: flush the move round so
            # the realized residency is adopted before the next
            # iteration reads the ledger
            if self.movesched is not None and self.movesched.has_pending:
                self.movesched.flush(epoch=self._step)

    def _qos_audit_step(self) -> None:
        """One predict/realize audit cycle for the ``qos.violation``
        model: join the previous check's tail forecast with the window
        p99 measured now, refresh the online baseline, and file the
        forecast for the next check from the live flow set."""
        sv = self.sv
        q = 0.99 if sv.slo_p99_decode_s is not None else 0.95
        observed = self.slo.quantile("decode_latency", q)
        if observed is None:
            return
        if self._qos_last_key is not None:
            self.predictor.realize(self._qos_last_key, sv.tenant,
                                   observed)
            self._qos_last_key = None
        self.predictor.observe_p99(sv.tenant, observed)
        pred = self.predictor.file_prediction(
            self._step, sv.tenant,
            extra_flows=self.sched._running_flows(),
            exclude=sv.tenant, epoch=self._step)
        if pred is not None:
            self._qos_last_key = self._step

    def telemetry_summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "trace_events": float(self.trace.total_events),
            "profiling_samples": float(self.sampler.samples),
            "profiling_overhead_s": self.sampler.overhead_s,
            "phase_shifts": float(len(self.phases.shifts)),
            "link_deferrals": float(self.sched.link_deferrals),
            "budget_preemptions": float(self.sched.budget_preemptions),
            "qos_deferrals": float(self.sched.qos_deferrals),
            "slo_preemptions": float(self.sched.slo_preemptions),
            "ledger_migrated_bytes": float(
                self.ledger.counters.migrated_bytes),
        }
        if self.replanner is not None:
            out.update(self.replanner.summary())
        if self.expert_pool is not None:
            out.update(self.expert_pool.summary())
        if self.movesched is not None:
            for k, v in self.movesched.summary().items():
                out[f"movesched.{k}"] = v
        if self.arbiter is not None:
            out["arbiter_rebalances"] = float(len(self.arbiter.decisions))
            out["arbiter_predicted_grants"] = float(
                self.arbiter.predicted_grants)
        lag = self.lag.ratio()
        if lag is not None:
            out["live_burst_entry_ratio"] = float(lag)
        out["trace_recorded_events"] = float(len(self.tracer))
        out["trace_dropped_events"] = float(self.tracer.dropped)
        if self._spans is not None:
            out["trace_dropped_spans"] = float(self.tracer.spans_dropped)
        if self.blame is not None:
            out.update(self.blame.summary())
        out.update(self.audit.summary())
        if self.calibrator is not None:
            out.update(self.calibrator.summary())
        return out

    def audit_report(self) -> Dict[str, object]:
        """Structured prediction-audit artifact (the ``--audit-out``
        payload): per-model residual stats plus, when calibration is
        on, the fitted/online correction state."""
        out: Dict[str, object] = {"audit": self.audit.report()}
        if self.calibrator is not None:
            out["calibration"] = self.calibrator.summary()
        return out

    # ------------------------------------------------------------------ #
    def _now(self) -> float:
        """Trace time: wall clock since run() start plus the virtual
        fast-forward over idle arrival gaps."""
        return self.clock() - self._t0 + self._virtual_skew

    def run(self, max_iterations: int = 10_000) -> ServingReport:
        """Drive the trace to completion; returns the serving report."""
        self._t0 = self.clock()
        self._virtual_skew = 0.0
        while self.sched.active and self._step < max_iterations:
            now = self._now()
            # an arbiter may have shrunk this tenant's fast budget in
            # the shared ledger since the last iteration: enforce it
            # before admitting new work (freed blocks re-admit victims)
            for v in self.sched.preempt_over_budget():
                self.metrics.on_preempt(v.rid, now)
            # predictive QoS: back off while any registered tenant's
            # predicted tail exceeds its target under our live flows
            for v in self.sched.preempt_predicted_violation():
                self.metrics.on_preempt(v.rid, now)
            admitted = self.sched.admit(now_s=now)
            if not admitted and not self.sched.running:
                # idle: fast-forward the arrival clock (synthetic traces)
                pending = [r.arrival_s for r in self.sched.waiting]
                skip = max(min(pending) - now, 0.0) if pending else 0.0
                if skip <= 0.0:
                    raise RuntimeError(
                        "scheduler stalled: waiting requests cannot be "
                        "admitted into an empty pool (pool too small)")
                self._virtual_skew += skip
                continue
            for req in admitted:
                self._do_prefill(req, now)
            self._ensure_tail_blocks()
            self._decode_iteration(now)
            if self.sv.migrate_every and \
                    self._step % self.sv.migrate_every == 0:
                self.tierer.step(
                    [r.rid for r in self.sched.running], self._step)
            self._replan_step()
            self.metrics.on_iteration(
                self._step, self.pool.used_block_count(),
                self.pool.fast_used(), len(self.sched.running),
                len(self.sched.waiting))
            self._step += 1
        self._flush_route_margins()
        tstats = self.tierer.stats.as_dict()
        # adaptive replan moves also migrate pool blocks; surface them in
        # the tiering counters the report exposes
        tstats["migrated_bytes"] = self.pool.counters.migrated_bytes
        if self.slo.targets:
            self.slo.check()           # final window evaluation
        summary = self.metrics.summary(tstats)
        telemetry = self.telemetry_summary()
        # publish the run's aggregates into the registry, so a
        # --metrics-out export carries engine + ledger + control-plane
        # state beside the streaming histograms
        self.registry.set_gauges(summary, prefix="serving.summary")
        self.registry.set_gauges(telemetry, prefix="serving.telemetry")
        self.ledger.publish(self.registry)
        self.registry.set_gauges(self.audit.summary())
        if self.calibrator is not None:
            self.calibrator.publish(self.registry)
        slo = self.slo.summary()
        if self.blame is not None:
            slo["blame"] = self.blame.blame_report()
        return ServingReport(
            summary=summary,
            per_request=self.metrics.per_request_rows(),
            tiering=tstats, policy=self.tierer.policy_name,
            telemetry=telemetry, slo=slo)
