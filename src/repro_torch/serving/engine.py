"""ServingEngine: continuous batching over the paged, tiered KV pool
(counterpart of ``repro.serving.engine``, attention-only models, dense
or MoE).

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

Then greedy argmax, ``append_token``, and one ``KVBlockTierer`` epoch.
Padded batch rows carry ``lens = 0`` and a zero block table, exactly as
in the reference.  The reference's control planes (telemetry and
adaptive replanning, predictive arbitration, calibration, topology,
QoS, MoE expert residency, the multi-host cluster) are not ported yet:
their options raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.tiered_array import DeviceLike, resolve_device
from ..kernels import ops
from ..launch import steps as steps_mod
from ..models import lm
from ..models import modules as M
from .kv_pool import FAST_KIND, PagedKVPool, spec_from_config
from .metrics import ServingMetrics
from .scheduler import (ContinuousBatchingScheduler, plan_admission, Request,
                        RequestState, SchedulerConfig)
from .tiering import KVBlockTierer

# options of the reference ServingConfig whose planes are not ported
# yet -> the ROADMAP queue-1 item that ports them
_NOT_PORTED = {
    "adaptive": "item 5 (telemetry and obs planes)",
    "predictive": "item 8 (engine control planes)",
    "calibrate": "item 8 (engine control planes)",
    "topology": "item 8 (engine control planes)",
    "qos": "item 8 (engine control planes)",
    "expert_policy": "item 5 (serving/expert_pool.py, with the telemetry "
                     "slice)",
    "cluster": "item 13 (cluster)",
}


def check_paged_support(cfg: ModelConfig) -> None:
    """Raise if the config can't run on the paged decode path."""
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.cross_attn:
            raise ValueError(
                f"{cfg.name}: paged serving supports attention-only "
                f"patterns (got {spec.kind}"
                f"{'+cross' if spec.cross_attn else ''})")
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: encoder-decoder serving is not "
                         "paged")
    if cfg.kv_cache_dtype != "bf16":
        raise ValueError(f"{cfg.name}: paged pool stores bf16 KV "
                         f"(got {cfg.kv_cache_dtype})")
    if cfg.pos_emb not in ("rope", "learned", "none"):
        raise ValueError(f"{cfg.name}: unsupported pos_emb "
                         f"{cfg.pos_emb!r} for paged decode")
    lm.check_supported(cfg)


# ---------------------------------------------------------------------- #
# Paged decode steps                                                     #
# ---------------------------------------------------------------------- #
def _qkv_tok(cfg: ModelConfig, lp, x: torch.Tensor, lengths: torch.Tensor):
    """Norm, projections and per-sequence rotary embedding for one
    decode token: q (B, 1, H, hd), k/v (B, 1, KV, hd)."""
    h = M.apply_norm(cfg.norm, lp["norm1"], x)
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
    x = x + att.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ lp["attn"]["wo"]
    return x, M.apply_norm(cfg.norm, lp["norm2"], x)


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

    Returns (out (B, 1, D), ids (B, K) int32, near (B, 2)): near holds
    the router probabilities of each token's K-th and (K+1)-th experts
    (0 where there is no (K+1)-th), whose difference says how near the
    routing came to a tie."""
    K = cfg.top_k
    probs = torch.softmax(h[:, 0].float() @ mp["router"], dim=-1)
    vals, idx = torch.topk(probs, min(K + 1, probs.shape[-1]), dim=-1)
    topw, topi = vals[:, :K], idx[:, :K].to(torch.int32)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    if vals.shape[-1] == K:
        vals = torch.nn.functional.pad(vals, (0, 1))
    out = ops.fused_expert_ffn(h[:, 0].contiguous(), mp["w_gate"],
                               mp["w_up"], mp["w_down"], topi, topw)
    return out[:, None], topi, vals[:, K - 1:]


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens[:, 0]].to(torch.bfloat16)[:, None]
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][lengths].to(x.dtype)[:, None]
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = M.apply_norm(cfg.norm, params["final_norm"], x)
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return (x[:, 0] @ W.T).float()


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

    Returns (logits (B, V), new_k, new_v (U, n_attn, B, KV, hd))."""
    x = _embed(cfg, params, tokens, lengths)
    new_k, new_v = [], []
    for u, up in enumerate(units):
        x, nk, nv = _paged_unit_fwd(cfg, up, x, kv_k[u], kv_v[u], lengths)
        new_k.append(nk)
        new_v.append(nv)
    return _logits(cfg, params, x), torch.stack(new_k), torch.stack(new_v)


def _fused_unit_fwd(cfg: ModelConfig, up, x, k_pool, v_pool, block_tbl,
                    lengths, block_tokens: int):
    """One unit on the fused path: k_pool/v_pool (n_attn, num_blocks,
    bt, KV, hd) are the pool's resident stores; block_tbl (B, nb)
    int32.  The kernel reads blocks through the table and folds the
    step's K/V in, so no gather or scatter happens.  Returns (x, new_k,
    new_v, routed ids (n_moe, B, K) or None without MoE layers, nears:
    one (B, 2) ``_routed_experts`` pair per MoE layer)."""
    new_ks, new_vs, routed, nears = [], [], [], []
    for li, spec in enumerate(cfg.pattern):
        lp = up["layers"][li]
        q, k, v = _qkv_tok(cfg, lp, x, lengths)
        k_tok = k[:, 0].to(k_pool.dtype).contiguous()
        v_tok = v[:, 0].to(v_pool.dtype).contiguous()
        att = ops.paged_decode_attention(
            q[:, 0].contiguous(), k_pool[li], v_pool[li], block_tbl,
            lengths, k_tok, v_tok, block_tokens=block_tokens)
        x, h = _attn_out(cfg, lp, x, att)
        if spec.moe:
            out, ids, near = _routed_experts(cfg, lp["moe"], h)
            routed.append(ids)
            nears.append(near)
        else:
            out = M.mlp_fwd(lp["mlp"], h, cfg.act)
        x = x + out
        new_ks.append(k_tok)
        new_vs.append(v_tok)
    ids = torch.stack(routed) if routed else None
    return x, torch.stack(new_ks), torch.stack(new_vs), ids, nears


@torch.no_grad()
def _fused_paged_decode(cfg: ModelConfig, block_tokens: int, units, params,
                        tokens, k_store, v_store, block_tbl, lengths,
                        route_margins: Optional[list] = None):
    """tokens (B, 1); k_store/v_store (U, n_attn, num_blocks, bt, KV,
    hd) — the pooled layout itself; block_tbl (B, nb) int32; lengths
    (B,) int32.  Returns (logits (B, V), new_k, new_v (U, n_attn, B,
    KV, hd), routed expert ids (U, n_moe, B, K) int32).  Where
    ``route_margins`` is a list, every MoE layer's (B, 2) K-th and
    (K+1)-th router probabilities (``_routed_experts``) are appended to
    it."""
    x = _embed(cfg, params, tokens, lengths)
    new_k, new_v, routed = [], [], []
    for u, up in enumerate(units):
        x, nk, nv, ids, nears = _fused_unit_fwd(
            cfg, up, x, k_store[u], v_store[u], block_tbl, lengths,
            block_tokens)
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
    # residency-ledger tenant namespace of this engine's pool
    tenant: str = "serving"
    # fused decode: pooled KV layout read through block tables by the
    # paged_decode_attention kernel (no staging copy)
    fused_gather: bool = False
    # reference options whose planes are not ported yet (see
    # _NOT_PORTED): setting any of them raises NotImplementedError
    adaptive: bool = False
    predictive: bool = False
    calibrate: bool = False
    topology: Optional[str] = None
    qos: bool = False
    expert_policy: Optional[str] = None
    cluster: Optional[object] = None

    def __post_init__(self):
        for name, item in _NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"ServingConfig.{name}: not ported to repro_torch yet "
                    f"(ROADMAP queue 1, {item})")

    @classmethod
    def from_args(cls, args) -> "ServingConfig":
        """Build from a serve-CLI-shaped namespace."""
        get = lambda name, default=None: getattr(args, name, default)  # noqa: E731
        return cls(
            block_tokens=get("block_tokens", 16),
            max_batch=get("batch", 4),
            max_context=(get("prompt_len", 32) + get("new_tokens", 16)
                         + get("block_tokens", 16)),
            policy=get("policy", "tiering08"),
            num_blocks=get("num_blocks"),
            fast_block_budget=get("fast_blocks"),
            tenant=get("tenant") or "serving",
            fused_gather=bool(get("fused_gather")))


@dataclasses.dataclass
class ServingReport:
    summary: Dict[str, float]
    per_request: List[Tuple[int, Dict[str, float]]]
    tiering: Dict[str, int]
    policy: str


class ServingEngine:
    """Continuous-batching serving over a tier-resident paged KV pool.

    ``device``: CUDA unless ``"cpu"`` is asked for; the parameters must
    already live there (``lm.init_params`` / ``lm.params_from_numpy``
    with the same device)."""

    def __init__(self, cfg: ModelConfig, params,
                 serving: Optional[ServingConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 ledger=None, device: DeviceLike = None):
        check_paged_support(cfg)
        self.cfg = cfg
        self.sv = sv = serving or ServingConfig()
        self.clock = clock
        self.device = resolve_device(device)
        if params is not None and params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.params = params
        bt = sv.block_tokens
        self.max_seq_blocks = max(1, math.ceil(sv.max_context / bt))
        if sv.device_budget_bytes is not None:
            plan = plan_admission(
                cfg, bt, sv.max_context, sv.device_budget_bytes,
                sv.host_budget_bytes or 0, max_batch_cap=sv.max_batch)
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
        self.tierer = KVBlockTierer(self.pool, sv.policy)
        self.sched = ContinuousBatchingScheduler(
            self.pool, SchedulerConfig(
                max_batch=max_batch,
                max_prefill_per_iter=sv.max_prefill_per_iter))
        self.metrics = ServingMetrics()
        self._t0 = 0.0
        self._virtual_skew = 0.0
        self._step = 0
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

    def _record_margins(self, rids: Sequence[int],
                        logits: torch.Tensor) -> None:
        top2 = torch.topk(logits[:len(rids)], 2, dim=-1).values
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
        tokens = torch.as_tensor(toks, dtype=torch.int64,
                                 device=self.device)
        logits, cache = self._prefill(self.params, {"tokens": tokens},
                                      units=self._units)
        self.pool.write_prefill(req.rid, cache["kv_k"][:, :, 0],
                                cache["kv_v"][:, :, 0], L,
                                kind=self._alloc_kind)
        self.metrics.on_admit(req.rid, now)
        self._record_margins([req.rid], logits)
        if self._track_routes:
            self._route_log.append(([req.rid], None))
        req.out_tokens.append(int(torch.argmax(logits[0])))
        self.metrics.on_token(req.rid, self._now())
        if req.done:
            self.sched.finish(req)
            self.metrics.on_finish(req.rid, self._now(), req.preemptions)

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
        return _paged_decode(self.cfg, self._units, self.params, tokens,
                             kv_k, kv_v, lengths)

    def _fused_decode_batch(self, batch):
        """Fused decode: no staging copy — the kernel reads the pooled
        stores through each sequence's block table.  Returns (logits,
        new_k, new_v); routed expert ids are dropped (no expert
        residency plane yet), router margins logged."""
        tbl, _ = self.pool.gather_tables([r.rid for r in batch],
                                         self.max_seq_blocks)
        n_pad = self.max_batch - len(batch)
        if n_pad:
            tbl = np.concatenate(
                [tbl, np.zeros((n_pad, tbl.shape[1]), np.int32)])
        tokens, lengths = self._batch_inputs(batch)
        nears = [] if self._track_routes else None
        logits, new_k, new_v, _ = _fused_paged_decode(
            self.cfg, self.sv.block_tokens, self._units, self.params,
            tokens, self.pool.k_store, self.pool.v_store,
            torch.as_tensor(tbl, device=self.device), lengths,
            route_margins=nears)
        if nears:
            self._route_log.append(([r.rid for r in batch],
                                    torch.stack(nears)))
        return logits, new_k, new_v

    def _decode_iteration(self, now: float) -> None:
        batch = list(self.sched.running)
        if not batch:
            return
        if self.sv.fused_gather:
            logits, new_k, new_v = self._fused_decode_batch(batch)
        else:
            logits, new_k, new_v = self._staged_decode_batch(batch)
        next_toks = torch.argmax(logits, dim=-1).tolist()
        self._record_margins([r.rid for r in batch], logits)
        now_tok = self._now()
        for i, req in enumerate(batch):
            self.pool.append_token(req.rid, new_k[:, :, i], new_v[:, :, i])
            self.pool.touch_seq(req.rid, self._step)
            req.out_tokens.append(int(next_toks[i]))
            self.metrics.on_token(req.rid, now_tok)
            if req.done:
                self.sched.finish(req)
                self.metrics.on_finish(req.rid, now_tok, req.preemptions)

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
            for v in self.sched.preempt_over_budget():
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
            self.metrics.on_iteration(
                self._step, self.pool.used_block_count(),
                self.pool.fast_used(), len(self.sched.running),
                len(self.sched.waiting))
            self._step += 1
        self._flush_route_margins()
        tstats = self.tierer.stats.as_dict()
        tstats["migrated_bytes"] = self.pool.counters.migrated_bytes
        return ServingReport(
            summary=self.metrics.summary(tstats),
            per_request=self.metrics.per_request_rows(),
            tiering=tstats, policy=self.tierer.policy_name)
