"""FlexGen-style one-shot serving engine (paper Sec. IV-B; counterpart of
``repro.offload.serve_engine``).

The paper's inference use case with real tier placement:

  * weights and the KV cache are placed across {device, pinned_host,
    unpinned_host} by share lists; ``search_placement`` picks shares
    with the cost model (``core.costmodel.policy_search``, the paper's
    LP search);
  * the weights are gathered into device memory once, before the timed
    prefill; prefill runs the flash kernel, and each decode step
    restores the tier-resident KV into device memory, runs the step
    (the ``decode_attention`` kernel on the card) and writes the KV
    back to its tiers (``serving.kv_pool.TieredKVCache``).  Only
    ``kv_k``/``kv_v`` are padded and tiered; the recurrent states and
    the cross-attention K/V stay on the device;
  * ``max_batch_for_capacity`` sizes the batch to a capacity budget
    (LIO 3: more capacity, larger batch, more throughput).

The engine reports prefill and decode throughput apart (Fig. 11's split:
prefill is latency-sensitive, decode bandwidth-sensitive).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..configs.base import ModelConfig
from ..core import costmodel, objects as obj_mod, tiers as tiers_mod
from ..core.tiered_array import (DeviceLike, gather_pytree, place_pytree,
                                 resolve_device)
from ..launch import steps as steps_mod
from ..models import lm
from ..serving.kv_pool import TieredKVCache


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    prompt_len: int = 64
    # tier capacity budget in bytes for {device, host}
    device_budget: Optional[int] = None
    weight_shares: Sequence[Tuple[str, float]] = (("device", 1.0),)
    kv_shares: Sequence[Tuple[str, float]] = (("device", 1.0),)


@dataclasses.dataclass
class ServeStats:
    batch: int
    prefill_s: float
    decode_s: float
    new_tokens: int

    @property
    def prefill_tok_s(self) -> float:
        return self.batch * 1.0 / max(self.prefill_s, 1e-9)

    @property
    def decode_tok_s(self) -> float:
        return self.batch * self.new_tokens / max(self.decode_s, 1e-9)


def search_placement(cfg: ModelConfig, batch: int, seq: int,
                     tier_set: Mapping[str, tiers_mod.MemoryTier],
                     fast: str = "HBM") -> costmodel.SearchResult:
    """FlexGen's policy search over the cost model."""
    n_params = cfg.param_count()
    kv_bytes = (cfg.n_layers * 2 * batch * seq * cfg.n_kv
                * cfg.head_dim * 2)
    act_bytes = batch * cfg.d_model * 4 * cfg.n_layers
    objs = obj_mod.llm_serve_objects(n_params, kv_bytes, act_bytes)
    return costmodel.policy_search(objs, tier_set, fast=fast, grid=10)


class FlexGenEngine:
    """Batched prefill + decode with tier-resident weights and KV, on
    ``device`` (CUDA unless ``"cpu"``).

    ``telemetry`` (an AccessTrace or AccessSampler) receives per-phase
    traffic: one write-heavy prefill epoch, then one epoch per decode
    step (weights and KV streamed, one token's KV written) — the Fig. 11
    latency/bandwidth split as an observable signal.  ``run`` keeps the
    generated tokens, (B, new_tokens) int64, on ``self.tokens``.
    """

    def __init__(self, cfg: ModelConfig, params: Any,
                 serve: Optional[ServeConfig] = None,
                 telemetry=None, ledger=None, tenant: str = "flexgen",
                 device: DeviceLike = None):
        if cfg.kv_cache_dtype == "int8":
            raise ValueError(
                f"{cfg.name}: the one-shot engine pads and tiers only "
                "kv_k/kv_v; an int8 cache's kv_k_scale/kv_v_scale would "
                "stay prompt-long and the first decode step could not "
                "dequantize the padded cache (the reference engine fails "
                "there too; ROADMAP section 3)")
        self.cfg = cfg
        self.serve_cfg = serve or ServeConfig()
        self.telemetry = telemetry
        self.device = resolve_device(device)
        # KV residency is accounted in the (possibly shared) ledger
        # under this engine's tenant namespace
        self.ledger = ledger
        self.tenant = tenant
        self.kv_home: Optional[TieredKVCache] = None
        self.tokens: Optional[torch.Tensor] = None
        sc = self.serve_cfg
        # place the weights by the share list (one contiguous span per
        # share, as TieredArray blocks)
        self.params_tiered = place_pytree(
            params, lambda n, l: list(sc.weight_shares), block_rows=None,
            device=self.device)
        self.prefill_step = steps_mod.make_prefill_step(cfg)
        self.decode_step = steps_mod.make_serve_step(cfg)

    def _materialize_params(self):
        return gather_pytree(self.params_tiered)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, prompts: np.ndarray,
            frames: Optional[np.ndarray] = None) -> ServeStats:
        """prompts: (B, prompt_len) integer token ids; frames: (B,
        S_enc, d_model) stubbed frontend embeddings (the image tokens of
        a vision model, the encoder's frames of Whisper), required by a
        model with cross-attention (``lm.prefill`` raises without them)
        and ignored by the others."""
        sc = self.serve_cfg
        B, P = prompts.shape
        params = self._materialize_params()
        units = lm.unit_views(params, self.cfg)
        batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                           dtype=torch.int64,
                                           device=self.device)}
        if frames is not None:
            batch["frames"] = torch.as_tensor(frames, device=self.device)
        self._sync()            # the weights are in place before the clock

        t0 = time.perf_counter()
        logits, cache = self.prefill_step(params, batch, units=units)
        self._sync()
        t1 = time.perf_counter()

        w_bytes = sum(p.nbytes for p in pytree.tree_leaves(params))
        kv_bytes = sum(cache[k].nbytes for k in ("kv_k", "kv_v")
                       if k in cache)
        if self.telemetry is not None:
            self.telemetry.observe("weights", read_bytes=w_bytes,
                                   phase="prefill")
            self.telemetry.observe("kv_cache", write_bytes=kv_bytes,
                                   phase="prefill")
            self.telemetry.advance_epoch()

        # pad the KV buffers for decode; tier residency between steps is
        # the serving subsystem's KV manager's (stash on the configured
        # shares, restore to the device for each decode step)
        pad_to = P + sc.max_new_tokens
        for k in ("kv_k", "kv_v"):
            if k in cache:
                cache[k] = F.pad(cache[k], (0, 0, 0, 0, 0, pad_to - P))
        kv_home = TieredKVCache(sc.kv_shares, ledger=self.ledger,
                                tenant=self.tenant, device=self.device)
        self.kv_home = kv_home
        kv_home.stash(cache)

        kv_step_bytes = sum(cache[k].nbytes for k in ("kv_k", "kv_v")
                            if k in cache)
        tok = torch.argmax(logits, -1)[:, None]
        out_tokens = [tok]
        t2 = time.perf_counter()
        for _ in range(sc.max_new_tokens - 1):
            cache = kv_home.restore(cache)
            logits, cache = self.decode_step(params, cache, tok,
                                             units=units)
            tok = torch.argmax(logits, -1)[:, None]
            out_tokens.append(tok)
            kv_home.update(cache)
            if self.telemetry is not None:
                self.telemetry.observe("weights", read_bytes=w_bytes,
                                       phase="decode")
                self.telemetry.observe(
                    "kv_cache", read_bytes=kv_step_bytes,
                    write_bytes=max(kv_step_bytes // max(pad_to, 1), 1),
                    phase="decode")
                self.telemetry.advance_epoch()
        self._sync()
        t3 = time.perf_counter()
        self.tokens = torch.cat(out_tokens, dim=1)
        return ServeStats(B, t1 - t0, t3 - t2, sc.max_new_tokens)


def max_batch_for_capacity(cfg: ModelConfig, seq: int,
                           capacity_bytes: int) -> int:
    """LIO 3: batch scales with memory capacity (weights + KV + acts)."""
    w = 2 * cfg.param_count()
    per_seq_kv = cfg.n_layers * 2 * seq * cfg.n_kv * cfg.head_dim * 2
    per_seq_act = cfg.d_model * 4 * cfg.n_layers
    avail = capacity_bytes - w
    if avail <= 0:
        return 0
    return max(int(avail // (per_seq_kv + per_seq_act)), 0)
