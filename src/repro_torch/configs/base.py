"""Config schema: architectures, shapes, and execution knobs.

A ModelConfig fully determines parameter shapes, the layer pattern
(dense / MoE / Mamba / RWKV / cross-attn units), and the step functions the
launcher lowers.  Configs are static pytrees (frozen dataclasses) so they
can be closed over by jitted functions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating unit."""

    kind: str = "attn"          # attn | mamba | rwkv
    moe: bool = False           # MLP replaced by MoE
    cross_attn: bool = False    # adds a cross-attention sublayer


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 32        # dispatch groups (≈ DP degree)

    # --- attention / embedding details ---
    qkv_bias: bool = False
    norm: str = "rms"           # rms | ln
    act: str = "silu"           # silu (SwiGLU) | gelu
    pos_emb: str = "rope"       # rope | learned | sinusoidal | none
    rope_theta: float = 500000.0
    rotary_pct: float = 1.0
    tie_embeddings: bool = False
    max_pos: int = 32768        # learned-pos table size (if pos_emb=learned)

    # --- SSM / RWKV ---
    mamba_expand: int = 2
    mamba_d_state: int = 16
    mamba_head_dim: int = 64
    mamba_d_conv: int = 4
    ssd_chunk: int = 128
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64

    # --- the port's opt-in knobs: plain class attributes here, not
    # fields, so that a reference architecture's config keeps the
    # reference's fields; ``PortModelConfig`` makes them fields ---
    mamba_groups = 0            # >0: the published Mamba-2 block
    shared_expert_ff = 0        # >0: a SwiGLU expert every token takes
    embedding_multiplier = 1.0  # token embeddings scaled by it
    residual_multiplier = 1.0   # each sublayer's output scaled by it
    logits_scaling = 1.0        # logits divided by it
    attention_multiplier = 0.0  # >0: softmax scale in place of 1/sqrt(hd)
    norm_eps = 0.0              # >0: the RMS norms' epsilon

    # --- encoder (whisper) / frontend stubs ---
    encoder_layers: int = 0     # >0: enc-dec; encoder is bidirectional
    n_frontend_tokens: int = 0  # stubbed modality tokens (audio frames /
                                # image patches), fed as embeddings
    # --- execution ---
    attn_chunk: int = 1024
    remat: bool = True
    loss_chunk: int = 512
    kv_cache_dtype: str = "bf16"    # bf16 | int8 (quantized decode cache)
    # capability flags
    subquadratic: bool = False  # can run long_500k
    supports_decode: bool = True

    # ------------------------------------------------------------------ #
    @property
    def n_units(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by " \
            f"pattern of {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    @property
    def unit_attn_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.pattern)
                     if s.kind == "attn")

    @property
    def unit_mamba_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.pattern)
                     if s.kind == "mamba")

    @property
    def unit_rwkv_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.pattern)
                     if s.kind == "rwkv")

    @property
    def unit_cross_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.pattern) if s.cross_attn)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + all units + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, hd = self.n_heads, self.n_kv, self.head_dim
        n = V * D                       # embed
        if not self.tie_embeddings:
            n += V * D                  # lm head
        if self.pos_emb == "learned":
            n += self.max_pos * D
        per_unit = 0
        for spec in self.pattern:
            if spec.kind == "attn":
                per_unit += D * H * hd + 2 * D * KV * hd + H * hd * D
            elif spec.kind == "mamba":
                di = self.d_inner
                nh = di // self.mamba_head_dim
                bc = self.mamba_groups or nh        # B, C per group or head
                conv = di + 2 * bc * self.mamba_d_state \
                    if self.mamba_groups else di
                per_unit += D * (2 * di + 2 * bc * self.mamba_d_state + nh)
                per_unit += di * D + self.mamba_d_conv * conv
            elif spec.kind == "rwkv":
                per_unit += 5 * D * D + D * max(32, D // 64) * 2
                per_unit += D * F + F * D   # channel mix
            if spec.cross_attn:
                per_unit += D * H * hd + 2 * D * KV * hd + H * hd * D
            if spec.kind != "rwkv":
                per_unit += 3 * D * self.shared_expert_ff
                if spec.moe:
                    mats = 3 if self.act == "silu" else 2
                    per_unit += D * self.n_experts + \
                        self.n_experts * mats * D * F
                else:
                    mats = 3 if self.act == "silu" else 2
                    per_unit += mats * D * F
        n += per_unit * self.n_units
        if self.encoder_layers:
            enc = self.encoder_layers * (
                D * H * hd + 2 * D * KV * hd + H * hd * D + 2 * D * F)
            n += enc
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        mats = 3 if self.act == "silu" else 2
        moe_layers = sum(1 for s in self.pattern if s.moe) * self.n_units
        dense_equiv = self.param_count() - \
            moe_layers * (self.n_experts * mats * D * F)
        return dense_equiv + moe_layers * (self.top_k * mats * D * F)


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A ``ModelConfig`` with the port's opt-in fields (the Granite 4.0-H
    family's), each defaulting to what a plain ``ModelConfig`` reads."""

    # >0: Mamba-2 as published (Dao & Gu 2024) with this many groups: B
    # and C per group, the depthwise conv over [x, B, C], and the gate
    # applied before an RMS norm over groups of d_inner / mamba_groups;
    # 0: the reference's simplified SSD block (B, C per head, conv over
    # x, norm before the gate)
    mamba_groups: int = 0
    shared_expert_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0
    norm_eps: float = 0.0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    step: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    n_units = 2
    return dataclasses.replace(
        cfg,
        n_layers=n_units * len(cfg.pattern),
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)) if cfg.n_kv < cfg.n_heads else 4,
        d_ff=128,
        head_dim=16,
        vocab=512,
        n_experts=8 if cfg.n_experts else 0,
        **({"shared_expert_ff": 128} if cfg.shared_expert_ff else {}),
        top_k=min(cfg.top_k, 2) if cfg.n_experts else 0,
        capacity_factor=8.0,   # drop-free at smoke scale (determinism)
        moe_groups=4,
        max_pos=256,
        mamba_head_dim=16,
        mamba_d_state=8,
        ssd_chunk=8,
        rwkv_head_dim=16,
        rwkv_chunk=8,
        attn_chunk=32,
        loss_chunk=32,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_frontend_tokens=16 if cfg.n_frontend_tokens else 0,
        remat=False,
    )
