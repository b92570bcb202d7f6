"""stablelm-1.6b [dense]: 24L d_model=2048 32H (kv=32) d_ff=5632
vocab=100352 — LayerNorm, partial rotary 25% [hf:stabilityai/stablelm-2-1_6b]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=5632,
    vocab=100352, head_dim=64,
    pattern=(LayerSpec(kind="attn"),),
    norm="ln", act="silu", pos_emb="rope", rope_theta=10000.0,
    rotary_pct=0.25,
)
