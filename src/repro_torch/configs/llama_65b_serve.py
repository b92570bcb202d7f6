"""LLaMA-65B for the paper's FlexGen inference study (Sec. IV-B)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-65b-serve", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=64, d_ff=22016,
    vocab=32000, head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    norm="rms", act="silu", pos_emb="rope", rope_theta=10000.0,
)
