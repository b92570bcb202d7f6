"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    norm="rms", act="silu", pos_emb="rope", rope_theta=500000.0,
)
