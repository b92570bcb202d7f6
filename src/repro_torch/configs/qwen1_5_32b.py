"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392,
    vocab=152064, head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    qkv_bias=True, norm="rms", act="silu", pos_emb="rope",
    rope_theta=1000000.0,
)
