"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, MHA) d_ff=13440
vocab=92416 — qwen1.5 arch (QKV bias) [hf:Qwen/CodeQwen1.5-7B]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=13440,
    vocab=92416, head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    qkv_bias=True, norm="rms", act="silu", pos_emb="rope",
    rope_theta=1000000.0,
)
