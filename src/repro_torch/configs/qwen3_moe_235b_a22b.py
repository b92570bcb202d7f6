"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B family]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536,
    vocab=151936, head_dim=128,
    pattern=(LayerSpec(kind="attn", moe=True),),
    n_experts=128, top_k=8, capacity_factor=1.25, moe_groups=32,
    norm="rms", act="silu", pos_emb="rope", rope_theta=1000000.0,
)
