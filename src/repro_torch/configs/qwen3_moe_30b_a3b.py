"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_ff=768,
    vocab=151936, head_dim=128,
    pattern=(LayerSpec(kind="attn", moe=True),),
    n_experts=128, top_k=8, capacity_factor=1.25, moe_groups=32,
    norm="rms", act="silu", pos_emb="rope", rope_theta=1000000.0,
)
