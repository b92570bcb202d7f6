"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
every other layer [arXiv:2403.19887].

Unit of 8 layers: 7 Mamba + 1 attention (index 4), MoE on odd layers.
Subquadratic (runs long_500k): attention layers are 1/8 and long-context
decode shards their KV over the data axis (SP flash-decode)."""
from .base import LayerSpec, ModelConfig

_M = LayerSpec(kind="mamba")
_MM = LayerSpec(kind="mamba", moe=True)
_A = LayerSpec(kind="attn")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, head_dim=128,
    pattern=(_M, _MM, _M, _MM, _A, _MM, _M, _MM),
    n_experts=16, top_k=2, capacity_factor=1.25, moe_groups=32,
    norm="rms", act="silu", pos_emb="rope", rope_theta=1000000.0,
    mamba_expand=2, mamba_d_state=16, mamba_head_dim=64, ssd_chunk=128,
    subquadratic=True,
)
