"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892].

Subquadratic: decode state is O(1) in context length (wkv matrix state),
so long_500k runs trivially."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv=64, d_ff=14336,
    vocab=65536, head_dim=64,
    pattern=(LayerSpec(kind="rwkv"),),
    norm="ln", act="silu", pos_emb="none",
    rwkv_head_dim=64, rwkv_chunk=64,
    subquadratic=True,
)
