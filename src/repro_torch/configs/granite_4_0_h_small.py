"""granite-4.0-h-small [hybrid]: 40L d_model=4096, 36 Mamba-2 layers
(128 heads of 64, d_state 128, 1 group, conv 4, chunk 256) and 4 GQA
attention layers (32H, kv=8, hd 128, no positional encoding), every
layer followed by an MoE of 72 SwiGLU experts of width 768 (top-10)
and a shared SwiGLU expert of width 1536; muP scalars (embeddings x12,
residual branches x0.22, logits /16, softmax scale 1/128); tied
embeddings, vocab 100352, RMS norms with eps 1e-5
[hf:ibm-granite/granite-4.0-h-small, config.json].

Unit of 10 layers, attention at index 5: the published layer_types
(attention at layers 5, 15, 25 and 35) as 4 units.  A port-only
architecture: the reference's registry does not hold it."""
from .base import LayerSpec, PortModelConfig

_M = LayerSpec(kind="mamba", moe=True)
_A = LayerSpec(kind="attn", moe=True)

CONFIG = PortModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=768,
    vocab=100352, head_dim=128,
    pattern=(_M, _M, _M, _M, _M, _A, _M, _M, _M, _M),
    n_experts=72, top_k=10, capacity_factor=1.25, moe_groups=32,
    norm="rms", act="silu", pos_emb="none", rope_theta=10000.0,
    tie_embeddings=True,
    mamba_expand=2, mamba_d_state=128, mamba_head_dim=64, mamba_d_conv=4,
    ssd_chunk=256, mamba_groups=1,
    shared_expert_ff=1536, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0,
    attention_multiplier=0.0078125, norm_eps=1e-5,
    subquadratic=True,
)
