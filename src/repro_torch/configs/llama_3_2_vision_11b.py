"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; vision encoder
STUBBED (input_specs provides patch embeddings (B, 1600, d_model))
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from .base import LayerSpec, ModelConfig

_A = LayerSpec(kind="attn")
_X = LayerSpec(kind="cross")

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, head_dim=128,
    pattern=(_A, _A, _A, _A, _X),
    norm="rms", act="silu", pos_emb="rope", rope_theta=500000.0,
    n_frontend_tokens=1600,
)
