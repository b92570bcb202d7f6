"""whisper-large-v3 [audio]: 32L enc + 32L dec, d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866 — enc-dec; conv frontend STUBBED (input_specs
provides precomputed frame embeddings (B, 1500, d_model))
[arXiv:2212.04356]."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51866, head_dim=64,
    pattern=(LayerSpec(kind="attn", cross_attn=True),),
    norm="ln", act="gelu", pos_emb="learned", max_pos=40960,
    encoder_layers=32, n_frontend_tokens=1500,
)
