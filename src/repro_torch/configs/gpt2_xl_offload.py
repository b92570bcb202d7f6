"""GPT2-style model for the paper's ZeRO-Offload training study (Sec. IV-A).
Sized ~1.5B (the paper uses 4-8B GPT2 variants; this is the example-scale
config — scale n_layers/d_model up for the full study)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gpt2-xl-offload", family="dense",
    n_layers=48, d_model=1600, n_heads=25, n_kv=25, d_ff=6400,
    vocab=50257, head_dim=64,
    pattern=(LayerSpec(kind="attn"),),
    norm="ln", act="gelu", pos_emb="learned", max_pos=4096,
    tie_embeddings=True,
)
