"""BERT-large-style encoder for the paper's ZeRO-Offload study (Sec. IV-A).
Trained here as a causal LM stand-in at matching size (the offload engine
exercises the same objects: params/grads/moments)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="bert-large-offload", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
    vocab=30522, head_dim=64,
    pattern=(LayerSpec(kind="attn"),),
    norm="ln", act="gelu", pos_emb="learned", max_pos=4096,
    tie_embeddings=True,
)
