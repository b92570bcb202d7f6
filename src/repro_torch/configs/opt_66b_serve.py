"""OPT-66B for the paper's FlexGen inference study (Sec. IV-B)."""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="opt-66b-serve", family="dense",
    n_layers=64, d_model=9216, n_heads=72, n_kv=72, d_ff=36864,
    vocab=50272, head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    norm="ln", act="gelu", pos_emb="learned", max_pos=34816,
)
