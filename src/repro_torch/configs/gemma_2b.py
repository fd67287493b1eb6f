"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), tied embeddings,
embeddings scaled by sqrt(d).  [arXiv:2403.08295]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    ffn_act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)
