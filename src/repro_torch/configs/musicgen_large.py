"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

Backbone only (per assignment): the EnCodec tokenizer + multi-codebook
interleaving is the STUB — ``input_specs`` feeds flat code-token ids
(vocab 2048).  MHA (kv == heads == 32).  GeGLU stands in for the original
non-gated GELU MLP (gated form, same hidden dim — noted in DESIGN.md).
long_500k skipped: full attention.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    ffn_act="gelu",
    frontend="audio",
)
