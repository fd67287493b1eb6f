"""llava-next-mistral-7b [vlm] — Mistral-7B-v0.2 backbone + anyres vision stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf].  The vision tower is a STUB: the
dry-run's ``input_specs`` provides precomputed patch embeddings (anyres
tiling: base 576 + one 2x2 high-res grid row = 1152 patch tokens) that the
model prepends to the text embedding sequence.  long_500k skipped: full
attention (Mistral-v0.2 dropped SWA).
"""
from ..models.config import ModelConfig

N_PATCH_TOKENS = 1152  # anyres: 576 base + 576 grid tile @ 24x24 patches

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    rope_theta=1_000_000.0,
    ffn_act="silu",
    frontend="vision",
    n_frontend_tokens=N_PATCH_TOKENS,
)
