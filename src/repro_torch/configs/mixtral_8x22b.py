"""mixtral-8x22b [moe] — 8 experts top-2 every layer, sliding-window
attention (window 4096, per assignment).  [arXiv:2401.04088]

long_500k RUNS: the SWA ring cache is bounded by the window, decode is
O(window) per token.
"""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # every layer is MoE
    vocab=32768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
)
