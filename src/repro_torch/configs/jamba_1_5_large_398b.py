"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave (period 8,
attention at offset 4), MoE 16e top-2 on every other layer.
[arXiv:2403.19887]

~398B total / ~94B active parameters.  Mamba positions use our SSD block
(DESIGN.md: Jamba-1.5 ships Mamba-1; SSD is the TPU-native successor with
the same state-space interface).  long_500k RUNS: decode state is O(1) for
the 63 mamba layers and the 9 attention layers hold the only KV.
"""
from ..models.config import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    attn_layer_period=8,
    attn_layer_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2, offset=1),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=128, n_groups=1),
)
