"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6,
first layer dense.  [arXiv:2401.06066]

Assigned d_ff=1408 is the per-expert (moe_intermediate) width; the dense
first layer uses the public 10944 intermediate.  MHA (kv=16).  The gate is
the paper's: the top-6 softmax scores, not renormalized (``norm_topk_prob:
false`` in the public config.json); the JAX package renormalizes.
"""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2, norm_topk=False),
    moe_skip_first=1,
)
