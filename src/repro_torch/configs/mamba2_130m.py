"""mamba2-130m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]

24 layers of pure Mamba2 blocks (no FFN), d_state=128, head_dim=64
(d_inner=1536 -> 24 SSM heads), tied embeddings (GPT-NeoX tokenizer,
vocab 50280 padded to 50432 for TP).  long_500k RUNS: O(1) decode state.
"""
from ..models.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    # chunk=256: measured optimum of the SSD traffic trade-off (intra-chunk
    # tensors grow with lc, inter-chunk states shrink as 1/lc) — §Perf C2:
    # 64->3.71s, 128->2.24s, 256->1.93s, 512->1.99s HBM term on train_4k
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
)
