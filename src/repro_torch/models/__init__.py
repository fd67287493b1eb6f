"""Model zoo of the port: the configuration classes and the reference's
models: ``models.model`` (the stacked parameter tree, ``init_params``,
``forward`` with nested remat, ``prefill``, ``decode_step`` and the cache
helpers), ``models.attention`` (GQA with qk-norm and RoPE, the KV caches),
``models.moe`` (top-k routing with capacity buckets), ``models.ssm``
(Mamba2's chunked SSD and its recurrent decode), ``models.ffn`` (the gated
FFN and its Kron-compressed variant), ``models.common``."""
from .config import LayerSpec, MambaConfig, ModelConfig, MoEConfig  # noqa: F401
