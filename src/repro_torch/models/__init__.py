"""Model zoo of the port: the configuration classes and the training half
of the reference's models: ``models.model`` (the stacked parameter tree,
``init_params``, ``forward`` with nested remat), ``models.attention``
(GQA with qk-norm and RoPE), ``models.ffn`` (the gated FFN and its
Kron-compressed variant), ``models.common``.  MoE, Mamba and the serving
entry points come with the serving slice."""
from .config import LayerSpec, MambaConfig, ModelConfig, MoEConfig  # noqa: F401
