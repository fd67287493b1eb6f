"""Model zoo of the port: the configuration classes, and the layers the
port has so far (``models.ffn``: the gated FFN with its Kron-compressed
variant; ``models.common``: norms, RoPE, initializers, activations).
The layer stacks of the reference's ``models.model`` come with a later
slice."""
from .config import LayerSpec, MambaConfig, ModelConfig, MoEConfig  # noqa: F401
