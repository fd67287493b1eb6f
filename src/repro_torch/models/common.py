"""Shared model components: norms, RoPE, initializers, activations.

The port of ``repro.models.common``.  Initializers draw from a
``torch.Generator`` on the caller's device (None: the default generator,
as on the ``meta`` device, where only the shapes are made)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the variance reduced in f32, the tensor-wide math in the
    input dtype."""
    dt = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * (1.0 + scale).to(dt)


def dense_init(
    generator: torch.Generator | None, d_in: int, d_out: int, dtype: torch.dtype,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun), cut at two standard deviations."""
    w = torch.empty(d_in, d_out, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * d_in ** -0.5).to(dtype)


def embed_init(
    generator: torch.Generator | None, vocab: int, d: int, dtype: torch.dtype,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=generator, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rope_freqs(head_dim: int, theta: float, device: str | torch.device | None = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


__all__ = ["rms_norm", "dense_init", "embed_init", "apply_rope", "rope_freqs", "act_fn"]
