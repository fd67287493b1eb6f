"""Gated FFN (SwiGLU / GeGLU) and its Kron-compressed variant.

The port of ``repro.models.ffn``.  ``kron_ffn`` swaps the three dense
projections for KronLinear factors, the paper's ML-compression use
(Table 4 rows 6-8): parameters drop from ``3*d*f`` to ``3*sum(P_i*Q_i)``
and every projection becomes a FastKron Kron-Matmul through the chain
kernels.  The dense branch is ``torch.matmul``, as the reference computes
it outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..core.layers import KronLinearSpec, kron_linear_apply, kron_linear_init
from .common import act_fn, dense_init
from .config import ModelConfig


def ffn_init(
    generator: torch.Generator | None, cfg: ModelConfig, dtype: torch.dtype,
    d_ff: int | None = None, *, device: str | torch.device = "cuda",
) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.kron_ffn:
        up = KronLinearSpec.balanced(d, f, cfg.kron_factors)
        down = KronLinearSpec.balanced(f, d, cfg.kron_factors)
        return {
            "w1": kron_linear_init(generator, up, dtype, device),
            "w3": kron_linear_init(generator, up, dtype, device),
            "w2": kron_linear_init(generator, down, dtype, device),
        }
    return {
        "w1": dense_init(generator, d, f, dtype, device),
        "w3": dense_init(generator, d, f, dtype, device),
        "w2": dense_init(generator, f, d, dtype, device),
    }


def ffn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """The block on ``x: (..., d_model)``; ``backend`` reaches the
    KronLinears' ops (``"torch"``: the kernels' plain twins)."""
    act = act_fn(cfg.ffn_act)
    if cfg.kron_ffn:
        h = act(kron_linear_apply(p["w1"], x, backend=backend)) * kron_linear_apply(
            p["w3"], x, backend=backend)
        return kron_linear_apply(p["w2"], h, backend=backend)
    h = act(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


__all__ = ["ffn_init", "ffn_apply"]
