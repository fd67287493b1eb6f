"""Gated FFN (SwiGLU / GeGLU) and its Kron-compressed variant.

The port of ``repro.models.ffn``.  ``kron_ffn`` swaps the three dense
projections for KronLinear factors, the paper's ML-compression use
(Table 4 rows 6-8): parameters drop from ``3*d*f`` to ``3*sum(P_i*Q_i)``
and every projection becomes a FastKron Kron-Matmul through the chain
kernels.  The dense branch is ``torch.matmul``, as the reference computes
it outside any Pallas kernel.

On a mesh (``sharding.use_mesh``) the dense branch runs tensor-parallel
where the caller says so (``tp``: ``w1``/``w3`` are this rank's columns of
``d_ff`` and ``w2`` its rows): the down projection's partial sums are
added over the model axis.
The Kron factors are replicated, so each rank runs the whole Kron FFN on
its own rows.
"""
from __future__ import annotations

import torch

from ..core.layers import KronLinearSpec, kron_linear_apply, kron_linear_init
from ..runtime import telemetry
from ..runtime.sharding import reduce_tp, tp_partial_grad
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


def ffn_apply(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, backend: str = "auto",
    tp: bool = False,
) -> torch.Tensor:
    """The block on ``x: (..., d_model)``, in a ``ffn`` span; ``backend``
    reaches the KronLinears' ops (``"torch"``: the kernels' plain twins).
    ``tp``: the dense projections are this rank's slice of ``d_ff``."""
    act = act_fn(cfg.ffn_act)
    with telemetry.span("ffn"):
        if cfg.kron_ffn:
            h = act(kron_linear_apply(p["w1"], x, backend=backend)) * kron_linear_apply(
                p["w3"], x, backend=backend)
            return kron_linear_apply(p["w2"], h, backend=backend)
        if tp:
            xf = tp_partial_grad(x)
            return reduce_tp((act(xf @ p["w1"]) * (xf @ p["w3"])) @ p["w2"])
        h = act(x @ p["w1"]) * (x @ p["w3"])
        return h @ p["w2"]


__all__ = ["ffn_init", "ffn_apply"]
