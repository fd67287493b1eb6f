"""Compatibility shims: the legacy functional Kron-Matmul entry points.

The port of ``repro.core.fastkron``.  The engine is the handle-based
``KronOp`` (resolve the plan once, call many times); ``kron_matmul``,
``kron_matmul_unfused`` and ``kron_matmul_batched`` look an op up in the
bounded ``engine.kron_op_for`` cache and call it.  Each shim emits a single
``DeprecationWarning`` per process pointing at ``KronOp``:

    from repro_torch.core import KronOp
    op = KronOp(ps, qs)                  # plan resolved here
    y = op(x, factors)                   # planned forward + planned backward

Numerics, gradients and the batched factor-sharing modes are exactly the
op's: the shims add nothing but the cache lookup.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import engine
from .autotune import KronPlan, Stage, TileConfig  # noqa: F401  (re-export)
from .engine import KronOp, kron_op_for, signature_of


def kron_matmul(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    plan: KronPlan | str | None = "auto",
    tune: str = "analytic",
    cache_path: str | None = None,
) -> torch.Tensor:
    """``x @ (F^1 (x) ... (x) F^N)`` for ``x: (..., prod P_i)``.

    DEPRECATED shim over ``KronOp(ps, qs, backend=..., plan=...)``.
    ``plan``: ``"auto"`` plans with ``autotune.make_plan``; ``None`` runs the
    paper-faithful unfused per-factor path; or an explicit KronPlan.
    ``tune="measure"`` and ``cache_path`` raise ``NotImplementedError``
    until the port has the measured planner.
    """
    engine.warn_deprecated("kron_matmul", "KronOp(ps, qs)")
    factors = tuple(factors)
    ps, qs = signature_of(factors, shared_factors=True)
    op = kron_op_for(ps, qs, backend=backend, plan=plan, tune=tune, cache_path=cache_path)
    return op(x, factors)


def kron_matmul_unfused(
    x: torch.Tensor, factors: Sequence[torch.Tensor], *, backend: str = "auto"
) -> torch.Tensor:
    """Paper-faithful Algorithm 1 without fusion/pairing (the C1 baseline)."""
    return kron_matmul(x, factors, backend=backend, plan=None)


def kron_matmul_batched(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    shared_factors: bool,
    backend: str = "auto",
    plan: KronPlan | str | None = "auto",
    tune: str = "analytic",
    cache_path: str | None = None,
) -> torch.Tensor:
    """``B`` independent Kron-Matmuls in one call: ``x: (B, ..., prod P_i)``.

    DEPRECATED shim over ``KronOp(ps, qs, batch=B, shared_factors=...)``.
    ``shared_factors=True``: one factor set ``F^i: (P_i, Q_i)`` for every
    sample (the batch folds into M).  ``shared_factors=False``: per-sample
    factors ``F^i: (B, P_i, Q_i)`` under a per-sample plan; their gradients
    have shape ``(B, P_i, Q_i)``.
    """
    engine.warn_deprecated(
        "kron_matmul_batched", "KronOp(ps, qs, batch=B, shared_factors=...)"
    )
    factors = tuple(factors)
    if x.ndim < 2:
        raise ValueError(f"x needs a leading batch axis: (B, ..., K), got {tuple(x.shape)}")
    ps, qs = signature_of(factors, shared_factors=shared_factors)
    op = kron_op_for(
        ps, qs, batch=int(x.shape[0]), shared_factors=shared_factors,
        backend=backend, plan=plan, tune=tune, cache_path=cache_path,
    )
    return op(x, factors)


__all__ = [
    "kron_matmul",
    "kron_matmul_unfused",
    "kron_matmul_batched",
    "KronOp",
    "KronPlan",
    "Stage",
    "TileConfig",
]
