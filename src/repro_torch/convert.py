"""Carrying state across from the JAX package.

FastKron has no weights: what the two packages share is the factors and the
plan.  ``factors_from_numpy`` puts numpy factors (for example the ones a JAX
program used, via ``np.asarray``) on a device; ``plan_from_jax_json`` reads
the dict that ``repro.core.autotune.plan_to_json`` writes into the port's
``KronPlan``.  Neither imports the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.autotune import KronPlan, plan_from_json


def _device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available here; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev


def factors_from_numpy(
    arrays: Sequence[np.ndarray],
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, ...]:
    """Factor arrays (problem order) as tensors on ``device``, in ``dtype``
    (None keeps each array's own dtype)."""
    dev = _device(device)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)
        for a in arrays
    )


def plan_from_jax_json(d: dict) -> KronPlan:
    """The port's ``KronPlan`` for a dict from
    ``repro.core.autotune.plan_to_json``."""
    return plan_from_json(d)


__all__ = ["factors_from_numpy", "plan_from_jax_json"]
