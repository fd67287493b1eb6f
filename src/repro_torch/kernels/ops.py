"""Backend dispatch for the per-factor sliced multiply.

The port of ``repro.kernels.ops.sliced_multiply``.  ``backend`` is ``"auto"``
(by the tensor's device), ``"cuda"`` (the kernel, CUDA tensors only) or
``"torch"`` (the plain twin, CPU tensors only); see
``emit.resolve_backend``.
"""
from __future__ import annotations

import torch

from . import kron_sliced
from .emit import resolve_backend


def sliced_multiply(
    x: torch.Tensor,
    f: torch.Tensor,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """One FastKron sliced multiply: (M, K) x (P, Q) -> (M, K//P*Q)."""
    if f.device != x.device:
        raise ValueError(f"x on {x.device} but the factor on {f.device}")
    if resolve_backend(backend, x) == "torch":
        return kron_sliced.sliced_multiply_reference(x, f)
    return kron_sliced.sliced_multiply_cuda(x.contiguous(), f.contiguous())


__all__ = ["sliced_multiply"]
