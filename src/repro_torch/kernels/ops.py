"""Backend dispatch for the per-factor sliced multiply and its transpose.

The port of ``repro.kernels.ops.sliced_multiply`` / ``sliced_multiply_t``.  ``backend`` is ``"auto"``
(by the tensor's device), ``"cuda"`` (the kernel, CUDA tensors only) or
``"torch"`` (the plain twin, CPU tensors only); see
``emit.resolve_backend``.
"""
from __future__ import annotations

import torch

from . import kron_sliced, kron_sliced_t
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


def sliced_multiply_t(
    dy: torch.Tensor,
    f: torch.Tensor,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Transposed sliced multiply (C1 backward): (M, Q*S) x (P, Q) -> (M, S*P)."""
    if f.device != dy.device:
        raise ValueError(f"dy on {dy.device} but the factor on {f.device}")
    if resolve_backend(backend, dy) == "torch":
        return kron_sliced_t.sliced_multiply_t_reference(dy, f)
    return kron_sliced_t.sliced_multiply_t_cuda(dy.contiguous(), f.contiguous())


__all__ = ["sliced_multiply", "sliced_multiply_t"]
