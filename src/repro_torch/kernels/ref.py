"""Plain PyTorch oracles for the kernels.

Each function mirrors ``repro.kernels.ref``: the contraction runs in f32
whatever the input dtype, and the output is cast back to it.
"""
from __future__ import annotations

from typing import Sequence

import torch


def sliced_multiply_ref(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Y[m, q*S+s] = sum_p X[m, s*P+p] * F[p, q]  (paper Figure 2)."""
    m, k = x.shape
    p, q = f.shape
    s = k // p
    y = torch.einsum("msp,pq->mqs", x.reshape(m, s, p).float(), f.float())
    return y.reshape(m, q * s).to(x.dtype)


def fused_kron_ref(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Chain of sliced multiplies, applied last factor first (Algorithm 1)."""
    y = x
    for f in reversed(list(factors)):
        y = sliced_multiply_ref(y, f)
    return y


def sliced_multiply_t_ref(dy: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """dX[m, s*P+p] = sum_q dY[m, q*S+s] F[p, q]  (backward of C1)."""
    m, l = dy.shape
    p, q = f.shape
    s = l // q
    dx = torch.einsum("mqs,pq->msp", dy.reshape(m, q, s).float(), f.float())
    return dx.reshape(m, s * p).to(dy.dtype)


def fused_kron_t_ref(dy: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Transposed chain: un-applies ``factors`` (problem order, F^1 first) in
    reverse of the forward application order, i.e. F^1's transpose first."""
    g = dy
    for f in factors:
        g = sliced_multiply_t_ref(g, f)
    return g


__all__ = [
    "sliced_multiply_ref",
    "fused_kron_ref",
    "sliced_multiply_t_ref",
    "fused_kron_t_ref",
]
