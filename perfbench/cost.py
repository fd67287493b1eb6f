"""The yardstick's arithmetic: operations, bytes, peaks and rooflines.

Frozen with the benchmark.  Every count here comes from a problem's shapes
alone, never from the plan the program chooses, so that two programs that
do the same work are held to the same roof.

* FLOPs are the sliced-multiply count of the paper (§3): applying factor
  ``F^i`` (P_i x Q_i) to an (M, K_i) intermediate costs ``2 M (K_i / P_i)
  P_i Q_i``, factors applied last first.  A training step adds the input
  gradient (the same chain over the transposed factors) and every factor
  gradient, whose contraction costs what that factor's forward multiply
  costs.  A GP epoch counts its MVMs.
* Bytes count each input byte read once and each output byte written once.
* Peaks are the published dense rates of one H100 SXM at 700 W: the tensor
  cores' rate for the input dtype (TF32 for float32, the highest rate at
  which the card multiplies float32 inputs, so a kernel that splits float32
  into TF32 parts cannot read above 100%) and the HBM bandwidth.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
PEAK_FLOPS = {
    "float32": 495e12,  # TF32 tensor cores
    "bfloat16": 989e12,
    "float16": 989e12,
}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


@dataclass(frozen=True)
class Cost:
    """The work one step needs: FLOPs and HBM bytes, in the step's dtype."""

    flops: int
    bytes: int
    dtype: str

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS[self.dtype]

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def roofline_s(self) -> float:
        """The least time the card could take: the larger of the two terms."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


def sliced_multiply_flops(m: int, ps: Sequence[int], qs: Sequence[int]) -> list[int]:
    """FLOPs of each factor's sliced multiply, in problem order (factor 1
    first), for ``x (M, prod P) @ (F^1 (x) ... (x) F^N)`` applied last
    factor first."""
    per = [0] * len(ps)
    k = math.prod(ps)
    for i in reversed(range(len(ps))):
        s = k // ps[i]
        per[i] = 2 * m * s * ps[i] * qs[i]
        k = s * qs[i]
    return per


def forward_flops(m: int, ps: Sequence[int], qs: Sequence[int]) -> int:
    return sum(sliced_multiply_flops(m, ps, qs))


def kron_forward(m: int, ps: Sequence[int], qs: Sequence[int], dtype: str) -> Cost:
    """``Y = X (F^1 (x) ... (x) F^N)``: read X and the factors, write Y."""
    size = ITEMSIZE[dtype]
    elems = m * math.prod(ps) + m * math.prod(qs) + sum(p * q for p, q in zip(ps, qs))
    return Cost(forward_flops(m, ps, qs), elems * size, dtype)


def kron_train_step(m: int, ps: Sequence[int], qs: Sequence[int], dtype: str) -> Cost:
    """Forward, then dX and every dF from a cotangent G: read X, G and the
    factors; write Y, dX and every dF."""
    size = ITEMSIZE[dtype]
    factor_elems = sum(p * q for p, q in zip(ps, qs))
    k, k_out = math.prod(ps), math.prod(qs)
    flops = (forward_flops(m, ps, qs)          # Y
             + forward_flops(m, qs, ps)        # dX through the transposed factors
             + forward_flops(m, ps, qs))       # dF: each as its forward multiply
    elems = 2 * m * k + 2 * m * k_out + 2 * factor_elems
    return Cost(flops, elems * size, dtype)


def gp_epoch(m: int, ps: Sequence[int], cg_iters: int, dtype: str) -> Cost:
    """A CG epoch on ``(K + noise I) X = V`` with ``K`` the Kronecker
    product of square factors: ``cg_iters + 1`` MVMs (the first on the zero
    start); read V and the factors, write X and the residual norm of each
    row."""
    size = ITEMSIZE[dtype]
    k = math.prod(ps)
    flops = (cg_iters + 1) * forward_flops(m, ps, ps)
    elems = 2 * m * k + sum(p * p for p in ps) + m
    return Cost(flops, elems * size, dtype)


__all__ = [
    "PEAK_FLOPS", "HBM_BYTES_PER_S", "ITEMSIZE", "Cost", "sliced_multiply_flops",
    "forward_flops", "kron_forward", "kron_train_step", "gp_epoch",
]
