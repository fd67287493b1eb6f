"""Core Kron-Matmul algorithms, in plain PyTorch.

The port of ``repro.core.kron``:
  * a naive oracle (materialize the Kronecker matrix),
  * the shuffle algorithm  [Davio'81; GPyTorch/PyKronecker baseline],
  * the FTMMT-style fused contraction baseline,
  * FastKron's sliced-multiply algorithm (paper §3, contribution C1).

These are the reference algorithms and the test oracles; the op that users
call is ``core.engine.KronOp``, which runs the kernels.  Shapes follow the
paper: ``X: (M, prod_i P_i)``, ``F^i: (P_i, Q_i)``, ``Y: (M, prod_i Q_i)`` and
the product applied is ``Y = X @ (F^1 ⊗ F^2 ⊗ ... ⊗ F^N)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch


# ---------------------------------------------------------------------------
# Problem description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KronProblem:
    """Static description of a Kron-Matmul problem."""

    m: int
    ps: tuple[int, ...]  # (P_1, ..., P_N) row dims of factors
    qs: tuple[int, ...]  # (Q_1, ..., Q_N) col dims of factors

    @property
    def n(self) -> int:
        return len(self.ps)

    @property
    def k(self) -> int:
        return math.prod(self.ps)

    @property
    def k_out(self) -> int:
        return math.prod(self.qs)

    @property
    def flops(self) -> int:
        """MAC*2 FLOPs of the sliced-multiply algorithm (paper §3).

        Iteration i multiplies an (M, K_i) intermediate by F^i (P_i, Q_i):
        output elems M*K_i*Q_i/P_i each needing P_i MACs.
        """
        total = 0
        k = self.k
        for p, q in zip(reversed(self.ps), reversed(self.qs)):
            out_cols = (k // p) * q
            total += 2 * self.m * out_cols * p
            k = out_cols
        return total

    @property
    def intermediate_elems(self) -> int:
        """Max #elements of any intermediate (paper line 3 of Algorithm 1)."""
        best = self.k
        k = self.k
        for p, q in zip(reversed(self.ps), reversed(self.qs)):
            k = (k // p) * q
            best = max(best, k)
        return best

    @classmethod
    def uniform(cls, m: int, p: int, q: int, n: int) -> "KronProblem":
        return cls(m, (p,) * n, (q,) * n)


def _check(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> KronProblem:
    ps = tuple(int(f.shape[0]) for f in factors)
    qs = tuple(int(f.shape[1]) for f in factors)
    prob = KronProblem(int(x.shape[0]), ps, qs)
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if x.shape[1] != prob.k:
        raise ValueError(f"x cols {x.shape[1]} != prod(P_i) {prob.k} for {ps}")
    return prob


# ---------------------------------------------------------------------------
# Naive oracle
# ---------------------------------------------------------------------------


def kron_matrix(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Materialize F^1 ⊗ ... ⊗ F^N (test oracle only; O(prod P * prod Q))."""
    g = factors[0]
    for f in factors[1:]:
        g = torch.kron(g, f)
    return g


def kron_matmul_naive(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Oracle: X @ (F^1 ⊗ ... ⊗ F^N) by materializing the Kronecker matrix."""
    _check(x, factors)
    return x @ kron_matrix(factors)


# ---------------------------------------------------------------------------
# Shuffle algorithm (the GPyTorch/PyKronecker baseline)
# ---------------------------------------------------------------------------


def shuffle_iteration(y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """One shuffle-algorithm iteration: reshape -> matmul -> transpose -> reshape.

    This is the paper's Figure 1 (steps a-c).  The transpose materializes a
    shuffled intermediate — the expensive step FastKron removes.
    """
    m, k = y.shape
    p, q = f.shape
    s = k // p
    t = y.reshape(m * s, p) @ f          # (a) reshape + GEMM
    t = t.reshape(m, s, q)
    t = t.transpose(1, 2)                # (b) transpose inner dims
    return t.reshape(m, q * s)           # (c) reshape


def shuffle_transpose_only(t: torch.Tensor, m: int, s: int, q: int) -> torch.Tensor:
    """The isolated transpose step (for the Table-1 cost-breakdown benchmark)."""
    return t.reshape(m, s, q).transpose(1, 2).reshape(m, q * s)


def kron_matmul_shuffle(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Full shuffle algorithm, iterating factors from last to first."""
    _check(x, factors)
    y = x
    for f in reversed(factors):
        y = shuffle_iteration(y, f)
    return y


# ---------------------------------------------------------------------------
# FTMMT-style baseline (transpose fused into a tensor contraction)
# ---------------------------------------------------------------------------


def kron_matmul_ftmmt(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """FTMMT algorithm: represent the intermediate as a 3-D tensor and contract.

    ``einsum('msp,pq->mqs')`` fuses transpose+multiply like COGENT/cuTensor —
    but each intermediate still round-trips through global memory every
    iteration.
    """
    _check(x, factors)
    m = x.shape[0]
    y = x
    for f in reversed(factors):
        p, q = f.shape
        s = y.shape[1] // p
        y = torch.einsum("msp,pq->mqs", y.reshape(m, s, p), f).reshape(m, q * s)
    return y


# ---------------------------------------------------------------------------
# FastKron sliced-multiply algorithm (contribution C1)
# ---------------------------------------------------------------------------


def sliced_multiply(y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """One FastKron iteration: Y'[m, q*S + s] = sum_p Y[m, s*P+p] * F[p, q].

    Output elements land at their final indices (paper Figure 2).  This is
    the plain oracle; the kernel is ``kernels/csrc/sliced.cu``.
    """
    m, k = y.shape
    p, q = f.shape
    s = k // p
    return torch.einsum("msp,pq->mqs", y.reshape(m, s, p), f).reshape(m, q * s)


def kron_matmul_fastkron(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """FastKron Algorithm 1 (plain PyTorch)."""
    _check(x, factors)
    y = x
    for f in reversed(factors):
        y = sliced_multiply(y, f)
    return y


# ---------------------------------------------------------------------------
# Beyond-paper: factor pre-kronization for small P
# ---------------------------------------------------------------------------


def pair_factors(
    factors: Sequence[torch.Tensor], max_p: int = 16, max_pair_dim: int = 256
) -> list[torch.Tensor]:
    """Fuse adjacent small factors into their explicit Kronecker product.

    Multiplying by (F^i ⊗ F^{i+1}) (contraction dim P^2) costs ~Q/2 x more
    FLOPs but deepens the contraction and halves the passes over memory.
    Adjacency matters: (A ⊗ B) ⊗ C == A ⊗ (B ⊗ C), so pairing preserves the
    product.
    """
    out: list[torch.Tensor] = []
    i = 0
    fs = list(factors)
    while i < len(fs):
        f = fs[i]
        if (
            i + 1 < len(fs)
            and f.shape[0] <= max_p
            and fs[i + 1].shape[0] <= max_p
            and f.shape[0] * fs[i + 1].shape[0] <= max_pair_dim
            and f.shape[1] * fs[i + 1].shape[1] <= max_pair_dim
        ):
            out.append(torch.kron(f, fs[i + 1]))
            i += 2
        else:
            out.append(f)
            i += 1
    return out


__all__ = [
    "KronProblem",
    "kron_matrix",
    "kron_matmul_naive",
    "kron_matmul_shuffle",
    "kron_matmul_ftmmt",
    "kron_matmul_fastkron",
    "sliced_multiply",
    "shuffle_iteration",
    "shuffle_transpose_only",
    "pair_factors",
]
