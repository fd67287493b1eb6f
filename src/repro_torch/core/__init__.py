"""Core: FastKron Kron-Matmul in PyTorch.

The execution surface is the handle-based ``KronOp`` (``core.engine``).
"""
from .autotune import KronPlan, Stage, TileConfig, lower, make_plan  # noqa: F401
from .engine import KronCost, KronOp  # noqa: F401
from .kron import (  # noqa: F401
    KronProblem,
    kron_matmul_fastkron,
    kron_matmul_ftmmt,
    kron_matmul_naive,
    kron_matmul_shuffle,
    kron_matrix,
    pair_factors,
    sliced_multiply,
)

__all__ = [
    "KronOp",
    "KronCost",
    "KronPlan",
    "Stage",
    "TileConfig",
    "make_plan",
    "lower",
    "KronProblem",
    "kron_matrix",
    "kron_matmul_naive",
    "kron_matmul_shuffle",
    "kron_matmul_ftmmt",
    "kron_matmul_fastkron",
    "sliced_multiply",
    "pair_factors",
]
