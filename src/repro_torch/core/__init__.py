"""Core: FastKron Kron-Matmul in PyTorch.

The execution surface is the handle-based ``KronOp`` (``core.engine``); the
functional ``kron_matmul*`` entry points remain as compatibility shims.
"""
from .autotune import (  # noqa: F401
    KronPlan,
    Stage,
    TileConfig,
    lower,
    make_batched_plan,
    make_plan,
)
from .engine import KronCost, KronOp, kron_op_for  # noqa: F401
from .fastkron import (  # noqa: F401
    kron_matmul,
    kron_matmul_batched,
    kron_matmul_unfused,
)
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
from .layers import (  # noqa: F401
    KronLinear,
    KronLinearSpec,
    balanced_factorization,
    kron_linear_apply,
    kron_linear_init,
    kron_linear_materialize,
)

__all__ = [
    # engine (the primary surface)
    "KronOp",
    "KronCost",
    "kron_op_for",
    # compatibility shims
    "kron_matmul",
    "kron_matmul_batched",
    "kron_matmul_unfused",
    # plans
    "KronPlan",
    "Stage",
    "TileConfig",
    "make_plan",
    "make_batched_plan",
    "lower",
    # problem description + reference algorithms
    "KronProblem",
    "kron_matrix",
    "kron_matmul_naive",
    "kron_matmul_shuffle",
    "kron_matmul_ftmmt",
    "kron_matmul_fastkron",
    "sliced_multiply",
    "pair_factors",
    # layers
    "KronLinearSpec",
    "KronLinear",
    "kron_linear_init",
    "kron_linear_apply",
    "kron_linear_materialize",
    "balanced_factorization",
]
