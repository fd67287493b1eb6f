"""Error taxonomy of the Kron-Matmul execution spine.

The same names and bases as ``repro.runtime.guard``, so ``except`` clauses
written against the JAX package carry over.  "VMEM" in ``VmemOverflowError``
means the on-chip budget of one block: shared memory on the card.  The
degradation ladder, health state and ``check_finite`` come with the runtime
slice (ROADMAP queue 1, item 9).
"""
from __future__ import annotations


class KronError(Exception):
    """Base of every typed Kron-Matmul runtime error."""


class PlanError(KronError, ValueError):
    """Planning failed: invalid plan inputs or an unknown tune mode."""


class VmemOverflowError(KronError, ValueError):
    """A kernel tile's live set exceeds the on-chip budget of one block."""


class LoweringError(KronError, ValueError):
    """A stage cannot be lowered to the kernel: illegal tiling, non-dividing
    dims, an unsupported dtype, or a malformed instruction."""


__all__ = ["KronError", "PlanError", "VmemOverflowError", "LoweringError"]
