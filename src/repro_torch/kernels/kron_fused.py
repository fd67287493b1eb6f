"""Compatibility shims: the fused FORWARD entry points (contribution C3).

The port of ``repro.kernels.kron_fused``, which holds no kernel of its own:
the fused chain is one ``multiply`` ``StageInstr`` on the emitter
(``emit.run_stage``: ``csrc/chain_fwd.cu`` on the card, ``chain_reference``
on the CPU).  The names are the reference's; ``backend`` replaces its
``interpret`` flag (``"auto"`` by the tensors' device, ``"cuda"`` or
``"torch"``).  New code should build a ``StageInstr``/``StageProgram`` and
call the emitter.
"""
from __future__ import annotations

import torch

from . import emit
from .emit import SMEM_BUDGET_ELEMS, fused_growth, max_n_fused  # noqa: F401


def _instr(kind: str, factors, acc_dtype: torch.dtype | None, **tiles) -> emit.StageInstr:
    """The shims' one instruction: (P_i, Q_i) are the factors' last two dims
    (2-D, or per-sample 3-D under ``t_b``)."""
    return emit.StageInstr(
        kind=kind,
        ps=tuple(int(f.shape[-2]) for f in factors),
        qs=tuple(int(f.shape[-1]) for f in factors),
        acc_dtype=None if acc_dtype is None else str(acc_dtype).replace("torch.", ""),
        **tiles,
    )


def fused_kron_pallas(
    x: torch.Tensor,
    *factors_last_first: torch.Tensor,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    backend: str = "auto",
    acc_dtype: torch.dtype | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """Apply ``n`` sliced multiplies in one kernel (shim over ``emit``).

    ``factors_last_first[0]`` is applied first (i.e. it is F^N).  Returns the
    (M, K * prod(Q)/prod(P)) intermediate after all given factors.
    """
    instr = _instr(emit.MULTIPLY, factors_last_first, acc_dtype, t_m=t_m, t_k=t_k, t_qs=t_qs)
    return emit.run_stage(
        x, factors_last_first, instr, backend=backend, vmem_budget_elems=vmem_budget_elems,
    )


def fused_kron_batched_pallas(
    x: torch.Tensor,
    *factors_last_first: torch.Tensor,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    backend: str = "auto",
    acc_dtype: torch.dtype | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """Batched fused chain (shim over ``emit``): ``x (B, M, K)``, factors
    ``(B, P_i, Q_i)`` per sample, ``t_b`` samples per block budget."""
    instr = _instr(
        emit.MULTIPLY, factors_last_first, acc_dtype, t_m=t_m, t_k=t_k, t_qs=t_qs, t_b=t_b
    )
    return emit.run_stage(
        x, factors_last_first, instr, backend=backend, vmem_budget_elems=vmem_budget_elems,
    )


__all__ = ["fused_kron_pallas", "fused_kron_batched_pallas", "fused_growth", "max_n_fused"]
