"""Compatibility shims: the fused TRANSPOSED / BACKWARD entry points.

The port of ``repro.kernels.kron_fused_t``, which holds no kernel of its
own: the transposed chain is one ``transposed_multiply`` ``StageInstr`` on
the emitter (``csrc/chain_bwd.cu`` on the card) and the stage backward is
``emit.run_stage_grad`` (``csrc/grad.cu``).  The names are the reference's;
``backend`` replaces its ``interpret`` flag.  New code should build a
``StageInstr``/``StageProgram`` and call the emitter.
"""
from __future__ import annotations

import torch

from . import emit
from .emit import SMEM_BUDGET_ELEMS, transposed_growth  # noqa: F401
from .kron_fused import _instr


def fused_kron_t_pallas(
    dy: torch.Tensor,
    *factors_last_first: torch.Tensor,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    backend: str = "auto",
    acc_dtype: torch.dtype | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """dX for a fused chain (shim over ``emit``): dy (M, prod(Q)*S) -> (M, K).

    ``factors_last_first`` is the SAME list the forward kernel was given
    (f[0] applied first); the transposes apply in reverse.
    """
    instr = _instr(
        emit.TRANSPOSED_MULTIPLY, factors_last_first, acc_dtype, t_m=t_m, t_k=t_k, t_qs=t_qs
    )
    return emit.run_stage(
        dy, factors_last_first, instr, backend=backend, vmem_budget_elems=vmem_budget_elems,
    )


def fused_kron_t_batched_pallas(
    dy: torch.Tensor,
    *factors_last_first: torch.Tensor,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
    backend: str = "auto",
    acc_dtype: torch.dtype | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> torch.Tensor:
    """Batched transposed fused chain (shim over ``emit``):
    dy (B, M, prod(Q)*S) -> dx (B, M, K), per-sample (B, P_i, Q_i) factors."""
    instr = _instr(
        emit.TRANSPOSED_MULTIPLY, factors_last_first, acc_dtype,
        t_m=t_m, t_k=t_k, t_qs=t_qs, t_b=t_b,
    )
    return emit.run_stage(
        dy, factors_last_first, instr, backend=backend, vmem_budget_elems=vmem_budget_elems,
    )


def fused_kron_bwd_pallas(
    x: torch.Tensor,
    dy: torch.Tensor,
    *factors_last_first: torch.Tensor,
    t_m: int = 8,
    t_k: int | None = None,
    backend: str = "auto",
    acc_dtype: torch.dtype | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Full backward of one fused stage (shim over ``emit.run_stage_grad``).

    x: (M, K) stage input; dy: (M, prod(Q)*S) stage output cotangent.
    Returns (dx, dfs) with dfs in ``factors_last_first`` order, in the
    stage's accumulator dtype.
    """
    instr = _instr(emit.MULTIPLY, factors_last_first, acc_dtype, t_m=t_m, t_k=t_k)
    return emit.run_stage_grad(
        x, dy, factors_last_first, instr, backend=backend,
        vmem_budget_elems=vmem_budget_elems,
    )


def fused_kron_bwd_batched_pallas(
    x: torch.Tensor,
    dy: torch.Tensor,
    *factors_last_first: torch.Tensor,
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    backend: str = "auto",
    acc_dtype: torch.dtype | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Batched full stage backward (shim over ``emit.run_stage_grad``):
    per-sample (dx (B, M, K), dfs each (B, P_i, Q_i) in
    ``factors_last_first`` order)."""
    instr = _instr(emit.MULTIPLY, factors_last_first, acc_dtype, t_m=t_m, t_k=t_k, t_b=t_b)
    return emit.run_stage_grad(
        x, dy, factors_last_first, instr, backend=backend,
        vmem_budget_elems=vmem_budget_elems,
    )


__all__ = [
    "fused_kron_t_pallas",
    "fused_kron_bwd_pallas",
    "fused_kron_t_batched_pallas",
    "fused_kron_bwd_batched_pallas",
    "transposed_growth",
]
