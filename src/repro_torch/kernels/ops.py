"""Backend dispatch for the per-factor sliced multiply, and the deprecated
fused-chain shims.

The port of ``repro.kernels.ops``.  ``sliced_multiply`` /
``sliced_multiply_t`` dispatch the per-factor kernels (``csrc/sliced.cu``,
``csrc/sliced_t.cu``) that the unfused baseline and the ladder's per-factor
rung use.  ``backend`` is ``"auto"`` (by the tensor's device), ``"cuda"``
(the kernel, CUDA tensors only) or ``"torch"`` (the plain twin, either
device); see ``emit.resolve_backend``.

The six ``fused_kron*`` wrappers are DEPRECATED compatibility shims over
``kron_fused`` / ``kron_fused_t`` (one ``StageInstr`` on the emitter each),
warning once per process.  The engine never enters them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..runtime import guard
from . import kron_fused, kron_fused_t, kron_sliced, kron_sliced_t
from . import ref as _ref
from .emit import acc_dtype_for, resolve_backend


def sliced_multiply(
    x: torch.Tensor,
    f: torch.Tensor,
    *,
    backend: str = "auto",
    tiles: tuple[int, int | None, int | None] | None = None,
) -> torch.Tensor:
    """One FastKron sliced multiply: (M, K) x (P, Q) -> (M, K//P*Q).

    ``tiles=(t_m, t_s, t_q)``, as the reference takes it, bounds the
    kernel's block tile (``kron_sliced.sliced_tiles(limit=)``); a tile that
    does not divide its dim raises ``LoweringError`` (a ``ValueError``) on
    either backend."""
    if f.device != x.device:
        raise ValueError(f"x on {x.device} but the factor on {f.device}")
    if resolve_backend(backend, x) == "cuda":
        return kron_sliced.sliced_multiply_cuda(x.contiguous(), f.contiguous(), tiles=tiles)
    if tiles is not None:
        p, q = (int(d) for d in f.shape)
        kron_sliced.check_tiles(int(x.shape[0]), int(x.shape[1]) // p, q, tiles)
    return kron_sliced.sliced_multiply_reference(x, f)


def sliced_multiply_t(
    dy: torch.Tensor,
    f: torch.Tensor,
    *,
    backend: str = "auto",
    tiles: tuple[int, int | None, int | None] | None = None,
) -> torch.Tensor:
    """Transposed sliced multiply (C1 backward): (M, Q*S) x (P, Q) -> (M, S*P).
    ``tiles`` as in ``sliced_multiply``."""
    if f.device != dy.device:
        raise ValueError(f"dy on {dy.device} but the factor on {f.device}")
    if resolve_backend(backend, dy) == "cuda":
        return kron_sliced_t.sliced_multiply_t_cuda(dy.contiguous(), f.contiguous(), tiles=tiles)
    if tiles is not None:
        q = int(f.shape[1])
        kron_sliced.check_tiles(int(dy.shape[0]), int(dy.shape[1]) // q, q, tiles)
    return kron_sliced_t.sliced_multiply_t_reference(dy, f)


# ---------------------------------------------------------------------------
# DEPRECATED fused-chain shims (one StageInstr each, executed by the emitter)
# ---------------------------------------------------------------------------

def warn_shim(name: str) -> None:
    """Emit ONE DeprecationWarning per process per legacy fused_kron* shim."""
    guard.warn_deprecated_once(
        name,
        f"kernels.ops.{name} is deprecated: build a StageInstr/StageProgram "
        "and call kernels.emit (run_stage / run_stage_grad); the engine's "
        "planned paths do this automatically.",
    )


def fused_kron(
    x: torch.Tensor,
    factors_last_first: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """DEPRECATED shim: chain of sliced multiplies in one kernel (C3).

    ``factors_last_first[0] == F^N``.  Equivalent to ``emit.run_stage`` on a
    ``multiply`` instruction (``kron_fused.fused_kron_pallas``).
    """
    warn_shim("fused_kron")
    return kron_fused.fused_kron_pallas(
        x, *factors_last_first, t_m=t_m, t_k=t_k, t_qs=t_qs, backend=backend
    )


def fused_kron_t(
    dy: torch.Tensor,
    factors_last_first: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """DEPRECATED shim: transposed fused chain (input cotangent of
    ``fused_kron``); a ``transposed_multiply`` instruction on the emitter.
    Takes the SAME factor list as the forward call."""
    warn_shim("fused_kron_t")
    return kron_fused_t.fused_kron_t_pallas(
        dy, *factors_last_first, t_m=t_m, t_k=t_k, t_qs=t_qs, backend=backend
    )


def fused_kron_bwd(
    x: torch.Tensor,
    dy: torch.Tensor,
    factors_last_first: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    t_m: int = 8,
    t_k: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """DEPRECATED shim: full backward of one fused stage (dx, factor grads)
    via ``emit.run_stage_grad``; factor grads in ``factors_last_first``
    order, in the accumulator dtype (callers cast)."""
    warn_shim("fused_kron_bwd")
    return kron_fused_t.fused_kron_bwd_pallas(
        x, dy, *factors_last_first, t_m=t_m, t_k=t_k, backend=backend
    )


def fused_kron_batched(
    x: torch.Tensor,
    factors_last_first: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """DEPRECATED shim: batched fused chain — x (B, M, K), per-sample factors
    (B, P_i, Q_i) — via a batched ``multiply`` instruction."""
    warn_shim("fused_kron_batched")
    return kron_fused.fused_kron_batched_pallas(
        x, *factors_last_first, t_b=t_b, t_m=t_m, t_k=t_k, t_qs=t_qs, backend=backend
    )


def fused_kron_t_batched(
    dy: torch.Tensor,
    factors_last_first: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
    t_qs: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """DEPRECATED shim: batched transposed fused chain (input cotangent of
    ``fused_kron_batched``)."""
    warn_shim("fused_kron_t_batched")
    return kron_fused_t.fused_kron_t_batched_pallas(
        dy, *factors_last_first, t_b=t_b, t_m=t_m, t_k=t_k, t_qs=t_qs, backend=backend
    )


def fused_kron_bwd_batched(
    x: torch.Tensor,
    dy: torch.Tensor,
    factors_last_first: Sequence[torch.Tensor],
    *,
    backend: str = "auto",
    t_b: int = 1,
    t_m: int = 8,
    t_k: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """DEPRECATED shim: batched full stage backward — per-sample (dx, factor
    grads each (B, P_i, Q_i)) — via ``emit.run_stage_grad``."""
    warn_shim("fused_kron_bwd_batched")
    return kron_fused_t.fused_kron_bwd_batched_pallas(
        x, dy, *factors_last_first, t_b=t_b, t_m=t_m, t_k=t_k, backend=backend
    )


# Re-export the oracles so tests can import one module.
sliced_multiply_ref = _ref.sliced_multiply_ref
fused_kron_ref = _ref.fused_kron_ref
sliced_multiply_t_ref = _ref.sliced_multiply_t_ref
fused_kron_t_ref = _ref.fused_kron_t_ref

__all__ = [
    "sliced_multiply",
    "sliced_multiply_t",
    "fused_kron",
    "fused_kron_t",
    "fused_kron_bwd",
    "fused_kron_batched",
    "fused_kron_t_batched",
    "fused_kron_bwd_batched",
    "warn_shim",
    "resolve_backend",
    "acc_dtype_for",
    "sliced_multiply_ref",
    "sliced_multiply_t_ref",
    "fused_kron_ref",
    "fused_kron_t_ref",
]
