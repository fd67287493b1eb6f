"""The TRANSPOSED FastKron sliced multiply on the card: the backward of one
sliced multiply with respect to its input.

Semantics: for ``dY: (M, Q*S)`` and ``F: (P, Q)`` compute

    dX[m, s*P + p] = sum_q dY[m, q*S + s] * F[p, q]

``sliced_multiply_t_cuda`` launches ``csrc/sliced_t.cu`` on a persistent
grid (as many blocks as the card holds, from the kernel's occupancy query):
each block walks ``(t_m, t_s)`` tiles, brings the ``(t_m, t_q, t_s)`` boxes
of the ``(M, Q, S)`` view of dY in through an asynchronous-copy ring,
contracts them against the transposed ``(t_q, P)`` panel of F, sums the
Q-tiles in f32 (f64 for f64) in registers, and writes the contiguous
``(t_m, t_s*P)`` block of dX.  ``sliced_multiply_t_reference`` is its plain
twin.  The Pallas kernel it replaces sums Q-tiles in dY's dtype; at its
default ``t_q = Q`` there is one tile, so the two agree to within one
rounding.
"""
from __future__ import annotations

import torch

from ..runtime.guard import LoweringError
from . import _launch
from .emit import acc_dtype_for, chain_flops, sliced_apply_t
from .kron_sliced import check_tiles, sliced_tiles


def _dims(dy: torch.Tensor, f: torch.Tensor) -> tuple[int, int, int, int]:
    m, l_cols = (int(d) for d in dy.shape)
    p, q = (int(d) for d in f.shape)
    if l_cols % q:
        raise LoweringError(f"dY cols {l_cols} not divisible by Q={q}")
    return m, l_cols // q, p, q


def sliced_multiply_t_cuda(
    dy: torch.Tensor, f: torch.Tensor, *, tiles: tuple | None = None
) -> torch.Tensor:
    """One launch of the transposed sliced kernel: (M, Q*S) x (P, Q) ->
    (M, S*P).  Tiles come from ``kron_sliced.sliced_tiles(kind="sliced_t")``,
    bounded by ``tiles=(t_m, t_s, t_q)`` when given, the grid from the
    occupancy query (``_launch.grad_blocks``).  Output in dy's dtype,
    accumulated in f32 (f64 for f64).  Raises on CPU tensors: their path is
    ``sliced_multiply_t_reference``.  A FakeTensor's output returns
    unlaunched (``_launch.skip``)."""
    m, s, p, q = _dims(dy, f)
    acc = acc_dtype_for(dy.dtype)
    isz = dy.element_size()
    limit = None if tiles is None else check_tiles(m, s, q, tiles)
    t_m, t_s, t_q = sliced_tiles(
        m, s, p, q, acc.itemsize, kind="sliced_t", in_bytes=isz, limit=limit
    )
    _launch.require_cuda("sliced_multiply_t_cuda", dy, f)
    code = _launch.kernel_dtype_code(dy, (f,), acc)
    dx = torch.empty((m, s * p), dtype=dy.dtype, device=dy.device)
    if _launch.skip("sliced_t", dx, lambda: chain_flops(1, m, s * p, (p,), (q,)), dy, f, dx):
        return dx
    _launch.launch(
        "sliced_t", dy.device,
        lambda nblk: (code, dy.data_ptr(), f.data_ptr(), dx.data_ptr(), m, s, p, q, t_m, t_s,
                      t_q, nblk),
        (code, dy.data_ptr() % 16, m, s, p, q, t_m, t_s, t_q), (m // t_m) * (s // t_s),
    )
    return dx


def sliced_multiply_t_reference(dy: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The transposed sliced kernel's plain PyTorch twin: the same function,
    f32 accumulation (f64 for f64), output in dy's dtype."""
    _dims(dy, f)
    return sliced_apply_t(dy, f)


__all__ = [
    "sliced_multiply_t_cuda",
    "sliced_multiply_t_reference",
]
