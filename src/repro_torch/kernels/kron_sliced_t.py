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

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..runtime import hlo_cost
from ..runtime.guard import LoweringError
from .emit import (
    _nbytes,
    CODE_BYTES,
    acc_dtype_for,
    chain_flops,
    check_launch,
    grad_blocks,
    kernel_dtype_code,
    kernel_fn,
    occupancy,
    require_cuda,
    sliced_apply_t,
    sm_count,
)
from .kron_sliced import check_tiles, sliced_t_smem_bytes, sliced_tiles

# Launch counter of the transposed sliced kernel: +1 per launch, nowhere else.
sliced_t_launches = 0

_LL, _I, _VP = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
# kron_sliced_t(dtype, dy, f, dx, M, S, p, q, t_m, t_s, t_q, nblk, stream)
_SLICED_T_ARGS = (_I, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _I, _I, _VP)
# kron_sliced_t_occupancy(dtype, dy, M, S, p, q, t_m, t_s, t_q, &blocks, &smem)
_OCC_ARGS = (_I, _VP, _LL, _LL, _I, _I, _I, _I, _I)


@functools.lru_cache(maxsize=256)
def sliced_t_occupancy(code, dy_align, m, s, p, q, t_m, t_s, t_q, device):
    """(blocks per SM, shared-memory bytes) of the kernel at these tiles,
    from its occupancy query; ``dy_align`` (dY's address mod 16) sets the
    ring's copy width.  Memoized.  Raises when the kernel's layout and
    ``sliced_t_smem_bytes`` disagree."""
    with torch.cuda.device(device):
        per_sm, smem = occupancy("sliced_t", _OCC_ARGS, code, dy_align, m, s, p, q, t_m, t_s, t_q)
    in_bytes, acc_bytes = CODE_BYTES[code]
    model = sliced_t_smem_bytes(t_m, t_s, p, q, t_q, in_bytes, acc_bytes)
    if smem != model:
        raise RuntimeError(f"sliced_t.cu lays out {smem} bytes of shared memory, the model {model}")
    return per_sm, smem


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
    bounded by ``tiles=(t_m, t_s, t_q)`` when given, the grid from the occupancy query (``emit.grad_blocks``).  Output in dy's
    dtype, accumulated in f32 (f64 for f64).  Raises on CPU tensors: their
    path is ``sliced_multiply_t_reference``.  A FakeTensor's output returns
    unlaunched (``emit``'s fake path)."""
    global sliced_t_launches
    m, s, p, q = _dims(dy, f)
    acc = acc_dtype_for(dy.dtype)
    isz = dy.element_size()
    limit = None if tiles is None else check_tiles(m, s, q, tiles)
    t_m, t_s, t_q = sliced_tiles(
        m, s, p, q, acc.itemsize, kind="sliced_t", in_bytes=isz, limit=limit
    )
    require_cuda("sliced_multiply_t_cuda", dy, f)
    code = kernel_dtype_code(dy, (f,), acc)
    dx = torch.empty((m, s * p), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    if hlo_cost.ACTIVE:
        hlo_cost.count_kernel("sliced_t", chain_flops(1, m, s * p, (p,), (q,)),
                              _nbytes(dy, f, dx))
    if isinstance(dy, FakeTensor):  # a dry-run's trace: counted, never launched
        return dx
    per_sm, _ = sliced_t_occupancy(
        code, dy.data_ptr() % 16, m, s, p, q, t_m, t_s, t_q, dy.device
    )
    nblk = grad_blocks(sm_count(dy.device), per_sm, (m // t_m) * (s // t_s), 1)
    with torch.cuda.device(dy.device):
        err = kernel_fn("sliced_t", _SLICED_T_ARGS)(
            code, dy.data_ptr(), f.data_ptr(), dx.data_ptr(), m, s, p, q,
            t_m, t_s, t_q, nblk, torch.cuda.current_stream().cuda_stream,
        )
    check_launch("sliced_t", err)
    sliced_t_launches += 1
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
