"""One FastKron sliced multiply on the card (contributions C1+C2).

Semantics: for ``X: (M, K)`` and ``F: (P, Q)`` with ``S = K // P`` compute

    Y[m, q*S + s] = sum_p X[m, s*P + p] * F[p, q]

``sliced_multiply_cuda`` launches ``csrc/sliced.cu`` over the grid
``(M/t_m, S/t_s, Q/t_q)``: a block stages its ``(t_m, t_s*P)`` slab of x and
the ``(P, t_q)`` panel of F in shared memory and writes the ``(t_m, t_q,
t_s)`` block of the ``(M, Q, S)`` view of y, so each element lands at its
final FastKron index.  ``sliced_multiply_reference`` is its plain twin.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime.guard import LoweringError, VmemOverflowError
from . import _build
from .emit import (
    _divisors,
    acc_dtype_for,
    block_tile,
    kernel_dtype_code,
    require_cuda,
    sliced_apply,
)

# Launch counter of the sliced kernel: +1 per launch, nowhere else.
sliced_launches = 0


@functools.lru_cache(maxsize=1024)
def sliced_tiles(
    m: int, s: int, p: int, q: int, acc_bytes: int, kind: str = "fwd"
) -> tuple[int, int, int]:
    """The card's tiles ``(t_m, t_s, t_q)`` for one sliced multiply
    (``kind="fwd"``, ``csrc/sliced.cu``) or its transpose (``"bwd"``,
    ``csrc/sliced_t.cu``, where Q is the contraction and the Q-tiles are
    summed inside the block).

    The widest Q-tile whose block fits shared memory (all of Q when it
    does, so the Q-wide operand is read once), then ``emit.block_tile``'s
    rule over the ``(t_m, t_s * P)`` slab for that kernel's shared-memory
    model: the largest ``t_m * t_s``, ties to the longer run of slices,
    preferring slabs that fit half of a block so two blocks share an SM.
    """
    for t_q in reversed(_divisors(q)):
        try:
            t_m, t_k = block_tile(
                m, s * p, (p,), (t_q,), acc_bytes, kind=kind, q_tiled=t_q < q
            )
        except VmemOverflowError:
            continue
        return t_m, t_k // p, t_q
    raise VmemOverflowError(
        f"sliced multiply with P={p} does not fit one block's shared memory "
        f"even at t_m=t_s=t_q=1"
    )


def _sliced_fn():
    fn = _build.library("sliced").kron_sliced
    if fn.argtypes is None:
        ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, vp, vp, vp, ll, ll, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def sliced_multiply_cuda(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """One launch of the sliced-multiply kernel: (M, K) x (P, Q) -> (M, Q*S).

    Tiles come from ``sliced_tiles``.  Output in x's dtype, accumulated in
    f32 (f64 for f64).  Raises on CPU tensors: their path is
    ``sliced_multiply_reference``.
    """
    global sliced_launches
    m, k = (int(d) for d in x.shape)
    p, q = (int(d) for d in f.shape)
    if k % p:
        raise LoweringError(f"K={k} not divisible by P={p}")
    s = k // p
    acc = acc_dtype_for(x.dtype)
    t_m, t_s, t_q = sliced_tiles(m, s, p, q, acc.itemsize)
    require_cuda("sliced_multiply_cuda", x, f)
    code = kernel_dtype_code(x, (f,), acc)
    y = torch.empty((m, q * s), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _sliced_fn()
    with torch.cuda.device(x.device):
        err = fn(
            code, x.data_ptr(), f.data_ptr(), y.data_ptr(), m, k, p, q,
            t_m, t_s, t_q, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"sliced launch failed: {_build.error_string(_build.library('sliced'), err)}"
        )
    sliced_launches += 1
    return y


def sliced_multiply_reference(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The sliced kernel's plain PyTorch twin: the same function, f32
    accumulation (f64 for f64), output in x's dtype."""
    p = int(f.shape[0])
    if int(x.shape[1]) % p:
        raise LoweringError(f"K={x.shape[1]} not divisible by P={p}")
    return sliced_apply(x, f)


__all__ = [
    "sliced_multiply_cuda",
    "sliced_multiply_reference",
    "sliced_tiles",
]
