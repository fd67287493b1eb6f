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
    ASYNC_THREADS,
    CODE_BYTES,
    SMEM_BYTES,
    TWO_BLOCK_SMEM_BYTES,
    _divisors,
    acc_dtype_for,
    block_smem_bytes,
    block_tile,
    kernel_dtype_code,
    occupancy,
    require_cuda,
    sliced_apply,
)

# Launch counter of the sliced kernel: +1 per launch, nowhere else.
sliced_launches = 0


SLICED_T_STAGES = 3  # the ring slots of csrc/sliced_t.cu (kStages)
_SLICES = 4  # slices of one thread's register tile in sliced_t.cu


def sliced_t_smem_bytes(
    t_m: int, t_s: int, p: int, q: int, t_q: int, in_bytes: int, acc_bytes: int
) -> int:
    """Shared memory of one ``csrc/sliced_t.cu`` block (``sliced_t_args``),
    in bytes, each region rounded to 16: the ring's three ``(t_m, t_q,
    t_s)`` dY boxes in the input dtype, and the transposed ``(t_q, P)``
    panel (P padded to 4) in the accumulator dtype, once when Q is whole,
    else one Q-tile slice in every slot."""
    box = -(-t_m * t_q * t_s * in_bytes // 16) * 16
    panel = -(-t_q * (-(-p // 4) * 4) * acc_bytes // 16) * 16
    if t_q < q:
        return SLICED_T_STAGES * (box + panel)
    return SLICED_T_STAGES * box + panel


def sliced_t_fits_threads(t_m: int, t_s: int, p: int) -> bool:
    """A sliced_t tile gives each thread at most one register tile of
    (1 row, 4 slices, 4 columns of P)."""
    return t_m * -(-t_s // _SLICES) * -(-p // 4) <= ASYNC_THREADS


@functools.lru_cache(maxsize=1024)
def sliced_tiles(
    m: int, s: int, p: int, q: int, acc_bytes: int, kind: str = "fwd",
    in_bytes: int | None = None,
) -> tuple[int, int, int]:
    """The card's tiles ``(t_m, t_s, t_q)`` for one sliced multiply
    (``kind="fwd"``, ``csrc/sliced.cu``) or its transpose
    (``kind="sliced_t"``, ``csrc/sliced_t.cu``, where Q is the contraction
    and the Q-tiles are summed inside the block).

    ``fwd``: the widest Q-tile whose block fits shared memory (all of Q when
    it does, so the Q-wide operand is read once), then ``emit.block_tile``'s
    rule over the ``(t_m, t_s * P)`` slab.

    ``sliced_t``: among the tiles that give each of the block's threads at
    most one register tile (``sliced_t_fits_threads``) and fit one block
    (``sliced_t_smem_bytes`` for inputs of ``in_bytes``, default
    ``acc_bytes``), those that leave room for a second block on the SM come
    first, then the widest Q-tile (the panel is loaded once per block when
    it is all of Q), then the largest ``t_m * t_s``, ties to the longer run
    of slices.
    """
    if kind == "fwd":
        for t_q in reversed(_divisors(q)):
            try:
                t_m, t_k = block_tile(m, s * p, (p,), (t_q,), acc_bytes, kind="fwd")
            except VmemOverflowError:
                continue
            return t_m, t_k // p, t_q
    elif kind == "sliced_t":
        ib = acc_bytes if in_bytes is None else in_bytes
        fits = []
        for t_q in _divisors(q):
            for t_s in _divisors(s):
                for t_m in _divisors(m):
                    if not sliced_t_fits_threads(t_m, t_s, p):
                        continue
                    nbytes = sliced_t_smem_bytes(t_m, t_s, p, q, t_q, ib, acc_bytes)
                    if nbytes <= SMEM_BYTES:
                        fits.append((nbytes <= TWO_BLOCK_SMEM_BYTES, t_q, t_m * t_s, t_s, t_m))
        if fits:
            best = max(fits)
            return best[4], best[3], best[1]
    else:
        raise ValueError(f"unknown sliced kernel kind {kind!r}")
    raise VmemOverflowError(
        f"{kind} sliced multiply with P={p} does not fit one block "
        f"even at t_m=t_s=t_q=1"
    )


# kron_sliced_occupancy(dtype, M, K, p, q, t_m, t_s, t_q, &blocks, &smem)
_OCC_ARGS = (ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong) + (ctypes.c_int,) * 5


@functools.lru_cache(maxsize=256)
def sliced_occupancy(code, m, s, p, q, t_m, t_s, t_q, device):
    """(blocks per SM, shared-memory bytes) of ``csrc/sliced.cu``'s kernel at
    these tiles, from its occupancy query; memoized.  Raises when the
    kernel's layout and ``block_smem_bytes`` disagree."""
    with torch.cuda.device(device):
        per_sm, smem = occupancy("sliced", _OCC_ARGS, code, m, s * p, p, q, t_m, t_s, t_q)
    model = block_smem_bytes(t_m, t_s * p, (p,), (t_q,), CODE_BYTES[code][1])
    if smem != model:
        raise RuntimeError(f"sliced.cu lays out {smem} bytes of shared memory, the model {model}")
    return per_sm, smem


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
    "sliced_occupancy",
    "sliced_t_smem_bytes",
    "sliced_tiles",
]
