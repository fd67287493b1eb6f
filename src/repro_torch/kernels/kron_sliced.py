"""One FastKron sliced multiply on the card (contributions C1+C2).

Semantics: for ``X: (M, K)`` and ``F: (P, Q)`` with ``S = K // P`` compute

    Y[m, q*S + s] = sum_p X[m, s*P + p] * F[p, q]

``sliced_multiply_cuda`` launches ``csrc/sliced.cu`` on a persistent grid
(as many blocks as the card holds, from the kernel's occupancy query): each
block walks ``(t_m, t_s)`` tiles of one ``t_q`` Q-tile after another, brings
the ``(t_m, t_s*P)`` x slabs in through an asynchronous-copy ring and writes
the ``(t_m, t_q, t_s)`` block of the ``(M, Q, S)`` view of y, so each element
lands at its final FastKron index.  bf16 launches whose panel fits
(``sliced_uses_mma``) run on the tensor cores.  ``sliced_multiply_reference``
is its plain twin.
"""
from __future__ import annotations

import functools

import torch

from ..runtime.guard import LoweringError, VmemOverflowError
from . import _launch
from .emit import (
    ASYNC_THREADS,
    SMEM_BYTES,
    TWO_BLOCK_SMEM_BYTES,
    acc_dtype_for,
    chain_flops,
    divisors,
    sliced_apply,
)

SLICED_STAGES = 3  # the ring slots of csrc/sliced.cu and csrc/sliced_t.cu (kStages)
_SLICES = 4  # slices of one thread's register tile (sliced.cu's CUDA cores, sliced_t.cu)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def sliced_smem_bytes(
    t_m: int, t_s: int, p: int, q: int, t_q: int, in_bytes: int, acc_bytes: int,
    mma: bool = False,
) -> int:
    """Shared memory of one ``csrc/sliced.cu`` block (``sliced_args``), in
    bytes: the ring's three slots of the raw x slab, then the panel, then
    (tensor cores) the staged output.  Each slice of a slot takes whole
    16-byte chunks.

    CUDA cores: ``ceil(P / e)`` chunks a slice (``e = 16 / in_bytes``) plus
    one skew chunk per 4 slices; the ``(P, t_q)`` panel in the accumulator
    dtype, rows padded to whole chunks, columns to 8.

    Tensor cores (``mma``, bf16, ``t_q = Q``): ``P16 / 8 + 1`` chunks a slice
    (P padded to 16, an odd count) for the ``t_m * t_s`` slices rounded up to
    8; the transposed panel ``(Q16, P16 + 8)`` in bf16; the staged ``(t_q,
    ldo)`` output in bf16, ``ldo`` the slices rounded up to an odd number of
    chunks of 8."""
    ns = t_m * t_s
    if mma:
        p16, q16 = _up(p, 16), _up(q, 16)
        n8 = _up(ns, 8)
        ldo = n8 if n8 % 16 else n8 + 8
        slot = n8 * (p16 // 8 + 1) * 16
        panel = q16 * (p16 + 8) * 2
        stage = t_q * ldo * 2
    else:
        ech = 16 // in_bytes
        cps = -(-p // ech)
        slot = t_m * (t_s * cps + -(-t_s // _SLICES)) * 16
        panel = cps * ech * _up(t_q, 8) * acc_bytes
        stage = 0
    return SLICED_STAGES * _up(slot, 16) + _up(panel, 16) + _up(stage, 16)


def sliced_uses_mma(p: int, q: int, in_bytes: int) -> bool:
    """sliced.cu runs a bf16 launch on the tensor cores when its whole
    transposed panel leaves room, at the smallest tile, for a second block
    on the SM; a larger bf16 factor stays on the CUDA cores."""
    return in_bytes == 2 and sliced_smem_bytes(1, 1, p, q, q, 2, 4, True) <= TWO_BLOCK_SMEM_BYTES


def sliced_mma(p: int, q: int, t_q: int, in_bytes: int) -> bool:
    """Whether a sliced.cu launch at Q-tile ``t_q`` runs on the tensor
    cores: ``sliced_uses_mma`` and Q whole (the mma path loads the whole
    transposed panel)."""
    return t_q == q and sliced_uses_mma(p, q, in_bytes)


def check_tiles(m: int, s: int, q: int, tiles) -> tuple[int, int, int]:
    """A caller's ``tiles=(t_m, t_s, t_q)`` limit, as the reference's
    ``ops.sliced_multiply(tiles=)`` takes it: each entry clamped to its
    dim (``None`` for ``t_s`` or ``t_q``: no limit).  Raises
    ``LoweringError`` (a ``ValueError``, the reference's class) when a
    tile does not divide its dim."""
    t_m, t_s, t_q = tiles
    t_m, t_s, t_q = min(int(t_m), m), min(int(t_s or s), s), min(int(t_q or q), q)
    if t_m < 1 or t_s < 1 or t_q < 1 or m % t_m or s % t_s or q % t_q:
        raise LoweringError(f"tiles must divide dims: {(m, s, q)} vs {(t_m, t_s, t_q)}")
    return t_m, t_s, t_q


def sliced_t_smem_bytes(
    t_m: int, t_s: int, p: int, q: int, t_q: int, in_bytes: int, acc_bytes: int
) -> int:
    """Shared memory of one ``csrc/sliced_t.cu`` block (``sliced_t_args``),
    in bytes, each region rounded to 16: the ring's three ``(t_m, t_q,
    t_s)`` dY boxes in the input dtype, and the transposed ``(t_q, P)``
    panel (P padded to 4) in the accumulator dtype, once when Q is whole,
    else one Q-tile slice in every slot."""
    box = _up(t_m * t_q * t_s * in_bytes, 16)
    panel = _up(t_q * _up(p, 4) * acc_bytes, 16)
    if t_q < q:
        return SLICED_STAGES * (box + panel)
    return SLICED_STAGES * box + panel


def sliced_t_fits_threads(t_m: int, t_s: int, p: int) -> bool:
    """A sliced_t tile gives each thread at most one register tile of
    (1 row, 4 slices, 4 columns of P)."""
    return t_m * -(-t_s // _SLICES) * -(-p // 4) <= ASYNC_THREADS


@functools.lru_cache(maxsize=1024)
def sliced_tiles(
    m: int, s: int, p: int, q: int, acc_bytes: int, kind: str = "fwd",
    in_bytes: int | None = None, limit: tuple[int, int, int] | None = None,
) -> tuple[int, int, int]:
    """The card's tiles ``(t_m, t_s, t_q)`` for one sliced multiply
    (``kind="fwd"``, ``csrc/sliced.cu``) or its transpose
    (``kind="sliced_t"``, ``csrc/sliced_t.cu``, where Q is the contraction
    and the Q-tiles are summed inside the block), for inputs of ``in_bytes``
    (default ``acc_bytes``).

    ``fwd``: among the tiles whose block (``sliced_smem_bytes``, on the
    tensor cores when ``sliced_uses_mma``) leaves room for a second block on
    the SM, the widest Q-tile (all of Q when it fits, so the panel is loaded
    once per block; always all of Q on the tensor cores), then output runs
    that fill a 32-byte sector (``t_s * in_bytes >= 32``), then the largest
    ``t_m * t_s``, ties to the longer run of slices.

    ``sliced_t``: among the tiles that give each of the block's threads at
    most one register tile (``sliced_t_fits_threads``) and fit one block
    (``sliced_t_smem_bytes``), those that leave room for a second block on
    the SM come first, then the widest Q-tile, then the largest ``t_m *
    t_s``, ties to the longer run of slices.

    ``limit=(t_m, t_s, t_q)`` (from ``check_tiles``: each divides its dim)
    bounds the tile: every entry divides the limit's.  A Q-tile limit below
    Q keeps a bf16 launch off the tensor cores (``sliced_mma``).
    """
    ib = acc_bytes if in_bytes is None else in_bytes
    lim_m, lim_s, lim_q = limit if limit is not None else (m, s, q)
    fits = []
    if kind == "fwd":
        mma = sliced_mma(p, q, lim_q, ib)
        for t_q in [q] if mma else divisors(lim_q):
            for t_s in divisors(lim_s):
                for t_m in divisors(lim_m):
                    nbytes = sliced_smem_bytes(t_m, t_s, p, q, t_q, ib, acc_bytes, mma)
                    if nbytes <= TWO_BLOCK_SMEM_BYTES:
                        fits.append((t_q, t_s * ib >= 32, t_m * t_s, t_s, t_m))
        if fits:
            best = max(fits)
            return best[4], best[3], best[0]
    elif kind == "sliced_t":
        for t_q in divisors(lim_q):
            for t_s in divisors(lim_s):
                for t_m in divisors(lim_m):
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
        f"{kind} sliced multiply with P={p}, Q={q} does not fit one block "
        f"even at t_m=t_s=t_q=1"
    )


def sliced_multiply_cuda(
    x: torch.Tensor, f: torch.Tensor, *, tiles: tuple | None = None
) -> torch.Tensor:
    """One launch of the sliced-multiply kernel: (M, K) x (P, Q) -> (M, Q*S).

    Tiles come from ``sliced_tiles``, bounded by ``tiles=(t_m, t_s, t_q)``
    when given (``check_tiles``), the grid from the occupancy query
    (``_launch.grad_blocks``).  Output in x's dtype, accumulated in f32 (f64
    for f64).  Raises on CPU tensors: their path is
    ``sliced_multiply_reference``.  A FakeTensor's output returns
    unlaunched (``_launch.skip``).
    """
    m, k = (int(d) for d in x.shape)
    p, q = (int(d) for d in f.shape)
    if k % p:
        raise LoweringError(f"K={k} not divisible by P={p}")
    s = k // p
    acc = acc_dtype_for(x.dtype)
    isz = x.element_size()
    limit = None if tiles is None else check_tiles(m, s, q, tiles)
    t_m, t_s, t_q = sliced_tiles(m, s, p, q, acc.itemsize, in_bytes=isz, limit=limit)
    _launch.require_cuda("sliced_multiply_cuda", x, f)
    code = _launch.kernel_dtype_code(x, (f,), acc)
    y = torch.empty((m, q * s), dtype=x.dtype, device=x.device)
    if _launch.skip("sliced", y, lambda: chain_flops(1, m, k, (p,), (q,)), x, f, y):
        return y
    mma = int(sliced_mma(p, q, t_q, isz))
    _launch.launch(
        "sliced", x.device,
        lambda nblk: (code, mma, x.data_ptr(), f.data_ptr(), y.data_ptr(), m, k, p, q, t_m, t_s,
                      t_q, nblk),
        (code, mma, m, k, p, q, t_m, t_s, t_q), (q // t_q) * (m // t_m) * (s // t_s),
    )
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
    "sliced_smem_bytes",
    "sliced_t_smem_bytes",
    "sliced_tiles",
    "sliced_uses_mma",
    "sliced_mma",
    "check_tiles",
]
