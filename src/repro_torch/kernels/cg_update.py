"""Conjugate gradients' vector updates on the card (``csrc/cg_update.cu``).

``FusedCG`` holds one solve's state on the device (``x``, ``r``, ``p``, the
dot products' per-chunk partials and the residual norms) and launches its
passes; ``gp.ski.conjugate_gradient`` drives it for every CUDA block with the
default row dot and keeps its eager updates, the plain twin, for CPU tensors
(and for a custom ``dot=``, the sharded solve's, which the kernels cannot
compute).  One iteration is ``dot`` (p . ap), ``step`` (x, r and r . r) and
``direction`` (p), with ``ap = y + shift * p`` formed inside the kernels from
the MVM's ``y``; alpha, beta and the residual norms never leave the device.
"""
from __future__ import annotations

import torch

from . import _launch

START, DOT, STEP, DIRECTION, NORM = range(5)  # the stages of csrc/cg_update.cu
DTYPES = {torch.float32: 0, torch.float64: 2}  # the kernels' dtype codes
CHUNK_UNIT = 1024  # a chunk is a multiple of this many elements
MAX_CHUNKS = 256  # chunks a row, at most: one partial per thread of a block


def cg_chunk(k: int) -> int:
    """Elements of a row's chunk: the least multiple of ``CHUNK_UNIT`` that
    cuts a row of ``k`` into at most ``MAX_CHUNKS`` chunks.  It depends on
    ``k`` alone, so the order of every sum is fixed by the shape."""
    return CHUNK_UNIT * -(-k // (CHUNK_UNIT * MAX_CHUNKS))


class FusedCG:
    """One solve of ``(A + shift I) x = b`` on the device.

    ``b`` is a contiguous, non-empty float32 or float64 CUDA tensor that
    needs no gradient (rows are the product of its leading dims, each
    reduced over the last); anything else raises ``ValueError``.  ``x`` is
    the caller's zero start, updated in place; ``r`` and ``p`` are allocated
    here.  Each method launches one pass on the current stream; ``y`` is the
    MVM's output for ``x`` (``start``) or ``p`` (``dot``, ``step``), of
    ``b``'s shape, dtype and device (a strided or misaligned ``y`` is copied
    first).  ``cur`` says which of the two r . r partial buffers holds the
    current residual's."""

    def __init__(self, b: torch.Tensor, x: torch.Tensor, shift: float):
        _launch.require_cuda("FusedCG", b, x)
        if b.dtype not in DTYPES:
            raise ValueError(f"FusedCG takes float32 or float64, not {b.dtype}")
        if b.requires_grad:
            raise ValueError("FusedCG: the fused updates do not record gradients")
        if b.dim() < 1 or b.numel() == 0:
            raise ValueError(f"FusedCG: an empty right-hand side {tuple(b.shape)}")
        if x.shape != b.shape or x.dtype != b.dtype:
            raise ValueError(f"FusedCG: x {tuple(x.shape)} {x.dtype} for b {tuple(b.shape)}")
        self.b, self.x, self.shift = b, x, float(shift)
        self.k = int(b.shape[-1])
        self.rows = b.numel() // self.k
        self.chunk = cg_chunk(self.k)
        nc = -(-self.k // self.chunk)
        self.r = torch.empty_like(b)
        self.p = torch.empty_like(b)
        self.part = torch.empty((3, self.rows, nc), dtype=torch.float64, device=b.device)
        self.res = torch.empty(b.shape[:-1], dtype=b.dtype, device=b.device)
        self.cur = 0
        wide = 16 // b.element_size()  # elements of one 16-byte access
        aligned = all(t.data_ptr() % 16 == 0 for t in (b, x, self.r, self.p))
        self.vec = wide if self.k % wide == 0 and aligned else 1

    def _pass(self, stage: int, y: torch.Tensor | None = None) -> None:
        if y is not None:
            if y.shape != self.b.shape or y.dtype != self.b.dtype or y.device != self.b.device:
                raise ValueError(f"FusedCG: the MVM gave {tuple(y.shape)} {y.dtype} on "
                                 f"{y.device} for {tuple(self.b.shape)} {self.b.dtype} on "
                                 f"{self.b.device}")
            if not y.is_contiguous() or (self.vec > 1 and y.data_ptr() % 16):
                y = y.clone(memory_format=torch.contiguous_format)
        _launch.launch("cg_update", self.b.device, lambda: (
            stage, DTYPES[self.b.dtype], self.b.data_ptr(), 0 if y is None else y.data_ptr(),
            self.x.data_ptr(), self.r.data_ptr(), self.p.data_ptr(), self.part.data_ptr(),
            self.res.data_ptr(), self.rows, self.k, self.chunk, self.shift, self.cur, self.vec,
        ))

    def start(self, y: torch.Tensor) -> None:
        """``r = b - y``, ``p = r`` and the partials of r . r."""
        self._pass(START, y)

    def dot(self, y: torch.Tensor) -> None:
        """The partials of p . (y + shift p)."""
        self._pass(DOT, y)

    def step(self, y: torch.Tensor) -> None:
        """alpha; ``x += alpha p``, ``r -= alpha (y + shift p)``; the new
        residual's partials of r . r, which become the current ones."""
        self._pass(STEP, y)
        self.cur ^= 1

    def direction(self) -> None:
        """beta; ``p = r + beta p``."""
        self._pass(DIRECTION)

    def norm(self) -> torch.Tensor:
        """The current residual's norm per row, of ``b``'s leading shape."""
        self._pass(NORM)
        return self.res


__all__ = ["DTYPES", "FusedCG", "cg_chunk"]
