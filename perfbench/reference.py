"""The plain reference that decides ``correct``, and its lower-precision control.

Plain PyTorch, independent of the program under test: it imports nothing
of it and takes nothing the program made.  The benchmark hands it the same
inputs it hands the program (``X``, the factors, the cotangent, ``V``)
and it works out everything else again.

* ``kron_apply`` is ``X (F^1 (x) ... (x) F^N)`` as N contractions
  (``einsum``), one factor at a time, with a hand-written backward (dX and
  every dF).  The benchmark runs it in float64, in blocks of rows, as the
  reference; with ``tf32=True`` every multiplication's operands are first
  rounded to TF32 (10 mantissa bits, to nearest), which is what a float32
  program computing on the tensor cores in TF32 gets: the control.
* ``conjugate_gradient`` is CG with a fixed iteration count and 1e-20
  clamps on both divisions, the paper's SKI training epoch (the control's
  epoch); ``true_residual`` judges a solution by its residual.
* ``rel_err`` is the comparison: ``max |got - ref| / max |ref|``, infinite
  where ``got`` holds a non-finite value; ``row_rel`` takes it row by row
  and keeps the worst row.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest (ties away from
    zero, as ``cvt.rna.tf32.f32``)."""
    if t.dtype != torch.float32:
        raise TypeError(f"tf32 rounds float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operand(t: torch.Tensor, rounded: bool) -> torch.Tensor:
    return tf32(t) if rounded else t


class _Contract(torch.autograd.Function):
    """``y (M, P, R) x f (P, Q) -> (M, R * Q)``: one factor of the chain."""

    @staticmethod
    def forward(ctx, y, f, rounded):
        a, b = _operand(y, rounded), _operand(f, rounded)
        ctx.save_for_backward(a, b)
        ctx.rounded = rounded
        return torch.einsum("mpr,pq->mrq", a, b).reshape(y.shape[0], -1)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m, _, r = a.shape
        g = _operand(g.reshape(m, r, b.shape[1]).contiguous(), ctx.rounded)
        dy = torch.einsum("mrq,pq->mpr", g, b)
        df = torch.einsum("mpr,mrq->pq", a, g)
        return dy, df, None


def kron_apply(x: torch.Tensor, factors: Sequence[torch.Tensor], *, tf32: bool = False):
    """``x (M, prod P) @ (F^1 (x) ... (x) F^N)`` -> ``(M, prod Q)``.

    Contracting factor 1 first leaves the rows as ``(P_2 .. P_N, Q_1)``, so
    after N contractions they are ``(Q_1 .. Q_N)``, row-major."""
    m = x.shape[0]
    y = x
    for f in factors:
        y = _Contract.apply(y.reshape(m, f.shape[0], -1), f, tf32)
    return y


def kron_grads(x, g, factors, *, want_x: bool, tf32: bool = False):
    """``(y, dx, dfs)`` of ``y = kron_apply(x, factors)`` for the cotangent
    ``g``; ``dx`` is None unless ``want_x``."""
    x = x.detach().requires_grad_(want_x)
    fs = [f.detach().requires_grad_(True) for f in factors]
    y = kron_apply(x, fs, tf32=tf32)
    inputs = ([x] if want_x else []) + fs
    grads = torch.autograd.grad(y, inputs, g)
    dx = grads[0] if want_x else None
    return y.detach(), dx, list(grads[1:] if want_x else grads)


def row_dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a * c).sum(dim=-1, keepdim=True)


def conjugate_gradient(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
                       iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CG on each row of ``b``; ``iters + 1`` MVMs, the first on the zero
    start.  Returns (x, the final residual norm of each row)."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    rs = row_dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(row_dot(p, ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = row_dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
        rs = rs_new
    return x, torch.sqrt(row_dot(r, r)).squeeze(-1)


def gp_solve(v, factors, *, noise: float, iters: int, tf32: bool = False):
    """``(K + noise I)^-1 v`` by ``iters`` CG iterations, ``K`` the Kronecker
    product of the (symmetric) factors."""
    return conjugate_gradient(lambda p: kron_apply(p, factors, tf32=tf32) + noise * p, v, iters)


def true_residual(x, v, factors, *, noise: float):
    """``|v - (K + noise I) x|`` of each row: what a solution ``x`` says."""
    return (v - kron_apply(x, factors) - noise * x).norm(dim=-1)


def rbf_factor(points: int, lengthscale: float, *, dtype=torch.float32, device="cpu"):
    """(P, P) RBF kernel on ``points`` equally spaced points of [0, 1],
    with 1e-4 on the diagonal (SKI's one-dimensional kernel)."""
    grid = torch.linspace(0, 1, points, dtype=dtype, device=device)
    d = grid[:, None] - grid[None, :]
    return torch.exp(-0.5 * (d / lengthscale) ** 2) + 1e-4 * torch.eye(
        points, dtype=dtype, device=device)


class MaxRel:
    """``max |got - ref| / max |ref|`` accumulated over blocks of one output."""

    def __init__(self):
        self.err = 0.0
        self.scale = 0.0

    def add(self, got: torch.Tensor, ref: torch.Tensor) -> None:
        if got.shape != ref.shape:
            raise ValueError(f"shape {tuple(got.shape)} != reference {tuple(ref.shape)}")
        got, ref = got.detach().double(), ref.detach().double()
        if not bool(torch.isfinite(got).all()):
            self.err = math.inf
            return
        self.err = max(self.err, float((got - ref).abs().max()))
        self.scale = max(self.scale, float(ref.abs().max()))

    @property
    def value(self) -> float:
        if math.isinf(self.err):
            return math.inf
        return self.err / self.scale if self.scale else self.err


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    acc = MaxRel()
    acc.add(got, ref)
    return acc.value


def row_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``rel_err`` of each row of ``(M, n)`` tensors, the worst row's."""
    if got.shape != ref.shape:
        raise ValueError(f"shape {tuple(got.shape)} != reference {tuple(ref.shape)}")
    got, ref = got.detach().double(), ref.detach().double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


__all__ = [
    "tf32", "kron_apply", "kron_grads", "row_dot", "conjugate_gradient", "gp_solve", "true_residual",
    "rbf_factor", "MaxRel", "rel_err", "row_rel",
]
