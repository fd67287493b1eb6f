"""Structured Kernel Interpolation (SKI / KISS-GP) with Kron-Matmul solves.

The port of ``repro.gp.ski``.  Paper §6.4: SKI approximates a GP kernel as
``W (K^1 (x) ... (x) K^D) W^T`` where each ``K^i`` is a 1-D kernel on a grid
of P inducing points and ``W`` is a sparse interpolation matrix.  Training
computes ``K^-1 V`` by conjugate gradients whose hot operation is the
Kron-Matmul of the CG residual block with the Kronecker kernel: on CUDA
tensors one forward-chain launch per planned stage per CG iteration.

The CG batch is M=16 rows as in the paper's experiments.  With ``mesh=``
every CG iteration's MVM runs the distributed Kron-Matmul on a
``DeviceMesh`` with dims ``("data", "model")``, and CG runs SPMD on each
rank's shard of the block: its element-wise steps locally, its row dot
products as a local sum plus one all-reduce over the model axis
(``_mesh_epoch``).  The reference leaves the same arithmetic to the
sharding of its arrays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Sequence

import torch

from ..core import kron as K
from ..core.engine import KronOp, kron_op_for
from ..kernels import cg_update
from ..runtime import telemetry


def rbf_kernel_1d(grid: torch.Tensor, lengthscale: float = 0.2) -> torch.Tensor:
    """(P, P) RBF kernel on a 1-D grid, jittered for PSD."""
    d = grid[:, None] - grid[None, :]
    k = torch.exp(-0.5 * (d / lengthscale) ** 2)
    return k + 1e-4 * torch.eye(grid.shape[0], dtype=k.dtype, device=k.device)


@dataclass(frozen=True)
class KronKernel:
    """K = (x)_i factors[i], each (P_i, P_i) PSD."""

    factors: tuple[torch.Tensor, ...]

    @property
    def dim(self) -> int:
        return math.prod(int(f.shape[0]) for f in self.factors)

    @cached_property
    def op(self) -> KronOp:
        """The kernel's resolved KronOp, built once and reused by every CG
        iteration's MVM (cached_property writes through the frozen
        dataclass's ``__dict__``)."""
        shapes = tuple(int(f.shape[0]) for f in self.factors)
        return kron_op_for(shapes, shapes)

    def matmul(self, v: torch.Tensor, *, backend: str = "fastkron", mesh=None) -> torch.Tensor:
        """v: (M, prod P) -> v @ K (symmetric K: right-multiply == solve op).
        ``backend``: ``"fastkron"`` (the op: the kernels on CUDA tensors),
        ``"shuffle"`` or ``"naive"`` (the reference algorithms of
        ``core.kron``).  ``mesh``: the op's mesh form (``"fastkron"``
        only); ``v`` a DTensor placed rows over ``data``, columns over
        ``model``, or a full tensor every rank holds."""
        if mesh is not None:
            if backend != "fastkron":
                raise ValueError(f"mesh= runs the fastkron op, not {backend!r}")
            shapes = tuple(int(f.shape[0]) for f in self.factors)
            return kron_op_for(shapes, shapes, mesh=mesh)(v, self.factors)
        if backend == "fastkron":
            return self.op(v, self.factors)
        if backend == "shuffle":
            return K.kron_matmul_shuffle(v, list(self.factors))
        if backend == "naive":
            return K.kron_matmul_naive(v, list(self.factors))
        raise ValueError(backend)


@dataclass(frozen=True)
class BatchedKronKernel:
    """B independent Kronecker kernels with common factor shapes: the
    multi-kernel solve regime (one kernel per task, output or lengthscale
    of a hyperparameter sweep).  ``factors[i]: (B, P_i, P_i)``; every CG
    iteration's MVM runs all B kernels in one per-sample batched
    Kron-Matmul."""

    factors: tuple[torch.Tensor, ...]

    @property
    def batch(self) -> int:
        return int(self.factors[0].shape[0])

    @property
    def dim(self) -> int:
        return math.prod(int(f.shape[1]) for f in self.factors)

    @cached_property
    def op(self) -> KronOp:
        """The per-sample batched KronOp, built once per kernel stack."""
        shapes = tuple(int(f.shape[1]) for f in self.factors)
        return kron_op_for(shapes, shapes, batch=self.batch, shared_factors=False)

    def matmul(self, v: torch.Tensor, *, mesh=None) -> torch.Tensor:
        """v: (B, M, prod P) -> per-sample v_b @ K_b.

        ``mesh``: a ``(data, model)`` DeviceMesh; the MVM then runs the
        mesh op (``v`` a DTensor placed ``(Shard(1), Shard(2))``, or a full
        tensor every rank holds; one collective round per stage for all B
        kernels) in place of the one-device batched launch."""
        if mesh is not None:
            shapes = tuple(int(f.shape[1]) for f in self.factors)
            op = kron_op_for(shapes, shapes, batch=self.batch, shared_factors=False, mesh=mesh)
            return op(v, self.factors)
        return self.op(v, self.factors)

    @classmethod
    def stack(cls, kernels: Sequence[KronKernel]) -> "BatchedKronKernel":
        """Stack same-shaped single kernels into one batched kernel."""
        n = len(kernels[0].factors)
        return cls(tuple(torch.stack([k.factors[i] for k in kernels]) for i in range(n)))


def interp_matrix(x: torch.Tensor, grid_sizes: Sequence[int]) -> torch.Tensor:
    """SKI's sparse W as a dense stand-in (test scale): nearest-two linear
    interpolation per dimension, Kronecker-composed per point.

    x: (n, D) in [0,1]^D.  Returns (n, prod P)."""
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    ws = None
    for j, p in enumerate(grid_sizes):
        pos = torch.clamp(x[:, j] * (p - 1), 0, p - 1 - 1e-6)
        lo = torch.floor(pos).long()
        frac = pos - lo
        w = torch.zeros(n, p, dtype=x.dtype, device=x.device)
        w[rows, lo] = 1 - frac
        w[rows, lo + 1] = frac
        # Row-wise Kronecker product of the per-dimension weights.
        ws = w if ws is None else (ws[:, :, None] * w[:, None, :]).reshape(n, -1)
    return ws


def _row_dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * c, dim=-1, keepdim=True)


def conjugate_gradient(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    iters: int = 10,
    tol: float = 0.0,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _row_dot,
    shift: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched CG on rows of b: solves (A + shift I) x = b with A given as
    row-matvec.

    A fixed iteration count (paper: 10 CG iterations per epoch) with the
    reference's 1e-20 clamps on both divisions; ``iters + 1`` MVMs, the
    first on the zero start.  ``shift`` enters every MVM as ``matvec(p) +
    shift * p``.  ``dot(a, c)`` is the per-row dot product, keeping the
    last dim (a sharded solve sums it over the column shards).  Returns (x,
    final residual norm per row).

    On the card the vector updates run as three fused passes an iteration
    (``kernels/csrc/cg_update.cu``, float32 or float64; a strided ``b`` is
    made contiguous first): the same recurrence, with the row sums in
    another order, no host synchronisation, and no ``p`` update after the
    last iteration; what the kernels cannot take (another dtype, a ``b``
    that needs gradients) raises.  CPU tensors run the eager updates, their
    plain twin.  So does a custom ``dot`` on either device: the sharded
    solve's all-reduce (``_mesh_epoch``) is a row dot the fused passes
    cannot compute, the one case that keeps the eager updates on the card.

    The solve is a ``cg`` telemetry span, the zero start and first
    residual included, and each iteration a ``cg_iter`` span; the counter
    ``cg.fused_iters`` or ``cg.eager_iters`` counts the iterations of each
    path."""
    with telemetry.span("cg"):
        if b.is_cuda and dot is _row_dot:
            return _cg_fused(matvec, b.contiguous(), iters, shift)
        return _cg_eager(matvec, b, iters, shift, dot)


def _cg_fused(matvec, b, iters: int, shift: float):
    x = torch.zeros_like(b)
    cg = cg_update.FusedCG(b, x, shift)
    cg.start(matvec(x))
    for i in range(iters):
        with telemetry.span("cg_iter"):
            y = matvec(cg.p)
            cg.dot(y)
            cg.step(y)
            if i + 1 < iters:
                cg.direction()
            telemetry.counter_inc("cg.fused_iters")
    return x, cg.norm()


def _cg_eager(matvec, b, iters: int, shift: float, dot):
    def apply(v):
        y = matvec(v)
        return y + shift * v if shift else y

    x = torch.zeros_like(b)
    r = b - apply(x)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        with telemetry.span("cg_iter"):
            ap = apply(p)
            denom = dot(p, ap)
            alpha = rs / torch.clamp(denom, min=1e-20)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = dot(r, r)
            beta = rs_new / torch.clamp(rs, min=1e-20)
            p = r + beta * p
            rs = rs_new
            telemetry.counter_inc("cg.eager_iters")
    return x, torch.sqrt(dot(r, r)).squeeze(-1)


def _mesh_epoch(matmul, v: torch.Tensor, mesh, *, noise: float, cg_iters: int):
    """CG on each rank's shard of ``v`` (a DTensor placed rows over
    ``data``, columns over ``model``, or a full tensor every rank holds,
    sliced locally): every MVM is ``matmul(shard, mesh=mesh)``, every row
    dot product a local sum and one all-reduce over the model axis.  That
    ``dot`` keeps CG's updates eager on the card too (``conjugate_gradient``).
    Returns (x, residual norms) as DTensors, or gathered for a full ``v``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..core import distributed as D

    placements = D.mesh_placements(mesh, ndim=v.ndim)
    vd = D._as_placed(v, mesh, placements)
    group = mesh.get_group("model")

    def dot(a, c):
        s = _row_dot(a, c)
        dist.all_reduce(s, group=group)
        return s

    def matvec(rows):
        return matmul(D._from_local(rows, mesh, placements, vd.shape), mesh=mesh).to_local()

    x, res = conjugate_gradient(matvec, vd.to_local(), iters=cg_iters, dot=dot, shift=noise)
    res_placements = tuple(Replicate() if isinstance(p, Shard) and p.dim == v.ndim - 1 else p
                           for p in placements)
    xd = D._from_local(x, mesh, placements, vd.shape)
    resd = D._from_local(res, mesh, res_placements, vd.shape[:-1])
    if isinstance(v, DTensor):
        return xd, resd
    return D.gather(xd), D.gather(resd)


def gp_train_epoch(
    kernel: KronKernel,
    v: torch.Tensor,
    *,
    noise: float = 0.1,
    cg_iters: int = 10,
    backend: str = "fastkron",
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One paper-style training epoch: solve (K + noise*I)^-1 V with CG.

    v: (M, dim) probe/batch block (M=16 in the paper's runs).  ``mesh``:
    the solve on the mesh (``_mesh_epoch``; ``backend`` must be
    ``"fastkron"``)."""
    if mesh is not None:
        if backend != "fastkron":
            raise ValueError(f"mesh= runs the fastkron op, not {backend!r}")
        return _mesh_epoch(kernel.matmul, v, mesh, noise=noise, cg_iters=cg_iters)

    return conjugate_gradient(lambda rows: kernel.matmul(rows, backend=backend), v,
                              iters=cg_iters, shift=noise)


def gp_train_epoch_batched(
    kernel: BatchedKronKernel,
    v: torch.Tensor,
    *,
    noise: float = 0.1,
    cg_iters: int = 10,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-kernel epoch: solve ``(K_b + noise*I)^-1 V_b`` for all B kernels
    at once.  ``v: (B, M, dim)``; CG runs on the whole stack (its reductions
    are per row), so each iteration is one batched Kron-Matmul.

    ``mesh``: a ``(data, model)`` DeviceMesh; the solve runs on each
    rank's shard (``_mesh_epoch``), every MVM the distributed per-sample
    rounds (one collective per round for the whole kernel stack).  A
    DTensor ``v`` gives DTensors back; a full ``v`` every rank holds gives
    full tensors back."""
    if mesh is not None:
        return _mesh_epoch(kernel.matmul, v, mesh, noise=noise, cg_iters=cg_iters)

    return conjugate_gradient(kernel.matmul, v, iters=cg_iters, shift=noise)


__all__ = [
    "rbf_kernel_1d",
    "KronKernel",
    "BatchedKronKernel",
    "interp_matrix",
    "conjugate_gradient",
    "gp_train_epoch",
    "gp_train_epoch_batched",
]
