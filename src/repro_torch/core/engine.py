"""KronOp: the handle-based Kron-Matmul execution engine.

The port of ``repro.core.engine`` for the local path.  ``KronOp`` is
constructed once from the problem signature; it resolves its ``KronPlan``
(memoized per row count), lowers it into a ``StageProgram`` and runs each
stage as one launch of the chain kernel:

    op = KronOp((16, 16), (16, 16))
    y = op(x, factors)                     # planned forward
    op.with_batch(8)(xb, factors)          # shared factors: B folds into rows

``plan=None`` runs the paper-faithful unfused loop instead: one sliced
multiply per factor, last factor first (Algorithm 1).

An op runs where its tensors are: CUDA tensors launch the kernels, CPU
tensors run their plain twins.  ``__call__`` goes through a
``torch.autograd.Function`` whose backward is ``_program_bwd``, the port of
the JAX custom VJP: the transposed program (``emit.transpose``), one
transposed-chain launch per stage for the x-gradient alone, or one
stage-backward launch per stage (``emit.run_stage_grad``) when factor
gradients are wanted, with the per-factor fallback for stages whose live
set cannot fit one block.  ``plan=None`` runs the unfused backward: one
transposed sliced multiply per factor.

Left for later slices (ROADMAP.md queue 1): per-sample factors
(``shared_factors=False``), the mesh rounds, the degradation ladder (and
its ``guard.record_event``), telemetry and ``profile()``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import torch

from ..kernels import emit, ops
from ..runtime.guard import LoweringError, VmemOverflowError
from . import autotune
from .autotune import KronPlan
from .kron import KronProblem


@functools.lru_cache(maxsize=512)
def _lowered(
    plan: KronPlan, ps: tuple[int, ...], qs: tuple[int, ...]
) -> emit.StageProgram:
    """One StageProgram per (plan, signature)."""
    return autotune.lower(plan, ps, qs)


def _auto_prekron() -> bool:
    # Pre-kronization trades FLOPs for contraction depth: a win on the TPU's
    # 128x128 systolic array.  The card's kernels contract one p at a time on
    # the CUDA cores, where the extra FLOPs are pure cost, so the auto-gate
    # is off; an explicit ``enable_prekron=True`` still plans and runs it.
    return False


@functools.lru_cache(maxsize=128)
def _resolve_plan(
    m: int,
    ps: tuple[int, ...],
    qs: tuple[int, ...],
    dtype_bytes: int,
    enable_prekron: bool,
) -> KronPlan:
    return autotune.make_plan(
        KronProblem(m, ps, qs), dtype_bytes=dtype_bytes, enable_prekron=enable_prekron
    )


def _kron_forward(
    x: torch.Tensor, factors: tuple[torch.Tensor, ...], plan: KronPlan | None,
    backend: str,
) -> torch.Tensor:
    if plan is None:
        # Paper-faithful unfused loop (the C1 baseline): application order is
        # last factor first (Algorithm 1).
        y = x
        for f in reversed(factors):
            y = ops.sliced_multiply(y, f, backend=backend)
        return y
    ps = tuple(int(f.shape[0]) for f in factors)
    qs = tuple(int(f.shape[1]) for f in factors)
    return emit.run_program(x, factors, _lowered(plan, ps, qs), backend=backend)


# Stages whose backward took the per-factor fallback: +1 per stage, nowhere
# else.
bwd_per_factor_fallbacks = 0

# The geometry checks raise these before any launch; a failed build or
# launch raises RuntimeError, which no fallback catches.
_FALLBACK_ERRORS = (VmemOverflowError, LoweringError)


def _prekron_vjp(dk: torch.Tensor, stage_factors: Sequence[torch.Tensor]) -> tuple:
    """Split the cotangent of kron(rev[i+1], ..., rev[i]) back into
    per-factor cotangents, in ``stage_factors`` (application) order."""
    stage_factors = tuple(stage_factors)
    if len(stage_factors) == 1:
        return (dk,)
    a = stage_factors[0]
    b = emit.prekron_product(stage_factors[1:])
    pa, qa = int(a.shape[0]), int(a.shape[1])
    pb, qb = int(b.shape[0]), int(b.shape[1])
    acc = emit.acc_dtype_for(dk.dtype)
    dk4 = dk.reshape(pb, pa, qb, qa).to(acc)
    da = torch.einsum("bpcq,bc->pq", dk4, b.to(acc))
    db = torch.einsum("bpcq,pq->bc", dk4, a.to(acc))
    return (da,) + _prekron_vjp(db, stage_factors[1:])


def _per_factor_bwd(u, g, stage_factors, backend, factors: bool):
    """Backward of a chain of sliced multiplies (``stage_factors`` in
    application order), one kernel per factor: (dx, dfs in application
    order or None).  It is the unfused loop's backward (``plan=None``) and
    the fallback of a stage whose one-launch backward cannot fit one block
    (e.g. Q-tiled stages: the forward tiles Q, but the backward needs every
    factor-gradient pair).  With factor grads the chain's inputs are
    rematerialized, one sliced multiply each."""
    inputs = [u]
    if factors:
        for f in stage_factors[:-1]:
            inputs.append(ops.sliced_multiply(inputs[-1], f, backend=backend))
    dfs = [None] * len(stage_factors)
    for idx in reversed(range(len(stage_factors))):  # last applied first
        f = stage_factors[idx]
        if factors:
            dfs[idx] = emit.sliced_vjp_factor(inputs[idx], g, int(f.shape[-2]), int(f.shape[-1]))
        g = ops.sliced_multiply_t(g, f, backend=backend)
    return g, (tuple(dfs) if factors else None)


def _fallback_bwd(u, g, stage_factors, backend, factors: bool):
    """``_per_factor_bwd`` for a planned stage, counted as a fallback."""
    global bwd_per_factor_fallbacks
    bwd_per_factor_fallbacks += 1
    return _per_factor_bwd(u, g, stage_factors, backend, factors)


def _program_bwd(plan: KronPlan, backend: str, x, factors, g, f_pert: bool):
    """Execute the backward of a lowered plan: (dx, dfs_by_rev_id or None).

    The dx chain is ``emit.transpose`` of the forward program.  When factor
    grads are needed, the stage inputs are rematerialized with the FORWARD
    program and each transposed instruction is replaced by the one-launch
    stage backward (``emit.run_stage_grad``), falling back to per-factor
    kernels when the stage's tiles fail the geometry checks.  Without factor
    grads the stage inputs are never used, so they are not rematerialized.
    """
    ps = tuple(int(f.shape[0]) for f in factors)
    qs = tuple(int(f.shape[1]) for f in factors)
    prog = _lowered(plan, ps, qs)
    rev = tuple(reversed(factors))
    stage_factors = [tuple(rev[i] for i in ins.factor_ids) for ins in prog.instrs]
    stage_inputs = [x]
    if f_pert:
        for ins, sf in zip(prog.instrs[:-1], stage_factors):
            stage_inputs.append(emit.run_stage(stage_inputs[-1], sf, ins, backend=backend))
    bwd_prog = emit.transpose(prog)
    n_st = len(prog.instrs)
    dfs_by_id: dict[int, torch.Tensor] = {}
    for pos, t_ins in enumerate(bwd_prog.instrs):
        fwd_idx = n_st - 1 - pos
        f_ins = prog.instrs[fwd_idx]
        sf = stage_factors[fwd_idx]
        if f_ins.kind == emit.PREKRON:
            fk = emit.prekron_product(sf)
            pk_ins = dataclasses.replace(
                f_ins, kind=emit.MULTIPLY, ps=(int(fk.shape[-2]),),
                qs=(int(fk.shape[-1]),),
                t_qs=f_ins.t_qs if f_ins.t_qs and len(f_ins.t_qs) == 1 else None,
            )
            if f_pert:
                try:
                    g, (dk,) = emit.run_stage_grad(
                        stage_inputs[fwd_idx], g, (fk,),
                        dataclasses.replace(pk_ins, t_m=t_ins.t_m), backend=backend,
                    )
                except _FALLBACK_ERRORS:
                    g, (dk,) = _fallback_bwd(stage_inputs[fwd_idx], g, (fk,), backend, True)
                for fid, d in zip(f_ins.factor_ids, _prekron_vjp(dk, sf)):
                    dfs_by_id[fid] = d
            else:
                try:
                    g = emit.run_stage(g, (fk,), pk_ins.transpose(), backend=backend)
                except _FALLBACK_ERRORS:
                    g, _ = _fallback_bwd(None, g, (fk,), backend, False)
        elif f_pert:
            try:
                # The forward stage shape with the transposed instruction's
                # tuned M-tile (plan.bwd_stages via transpose()).
                g, dfs = emit.run_stage_grad(
                    stage_inputs[fwd_idx], g, sf,
                    dataclasses.replace(f_ins, t_m=t_ins.t_m), backend=backend,
                )
            except _FALLBACK_ERRORS:
                g, dfs = _fallback_bwd(stage_inputs[fwd_idx], g, sf, backend, True)
            for fid, d in zip(f_ins.factor_ids, dfs):
                dfs_by_id[fid] = d
        else:
            try:
                g = emit.run_stage(g, sf, t_ins, backend=backend)
            except _FALLBACK_ERRORS:
                # The planner validated tiles against FORWARD block sizes;
                # the transposed shapes can overflow.
                g, _ = _fallback_bwd(None, g, sf, backend, False)
    return g, (dfs_by_id if f_pert else None)


class _KronFunction(torch.autograd.Function):
    """Forward through the planned kernels; backward through the transposed
    program's kernels (``_program_bwd``), or one kernel per factor for
    ``plan=None`` (``_per_factor_bwd``).

    Autograd runs ``forward`` with gradient recording off, so neither the
    kernels nor their plain twins are ever traced.  The residuals are x and
    the factors; the stage inputs are rematerialized in ``backward``.
    Factor gradients are computed only when autograd asks for them."""

    @staticmethod
    def forward(ctx, x, plan, backend, *factors):
        ctx.save_for_backward(x, *factors)
        ctx.plan = plan
        ctx.backend = backend
        return _kron_forward(x, factors, plan, backend)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        x, *factors = ctx.saved_tensors
        factors = tuple(factors)
        f_pert = any(ctx.needs_input_grad[3:])
        g = grad_out.contiguous()
        if ctx.plan is None:
            # The unfused loop applied the last factor first.
            dx, dfs = _per_factor_bwd(x, g, factors[::-1], ctx.backend, f_pert)
            dfactors = dfs[::-1] if f_pert else None
        else:
            dx, dfs_by_id = _program_bwd(ctx.plan, ctx.backend, x, factors, g, f_pert)
            nf = len(factors)
            dfactors = (
                tuple(dfs_by_id[nf - 1 - j] for j in range(nf)) if f_pert else None
            )
        dx = dx.to(x.dtype) if ctx.needs_input_grad[0] else None
        if dfactors is None:
            dfactors = (None,) * len(factors)
        else:
            dfactors = tuple(
                d.to(f.dtype) if need else None
                for d, f, need in zip(dfactors, factors, ctx.needs_input_grad[3:])
            )
        return (dx, None, None, *dfactors)


@dataclasses.dataclass(frozen=True)
class KronCost:
    """Analytic per-call cost of a KronOp (``KronOp.cost()``).  Local ops
    move nothing between devices: ``comm_elems_per_device`` and ``rounds``
    are 0 until the mesh slice."""

    flops: int
    comm_elems_per_device: int = 0
    rounds: int = 0


_OP_STATE_SIZE = 8  # per-op (rows, dtype) -> plan entries kept


class KronOp:
    """A Kron-Matmul problem resolved into an executable operator.

    ``KronOp(ps, qs)`` describes ``x @ (F^1 (x) ... (x) F^N)`` with factor
    shapes ``F^i: (P_i, Q_i)``.

    Parameters
    ----------
    ps, qs : factor row/column dims, problem order.
    m : optional row count the plan is resolved for at construction.  When
        omitted, plans resolve on first call per distinct row count and
        ``.plan`` defaults to the paper's M=16 CG-block row count.
    batch : B for the shared-factor batched mode: x is ``(B, ..., K)`` and
        one 2-D factor set serves every sample (B folds into the rows).
        Per-sample factors (``shared_factors=False``) are a later slice.
    backend : ``"auto"`` (by the tensors' device), ``"cuda"`` or ``"torch"``.
    plan : ``"auto"``, ``None`` (paper-faithful unfused loop) or a
        ``KronPlan``.
    enable_prekron : None keeps the auto-gate (off: ``_auto_prekron``); an
        explicit bool overrides it.
    """

    def __init__(
        self,
        ps: Sequence[int],
        qs: Sequence[int],
        *,
        m: int | None = None,
        batch: int | None = None,
        shared_factors: bool = True,
        backend: str = "auto",
        plan: KronPlan | str | None = "auto",
        dtype_bytes: int = 4,
        enable_prekron: bool | None = None,
    ):
        self.ps = tuple(int(p) for p in ps)
        self.qs = tuple(int(q) for q in qs)
        if len(self.ps) != len(self.qs) or not self.ps:
            raise ValueError(f"ps/qs must be equal-length and non-empty: {ps}, {qs}")
        if any(d <= 0 for d in self.ps + self.qs):
            raise ValueError(f"factor dims must be positive: {ps}, {qs}")
        if batch is not None and batch <= 0:
            raise ValueError(f"batch must be positive, got {batch}")
        if batch is not None and not shared_factors:
            raise NotImplementedError(
                "per-sample factors (shared_factors=False) are a later slice "
                "of the port: ROADMAP.md queue 1, item 7"
            )
        if isinstance(plan, str) and plan != "auto":
            raise ValueError(f"plan must be 'auto', None, or a KronPlan: {plan!r}")
        if backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}: 'auto', 'cuda' or 'torch'")
        self.n = len(self.ps)
        self.k = math.prod(self.ps)
        self.k_out = math.prod(self.qs)
        self.batch = batch
        self.shared_factors = True
        self.backend = backend
        self._m = m
        self._dtype_bytes = dtype_bytes
        self._plan_arg = plan
        self._enable_prekron = enable_prekron
        self._prekron = _auto_prekron() if enable_prekron is None else bool(enable_prekron)
        # Op-owned resolved state: (rows, dtype_bytes) -> plan.
        self._plans: dict = {}
        if m is not None:
            self._plan_for(m if batch is None else batch * m, dtype_bytes)

    # -- plan resolution (op-owned, bounded) ---------------------------------

    def _plan_for(self, rows: int, dtype_bytes: int) -> KronPlan | None:
        key = (rows, dtype_bytes)
        if key not in self._plans:
            if self._plan_arg == "auto":
                plan = _resolve_plan(rows, self.ps, self.qs, dtype_bytes, self._prekron)
            else:
                plan = self._plan_arg
            self._plans[key] = plan
            while len(self._plans) > _OP_STATE_SIZE:
                self._plans.pop(next(iter(self._plans)))
        return self._plans[key]

    def _default_rows(self) -> int:
        # The paper's M=16 CG-block row count when no row hint exists.
        return self._m if self._m is not None else 16

    @property
    def plan(self) -> KronPlan | None:
        """The op's resolved KronPlan (last resolved; resolves for the
        construction-time ``m`` or the M=16 default when none seen yet)."""
        if self._plans:
            return next(reversed(self._plans.values()))
        m = self._default_rows()
        rows = m if self.batch is None else self.batch * m
        return self._plan_for(rows, self._dtype_bytes)

    # -- derivations --------------------------------------------------------

    def with_batch(
        self, batch: int | None, *, shared_factors: bool | None = None
    ) -> "KronOp":
        """The same problem over ``batch`` samples sharing one factor set.

        The row-count hint is dropped: a single op's ``m`` is total rows while
        a batched op's ``m`` is rows per sample."""
        return KronOp(
            self.ps, self.qs, m=None, batch=batch,
            shared_factors=True if shared_factors is None else shared_factors,
            backend=self.backend, plan=self._plan_arg,
            dtype_bytes=self._dtype_bytes, enable_prekron=self._enable_prekron,
        )

    # -- size / cost queries -------------------------------------------------

    def out_shape(self, x_shape: Sequence[int]) -> tuple[int, ...]:
        """Output shape for an input of shape ``x_shape``."""
        x_shape = tuple(int(d) for d in x_shape)
        if not x_shape or x_shape[-1] != self.k:
            raise ValueError(
                f"x last dim {x_shape[-1] if x_shape else None} != "
                f"prod(P)={self.k} for {self.ps}"
            )
        if self.batch is not None:
            if len(x_shape) < 2 or x_shape[0] != self.batch:
                raise ValueError(
                    f"batched op expects (B={self.batch}, ..., K), got {x_shape}"
                )
        return (*x_shape[:-1], self.k_out)

    def cost(self, m: int | None = None) -> KronCost:
        """Analytic cost of one call: the sliced-multiply FLOPs."""
        m = m if m is not None else self._default_rows()
        b = self.batch or 1
        return KronCost(KronProblem(b * m, self.ps, self.qs).flops)

    def describe(self) -> str:
        mode = "batched" if self.batch is not None else "single"
        shared = "" if self.batch is None else ", shared"
        plan = self.plan
        pdesc = plan.describe() if plan is not None else "unfused"
        return (
            f"KronOp(ps={list(self.ps)}, qs={list(self.qs)}, {mode}{shared}, "
            f"local, backend={self.backend}) :: {pdesc}"
        )

    def __repr__(self) -> str:
        return self.describe()

    # -- execution -----------------------------------------------------------

    def _check_factors(self, x: torch.Tensor, factors: tuple[torch.Tensor, ...]):
        if not factors:
            raise ValueError("need at least one factor")
        if any(f.ndim != 2 for f in factors):
            raise ValueError("expected 2-D (P_i, Q_i) factors")
        ps = tuple(int(f.shape[0]) for f in factors)
        qs = tuple(int(f.shape[1]) for f in factors)
        if (ps, qs) != (self.ps, self.qs):
            raise ValueError(
                f"factor shapes {ps}x{qs} do not match op signature "
                f"{self.ps}x{self.qs}"
            )
        for f in factors:
            if f.device != x.device:
                raise ValueError(f"x on {x.device} but a factor on {f.device}")
        if x.shape[-1] != self.k:
            raise ValueError(
                f"x last dim {x.shape[-1]} != prod(P)={self.k} for {self.ps}"
            )

    def __call__(
        self, x: torch.Tensor, factors: Sequence[torch.Tensor]
    ) -> torch.Tensor:
        factors = tuple(factors)
        self._check_factors(x, factors)
        if self.batch is not None:
            if x.ndim < 2 or int(x.shape[0]) != self.batch:
                raise ValueError(
                    f"batched op expects x (B={self.batch}, ..., K), got "
                    f"{tuple(x.shape)}"
                )
        lead = x.shape[:-1]
        rows = math.prod(lead) if lead else 1
        plan = self._plan_for(rows, x.element_size())
        y = _KronFunction.apply(x.reshape(rows, self.k), plan, self.backend, *factors)
        return y.reshape(*lead, self.k_out)


__all__ = ["KronOp", "KronCost"]
