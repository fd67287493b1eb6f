"""KronOp: the handle-based Kron-Matmul execution engine.

The port of ``repro.core.engine`` for the local path.  ``KronOp`` is
constructed once from the problem signature; it resolves its ``KronPlan``
(memoized per row count), lowers it into a ``StageProgram`` and runs each
stage as one launch of the chain kernel:

    op = KronOp((16, 16), (16, 16))
    y = op(x, factors)                                 # planned forward
    op.with_batch(8)(xb, factors)                      # shared: B folds into rows
    op.with_batch(8, shared_factors=False)(xb, fb)     # per-sample (8, P, Q) factors

``plan=None`` runs the paper-faithful unfused loop instead: one sliced
multiply per factor, last factor first (Algorithm 1).

An op runs where its tensors are: CUDA tensors launch the kernels, CPU
tensors run their plain twins.  ``__call__`` goes through a
``torch.autograd.Function`` (``_KronFunction``, in the ``setup_context``
form) whose pieces are the port of the JAX primitives and custom VJP:

* the forward runs under the degradation ladder (``_fwd_ladder``): the
  planned program, then one kernel per factor, then (with the ``torch``
  backend only) the plain twins;
* the backward is ``_program_bwd``: the transposed program
  (``emit.transpose``), one transposed-chain launch per stage for the
  x-gradient alone, or one stage-backward launch per stage
  (``emit.run_stage_grad``) when factor gradients are wanted, with the
  per-factor fallback (``guard.record_event("bwd_per_factor")``) for stages
  whose live set cannot fit one block;
* its ``vmap`` staticmethod is the reference's batching rules:
  ``torch.func.vmap`` over ``x`` alone folds the batch into the rows and
  plans again for the new row count; over ``x`` and the factors it runs the
  per-sample batched plan; nested ``vmap`` folds into one batch axis.

Per-sample batching (``batch=B, shared_factors=False``) runs the same
kernels on 3-D ``(B, P_i, Q_i)`` factors under ``make_batched_plan``'s
per-sample plan.

Left for later slices (ROADMAP.md queue 1): measured tuning and the plan
cache (``tune="measure"``, ``cache_path``), the mesh rounds, and
``profile()``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Sequence

import torch

from ..kernels import emit, ops
from ..kernels.emit import _divisors
from ..runtime import chaos, guard, telemetry
from ..runtime.guard import LoweringError, VmemOverflowError
from . import autotune
from .autotune import KronPlan, Stage, TileConfig
from .kron import KronProblem


@functools.lru_cache(maxsize=512)
def _lowered(
    plan: KronPlan, ps: tuple[int, ...], qs: tuple[int, ...], batched: bool = False
) -> emit.StageProgram:
    """One StageProgram per (plan, signature, batchedness)."""
    return autotune.lower(plan, ps, qs, batched=batched)


def _signature(factors: Sequence[torch.Tensor]) -> tuple[tuple[int, ...], tuple[int, ...]]:
    # (P_i, Q_i) are the last two dims of 2-D and per-sample 3-D factors alike.
    return tuple(f.shape[-2] for f in factors), tuple(f.shape[-1] for f in factors)


def _auto_prekron() -> bool:
    # Pre-kronization trades FLOPs for contraction depth: a win on the TPU's
    # 128x128 systolic array.  The card's kernels contract one p at a time on
    # the CUDA cores, where the extra FLOPs are pure cost, so the auto-gate
    # is off; an explicit ``enable_prekron=True`` still plans and runs it.
    return False


_PLAN_MEMO_SIZE = 128


@functools.lru_cache(maxsize=_PLAN_MEMO_SIZE)
def _resolve_plan(
    m: int,
    ps: tuple[int, ...],
    qs: tuple[int, ...],
    dtype_bytes: int,
    enable_prekron: bool,
) -> KronPlan:
    with telemetry.span("plan", m=m, ps=ps, qs=qs, tune="analytic"):
        return autotune.make_plan(
            KronProblem(m, ps, qs), dtype_bytes=dtype_bytes, enable_prekron=enable_prekron
        )


@functools.lru_cache(maxsize=_PLAN_MEMO_SIZE)
def _resolve_batched_plan(
    batch: int,
    m: int,
    ps: tuple[int, ...],
    qs: tuple[int, ...],
    dtype_bytes: int,
    enable_prekron: bool,
) -> KronPlan:
    with telemetry.span("plan", m=m, ps=ps, qs=qs, tune="analytic", batch=batch):
        return autotune.make_batched_plan(
            KronProblem(m, ps, qs), batch, shared_factors=False,
            dtype_bytes=dtype_bytes, enable_prekron=enable_prekron,
        )


def _unfused_batched_plan(n: int, m: int) -> KronPlan:
    """``plan=None`` for the per-sample path: one batched sliced multiply per
    factor (the paper-faithful loop, batch-dispatched)."""
    t_m = min(m, 8)
    while m % t_m:
        t_m -= 1
    return KronPlan(tuple(Stage((i,), False, TileConfig(t_m, 1, 1)) for i in range(n)))


# ---------------------------------------------------------------------------
# Per-factor building blocks (batch-polymorphic: 2-D and per-sample 3-D)
# ---------------------------------------------------------------------------


def _conservative_batched_tiles(m: int, k: int, p: int, q: int) -> tuple[int, int]:
    """``(t_m, t_k)`` for a single-factor batched instruction at ``t_b=1``
    whose live set ``t_m * t_k * max(1, q/p)`` fits the per-block budget
    (``emit.SMEM_BUDGET_ELEMS``), the largest ``t_k`` at up to 8 rows.  They
    bound the chain kernel's block tile, which its own rule
    (``emit.block_tile``) picks inside them.  The ladder's per-factor rung
    and the backward fallbacks run on them, so they must not overflow where
    anything fits: rows shrink before slices, and at one row and one slice
    the geometry check, not this function, reports the overflow."""
    budget = emit.SMEM_BUDGET_ELEMS
    growth = max(1.0, q / p)
    rows = [d for d in _divisors(m) if d <= 8]
    t_m = max((d for d in rows if d * p * growth <= budget), default=1)
    s = k // p
    t_s = max((d for d in _divisors(s) if t_m * d * p * growth <= budget), default=1)
    return t_m, t_s * p


def _sliced_batched(y: torch.Tensor, f: torch.Tensor, backend: str) -> torch.Tensor:
    """One sliced multiply, batch-polymorphic: 2-D operands run the sliced
    kernel (``ops.sliced_multiply``); per-sample 3-D operands run a batched
    chain-of-one instruction (the chain kernel) on conservative tiles."""
    if f.ndim == 2:
        return ops.sliced_multiply(y, f, backend=backend)
    p, q = int(f.shape[1]), int(f.shape[2])
    t_m, t_k = _conservative_batched_tiles(int(y.shape[1]), int(y.shape[2]), p, q)
    instr = emit.StageInstr(kind=emit.MULTIPLY, ps=(p,), qs=(q,), t_m=t_m, t_k=t_k, t_b=1)
    return emit.run_stage(y, (f,), instr, backend=backend)


def _sliced_t_batched(g: torch.Tensor, f: torch.Tensor, backend: str) -> torch.Tensor:
    """Transposed twin of ``_sliced_batched`` (the input has Q-sized slices,
    dX P-sized ones): the transposed sliced kernel for 2-D operands, a
    batched transposed chain-of-one for per-sample 3-D ones."""
    if f.ndim == 2:
        return ops.sliced_multiply_t(g, f, backend=backend)
    p, q = int(f.shape[1]), int(f.shape[2])
    t_m, t_k = _conservative_batched_tiles(int(g.shape[1]), int(g.shape[2]) // q * p, p, q)
    instr = emit.StageInstr(
        kind=emit.TRANSPOSED_MULTIPLY, ps=(p,), qs=(q,), t_m=t_m, t_k=t_k, t_b=1
    )
    return emit.run_stage(g, (f,), instr, backend=backend)


def _prekron_vjp(dk: torch.Tensor, stage_factors: Sequence[torch.Tensor]) -> tuple:
    """Split the cotangent of kron(rev[i+1], ..., rev[i]) back into
    per-factor cotangents, in ``stage_factors`` (application) order; per
    sample for 3-D ``dk`` and factors."""
    stage_factors = tuple(stage_factors)
    if len(stage_factors) == 1:
        return (dk,)
    a = stage_factors[0]
    b = emit.prekron_product(stage_factors[1:])
    pa, qa = int(a.shape[-2]), int(a.shape[-1])
    pb, qb = int(b.shape[-2]), int(b.shape[-1])
    acc = emit.acc_dtype_for(dk.dtype)
    dk4 = dk.reshape(*dk.shape[:-2], pb, pa, qb, qa).to(acc)
    da = torch.einsum("...bpcq,...bc->...pq", dk4, b.to(acc))
    db = torch.einsum("...bpcq,...pq->...bc", dk4, a.to(acc))
    return (da,) + _prekron_vjp(db, stage_factors[1:])


# ---------------------------------------------------------------------------
# Program-driven backward (one implementation for single and batched)
# ---------------------------------------------------------------------------

# Stages whose backward took the per-factor fallback: +1 per stage, nowhere
# else.
bwd_per_factor_fallbacks = 0

# Capacity failures: the geometry checks raise these before any launch.  A
# failed build or launch raises RuntimeError and a non-finite value under
# policy "raise" NumericsError; no fallback catches those.
_FALLBACK_ERRORS = (VmemOverflowError, LoweringError)


def _per_factor_bwd(u, g, stage_factors, backend, factors: bool):
    """Backward of a chain of sliced multiplies (``stage_factors`` in
    application order), one kernel per factor, batch-polymorphic: (dx, dfs
    in application order or None).  It is the unfused loop's backward
    (``plan=None``) and the fallback of a stage whose one-launch backward
    cannot fit one block (e.g. Q-tiled stages: the forward tiles Q, but the
    backward needs every factor-gradient pair).  With factor grads the
    chain's inputs are rematerialized, one sliced multiply each."""
    inputs = [u]
    if factors:
        for f in stage_factors[:-1]:
            inputs.append(_sliced_batched(inputs[-1], f, backend))
    dfs = [None] * len(stage_factors)
    for idx in reversed(range(len(stage_factors))):  # last applied first
        f = stage_factors[idx]
        if factors:
            dfs[idx] = emit.sliced_vjp_factor(inputs[idx], g, int(f.shape[-2]), int(f.shape[-1]))
        g = _sliced_t_batched(g, f, backend)
    return g, (tuple(dfs) if factors else None)


def _fallback_bwd(u, g, stage_factors, backend, factors: bool, exc: BaseException):
    """``_per_factor_bwd`` for a planned stage, counted as a fallback and
    recorded as a ``bwd_per_factor`` guard event."""
    global bwd_per_factor_fallbacks
    bwd_per_factor_fallbacks += 1
    guard.record_event("bwd_per_factor", exc)
    return _per_factor_bwd(u, g, stage_factors, backend, factors)


def _program_bwd(plan: KronPlan, backend: str, x, factors, g, f_pert: bool,
                 batched: bool = False):
    """Execute the backward of a lowered plan: (dx, dfs_by_rev_id or None).

    The dx chain is ``emit.transpose`` of the forward program; batched vs
    single is carried by the program's ``t_b`` and the operands' rank.  When
    factor grads are needed, the stage inputs are rematerialized with the
    FORWARD program and each transposed instruction is replaced by the
    one-launch stage backward (``emit.run_stage_grad``), falling back to
    per-factor kernels when the stage's tiles fail the geometry checks.
    Without factor grads the stage inputs are never used, so they are not
    rematerialized.
    """
    ps, qs = _signature(factors)
    prog = _lowered(plan, ps, qs, batched)
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
                except _FALLBACK_ERRORS as e:
                    g, (dk,) = _fallback_bwd(stage_inputs[fwd_idx], g, (fk,), backend, True, e)
                for fid, d in zip(f_ins.factor_ids, _prekron_vjp(dk, sf)):
                    dfs_by_id[fid] = d
            else:
                try:
                    g = emit.run_stage(g, (fk,), pk_ins.transpose(), backend=backend)
                except _FALLBACK_ERRORS as e:
                    g, _ = _fallback_bwd(None, g, (fk,), backend, False, e)
        elif f_pert:
            try:
                # The forward stage shape with the transposed instruction's
                # tuned M-tile (plan.bwd_stages via transpose()).
                g, dfs = emit.run_stage_grad(
                    stage_inputs[fwd_idx], g, sf,
                    dataclasses.replace(f_ins, t_m=t_ins.t_m), backend=backend,
                )
            except _FALLBACK_ERRORS as e:
                g, dfs = _fallback_bwd(stage_inputs[fwd_idx], g, sf, backend, True, e)
            for fid, d in zip(f_ins.factor_ids, dfs):
                dfs_by_id[fid] = d
        else:
            try:
                g = emit.run_stage(g, sf, t_ins, backend=backend)
            except _FALLBACK_ERRORS as e:
                # The planner validated tiles against FORWARD block sizes;
                # the transposed shapes can overflow.
                g, _ = _fallback_bwd(None, g, sf, backend, False, e)
    return g, (dfs_by_id if f_pert else None)


# ---------------------------------------------------------------------------
# The forward: degradation ladder
# ---------------------------------------------------------------------------


def _fwd_ladder(x, factors, plan: KronPlan, backend: str, batched: bool):
    """The per-op forward degradation ladder:

      rung 0  planned      the lowered StageProgram (one chain launch per stage)
      rung 1  per-factor   one conservatively tiled sliced multiply per factor:
                           the sliced kernel for 2-D factors, chain-of-one
                           launches of the chain kernel for per-sample ones
      rung 2  torch-eager  the whole chain through ``emit.chain_reference``,
                           the kernels' plain twins; only where the backend
                           already is ``torch`` (CPU tensors, or an explicit
                           ``backend="torch"``)

    On the card the ladder ends at the per-factor kernels and re-raises
    their error: a call on CUDA tensors runs the kernels or fails, never the
    plain twins in their place.

    Run under ``guard.run_ladder``, keyed on the resolved backend: a typed
    failure degrades THE CALL with a once-per-process warning; ``patience``
    consecutive degraded calls pin the op's signature to the surviving
    rung.  Every rung computes the same contraction; only the rounding of
    the sums differs where rungs run different kernels.

    Only CAPACITY failures degrade (``VmemOverflowError``,
    ``LoweringError``): a ``NumericsError`` means the DATA is bad, and every
    rung would compute the same non-finite values.
    """
    ps, qs = _signature(factors)
    prog = _lowered(plan, ps, qs, batched)
    resolved = emit.resolve_backend(backend, x)

    def _planned():
        return emit.run_program(x, factors, prog, backend=resolved)

    def _per_factor():
        chaos.maybe_fail("per_factor")
        y = x
        for f in reversed(factors):
            y = _sliced_batched(y, f, resolved)
        return guard.check_finite(y, "per_factor")

    rungs = [("planned", _planned), ("per-factor", _per_factor)]
    if resolved == "torch":
        rungs.append(("torch-eager", lambda: guard.check_finite(
            emit.chain_reference(x, *reversed(factors)), "torch_eager")))
    return guard.run_ladder(
        ("kron", ps, qs, resolved, batched), rungs, catch=_FALLBACK_ERRORS
    )


def _kron_forward(x, factors, plan: KronPlan | None, backend: str, batched: bool):
    if plan is None:
        # Paper-faithful unfused loop (the C1 baseline): application order is
        # last factor first (Algorithm 1).
        y = x
        for f in reversed(factors):
            y = ops.sliced_multiply(y, f, backend=backend)
        return y
    return _fwd_ladder(x, factors, plan, backend, batched)


# ---------------------------------------------------------------------------
# The autograd.Function: forward, backward and the vmap rules
# ---------------------------------------------------------------------------


class _PlanCtx(NamedTuple):
    """Static re-planning context carried into the vmap rules, so they can
    resolve the right plan for the transformed problem."""

    auto: bool  # plan came from the planner (re-plan on reshape) vs explicit
    prekron: bool


def _front(a: torch.Tensor, d: int | None, size: int) -> torch.Tensor:
    """Move the mapped axis to the front, or broadcast an unmapped operand."""
    if d is None:
        return a.expand(size, *a.shape)
    return a.movedim(d, 0)


class _KronFunction(torch.autograd.Function):
    """``x @ (F^1 (x) ... (x) F^N)`` through the planned kernels.

    ``batched=False``: x ``(M, K)`` with 2-D factors; ``batched=True``: x
    ``(B, M, K)`` with per-sample 3-D factors under a per-sample plan.  The
    forward runs the ladder (or the unfused loop for ``plan=None``); the
    backward is ``_program_bwd`` (or ``_per_factor_bwd`` for ``plan=None``),
    factor gradients only when autograd asks for them; the residuals are x
    and the factors.  ``vmap`` is the reference's custom batching rules."""

    @classmethod
    def apply(cls, *args):
        # Outside a functorch transform, go straight to the C++ apply:
        # ``Function.apply`` binds the arguments through ``inspect.signature``
        # on every call in the ``setup_context`` form, which doubles the host
        # time of a small call.  Every call here is positional and the
        # forward has no defaults, so the binding changes nothing.
        if torch._C._are_functorch_transforms_active():
            return super().apply(*args)
        return super(torch.autograd.Function, cls).apply(*args)

    @staticmethod
    def forward(x, plan, backend, pctx, batched, *factors):
        return _kron_forward(x, factors, plan, backend, batched)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, plan, backend, _, batched, *factors = inputs
        ctx.save_for_backward(x, *factors)
        ctx.plan, ctx.backend, ctx.batched = plan, backend, batched

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        x, *factors = ctx.saved_tensors
        factors = tuple(factors)
        need = ctx.needs_input_grad[5:]
        f_pert = any(need)
        g = grad_out.contiguous()
        if ctx.plan is None:
            # The unfused loop applied the last factor first.
            dx, dfs = _per_factor_bwd(x, g, factors[::-1], ctx.backend, f_pert)
            dfactors = dfs[::-1] if f_pert else None
        else:
            dx, dfs_by_id = _program_bwd(
                ctx.plan, ctx.backend, x, factors, g, f_pert, ctx.batched
            )
            nf = len(factors)
            dfactors = tuple(dfs_by_id[nf - 1 - j] for j in range(nf)) if f_pert else None
        dx = dx.to(x.dtype) if ctx.needs_input_grad[0] else None
        if dfactors is None:
            dfactors = (None,) * len(factors)
        else:
            dfactors = tuple(
                d.to(f.dtype) if n else None for d, f, n in zip(dfactors, factors, need)
            )
        return (dx, None, None, None, None, *dfactors)

    @staticmethod
    def vmap(info, in_dims, x, plan, backend, pctx, batched, *factors):
        """``torch.func.vmap`` over a call.

        * only ``x`` mapped (shared factors): the batch is a row-parallel
          axis, so it folds into M and the single-problem path runs on the
          ``(B*M, K)`` rows, planned again for that row count when the plan
          was auto-resolved;
        * any factor mapped (per-sample factors): the per-sample batched
          path under a batched plan, the same plan a
          ``KronOp(batch=B, shared_factors=False)`` call resolves;
        * over an already batched call (nested vmap): the new axis folds
          into the existing batch axis (C problems of B samples are one
          batch of C*B samples).
        """
        size = info.batch_size
        xd, fds = in_dims[0], in_dims[5:]
        xb = _front(x, xd, size)
        ps, qs = _signature(factors)
        itemsize = x.element_size()
        if not batched and all(d is None for d in fds):
            m = int(xb.shape[1])
            p2 = plan
            if pctx.auto and plan is not None:
                p2 = _resolve_plan(size * m, ps, qs, itemsize, pctx.prekron)
            y = _KronFunction.apply(
                xb.reshape(size * m, -1), p2, backend, pctx, False, *factors
            )
            return y.reshape(size, m, -1), 0
        fbs = tuple(_front(f, d, size) for f, d in zip(factors, fds))
        if not batched:
            m = int(xb.shape[1])
            if plan is None:
                p2 = _unfused_batched_plan(len(factors), m)
            elif pctx.auto:
                p2 = _resolve_batched_plan(size, m, ps, qs, itemsize, pctx.prekron)
            else:
                p2 = plan
            return _KronFunction.apply(xb, p2, backend, pctx, True, *fbs), 0
        b, m = int(xb.shape[1]), int(xb.shape[2])
        p2 = (
            _resolve_batched_plan(size * b, m, ps, qs, itemsize, pctx.prekron)
            if pctx.auto else plan
        )
        y = _KronFunction.apply(
            xb.reshape(size * b, m, -1), p2, backend, pctx, True,
            *(f.reshape(size * b, *f.shape[2:]) for f in fbs),
        )
        return y.reshape(size, b, m, -1), 0


# ---------------------------------------------------------------------------
# KronOp
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KronCost:
    """Analytic per-call cost of a KronOp (``KronOp.cost()``).  Local ops
    move nothing between devices: ``comm_elems_per_device`` and ``rounds``
    are 0 until the mesh slice."""

    flops: int
    comm_elems_per_device: int = 0
    rounds: int = 0


_OP_STATE_SIZE = 8  # per-op (rows, dtype) -> plan entries kept


def signature_of(
    factors: Sequence[torch.Tensor], shared_factors: bool
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(ps, qs) of a factor list, validating the ndim for the sharing mode."""
    factors = tuple(factors)
    if not factors:
        raise ValueError("need at least one factor")
    if shared_factors:
        if any(f.ndim != 2 for f in factors):
            raise ValueError("shared_factors=True expects 2-D (P_i, Q_i) factors")
        return _signature(factors)
    if any(f.ndim != 3 for f in factors):
        raise ValueError("shared_factors=False expects 3-D (B, P_i, Q_i) factors")
    return _signature(factors)


class KronOp:
    """A Kron-Matmul problem resolved into an executable operator.

    ``KronOp(ps, qs)`` describes ``x @ (F^1 (x) ... (x) F^N)`` with factor
    shapes ``F^i: (P_i, Q_i)``.

    Parameters
    ----------
    ps, qs : factor row/column dims, problem order.
    m : optional row count the plan is resolved for at construction (rows
        per sample for a batched op).  When omitted, plans resolve on first
        call per distinct row count and ``.plan`` defaults to the paper's
        M=16 CG-block row count.
    batch : B for the batched modes; None = single problem.
    shared_factors : with ``batch``: one 2-D factor set for every sample
        (B folds into the rows) vs per-sample 3-D ``(B, P_i, Q_i)`` factors
        (``make_batched_plan``'s per-sample plan).
    backend : ``"auto"`` (by the tensors' device), ``"cuda"`` or ``"torch"``.
    plan : ``"auto"``, ``None`` (paper-faithful unfused loop) or a
        ``KronPlan``.
    tune, cache_path : ``"analytic"`` and None; the measured planner and the
        plan cache raise ``NotImplementedError`` (``autotune.MEASURED_SLICE``).
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
        tune: str = "analytic",
        cache_path: str | None = None,
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
        if isinstance(plan, str) and plan != "auto":
            raise ValueError(f"plan must be 'auto', None, or a KronPlan: {plan!r}")
        if backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}: 'auto', 'cuda' or 'torch'")
        if tune == "measure" or cache_path is not None:
            raise NotImplementedError(autotune.MEASURED_SLICE)
        if tune != "analytic":
            raise guard.PlanError(f"unknown tune mode {tune!r}")
        self.n = len(self.ps)
        self.k = math.prod(self.ps)
        self.k_out = math.prod(self.qs)
        self.batch = batch
        self.shared_factors = bool(shared_factors)
        self.backend = backend
        self._m = m
        self._dtype_bytes = dtype_bytes
        self._plan_arg = plan
        self._enable_prekron = enable_prekron
        prekron = _auto_prekron() if enable_prekron is None else bool(enable_prekron)
        self._ctx = _PlanCtx(plan == "auto", prekron)
        # Op-owned resolved state: (mode, rows or (b, m), dtype_bytes) -> plan.
        self._plans: dict = {}
        if m is not None:
            if self._per_sample:
                self._batched_plan(batch, m, dtype_bytes)
            else:
                self._single_plan(m if batch is None else batch * m, dtype_bytes)

    @property
    def _per_sample(self) -> bool:
        return self.batch is not None and not self.shared_factors

    # -- plan resolution (op-owned, bounded) ---------------------------------

    def _remember(self, key, resolve):
        if key not in self._plans:
            self._plans[key] = resolve()
            while len(self._plans) > _OP_STATE_SIZE:
                self._plans.pop(next(iter(self._plans)))
        return self._plans[key]

    def _single_plan(self, rows: int, dtype_bytes: int) -> KronPlan | None:
        def resolve():
            if self._plan_arg == "auto":
                return _resolve_plan(rows, self.ps, self.qs, dtype_bytes, self._ctx.prekron)
            return self._plan_arg

        return self._remember(("single", rows, dtype_bytes), resolve)

    def _batched_plan(self, b: int, m: int, dtype_bytes: int) -> KronPlan:
        def resolve():
            if self._plan_arg == "auto":
                return _resolve_batched_plan(
                    b, m, self.ps, self.qs, dtype_bytes, self._ctx.prekron
                )
            if self._plan_arg is None:
                return _unfused_batched_plan(self.n, m)
            return self._plan_arg

        return self._remember(("batched", b, m, dtype_bytes), resolve)

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
        if self._per_sample:
            return self._batched_plan(self.batch, m, self._dtype_bytes)
        rows = m if self.batch is None else self.batch * m
        return self._single_plan(rows, self._dtype_bytes)

    # -- derivations --------------------------------------------------------

    def with_batch(
        self, batch: int | None, *, shared_factors: bool | None = None
    ) -> "KronOp":
        """The same problem over ``batch`` independent samples (sharing mode
        kept unless given).

        The row-count hint is dropped: a single op's ``m`` is total rows while
        a batched op's ``m`` is rows per sample."""
        return KronOp(
            self.ps, self.qs, m=None, batch=batch,
            shared_factors=self.shared_factors if shared_factors is None else shared_factors,
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
        if self._per_sample:
            return KronCost(b * KronProblem(m, self.ps, self.qs).flops)
        return KronCost(KronProblem(b * m, self.ps, self.qs).flops)

    def describe(self) -> str:
        mode = "batched" if self.batch is not None else "single"
        shared = "" if self.batch is None else (
            ", shared" if self.shared_factors else ", per-sample"
        )
        plan = self.plan
        pdesc = plan.describe() if plan is not None else "unfused"
        base = (
            f"KronOp(ps={list(self.ps)}, qs={list(self.qs)}, {mode}{shared}, "
            f"local, backend={self.backend}) :: {pdesc}"
        )
        return base + self._health_suffix() + self._telemetry_suffix()

    def _telemetry_suffix(self) -> str:
        """One-line KronScope state while telemetry is live; empty when off,
        so ``describe()`` stays byte-stable for untelemetered processes."""
        if not telemetry.active():
            return ""
        return " :: " + telemetry.summary_line()

    def _health_suffix(self) -> str:
        """Guard-layer health for this op's signature: empty while healthy,
        a ``:: guard[...]`` tail once any ladder keyed on (ps, qs) degraded."""
        parts = []
        for key, h in guard.health_entries():
            if (
                isinstance(key, tuple)
                and len(key) >= 3
                and key[1] == self.ps
                and key[2] == self.qs
                and (h.degraded_calls or h.pinned or h.errors)
            ):
                rung = f"rung={h.rung}{' pinned' if h.pinned else ''}"
                errs = ",".join(f"{k}x{v}" for k, v in sorted(h.errors.items()))
                parts.append(
                    f"{key[0]}: {rung} degraded={h.degraded_calls}/{h.calls}"
                    + (f" [{errs}]" if errs else "")
                )
        return f" :: guard[{'; '.join(parts)}]" if parts else ""

    def __repr__(self) -> str:
        return self.describe()

    # -- execution -----------------------------------------------------------

    def _check_factors(self, x: torch.Tensor, factors: tuple[torch.Tensor, ...]):
        ps, qs = signature_of(factors, not self._per_sample)
        if (ps, qs) != (self.ps, self.qs):
            raise ValueError(
                f"factor shapes {ps}x{qs} do not match op signature "
                f"{self.ps}x{self.qs}"
            )
        for f in factors:
            if self._per_sample and int(f.shape[0]) != self.batch:
                raise ValueError(f"factor batch {f.shape[0]} != x batch {self.batch}")
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
        size = x.element_size()
        if self.batch is None:
            lead = x.shape[:-1]
            rows = math.prod(lead) if lead else 1
            plan = self._single_plan(rows, size)
            y = _KronFunction.apply(
                x.reshape(rows, self.k), plan, self.backend, self._ctx, False, *factors
            )
            return y.reshape(*lead, self.k_out)
        if x.ndim < 2 or int(x.shape[0]) != self.batch:
            raise ValueError(
                f"batched op expects x (B={self.batch}, ..., K), got {tuple(x.shape)}"
            )
        b = self.batch
        lead = x.shape[1:-1]
        m = math.prod(lead) if lead else 1
        if self.shared_factors:
            # B folds into M: both are row indices of the same contiguous array.
            plan = self._single_plan(b * m, size)
            y = _KronFunction.apply(
                x.reshape(b * m, self.k), plan, self.backend, self._ctx, False, *factors
            )
        else:
            plan = self._batched_plan(b, m, size)
            y = _KronFunction.apply(
                x.reshape(b, m, self.k), plan, self.backend, self._ctx, True, *factors
            )
        return y.reshape(b, *lead, self.k_out)


# ---------------------------------------------------------------------------
# Bounded op factory (the shim path) + deprecation bookkeeping
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def kron_op_for(
    ps: tuple[int, ...],
    qs: tuple[int, ...],
    *,
    m: int | None = None,
    batch: int | None = None,
    shared_factors: bool = True,
    backend: str = "auto",
    plan: KronPlan | str | None = "auto",
    tune: str = "analytic",
    cache_path: str | None = None,
    dtype_bytes: int = 4,
    enable_prekron: bool | None = None,
) -> KronOp:
    """Shared, bounded ``KronOp`` factory: same signature -> same op object.

    The cache behind the ``kron_matmul*`` shims and the consumers that key
    ops on runtime shapes.  Plans are also shared through the engine's
    bounded plan memo, so two distinct ops with one signature hold one plan.
    """
    return KronOp(
        ps, qs, m=m, batch=batch, shared_factors=shared_factors, backend=backend,
        plan=plan, tune=tune, cache_path=cache_path, dtype_bytes=dtype_bytes,
        enable_prekron=enable_prekron,
    )


def kron_precond_op(
    p: int, q: int, batch: int, *, dtype_bytes: int = 4, backend: str = "auto"
) -> KronOp:
    """The op behind one Kron-factored-preconditioner shape group.

    A Shampoo-style update ``P_l = A_l G_l B_l`` (per-layer root pairs
    ``A_l = L_l^{-1/4}``, ``B_l = R_l^{-1/4}``) over ``batch`` same-shape
    ``(p, q)`` layers is ONE per-sample batched Kron-Matmul: ``x =
    vec_row(G)`` stacked to ``(B, 1, p*q)``, ``factors = (A, B)`` stacked to
    ``((B, p, p), (B, q, q))``, since ``row @ (A (x) B) == vec_row(A^T G B)``
    and the roots are symmetric.  Resolved through ``kron_op_for``.

    Pre-kronization is forced OFF: densifying ``kron(A_l, B_l)`` is a
    ``(p*q)^2`` buffer per layer per step, the materialization the
    Kron-factored preconditioner exists to avoid.
    """
    if batch <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    return kron_op_for(
        (int(p), int(q)), (int(p), int(q)), m=1, batch=int(batch),
        shared_factors=False, backend=backend, dtype_bytes=dtype_bytes,
        enable_prekron=False,
    )


def warn_deprecated(name: str, hint: str) -> None:
    """Emit ONE DeprecationWarning per process per legacy entry point."""
    guard.warn_deprecated_once(
        name,
        f"{name} is deprecated: construct a repro_torch.core.KronOp once "
        f"({hint}) and call it; the shim re-dispatches through a bounded "
        "op cache on every call.",
    )


__all__ = [
    "KronOp",
    "KronCost",
    "kron_op_for",
    "kron_precond_op",
    "signature_of",
]
