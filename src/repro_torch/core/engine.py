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
per-sample plan.  ``tune="measure"`` resolves each plan by timing its
candidates on the device (``autotune.make_plan``) through the on-disk plan
cache; ``KronOp.profile`` times the forward program stage by stage against
the cost model.

On a ``DeviceMesh`` (``KronOp(ps, qs, mesh=mesh)``, ``op.with_mesh(mesh)``)
a call runs the paper's distributed round schedule
(``core.distributed``): a ``DTensor`` x placed rows over ``data_axis`` and
columns over ``model_axis`` comes back as a DTensor with its placements; a
plain tensor is taken as the full array every rank holds, sliced locally
and handed back replicated.  The mesh ladder runs the slab-pipelined
rounds, then the serial rounds, then the local op on the gathered x,
degrading on ``CollectiveError`` only.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Sequence

import torch

from ..kernels import emit, ops
from ..kernels.emit import divisors
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
    # 128x128 systolic array.  The card's chain kernel contracts one p at a
    # time on the CUDA cores, where the extra FLOPs are pure cost: measured
    # on an H100, a 16 x 16 pair's 256 x 256 product makes the GP forward
    # (M=16, six 16 x 16 factors) 6.6x slower, and 6.9x for four such
    # problems per sample (PERF.md §6).  So the auto-gate is off; an
    # explicit ``enable_prekron=True`` still plans and runs it.
    return False


_PLAN_MEMO_SIZE = 128


class _PlanCtx(NamedTuple):
    """Static re-planning context carried into the vmap rules, so they can
    resolve the right plan for the transformed problem."""

    auto: bool  # plan came from the planner (re-plan on reshape) vs explicit
    prekron: bool
    tune: str = "analytic"
    cache_path: str | None = None


def _auto_plan(m, ps, qs, dtype_bytes, pctx: _PlanCtx, backend: str, device) -> KronPlan:
    """The planner's plan for ``m`` rows: the memoized analytic plan, or the
    measured one (``tune="measure"``) on ``device`` through the plan cache,
    which is that path's memo."""
    if pctx.tune != "measure":
        return _resolve_plan(m, ps, qs, dtype_bytes, pctx.prekron)
    with telemetry.span("plan", m=m, ps=ps, qs=qs, tune="measure"):
        return autotune.make_plan(
            KronProblem(m, ps, qs), dtype_bytes=dtype_bytes, enable_prekron=pctx.prekron,
            tune="measure", backend=backend, cache_path=pctx.cache_path, device=device,
        )


def _auto_batched_plan(b, m, ps, qs, dtype_bytes, pctx: _PlanCtx, backend: str,
                       device) -> KronPlan:
    """``_auto_plan`` for the per-sample batched path."""
    if pctx.tune != "measure":
        return _resolve_batched_plan(b, m, ps, qs, dtype_bytes, pctx.prekron)
    with telemetry.span("plan", m=m, ps=ps, qs=qs, tune="measure", batch=b):
        return autotune.make_batched_plan(
            KronProblem(m, ps, qs), b, shared_factors=False, dtype_bytes=dtype_bytes,
            enable_prekron=pctx.prekron, tune="measure", backend=backend,
            cache_path=pctx.cache_path, device=device,
        )


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
    g_k: int = 1,
) -> KronPlan:
    """The analytic per-sample plan; ``g_k > 1`` the distributed plan of the
    local problem (``m`` = rows per rank), which carries ``n_slabs``."""
    with telemetry.span("plan", m=m, ps=ps, qs=qs, tune="analytic", batch=batch, g_k=g_k):
        return autotune.make_batched_plan(
            KronProblem(m, ps, qs), batch, shared_factors=False,
            dtype_bytes=dtype_bytes, enable_prekron=enable_prekron and g_k <= 1, g_k=g_k,
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
    rows = [d for d in divisors(m) if d <= 8]
    t_m = max((d for d in rows if d * p * growth <= budget), default=1)
    s = k // p
    t_s = max((d for d in divisors(s) if t_m * d * p * growth <= budget), default=1)
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


def _sliced_vjp_factor(u: torch.Tensor, g: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """df[p,q] = sum_{m,s} u[m, s*P+p] g[m, q*S+s] (one ``torch.einsum``, in
    the accumulator dtype); per-sample ``(B, P, Q)`` grads when ``u`` and
    ``g`` carry a leading batch axis.  The mesh backward's factor
    gradient."""
    return emit.sliced_vjp_factor(u, g, p, q)


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
        # The backward entry's span, on the autograd engine's thread.
        with telemetry.span("op_bwd"):
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
                p2 = _auto_plan(size * m, ps, qs, itemsize, pctx, backend, x.device)
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
                p2 = _auto_batched_plan(size, m, ps, qs, itemsize, pctx, backend, x.device)
            else:
                p2 = plan
            return _KronFunction.apply(xb, p2, backend, pctx, True, *fbs), 0
        b, m = int(xb.shape[1]), int(xb.shape[2])
        p2 = (
            _auto_batched_plan(size * b, m, ps, qs, itemsize, pctx, backend, x.device)
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
    """Analytic per-call cost of a KronOp (``KronOp.cost()``).

    Local ops move nothing between devices (``comm_elems_per_device`` and
    ``rounds`` 0).  On a mesh: the all-to-all payload (elements sent per
    device, all rounds), the round count, the share of the payload the
    slab pipeline can hide under chain compute (``comm_hidden_elems``, an
    upper bound), the resolved slab count, and the critical-path estimate:
    per-device compute at the dtype's rate, the exposed transfer at
    ``autotune.NVLINK_BW`` and one ``A2A_LATENCY_S`` per collective."""

    flops: int
    comm_elems_per_device: int = 0
    rounds: int = 0
    comm_hidden_elems: int = 0
    n_slabs: int = 1
    critical_path_s: float = 0.0


def _stage_flops_bytes(
    y_shape: Sequence[int], instr: emit.StageInstr, dtype_bytes: int
) -> tuple[int, int]:
    """Analytic (flops, bytes) of one stage launch on input ``y_shape``.

    Flops follow the sliced-multiply count (``KronProblem.flops``, per
    chained factor); bytes are the input and output plus the factor panels,
    the two quantities the planner's model trades, so ``profile()`` drift is
    measured against the model that chose the plan."""
    rows = math.prod(int(d) for d in y_shape[:-1]) or 1
    k = int(y_shape[-1])
    if instr.kind == emit.PREKRON:
        pairs = [(instr.pprod, instr.qprod)]
    else:
        pairs = list(zip(instr.ps, instr.qs))
    factor_elems = sum(p * q for p, q in zip(instr.ps, instr.qs))
    flops = 0
    cur = k
    for p, q in pairs:
        out = (cur // p) * q
        flops += 2 * rows * out * p
        cur = out
    return flops, (rows * k + rows * cur + factor_elems) * dtype_bytes


def _stage_drift(
    measured: Sequence[float], predicted: Sequence[float], threshold: float
) -> list[bool]:
    """Per-stage cost-model drift flags for ``KronOp.profile()``.

    An absolute measured/predicted ratio is calibration, not drift: what the
    model promises is the split of time across stages.  So each stage's
    ratio is normalised by the whole program's and flagged when it deviates
    by more than ``threshold`` times either way."""
    total_m = sum(measured)
    total_p = sum(predicted)
    if total_m <= 0 or total_p <= 0 or threshold <= 0:
        return [False] * len(list(measured))
    overall = total_m / total_p
    flags = []
    for m_i, p_i in zip(measured, predicted):
        if p_i <= 0:
            flags.append(m_i > 0)
            continue
        drift = (m_i / p_i) / overall
        flags.append(drift > threshold or drift < 1.0 / threshold)
    return flags


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
    tune : ``"analytic"`` (the cost model) or ``"measure"`` (with
        ``plan="auto"``: each plan is ranked by the time of its candidates'
        forward and full backward and kept in the plan cache at
        ``cache_path``, default ``autotune.default_cache_path()``).
    device : where a measured plan is timed when no tensor is at hand (a
        plan resolved at construction, or ``.plan`` before any call);
        default the card.  A call measures on its tensors' device.
    enable_prekron : None keeps the auto-gate (``_auto_prekron``); an
        explicit bool overrides it.
    mesh : a ``DeviceMesh`` with dims ``data_axis`` (a name or a tuple of
        names) and ``model_axis``: calls run the distributed round schedule
        (``core.distributed``), validated at construction (``ValueError``
        when ``K`` does not divide over the model axis, ``PlanError`` when
        no legal relocation schedule exists).  ``per_iteration=True``
        relocates after every factor (the CTF/DISTAL baseline).
    n_slabs : row slabs of the mesh round pipeline: ``"auto"`` lets the
        planner decide (a per-sample op's plan carries it as
        ``KronPlan.n_slabs``; otherwise ``autotune.choose_n_slabs``), an int
        forces it, clamped to a divisor of the local rows.  Ignored
        off-mesh.

    On a mesh a call is held to ``autotune.device_memory_budget`` of its
    tensors' device (the card's memory less ``MEMORY_RESERVE_BYTES``; no
    bound off the card): ``"auto"`` slab counts are chosen among those whose
    working set fits (``autotune.choose_n_slabs``), and a rung of the mesh
    ladder that cannot fit raises ``PlanError`` naming the sizes instead of
    running.
    """

    def __init__(
        self,
        ps: Sequence[int],
        qs: Sequence[int],
        *,
        m: int | None = None,
        batch: int | None = None,
        shared_factors: bool = True,
        mesh=None,
        data_axis: str | tuple[str, ...] = "data",
        model_axis: str = "model",
        per_iteration: bool = False,
        backend: str = "auto",
        plan: KronPlan | str | None = "auto",
        tune: str = "analytic",
        cache_path: str | None = None,
        dtype_bytes: int = 4,
        enable_prekron: bool | None = None,
        device: str | torch.device | None = None,
        n_slabs: int | str = "auto",
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
        if tune not in ("analytic", "measure"):
            raise guard.PlanError(f"unknown tune mode {tune!r}")
        if isinstance(n_slabs, str):
            if n_slabs != "auto":
                raise ValueError(f"n_slabs must be 'auto' or an int: {n_slabs!r}")
        elif int(n_slabs) <= 0:
            raise ValueError(f"n_slabs must be positive, got {n_slabs}")
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
        self._device = device
        self._default_device = None
        self._measure = tune == "measure"
        prekron = _auto_prekron() if enable_prekron is None else bool(enable_prekron)
        self._ctx = _PlanCtx(plan == "auto", prekron, tune, cache_path)
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.per_iteration = bool(per_iteration)
        self._n_slabs_arg = n_slabs if n_slabs == "auto" else int(n_slabs)
        self._slabs: dict = {}  # (m_loc, dtype_bytes, budget) -> the "auto" slab count
        self._local = None  # the mesh ladder's last rung (``_local_op``)
        if mesh is not None:
            from .distributed import _mesh_size, plan_rounds

            self.g_m = _mesh_size(mesh, data_axis)
            self.g_k = _mesh_size(mesh, model_axis)
            if self.k % self.g_k:
                raise ValueError(f"K={self.k} not divisible by model axis G_K={self.g_k}")
            # The round schedule, resolved (and validated) at construction.
            self.rounds = tuple(plan_rounds(
                self.k // self.g_k, self.ps[::-1], self.qs[::-1], self.g_k,
                minimal=self.per_iteration,
            ))
        else:
            self.g_m = self.g_k = 1
            self.rounds = None
        # Op-owned resolved state: (mode, rows or (b, m), dtype_bytes) -> plan.
        self._plans: dict = {}
        if m is not None and mesh is None:
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

    def _measured_on(self, device: torch.device | None) -> torch.device | None:
        """The device a measured plan is timed on, part of its memo key (a
        measured plan belongs to its device): a call's tensors' device, or
        the op's ``device`` (default the card); None when not measuring."""
        if not self._measure:
            return None
        if device is not None:
            return device
        if self._default_device is None:
            self._default_device = autotune.measure_device(self._device)
        return self._default_device

    def _single_plan(self, rows: int, dtype_bytes: int, device=None) -> KronPlan | None:
        device = self._measured_on(device)

        def resolve():
            if self._plan_arg == "auto":
                return _auto_plan(rows, self.ps, self.qs, dtype_bytes, self._ctx,
                                  self.backend, device)
            return self._plan_arg

        return self._remember(("single", rows, dtype_bytes, device), resolve)

    def _batched_plan(self, b: int, m: int, dtype_bytes: int, device=None) -> KronPlan:
        device = self._measured_on(device)

        def resolve():
            if self._plan_arg == "auto":
                return _auto_batched_plan(b, m, self.ps, self.qs, dtype_bytes, self._ctx,
                                          self.backend, device)
            if self._plan_arg is None:
                return _unfused_batched_plan(self.n, m)
            return self._plan_arg

        return self._remember(("batched", b, m, dtype_bytes, device), resolve)

    def _mesh_batched_plan(self, b: int, m_loc: int, dtype_bytes: int, device) -> KronPlan:
        """The per-sample mesh op's plan for ``m_loc`` rows per rank: the
        distributed plan (``make_batched_plan(g_k=G_K)``), measured on the
        op's own mesh under ``tune="measure"`` (the plan cache's ``;gk=``
        entry is that path's memo)."""

        def resolve():
            if self._plan_arg == "auto":
                if self._measure:
                    with telemetry.span("plan", m=m_loc, ps=self.ps, qs=self.qs,
                                        tune="measure", batch=b, g_k=self.g_k):
                        return autotune.make_batched_plan(
                            KronProblem(m_loc, self.ps, self.qs), b, shared_factors=False,
                            dtype_bytes=dtype_bytes, tune="measure", backend=self.backend,
                            cache_path=self._ctx.cache_path, g_k=self.g_k, mesh=self.mesh,
                            data_axis=self.data_axis, model_axis=self.model_axis,
                            device=device,
                        )
                return _resolve_batched_plan(b, m_loc, self.ps, self.qs, dtype_bytes,
                                             self._ctx.prekron, self.g_k)
            if self._plan_arg is None:
                return _unfused_batched_plan(self.n, m_loc)
            return self._plan_arg

        return self._remember(("mesh-batched", b, m_loc, dtype_bytes, device), resolve)

    def _rounds_bytes(self, m_loc: int, n: int, dtype_bytes: int) -> int:
        """One rank's working set of the forward rounds at ``n`` slabs."""
        from .distributed import round_working_set_bytes

        return round_working_set_bytes(
            m_loc, self.k // self.g_k, self.ps[::-1], self.qs[::-1], self.g_k, n_slabs=n,
            batch=self.batch if self._per_sample else 1, dtype_bytes=dtype_bytes,
            per_iteration=self.per_iteration)

    def _require_fit(self, what: str, need: int, device) -> None:
        budget = autotune.device_memory_budget(device)
        if budget is not None and need > budget:
            raise guard.PlanError(
                f"{what} of {self.ps}x{self.qs} on a {self.g_m}x{self.g_k} mesh needs "
                f"{need} bytes of one card, over its budget of {budget}")

    def _resolve_n_slabs(self, m_loc: int, dtype_bytes: int,
                         plan: KronPlan | None = None, device=None) -> int:
        """The round schedule's slab count for ``m_loc`` rows per rank: an
        explicit int, clamped to a divisor of the rows as the executor
        clamps it; under ``"auto"`` the per-sample plan's ``n_slabs``, else
        the analytic model (``autotune.choose_n_slabs``), in either case
        among the counts whose working set fits ``device``'s budget
        (``PlanError`` where none does).  Always 1 without a model axis to
        overlap."""
        if self.mesh is None or self.g_k <= 1 or m_loc <= 1:
            return 1
        if self._n_slabs_arg != "auto":
            return emit.effective_slabs(m_loc, int(self._n_slabs_arg))
        budget = autotune.device_memory_budget(device)
        if plan is not None:
            n = emit.effective_slabs(m_loc, int(plan.n_slabs))
            if budget is None or self._rounds_bytes(m_loc, n, dtype_bytes) <= budget:
                return n
        key = (m_loc, dtype_bytes, budget)
        if key not in self._slabs:
            b = self.batch if self._per_sample else 1
            while len(self._slabs) >= _OP_STATE_SIZE:
                self._slabs.pop(next(iter(self._slabs)))
            self._slabs[key] = emit.effective_slabs(m_loc, autotune.choose_n_slabs(
                KronProblem(m_loc, self.ps, self.qs), self.g_k, batch=b,
                dtype_bytes=dtype_bytes, memory_budget=budget,
                per_iteration=self.per_iteration,
            ))
        return self._slabs[key]

    def _default_rows(self) -> int:
        # The paper's M=16 CG-block row count when no row hint exists.
        return self._m if self._m is not None else 16

    @property
    def plan(self) -> KronPlan | None:
        """The op's resolved KronPlan (last resolved; resolves for the
        construction-time ``m`` or the M=16 default when none seen yet).

        Mesh ops on the single and shared path return None: that path runs
        the round schedule (``self.rounds``), not a stage plan.  Per-sample
        mesh ops resolve their distributed plan (which carries
        ``n_slabs``)."""
        if self.mesh is not None and not self._per_sample:
            return None
        if self._plans:
            return next(reversed(self._plans.values()))
        m = self._default_rows()
        if self._per_sample:
            if self.mesh is not None:
                return self._mesh_batched_plan(self.batch, max(1, m // self.g_m),
                                               self._dtype_bytes, self._measured_on(None))
            return self._batched_plan(self.batch, m, self._dtype_bytes)
        rows = m if self.batch is None else self.batch * m
        return self._single_plan(rows, self._dtype_bytes)

    # -- derivations --------------------------------------------------------

    def _derive(self, **changes) -> "KronOp":
        kw = dict(
            m=self._m, batch=self.batch, shared_factors=self.shared_factors, mesh=self.mesh,
            data_axis=self.data_axis, model_axis=self.model_axis,
            per_iteration=self.per_iteration, backend=self.backend, plan=self._plan_arg,
            tune=self._ctx.tune, cache_path=self._ctx.cache_path,
            dtype_bytes=self._dtype_bytes, enable_prekron=self._enable_prekron,
            device=self._device, n_slabs=self._n_slabs_arg,
        )
        kw.update(changes)
        return KronOp(self.ps, self.qs, **kw)

    def with_mesh(
        self, mesh, *, data_axis="data", model_axis="model", per_iteration: bool = False,
    ) -> "KronOp":
        """The same problem run as distributed rounds on ``mesh``."""
        return self._derive(mesh=mesh, data_axis=data_axis, model_axis=model_axis,
                            per_iteration=per_iteration)

    def with_batch(
        self, batch: int | None, *, shared_factors: bool | None = None
    ) -> "KronOp":
        """The same problem over ``batch`` independent samples (sharing mode
        kept unless given).

        The row-count hint is dropped: a single op's ``m`` is total rows while
        a batched op's ``m`` is rows per sample."""
        return self._derive(
            m=None, batch=batch,
            shared_factors=self.shared_factors if shared_factors is None else shared_factors,
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
        """Analytic cost of one call: the sliced-multiply FLOPs and, on a
        mesh, the all-to-all payload, its share the slab pipeline can hide,
        the slab count and the critical-path estimate (``KronCost``)."""
        m = m if m is not None else self._default_rows()
        b = self.batch or 1
        if self._per_sample:
            flops = b * KronProblem(m, self.ps, self.qs).flops
        else:
            flops = KronProblem(b * m, self.ps, self.qs).flops
        if self.mesh is None:
            return KronCost(flops)
        from .distributed import comm_elems_per_device, comm_hidden_elems

        rows = m if self._per_sample else b * m
        m_loc = max(1, rows // self.g_m)
        comm_batch = b if self._per_sample else 1
        ps_rev, qs_rev = self.ps[::-1], self.qs[::-1]
        k_loc = self.k // self.g_k
        comm = comm_elems_per_device(m_loc, k_loc, ps_rev, qs_rev, self.g_k,
                                     rounds=self.rounds, batch=comm_batch)
        plan = (self._mesh_batched_plan(b, m_loc, self._dtype_bytes, self._measured_on(None))
                if self._per_sample and self._plan_arg == "auto" and not self._measure
                else None)
        n = self._resolve_n_slabs(m_loc, self._dtype_bytes, plan)
        hidden = comm_hidden_elems(m_loc, k_loc, ps_rev, qs_rev, self.g_k,
                                   rounds=self.rounds, batch=comm_batch, n_slabs=n)
        critical = (
            flops / (self.g_m * self.g_k) / autotune.peak_flops(self._dtype_bytes)
            + (comm - hidden) * self._dtype_bytes / autotune.NVLINK_BW
            + len(self.rounds) * n * autotune.A2A_LATENCY_S
        )
        return KronCost(flops, comm, len(self.rounds), hidden, n, critical)

    def profile(
        self,
        x: torch.Tensor,
        factors: Sequence[torch.Tensor],
        *,
        warmup: int = 1,
        iters: int = 3,
        drift_threshold: float | None = None,
    ) -> dict:
        """Time the op's forward program stage by stage and compare the
        split with the planner's cost model.

        Each stage runs through ``emit.run_stage`` (the call
        ``run_program`` chains) and is timed alone, by CUDA events on the
        card and ``time.perf_counter`` on the CPU: the minimum over
        ``iters`` runs after ``warmup`` discarded ones.  A stage's
        prediction is ``flops / rate + bytes / HBM_BW``, the rate the CUDA
        cores' for the dtype (``autotune.peak_flops``), though the planned
        forward's f32 stages of factors at least 8 x 8 run ``chain_fwd`` on
        the tensor cores in 3xTF32 (``emit.chain_uses_tf32``): there the
        model overstates the FLOPs' time, and the bytes set the stage's.
        A stage whose measured share departs from its predicted share by
        more than ``drift_threshold`` (default
        ``telemetry.DRIFT_THRESHOLD``) either way is flagged
        (``_stage_drift``).  ``plan=None`` ops have no program and raise
        ``PlanError``.  With telemetry on, the report is stamped into the
        registry (``telemetry.mark_profile``) and each flagged stage emits
        a ``cost_model_drift`` event."""
        factors = tuple(factors)
        self._check_factors(x, factors)
        threshold = (
            telemetry.DRIFT_THRESHOLD if drift_threshold is None else float(drift_threshold)
        )
        op = self
        if self.mesh is not None:
            # Per-stage times inside the rounds are not the program's: a
            # mesh op profiles its local-equivalent plan on the gathered x,
            # with the collective cost as predicted-only under "comm".
            from torch.distributed.tensor import DTensor

            from .distributed import _local_factor, gather

            op = self._derive(mesh=None, m=None)
            x = gather(x) if isinstance(x, DTensor) else x
            factors = tuple(_local_factor(f) for f in factors)
        report = op._profile_stages(
            x, factors, warmup=int(warmup), iters=int(iters), threshold=threshold
        )
        if self.mesh is not None:
            cost = self.cost(report["signature"]["m"])
            report["signature"]["mesh"] = [self.g_m, self.g_k]
            report["comm"] = {
                "elems_per_device": cost.comm_elems_per_device,
                "rounds": cost.rounds,
                "n_slabs": cost.n_slabs,
                "hidden_elems": cost.comm_hidden_elems,
                "critical_path_s": cost.critical_path_s,
                "predicted_s": cost.comm_elems_per_device * self._dtype_bytes
                / autotune.NVLINK_BW,
                "measured_s": None,
            }
            # The gauges' hidden total (per round: total - max slab) equals
            # the model's payload - payload/n when the rounds ran the
            # schedule cost() predicts.
            tele = telemetry.comm_summary()
            if tele:
                report["comm"]["telemetry_hidden_elems"] = sum(
                    r["hidden"] for r in tele.values())
                report["comm"]["telemetry_rounds"] = tele
        telemetry.mark_profile(report)
        for i in report["drift_flagged"]:
            st = report["stages"][i]
            telemetry.event("cost_model_drift", stage=i, drift=st["drift"], instr=st["instr"])
        return report

    def _profile_stages(
        self, x: torch.Tensor, factors: tuple, *, warmup: int, iters: int, threshold: float
    ) -> dict:
        dtype_bytes = x.element_size()
        dev = x.device if self._measure else None
        if self._per_sample:
            b = self.batch
            m_rows = math.prod(int(d) for d in x.shape[1:-1]) or 1
            plan = self._batched_plan(b, m_rows, dtype_bytes, dev)
            batched = True
            y = x.detach().reshape(b, m_rows, self.k)
        else:
            rows = math.prod(int(d) for d in x.shape[:-1]) or 1
            plan = self._single_plan(rows, dtype_bytes, dev)
            batched = False
            y = x.detach().reshape(rows, self.k)
            m_rows = rows // (self.batch or 1)
        if plan is None:
            raise guard.PlanError(
                "profile() needs a planned op (plan='auto' or an explicit "
                "KronPlan): plan=None runs the paper-faithful unfused loop, "
                "which has no StageProgram to time stage by stage"
            )
        prog = _lowered(plan, self.ps, self.qs, batched)
        rev = tuple(f.detach() for f in reversed(factors))
        stages: list[dict] = []
        measured: list[float] = []
        predicted: list[float] = []
        with torch.no_grad(), telemetry.span("profile", ps=self.ps, qs=self.qs):
            for idx, instr in enumerate(prog.instrs):
                sf = tuple(rev[i] for i in instr.factor_ids)

                def run(y_in=y, sf=sf, instr=instr):
                    return emit.run_stage(y_in, sf, instr, backend=self.backend)

                for _ in range(max(0, warmup)):
                    run()
                best, out = float("inf"), None
                for _ in range(max(1, iters)):
                    dt, out = autotune.time_once(run, y.is_cuda)
                    best = min(best, dt)
                flops, nbytes = _stage_flops_bytes(y.shape, instr, dtype_bytes)
                rate = autotune.peak_flops(dtype_bytes)
                pred = flops / rate + nbytes / autotune.HBM_BW
                measured.append(best)
                predicted.append(pred)
                stages.append({
                    "stage": idx, "instr": instr.describe(),
                    "factor_ids": list(instr.factor_ids), "measured_s": best,
                    "predicted_s": pred, "flops": flops, "bytes": nbytes,
                    "kernel": "chain_fwd", "peak_flops": rate,
                })
                y = out
        flags = _stage_drift(measured, predicted, threshold)
        total_m, total_p = sum(measured), sum(predicted)
        overall = total_m / total_p if total_p > 0 else float("nan")
        for st, m_i, p_i, flag in zip(stages, measured, predicted, flags):
            st["share_measured"] = m_i / total_m if total_m > 0 else 0.0
            st["share_predicted"] = p_i / total_p if total_p > 0 else 0.0
            st["drift"] = (m_i / p_i) / overall if p_i > 0 and overall == overall else float("inf")
            st["drift_flagged"] = flag
        cost = self.cost(m_rows)
        return {
            "signature": {"ps": list(self.ps), "qs": list(self.qs), "m": m_rows,
                          "batch": self.batch, "backend": self.backend},
            "plan": plan.describe(),
            "program": prog.describe(),
            "stages": stages,
            "measured_s": total_m,
            "predicted_s": total_p,
            "cost_flops": cost.flops,
            "measured_gflops_s": cost.flops / total_m / 1e9 if total_m > 0 else 0.0,
            "drift_threshold": threshold,
            "drift_flagged": [i for i, f in enumerate(flags) if f],
            "warmup": warmup,
            "iters": iters,
        }

    def describe(self) -> str:
        mode = "batched" if self.batch is not None else "single"
        shared = "" if self.batch is None else (
            ", shared" if self.shared_factors else ", per-sample"
        )
        where = f"mesh({self.g_m}x{self.g_k})" if self.mesh is not None else "local"
        plan = self.plan
        if plan is not None:
            pdesc = plan.describe()
        elif self.rounds is not None:
            pdesc = f"rounds{list(self.rounds)}"  # the mesh path's schedule is its plan
        else:
            pdesc = "unfused"
        base = (
            f"KronOp(ps={list(self.ps)}, qs={list(self.qs)}, {mode}{shared}, "
            f"{where}, backend={self.backend}) :: {pdesc}"
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
            if f.device.type != x.device.type or (self.mesh is None and f.device != x.device):
                raise ValueError(f"x on {x.device} but a factor on {f.device}")
        if x.shape[-1] != self.k:
            raise ValueError(
                f"x last dim {x.shape[-1]} != prod(P)={self.k} for {self.ps}"
            )

    def __call__(
        self, x: torch.Tensor, factors: Sequence[torch.Tensor]
    ) -> torch.Tensor:
        # The op layer's span: its self time is the checks, the plan memo, the
        # autograd entry and the ladder, outside the executor's spans.
        with telemetry.span("op"):
            factors = tuple(factors)
            self._check_factors(x, factors)
            if self.mesh is not None:
                return self._run_mesh(x, factors)
            size = x.element_size()
            dev = x.device if self._measure else None
            if self.batch is None:
                lead = x.shape[:-1]
                rows = math.prod(lead) if lead else 1
                plan = self._single_plan(rows, size, dev)
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
                plan = self._single_plan(b * m, size, dev)
                y = _KronFunction.apply(
                    x.reshape(b * m, self.k), plan, self.backend, self._ctx, False, *factors
                )
            else:
                plan = self._batched_plan(b, m, size, dev)
                y = _KronFunction.apply(
                    x.reshape(b, m, self.k), plan, self.backend, self._ctx, True, *factors
                )
            return y.reshape(b, *lead, self.k_out)

    # -- the mesh path -------------------------------------------------------

    def _local_op(self) -> "KronOp":
        """The mesh ladder's last rung: this problem on one device (a shared
        batch folds into the rows, so the single-problem op)."""
        if self._local is None:
            self._local = (
                self._derive(mesh=None, m=None) if self._per_sample
                else self._derive(mesh=None, m=None, batch=None, shared_factors=True))
        return self._local

    def _run_mesh(self, x, factors):
        """A call on the mesh.  ``x`` is a DTensor placed rows over
        ``data_axis`` and columns over ``model_axis`` (``(M, K)``; ``(B, M,
        K)`` for a batched op, B replicated), or a plain tensor every rank
        holds in full, which is sliced locally (no communication) and whose
        result comes back replicated (an all-gather).

        The mesh ladder: ``mesh-slabbed`` (when the schedule has more than
        one slab), ``mesh-rounds`` (serial), ``local``.  The local rung
        gathers x (``distributed.gather``, an all-gather, not the
        relocation that failed), runs the local op on each rank's device
        and hands back the caller's placements.  Only ``CollectiveError``
        degrades; a rung whose working set does not fit the card's
        budget (``autotune.device_memory_budget``) raises ``PlanError``
        before it allocates.  With telemetry on, the gauge ``mesh.n_slabs`` holds
        the slab count of the call."""
        from torch.distributed.tensor import DTensor

        from . import distributed as D

        plain = not isinstance(x, DTensor)
        shape = tuple(x.shape)
        if self.batch is None:
            if plain:
                x = x.reshape(-1, self.k)
            elif x.ndim != 2:
                raise ValueError(f"distributed op expects x (M, K), got {shape}")
        elif x.ndim != 3 or int(x.shape[0]) != self.batch:
            raise ValueError(f"batched mesh op expects x (B={self.batch}, M, K), got {shape}")
        elif plain and self.shared_factors:
            # A shared batch folds into the sharded rows, as in the reference.
            x = x.reshape(-1, self.k)
        placements = D.mesh_placements(self.mesh, self.data_axis, self.model_axis, ndim=x.ndim)
        size = x.element_size()
        m = int(x.shape[-2])
        rows = m * (int(x.shape[0]) if x.ndim == 3 and not self._per_sample else 1)
        m_loc = max(1, rows // self.g_m)
        dev = x.device
        if self._per_sample:
            plan = self._mesh_batched_plan(
                self.batch, m_loc, size, dev if self._measure else None)
            n_slabs = self._resolve_n_slabs(m_loc, size, plan, dev)
            run = D.run_batched_distributed_rounds
        else:
            n_slabs = self._resolve_n_slabs(m_loc, size, device=dev)
            run = D.run_distributed_rounds
        telemetry.gauge_set("mesh.n_slabs", n_slabs)
        kw = dict(data_axis=self.data_axis, model_axis=self.model_axis, backend=self.backend,
                  per_iteration=self.per_iteration)

        def _serial():
            self._require_fit("the serial rounds", self._rounds_bytes(m_loc, 1, size), dev)
            return run(x, factors, self.mesh, **kw)

        def _local():
            full = rows * self.g_m * (self.batch if self._per_sample else 1)
            self._require_fit(
                f"the local rung's gathered x ({full} x {self.k}) and output",
                full * (self.k + self.k_out + max(self.k, self.k_out)) * size, dev)
            xf = D.gather(x) if isinstance(x, DTensor) else x
            fs = tuple(D._local_factor(f) for f in factors)
            if self._per_sample:
                y = self._local_op()(xf, fs)
            else:
                y = self._local_op()(xf.reshape(-1, self.k), fs).reshape(
                    *xf.shape[:-1], self.k_out)
            return D._as_placed(y, self.mesh, placements)

        rungs = [("mesh-rounds", _serial), ("local", _local)]
        if n_slabs > 1:
            rungs.insert(0, ("mesh-slabbed",
                             lambda: run(x, factors, self.mesh, n_slabs=n_slabs, **kw)))
        mode = "batched" if self._per_sample else "single"
        y = guard.run_ladder(("mesh", self.ps, self.qs, self.backend, mode), rungs,
                             catch=(guard.CollectiveError,))
        if plain:
            return D.gather(y).reshape(*shape[:-1], self.k_out)
        return y


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
    mesh=None,
    data_axis: str | tuple[str, ...] = "data",
    model_axis: str = "model",
    per_iteration: bool = False,
    backend: str = "auto",
    plan: KronPlan | str | None = "auto",
    tune: str = "analytic",
    cache_path: str | None = None,
    dtype_bytes: int = 4,
    enable_prekron: bool | None = None,
    device: str | None = None,
    n_slabs: int | str = "auto",
) -> KronOp:
    """Shared, bounded ``KronOp`` factory: same signature -> same op object.

    The cache behind the ``kron_matmul*`` shims and the consumers that key
    ops on runtime shapes (a ``DeviceMesh`` is hashable, so mesh ops are
    shared too).  Plans are also shared through the engine's bounded plan
    memo, so two distinct ops with one signature hold one plan.
    """
    return KronOp(
        ps, qs, m=m, batch=batch, shared_factors=shared_factors, mesh=mesh,
        data_axis=data_axis, model_axis=model_axis, per_iteration=per_iteration,
        backend=backend, plan=plan, tune=tune, cache_path=cache_path,
        dtype_bytes=dtype_bytes, enable_prekron=enable_prekron, device=device,
        n_slabs=n_slabs,
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
