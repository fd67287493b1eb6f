"""Planner for FastKron execution plans, with an H100 hardware model.

The port of ``repro.core.autotune``'s analytic planner.  Candidates are
scored with the same two-term (compute, memory) model as the JAX package,
with an H100's constants in place of the TPU's: device-memory bandwidth,
the f32 rate of the CUDA cores (the kernels do their arithmetic there), the
227 KB of shared memory one block may hold, and the kernels' register tile
in place of the MXU and sublane shapes.

Plan construction decides, per the paper + the beyond-paper extensions:

  * fusion grouping (C3): how many consecutive factors one kernel chains,
    bounded by ``N_fused = floor(log_P T_K)`` and the per-block budget — with
    per-factor Q-tiling (``Stage.t_qs``) to keep fusion legal when
    ``prod(Q)/prod(P)`` alone would blow the budget;
  * factor pre-kronization (``enable_prekron``): explicitly form
    F^i (x) F^{i+1} when P is small;
  * a BACKWARD plan (``KronPlan.bwd_stages``): the mirrored stages, with
    tiles tuned for the transposed shapes and M-tiles clamped so both
    backward kernels fit one block at the forward stage's ``t_k``.

``make_batched_plan`` plans ``B`` independent problems: shared factors fold
B into the rows; per-sample factors keep the single-problem plan at the
sample tile ``t_b=1``.  ``lower`` turns a plan
into the executor's ``StageProgram``.  Measured tuning (``tune="measure"``)
and the on-disk plan cache come with a later slice (``MEASURED_SLICE``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

from ..kernels import emit as emit_mod
from ..kernels.emit import SMEM_BUDGET_ELEMS, StageInstr, StageProgram, fused_growth
from ..runtime.guard import PlanError
from .kron import KronProblem

# What ``tune="measure"`` and ``cache_path=`` raise until the port has them.
MEASURED_SLICE = (
    "the measured planner and the plan cache are a later slice of the port: "
    "ROADMAP.md queue 1, 'Planner, measured half'"
)

# H100 SXM hardware model (NVIDIA data sheet, dense rates).  The kernels run
# every dtype's arithmetic on the CUDA cores in f32 (f64 for f64), so a bf16
# input is costed at the f32 rate, not the tensor cores' 989 TFLOP/s.
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12  # bytes/s
SMEM_BYTES = emit_mod.SMEM_BYTES  # 227 KB: what one block may hold
# Granularity of the kernels' work (the register tiles of
# csrc/kron_async.cuh), in place of the TPU's 128x128 MXU and (8, 128) tile:
# each thread owns 4 (or 8) columns of the factor panel and up to 4 slices.
# The chain kernels contract one p at a time, so P needs no padding.
COL_ALIGN = 4
ROW_ALIGN = 4


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclasses.dataclass(frozen=True)
class TileConfig:
    t_m: int
    t_s: int  # slices per block (T_K = t_s * P)
    t_q: int

    @property
    def as_tuple(self) -> tuple[int, int, int]:
        return (self.t_m, self.t_s, self.t_q)


def vmem_elems(cfg: TileConfig, p: int, growth: float = 1.0) -> int:
    """f32-elements resident per block (x tile, f tile, y tile), x2 buffered."""
    x_t = cfg.t_m * cfg.t_s * p
    f_t = p * cfg.t_q
    y_t = int(cfg.t_m * cfg.t_q * cfg.t_s * growth)
    return 2 * (x_t + f_t + y_t)


def predict_seconds(
    prob_m: int, s: int, p: int, q: int, cfg: TileConfig, dtype_bytes: int = 4
) -> float:
    """Two-term analytic time model for one sliced multiply on one card."""
    flops = 2.0 * prob_m * s * p * q
    # Utilization of the kernel's work granularity along each axis.
    u_q = cfg.t_q / _ceil_to(cfg.t_q, COL_ALIGN)
    rows = cfg.t_m * cfg.t_s
    u_r = rows / _ceil_to(rows, ROW_ALIGN)
    t_compute = flops / (PEAK_FLOPS * max(u_q * u_r, 1e-6))
    # Memory traffic: X re-read once per Q-tile sweep; Y written once.
    x_bytes = prob_m * s * p * dtype_bytes * (q // cfg.t_q)
    y_bytes = prob_m * s * q * dtype_bytes
    f_bytes = p * q * dtype_bytes * (prob_m // cfg.t_m) * (s // cfg.t_s)
    t_mem = (x_bytes + y_bytes + f_bytes) / HBM_BW
    return max(t_compute, t_mem)


def candidate_tiles(m: int, s: int, p: int, q: int) -> list[TileConfig]:
    """Paper §4.3 search-space narrowing: prune by the block's resources."""
    t_ms = [t for t in (1, 2, 4, 8, 16, 32) if t <= m and m % t == 0]
    t_ss = [t for t in _divisors(s) if t <= 2048]
    t_qs = _divisors(q)
    out = []
    for t_m, t_s, t_q in itertools.product(t_ms, t_ss, t_qs):
        cfg = TileConfig(t_m, t_s, t_q)
        if vmem_elems(cfg, p) * 4 > SMEM_BYTES * 3 // 4:
            continue  # resource-limit pruning (paper: smem + regs cap)
        out.append(cfg)
    return out


def tune_sliced(
    m: int, s: int, p: int, q: int, *, dtype_bytes: int = 4
) -> TileConfig:
    """Best analytic tile config for a single sliced multiply."""
    cands = candidate_tiles(m, s, p, q)
    if not cands:
        return TileConfig(min(m, 8), 1, 1)
    return min(cands, key=lambda c: predict_seconds(m, s, p, q, c, dtype_bytes))


# ---------------------------------------------------------------------------
# Plan: pairing + fusion grouping + tiles per stage (+ mirrored backward)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One kernel launch: chain ``factor_ids`` (in application order, i.e.
    reversed problem order) inside a single fused kernel.

    ``prekron=True``: the stage's factors are first combined into their
    explicit Kronecker product and applied as ONE sliced multiply.
    ``t_qs`` (application order, one entry per factor) tiles the composite Q
    axis so the in-block growth is bounded by ``prod(t_qs)/prod(P)``; None
    means no Q-tiling.  ``acc_dtype`` (a dtype name) is this stage's
    accumulation dtype; None promotes the input dtype against f32.
    """

    factor_ids: tuple[int, ...]
    prekron: bool
    tiles: TileConfig
    t_qs: tuple[int, ...] | None = None
    acc_dtype: str | None = None


@dataclasses.dataclass(frozen=True)
class KronPlan:
    stages: tuple[Stage, ...]
    # Backward stages in EXECUTION order (last forward stage first); None
    # falls back to a mirror of ``stages``.
    bwd_stages: tuple[Stage, ...] | None = None
    # Samples per block for per-sample batched execution; 1 == unbatched.
    t_b: int = 1

    def describe(self) -> str:
        parts = []
        for st in self.stages:
            kind = "prekron" if st.prekron else ("fused" if len(st.factor_ids) > 1 else "sliced")
            tag = f"{kind}{list(st.factor_ids)}@{st.tiles.as_tuple}"
            if st.t_qs is not None:
                tag += f"/tq{list(st.t_qs)}"
            parts.append(tag)
        head = f"[t_b={self.t_b}] " if self.t_b != 1 else ""
        return head + " -> ".join(parts)


def mirror_bwd_stages(
    prob: KronProblem,
    stages: Sequence[Stage],
    *,
    dtype_bytes: int = 4,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
) -> tuple[Stage, ...]:
    """Backward stages for a forward plan: same grouping, reversed execution
    order, tiles tuned for the transposed contraction (P and Q swap roles).

    The backward runs the forward stage's ``t_k`` with the tuned M-tile, so
    ``t_m`` is clamped to the largest divisor of the tuned one at which both
    backward forms fit the per-block budget there: the transposed chain
    (``t_m * t_k * transposed_growth``) and the stage backward's live set
    (``t_m * emit.grad_live_elems``); 1 when none does (the stage then
    takes the per-factor fallback)."""
    ps = list(reversed(prob.ps))
    qs = list(reversed(prob.qs))
    k = prob.k
    outs = []
    for st in stages:
        sps = [ps[i] for i in st.factor_ids]
        sqs = [qs[i] for i in st.factor_ids]
        if st.prekron:
            sps, sqs = [math.prod(sps)], [math.prod(sqs)]
        pprod, qprod = math.prod(sps), math.prod(sqs)
        k = k // pprod * qprod
        outs.append((st, sps, sqs, k))
    bwd = []
    for st, sps, sqs, k_out in reversed(outs):
        pprod, qprod = math.prod(sps), math.prod(sqs)
        tiles = tune_sliced(prob.m, k_out // qprod, qprod, pprod, dtype_bytes=dtype_bytes)
        t_k = st.tiles.t_s * pprod
        t_qs = st.t_qs if st.t_qs is not None and len(st.t_qs) == len(sps) else None
        per_row = max(
            t_k * emit_mod.transposed_growth(sps, sqs, t_qs),
            emit_mod.grad_live_elems(t_k, sps, sqs),
        )
        t_m = max(
            (d for d in _divisors(tiles.t_m) if d * per_row <= vmem_budget_elems),
            default=1,
        )
        if t_m != tiles.t_m:
            tiles = TileConfig(t_m, tiles.t_s, tiles.t_q)
        bwd.append(Stage(st.factor_ids, st.prekron, tiles, st.t_qs, st.acc_dtype))
    return tuple(bwd)


def lower(
    plan: KronPlan,
    ps: Sequence[int],
    qs: Sequence[int],
    *,
    batched: bool = False,
    acc_dtype: str | None = None,
) -> StageProgram:
    """Lower a ``KronPlan`` into the executor's ``StageProgram`` IR.

    One typed instruction per stage (``multiply`` or ``prekron``), carrying
    its per-factor ``(p_i, q_i)``, its tiles (``t_k = t_s * prod(P)``), its
    batch tile (``t_b=None`` when ``batched=False``), its accumulation dtype
    (``Stage.acc_dtype``, falling back to ``acc_dtype``) and the tuned
    transposed M-tile from ``plan.bwd_stages``.  ``ps``/``qs`` are the
    problem-order factor dims.
    """
    rps = tuple(reversed(tuple(int(p) for p in ps)))
    rqs = tuple(reversed(tuple(int(q) for q in qs)))
    bwd_sts = plan.bwd_stages or tuple(reversed(plan.stages))
    n_st = len(plan.stages)
    instrs = []
    for i, st in enumerate(plan.stages):
        sps = tuple(rps[j] for j in st.factor_ids)
        sqs = tuple(rqs[j] for j in st.factor_ids)
        bst = bwd_sts[n_st - 1 - i]
        t_qs = st.t_qs
        if t_qs is None and (st.prekron or len(st.factor_ids) == 1):
            # Single-multiply stages (one factor, or a prekron product): the
            # stage's tuned Q-tile is tiles.t_q, injected only when full-Q
            # growth overflows the per-block budget.
            eff_p = math.prod(sps)
            eff_q = math.prod(sqs)
            t_k = st.tiles.t_s * eff_p
            full = st.tiles.t_m * t_k * max(1.0, eff_q / eff_p)
            if (
                (plan.t_b if batched else 1) * full > emit_mod.SMEM_BUDGET_ELEMS
                and 1 < st.tiles.t_q < eff_q
                and eff_q % st.tiles.t_q == 0
            ):
                t_qs = (st.tiles.t_q,)
        instrs.append(
            StageInstr(
                kind=emit_mod.PREKRON if st.prekron else emit_mod.MULTIPLY,
                ps=sps,
                qs=sqs,
                factor_ids=st.factor_ids,
                t_m=st.tiles.t_m,
                t_k=st.tiles.t_s * math.prod(sps),
                t_qs=t_qs,
                t_b=plan.t_b if batched else None,
                acc_dtype=st.acc_dtype if st.acc_dtype is not None else acc_dtype,
                t_m_bwd=bst.tiles.t_m,
            )
        )
    return StageProgram(tuple(instrs), len(rps))


def make_plan(
    prob: KronProblem,
    *,
    dtype_bytes: int = 4,
    enable_fusion: bool = True,
    enable_prekron: bool = True,
    prekron_max_p: int = 16,
    prekron_max_dim: int = 256,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
    acc_dtype: str | None = None,
) -> KronPlan:
    """Greedy analytic plan over the reversed factor list (application order).

    Stage selection per position i (0 = last factor, applied first):
      1. If P_i and P_{i+1} are both small, pre-kronize the pair.
      2. Else fuse as many consecutive factors as N_fused and the per-block
         budget allow (C3), Q-tiling factors whose growth would otherwise
         end the group.
      3. Else a single tuned sliced multiply.

    ``vmem_budget_elems`` defaults to one H100 block's shared memory in f32
    elements (``SMEM_BUDGET_ELEMS``).  ``acc_dtype`` stamps every stage's
    accumulation dtype; None keeps the promote-against-f32 default.
    """
    ps = list(reversed(prob.ps))
    qs = list(reversed(prob.qs))
    n = len(ps)
    stages: list[Stage] = []
    k = prob.k
    i = 0
    while i < n:
        p, q = ps[i], qs[i]
        # -- beyond-paper pre-kronization --
        if (
            enable_prekron
            and i + 1 < n
            and p <= prekron_max_p
            and ps[i + 1] <= prekron_max_p
            and p * ps[i + 1] <= prekron_max_dim
            and q * qs[i + 1] <= prekron_max_dim
        ):
            pp, qq = p * ps[i + 1], q * qs[i + 1]
            s = k // pp
            tiles = tune_sliced(prob.m, s, pp, qq, dtype_bytes=dtype_bytes)
            stages.append(Stage((i, i + 1), True, tiles, None, acc_dtype))
            k = s * qq
            i += 2
            continue
        # -- C3 fusion grouping (budget-bounded, with Q-tiling relief) --
        group = [i]
        group_tqs = [q]
        if enable_fusion:
            pprod, tqprod = p, q
            j = i + 1
            while j < n:
                np_ = pprod * ps[j]
                if np_ > k:
                    break  # N_fused cap: T_K can hold at most log_P K factors
                # Largest Q-tile of factor j whose growth fits the budget with
                # a T_M of 8 (T_K refined below); full Q when it already fits.
                tq_j = None
                for cand in sorted(_divisors(qs[j]), reverse=True):
                    growth = max(1.0, tqprod * cand / np_)
                    if 8 * np_ * growth * 4 <= vmem_budget_elems:
                        tq_j = cand
                        break
                if tq_j is None:
                    break
                pprod, tqprod = np_, tqprod * tq_j
                group.append(j)
                group_tqs.append(tq_j)
                j += 1
        pprod = math.prod(ps[g] for g in group)
        qprod = math.prod(qs[g] for g in group)
        s = k // pprod
        if len(group) > 1:
            # Repair pass: shrink the worst-contributing Q-tile until the
            # minimal (t_m=1, t_s=1) tile's prefix growth fits the budget.
            sps = [ps[g] for g in group]
            sqs = [qs[g] for g in group]
            while (
                pprod * fused_growth(sps, sqs, group_tqs) > vmem_budget_elems
                and any(t > 1 for t in group_tqs)
            ):
                i_big = max(
                    range(len(group_tqs)),
                    key=lambda j: group_tqs[j] / sps[j],
                )
                group_tqs[i_big] = max(
                    (d for d in _divisors(sqs[i_big]) if d < group_tqs[i_big]),
                    default=1,
                )
        tiles = tune_sliced(prob.m, s, pprod, qprod, dtype_bytes=dtype_bytes)
        t_qs = tuple(group_tqs) if group_tqs != [qs[g] for g in group] else None
        if len(group) > 1:
            # Clamp (T_M, T_K = t_s * prod(P)) so the fused tile respects the
            # budget (the grouping loop guaranteed a fit at T_M=8, t_s=1).
            growth = fused_growth([ps[g] for g in group], [qs[g] for g in group], t_qs)
            t_m = tiles.t_m
            while t_m > 1 and t_m * pprod * growth > vmem_budget_elems:
                t_m = max(d for d in _divisors(prob.m) if d < t_m)
            max_ts = max(1, int(vmem_budget_elems // (t_m * pprod * growth)))
            ts = tiles.t_s
            if ts > max_ts:
                ts = max(d for d in _divisors(s) if d <= max_ts)
            if (t_m, ts) != (tiles.t_m, tiles.t_s):
                tiles = TileConfig(t_m, ts, tiles.t_q)
        stages.append(Stage(tuple(group), False, tiles, t_qs, acc_dtype))
        k = s * qprod
        i = group[-1] + 1
    fwd = tuple(stages)
    return KronPlan(
        fwd,
        mirror_bwd_stages(
            prob, fwd, dtype_bytes=dtype_bytes, vmem_budget_elems=vmem_budget_elems
        ),
    )


# ---------------------------------------------------------------------------
# Batched plans
# ---------------------------------------------------------------------------


def make_batched_plan(
    prob: KronProblem,
    batch: int,
    *,
    shared_factors: bool = True,
    dtype_bytes: int = 4,
    enable_fusion: bool = True,
    enable_prekron: bool = False,
    prekron_max_p: int = 16,
    prekron_max_dim: int = 256,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
    tune: str = "analytic",
    cache_path: str | None = None,
    acc_dtype: str | None = None,
) -> KronPlan:
    """Plan for ``batch`` independent copies of ``prob`` in one launch.

    ``shared_factors=True`` (one factor set, batched x): the batch folds into
    M, so this is ``make_plan`` on the ``(batch * M, ps, qs)`` problem.

    ``shared_factors=False`` (per-sample factors): the single-problem plan
    at the sample tile ``t_b=1``.  The card's chain kernels walk one sample
    per tile on a persistent grid whose blocks already cross samples, so no
    kernel packs ``t_b`` samples into a tile; the reference's trade of the
    M-tile for sample tiles is TPU-specific.  ``enable_prekron=True`` lets
    the planner emit pre-kronization stages (the executor forms each
    sample's product).

    The reference's mesh mode (``g_k > 1``) belongs to the port's mesh
    slice.  ``tune="measure"`` and ``cache_path`` raise
    ``NotImplementedError`` (``MEASURED_SLICE``); any other tune mode
    raises ``PlanError``.
    """
    if batch <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    if tune == "measure" or cache_path is not None:
        raise NotImplementedError(MEASURED_SLICE)
    if tune != "analytic":
        raise PlanError(f"unknown tune mode {tune!r}")
    kw = dict(
        dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
        enable_prekron=enable_prekron, prekron_max_p=prekron_max_p,
        prekron_max_dim=prekron_max_dim, vmem_budget_elems=vmem_budget_elems,
        acc_dtype=acc_dtype,
    )
    if shared_factors:
        return make_plan(KronProblem(batch * prob.m, prob.ps, prob.qs), **kw)
    base = make_plan(prob, **kw)
    return KronPlan(base.stages, base.bwd_stages, 1)


def plan_cache_key(
    prob: KronProblem,
    dtype_bytes: int,
    backend: str,
    *,
    enable_fusion: bool = True,
    enable_prekron: bool = True,
    prekron_max_p: int = 16,
    prekron_max_dim: int = 256,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
    batch: int = 0,
    shared_factors: bool = True,
    acc_dtype: str | None = None,
) -> str:
    """The key a plan-cache entry is stored under, in the reference's
    format (``repro.core.autotune.plan_cache_key``): every plan-shaping
    input, ``;B=<batch>;shared=<0|1>`` for a batched plan (``batch > 0``)
    and ``;acc=`` when an accumulation dtype is set.  The cache itself comes
    with ``MEASURED_SLICE``."""
    ps = ",".join(map(str, prob.ps))
    qs = ",".join(map(str, prob.qs))
    key = (
        f"m={prob.m};ps={ps};qs={qs};dtype={dtype_bytes};backend={backend}"
        f";fuse={int(enable_fusion)};prekron={int(enable_prekron)}"
        f";pmax={prekron_max_p};pdim={prekron_max_dim};vmem={vmem_budget_elems}"
    )
    if batch > 0:
        key += f";B={batch};shared={int(shared_factors)}"
    if acc_dtype is not None:
        key += f";acc={acc_dtype}"
    return key


# ---------------------------------------------------------------------------
# Plan JSON (the format repro.core.autotune.plan_to_json writes)
# ---------------------------------------------------------------------------


def _stage_to_json(st: Stage) -> dict:
    return {
        "factor_ids": list(st.factor_ids),
        "prekron": st.prekron,
        "tiles": list(st.tiles.as_tuple),
        "t_qs": list(st.t_qs) if st.t_qs is not None else None,
        "acc_dtype": st.acc_dtype,
    }


def _stage_from_json(d: dict) -> Stage:
    return Stage(
        tuple(int(i) for i in d["factor_ids"]),
        bool(d["prekron"]),
        TileConfig(*(int(t) for t in d["tiles"])),
        tuple(int(t) for t in d["t_qs"]) if d.get("t_qs") is not None else None,
        d.get("acc_dtype"),
    )


def plan_to_json(plan: KronPlan) -> dict:
    return {
        "stages": [_stage_to_json(s) for s in plan.stages],
        "bwd_stages": (
            [_stage_to_json(s) for s in plan.bwd_stages]
            if plan.bwd_stages is not None
            else None
        ),
        "t_b": plan.t_b,
    }


def plan_from_json(d: dict) -> KronPlan:
    """Read a plan dict.  Keys the port does not use yet (the JAX package's
    ``n_slabs``, which only its mesh rounds read) are ignored."""
    return KronPlan(
        tuple(_stage_from_json(s) for s in d["stages"]),
        (
            tuple(_stage_from_json(s) for s in d["bwd_stages"])
            if d.get("bwd_stages") is not None
            else None
        ),
        int(d.get("t_b", 1)),
    )


__all__ = [
    "TileConfig",
    "Stage",
    "KronPlan",
    "vmem_elems",
    "predict_seconds",
    "candidate_tiles",
    "tune_sliced",
    "mirror_bwd_stages",
    "lower",
    "make_plan",
    "make_batched_plan",
    "plan_cache_key",
    "plan_to_json",
    "plan_from_json",
    "PEAK_FLOPS",
    "HBM_BW",
    "SMEM_BYTES",
]
