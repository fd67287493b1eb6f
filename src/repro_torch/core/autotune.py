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
into the executor's ``StageProgram``.

``tune="measure"`` ranks the analytic plan and its M-tile variants by the
time of a forward plus full backward on the device (``measure_best``: CUDA
events on the card, ``time.perf_counter`` on the CPU) and keeps the winner
in the on-disk plan cache (``load_plan_cache``/``save_plan_cache``), the
reference's file and format with the device's name in every key.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import tempfile
import time
from typing import Callable, Sequence

import torch
from torch._guards import detect_fake_mode

from ..kernels import emit as emit_mod
from ..kernels import kron_sliced
from ..kernels.emit import SMEM_BUDGET_ELEMS, StageInstr, StageProgram, fused_growth
from ..runtime import chaos, guard, telemetry
from ..runtime.guard import LoweringError, PlanError, VmemOverflowError
from .kron import KronProblem

# H100 SXM hardware model (NVIDIA data sheet, dense rates).  The costed
# path, the planned forward, runs ``chain_fwd``, which does every dtype's
# arithmetic on the CUDA cores: in f32 (67 TFLOP/s, bf16 inputs included)
# or f64 (34).  The tensor cores' rate is not modelled: no costed
# instruction runs on them (only ``grad_mma_kernel`` and ``sliced.cu``'s
# bf16 path do, and neither the tile model nor ``KronOp.profile`` costs
# them).
PEAK_FLOPS = 67e12
PEAK_FLOPS_F64 = 34e12
HBM_BW = 3.35e12  # bytes/s
SMEM_BYTES = emit_mod.SMEM_BYTES  # 227 KB: what one block may hold
# Granularity of the kernels' work (the register tiles of
# csrc/kron_async.cuh), in place of the TPU's 128x128 MXU and (8, 128) tile:
# each thread owns 4 (or 8) columns of the factor panel and up to 4 slices.
# The chain kernels contract one p at a time, so P needs no padding.
COL_ALIGN = 4
ROW_ALIGN = 4

# Interconnect model of the distributed slab pipeline, in place of the
# reference's TPU v5e ICI figures (45 GB/s, 1 us).  Published, not
# measured: NVLink 4 moves 450 GB/s per direction per H100 SXM (NVIDIA
# data sheet), and A2A_LATENCY_S is an assumed 10 us launch latency per
# all-to-all, the order of NCCL's small-message collectives on one NVLink
# node.  A four-card cell is to replace both.  Slabbing a round multiplies
# the latency term by n_slabs while up to (n-1)/n of the payload hides
# under chain compute, so the analytic model picks n_slabs > 1 only once a
# round's payload clears about latency * bandwidth (4.5 MB).
NVLINK_BW = 450e9  # bytes/s per direction per card
A2A_LATENCY_S = 10e-6


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


def peak_flops(dtype_bytes: int) -> float:
    """The CUDA cores' rate for inputs of ``dtype_bytes``: f64's for 8,
    f32's otherwise (bf16 is accumulated in f32)."""
    return PEAK_FLOPS_F64 if dtype_bytes == 8 else PEAK_FLOPS


def predict_seconds(
    prob_m: int, s: int, p: int, q: int, cfg: TileConfig, dtype_bytes: int = 4
) -> float:
    """Two-term analytic time model for one sliced multiply on one card, at
    the CUDA cores' rate for the dtype (the chain kernels', which run the
    planned stages whose tiles it ranks)."""
    flops = 2.0 * prob_m * s * p * q
    peak = peak_flops(dtype_bytes)
    # Utilization of the kernel's work granularity along each axis.
    u_q = cfg.t_q / _ceil_to(cfg.t_q, COL_ALIGN)
    rows = cfg.t_m * cfg.t_s
    u_r = rows / _ceil_to(rows, ROW_ALIGN)
    t_compute = flops / (peak * max(u_q * u_r, 1e-6))
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


def _on_cuda(out) -> bool:
    """Whether ``out`` (a tensor or a sequence of them) lies on a card."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    return any(_on_cuda(o) for o in out) if isinstance(out, (tuple, list)) else False


def time_once(fn: Callable[[], object], cuda: bool) -> tuple[float, object]:
    """(seconds, output) of one ``fn()``: CUDA events around it on the card
    (after the work already queued), ``time.perf_counter`` on the CPU."""
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def measure_best(
    fn_of_cfg: Callable[[object], Callable[[], object]],
    cands: Sequence[object],
    *,
    warmup: int = 2,
    iters: int = 5,
    timings: list | None = None,
) -> tuple[object, float]:
    """Rank candidates by the time of ``fn_of_cfg(cfg)()`` on its device
    and return ``(best, seconds)``.  Generic over the candidate type: tile
    configs for one kernel, or whole ``KronPlan``s in
    ``make_plan(tune="measure")``.

    Each candidate runs ``warmup`` times (at least once: its output tells
    the device), then ``iters`` rounds time one call of every candidate in
    turn (CUDA events on the card, ``time.perf_counter`` on the CPU), and a
    candidate's time is its fastest call.  In turns, so that nothing that
    warms up or drifts during the sweep (first calls, clocks) lands on the
    candidates timed first.

    The first candidate that runs is the incumbent (the analytic plan in
    ``_measured_plan``): another replaces it only if it is faster in every
    round, a win by more than the rounds' spread; of those that are, the
    fastest wins (ties keep the earlier).  So a plan is not chosen, and
    cached, by noise.

    A candidate that raises a capacity error (``VmemOverflowError``,
    ``LoweringError``: tiles the kernel cannot take, the errors the ladder
    catches) is skipped; any other error propagates, so a kernel that fails
    to build or launch is never hidden behind another candidate.  With
    ``timings``, each measured candidate's ``(cfg, seconds)`` is appended."""
    runs = []
    for cfg in cands:
        try:
            fn = fn_of_cfg(cfg)
            for _ in range(max(1, warmup)):
                out = fn()
        except (VmemOverflowError, LoweringError):
            continue
        runs.append((cfg, fn, _on_cuda(out), []))
    if not runs:
        raise PlanError("no candidate executed successfully")
    for _ in range(max(1, iters)):
        for _, fn, cuda, times in runs:
            times.append(time_once(fn, cuda)[0])
    if timings is not None:
        timings.extend((cfg, min(times)) for cfg, _, _, times in runs)
    incumbent = runs[0][3]
    winners = [r for r in runs[1:] if all(t < i for t, i in zip(r[3], incumbent))]
    best = min(winners, key=lambda r: min(r[3])) if winners else runs[0]
    return best[0], min(best[3])


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
    # Row slabs of the distributed round pipeline (per-sample mesh plans,
    # ``make_batched_plan(g_k > 1)``); local execution ignores it.
    n_slabs: int = 1

    def describe(self) -> str:
        parts = []
        for st in self.stages:
            kind = "prekron" if st.prekron else ("fused" if len(st.factor_ids) > 1 else "sliced")
            tag = f"{kind}{list(st.factor_ids)}@{st.tiles.as_tuple}"
            if st.t_qs is not None:
                tag += f"/tq{list(st.t_qs)}"
            parts.append(tag)
        head = f"[t_b={self.t_b}] " if self.t_b != 1 else ""
        if self.n_slabs != 1:
            head += f"[slabs={self.n_slabs}] "
        return head + " -> ".join(parts)


def _stage_dims(prob: KronProblem, st: Stage) -> tuple[list[int], list[int]]:
    """A forward stage's (ps, qs) in application order; a prekron stage as
    its one combined factor."""
    ps, qs = prob.ps[::-1], prob.qs[::-1]
    sps = [ps[i] for i in st.factor_ids]
    sqs = [qs[i] for i in st.factor_ids]
    if st.prekron:
        return [math.prod(sps)], [math.prod(sqs)]
    return sps, sqs


def _bwd_t_m(prob: KronProblem, st: Stage, t_m: int, vmem_budget_elems: int) -> int:
    """The largest divisor of ``t_m`` at which both backward forms of the
    forward stage ``st`` fit the per-block budget at its ``t_k``: the
    transposed chain (``t_m * t_k * transposed_growth``) and the stage
    backward's live set (``t_m * emit.grad_live_elems``); 1 when none does
    (the stage then takes the per-factor fallback)."""
    sps, sqs = _stage_dims(prob, st)
    t_k = st.tiles.t_s * math.prod(sps)
    t_qs = st.t_qs if st.t_qs is not None and len(st.t_qs) == len(sps) else None
    per_row = max(
        t_k * emit_mod.transposed_growth(sps, sqs, t_qs),
        emit_mod.grad_live_elems(t_k, sps, sqs),
    )
    return max((d for d in _divisors(t_m) if d * per_row <= vmem_budget_elems), default=1)


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
    ``t_m`` is clamped by ``_bwd_t_m``."""
    k = prob.k
    outs = []
    for st in stages:
        sps, sqs = _stage_dims(prob, st)
        k = k // math.prod(sps) * math.prod(sqs)
        outs.append((st, sps, sqs, k))
    bwd = []
    for st, sps, sqs, k_out in reversed(outs):
        pprod, qprod = math.prod(sps), math.prod(sqs)
        tiles = tune_sliced(prob.m, k_out // qprod, qprod, pprod, dtype_bytes=dtype_bytes)
        t_m = _bwd_t_m(prob, st, tiles.t_m, vmem_budget_elems)
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
            # growth overflows the per-block budget, or when the whole
            # (P, Q) panel does (a 16 x 16 pair's 256 x 256 product: the
            # chain kernel holds its stage's panels in shared memory).
            eff_p = math.prod(sps)
            eff_q = math.prod(sqs)
            t_k = st.tiles.t_s * eff_p
            full = st.tiles.t_m * t_k * max(1.0, eff_q / eff_p)
            budget = emit_mod.SMEM_BUDGET_ELEMS
            if (
                ((plan.t_b if batched else 1) * full > budget or eff_p * eff_q > budget)
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
    tune: str = "analytic",
    backend: str = "auto",
    cache_path: str | None = None,
    acc_dtype: str | None = None,
    device: str | torch.device | None = None,
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

    ``tune="measure"`` ranks the analytic plan and its M-tile variants by
    the time of their forward plus full backward through ``KronOp`` on
    ``device`` (default the card; ``"cpu"`` times the plain twins) and
    keeps the winner in the plan cache at ``cache_path`` (default
    ``default_cache_path()``); ``backend`` is the ops' backend.
    """
    if tune == "measure":
        return _measured_plan(
            prob, dtype_bytes=dtype_bytes, backend=backend, cache_path=cache_path,
            device=device, vmem_budget_elems=vmem_budget_elems,
            enable_fusion=enable_fusion, enable_prekron=enable_prekron,
            prekron_max_p=prekron_max_p, prekron_max_dim=prekron_max_dim,
            acc_dtype=acc_dtype,
        )
    if tune != "analytic":
        raise PlanError(f"unknown tune mode {tune!r}")
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


def _dist_round_payload_elems(prob: KronProblem, g_k: int) -> int:
    """The worst round's per-sample relocation buffer of the distributed
    round schedule: ``M_loc * C`` elements at the round's output width
    ``C``.  ``prob`` is the local problem (``m = M_loc``; columns start at
    ``K / G_K``).  0 without a model axis or a feasible round schedule.
    The reference trades its batch tile against this buffer in VMEM; the
    card's kernels take no batch tile, so here it is what a measured
    distributed plan's cache entry records as ``payload_elems``."""
    if g_k <= 1:
        return 0
    from .distributed import plan_rounds

    ps = list(reversed(prob.ps))
    qs = list(reversed(prob.qs))
    k_loc = prob.k // g_k
    try:
        rounds = plan_rounds(k_loc, ps, qs, g_k)
    except ValueError:
        return 0
    worst = 0
    c = k_loc
    i = 0
    for r in rounds:
        c = c // math.prod(ps[i : i + r]) * math.prod(qs[i : i + r])
        worst = max(worst, prob.m * c)
        i += r
    return worst


def _dist_round_costs(
    prob: KronProblem, g_k: int, batch: int, dtype_bytes: int
) -> list[tuple[float, float]]:
    """Per-round ``(compute_s, comm_s)`` on one card of the round schedule:
    the chain's flops at the dtype's rate (``peak_flops``) and the
    all-to-all payload at ``NVLINK_BW``.  ``prob`` is the local problem.
    Raises ``PlanError`` when no round schedule exists."""
    from .distributed import plan_rounds

    ps = list(reversed(prob.ps))
    qs = list(reversed(prob.qs))
    k_loc = prob.k // g_k
    rounds = plan_rounds(k_loc, ps, qs, g_k)
    peak = peak_flops(dtype_bytes)
    costs = []
    c = k_loc
    i = 0
    for r in rounds:
        flops = 0.0
        for j in range(i, i + r):
            flops += 2.0 * batch * prob.m * c * qs[j]
            c = c // ps[j] * qs[j]
        payload = batch * prob.m * c * (g_k - 1) / g_k
        costs.append((flops / peak, payload * dtype_bytes / NVLINK_BW))
        i += r
    return costs


def _slab_schedule_seconds(costs: Sequence[tuple[float, float]], n_slabs: int) -> float:
    """Analytic time of the slab-pipelined round schedule: per round, up to
    ``(n-1)/n`` of ``min(compute, comm)`` hides, and every slab's
    all-to-all pays the launch latency.  ``n_slabs=1`` is the serial
    ``compute + comm + latency``."""
    total = 0.0
    for comp, comm in costs:
        hidden = min(comp, comm) * (n_slabs - 1) / n_slabs
        total += comp + comm - hidden + n_slabs * A2A_LATENCY_S
    return total


def choose_n_slabs(
    prob: KronProblem,
    g_k: int,
    *,
    batch: int = 1,
    dtype_bytes: int = 4,
    candidates: Sequence[int] = (1, 2, 4),
    memory_budget: int | None = None,
    per_iteration: bool = False,
) -> int:
    """Analytic slab count of the distributed round pipeline.

    ``prob`` is the local problem (``m`` = rows per rank, the slab axis;
    for shared factors the folded ``B*M/G_M``).  Each candidate is clamped
    to a divisor of the rows and scored with ``_slab_schedule_seconds``;
    the serial schedule wins ties, so small problems plan serial.
    ``make_batched_plan(tune="measure", mesh=...)`` overrules the model
    with times on the mesh.

    With a ``memory_budget`` (bytes of one card) only counts whose working
    set (``distributed.round_working_set_bytes``) fits are scored; where no
    candidate fits, the fewest slabs beyond them that fit (doubling up to
    the rows), and where none does, ``PlanError`` naming the sizes."""
    if g_k <= 1 or prob.m <= 1:
        return 1
    try:
        costs = _dist_round_costs(prob, g_k, batch, dtype_bytes)
    except PlanError:
        return 1
    need = _working_set(prob, g_k, batch, dtype_bytes, per_iteration)

    def fits(n: int) -> bool:
        return memory_budget is None or need(n) <= memory_budget

    best_n, best_t = None, math.inf
    for n in (1, *candidates):
        n_eff = emit_mod.effective_slabs(prob.m, n)
        if n_eff == best_n or not fits(n_eff):
            continue
        t = _slab_schedule_seconds(costs, n_eff)
        if t < best_t:
            best_n, best_t = n_eff, t
    n = max(candidates, default=1) * 2
    while best_n is None and n <= 2 * prob.m:
        n_eff = emit_mod.effective_slabs(prob.m, n)
        if fits(n_eff):
            best_n = n_eff
        n *= 2
    if best_n is None:
        raise PlanError(
            f"the distributed rounds of {prob.m} rows x {prob.k // g_k} columns per rank "
            f"(batch {batch}, {dtype_bytes}-byte elements) need "
            f"{need(prob.m)} bytes at "
            f"{prob.m} slabs, over the budget of {memory_budget}"
        )
    return best_n


def _working_set(prob: KronProblem, g_k: int, batch: int, dtype_bytes: int,
                 per_iteration: bool) -> Callable[[int], int]:
    """``need(n)``: one rank's bytes of the round pipeline at ``n`` slabs
    (``distributed.round_working_set_bytes``)."""
    from .distributed import round_working_set_bytes

    def need(n: int) -> int:
        return round_working_set_bytes(
            prob.m, prob.k // g_k, list(reversed(prob.ps)), list(reversed(prob.qs)), g_k,
            n_slabs=n, batch=batch, dtype_bytes=dtype_bytes, per_iteration=per_iteration)

    return need


# Bytes of a card's memory the round pipeline leaves to the CUDA context,
# the collectives' own buffers and the caching allocator's slack.
MEMORY_RESERVE_BYTES = 4 * 2**30


def device_memory_budget(device) -> int | None:
    """Bytes the mesh path may plan to hold on ``device``: a card's memory
    less ``MEMORY_RESERVE_BYTES``; None (no bound) off the card.  From the
    card's size, not what is free, so that every rank of a mesh plans the
    same schedule."""
    if device is None or torch.device(device).type != "cuda":
        return None
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return max(0, int(total) - MEMORY_RESERVE_BYTES)


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
    backend: str = "auto",
    cache_path: str | None = None,
    acc_dtype: str | None = None,
    device: str | torch.device | None = None,
    g_k: int = 1,
    mesh=None,
    data_axis="data",
    model_axis: str = "model",
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

    ``tune="measure"`` ranks candidates as ``make_plan`` does: the shared
    mode measures the folded ``(batch * M)``-row problem, the per-sample
    mode the per-sample plan on ``(B, M, K)`` inputs (its M-tile variants;
    no ``t_b`` variants, since no kernel reads ``t_b``).  An unknown tune
    mode raises ``PlanError``.

    ``g_k > 1`` is the distributed mode (per-sample factors on a mesh with
    a ``G_K``-way model axis): ``prob`` is the local problem (``m = M_loc``)
    and the plan carries the slab pipeline's depth ``n_slabs``, one
    candidate per distinct slab count in (1, 2, 4) scored by the overlap
    model (``_analytic_dist_plan``).  The reference trades ``n_slabs``
    against ``t_b`` in VMEM; here ``t_b`` stays 1.  With
    ``tune="measure"`` and a ``mesh``, the candidates are timed on the mesh
    through the round runner (forward and backward) and the winner kept in
    the plan cache under the batched key plus ``;gk=<G_K>``
    (``_measured_dist_plan``); without a mesh, measuring falls back to the
    analytic plan and caches nothing.  Shared factors take no distributed
    plan (the batch folds into the sharded rows): ``g_k > 1`` with
    ``shared_factors=True`` raises.
    """
    if batch <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    if g_k > 1:
        if shared_factors:
            raise ValueError(
                "g_k > 1 (distributed mode) requires shared_factors=False: the "
                "shared-factors distributed path folds the batch into the "
                "data-sharded rows and takes no batched plan"
            )
        if tune not in ("analytic", "measure"):
            raise PlanError(f"unknown tune mode {tune!r}")
        dist_kw = dict(dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
                       vmem_budget_elems=vmem_budget_elems, acc_dtype=acc_dtype)
        if tune == "measure" and mesh is not None:
            return _measured_dist_plan(
                prob, batch=batch, g_k=g_k, mesh=mesh, data_axis=data_axis,
                model_axis=model_axis, backend=backend, cache_path=cache_path,
                device=device, **dist_kw,
            )
        return _analytic_dist_plan(prob, batch, g_k, **dist_kw)
    kw = dict(
        dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
        enable_prekron=enable_prekron, prekron_max_p=prekron_max_p,
        prekron_max_dim=prekron_max_dim, vmem_budget_elems=vmem_budget_elems,
        acc_dtype=acc_dtype,
    )
    if shared_factors:
        return make_plan(
            KronProblem(batch * prob.m, prob.ps, prob.qs), tune=tune, backend=backend,
            cache_path=cache_path, device=device, **kw,
        )
    if tune == "measure":
        return _measured_plan(
            prob, batch=batch, backend=backend, cache_path=cache_path, device=device, **kw
        )
    if tune != "analytic":
        raise PlanError(f"unknown tune mode {tune!r}")
    base = make_plan(prob, **kw)
    return KronPlan(base.stages, base.bwd_stages, 1)


def _dist_plan_candidates(
    prob: KronProblem, *, dtype_bytes: int, enable_fusion: bool, vmem_budget_elems: int,
    acc_dtype: str | None, slab_candidates: Sequence[int] = (1, 2, 4),
) -> list[KronPlan]:
    """One distributed plan per distinct feasible slab count, serial first:
    the per-sample plan of the local problem (``t_b=1``) with its
    ``n_slabs``."""
    base = make_plan(prob, dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
                     enable_prekron=False, vmem_budget_elems=vmem_budget_elems,
                     acc_dtype=acc_dtype)
    slabs = sorted({emit_mod.effective_slabs(prob.m, n) for n in slab_candidates})
    return [KronPlan(base.stages, base.bwd_stages, 1, n) for n in slabs]


def _analytic_dist_plan(
    prob: KronProblem, batch: int, g_k: int, *, dtype_bytes, enable_fusion,
    vmem_budget_elems, acc_dtype,
) -> KronPlan:
    """The candidate whose slab schedule the overlap model times fastest;
    ties keep the shallower pipeline (serial is listed first)."""
    cands = _dist_plan_candidates(
        prob, dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
        vmem_budget_elems=vmem_budget_elems, acc_dtype=acc_dtype,
    )
    try:
        costs = _dist_round_costs(prob, g_k, batch, dtype_bytes)
    except PlanError:
        return cands[0]
    best, best_t = cands[0], _slab_schedule_seconds(costs, cands[0].n_slabs)
    for plan in cands[1:]:
        t = _slab_schedule_seconds(costs, plan.n_slabs)
        if t < best_t:
            best, best_t = plan, t
    return best


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
    device: str | torch.device | None = None,
) -> str:
    """The key a plan-cache entry is stored under, in the reference's
    format (``repro.core.autotune.plan_cache_key``): every plan-shaping
    input, ``;B=<batch>;shared=<0|1>`` for a batched plan (``batch > 0``)
    and ``;acc=`` when an accumulation dtype is set; then, appended as those
    are, ``;dev=<the card's name>`` (``;dev=cpu``) for the device the plan
    was measured on (``device_tag``), so a file shared with the reference,
    or with another device, never gives this device a plan it did not
    measure.  ``device=None`` is the card."""
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
    return key + f";dev={device_tag(device)}"


def measure_device(device: str | torch.device | None) -> torch.device:
    """The device measured tuning runs on: ``device``, default the card.
    Asking for CUDA without a card raises instead of measuring on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "measured tuning on the card needs CUDA, which is not available "
                "here; pass device='cpu' to measure the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_tag(device: str | torch.device | None) -> str:
    """``;dev=`` of a plan-cache key: the card's name, or ``cpu``; ``fake``
    inside a fake-tensor trace (a dry-run), which asks no device."""
    if detect_fake_mode() is not None:
        return "fake"
    dev = measure_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


# ---------------------------------------------------------------------------
# Measured tuning + the on-disk plan cache
# ---------------------------------------------------------------------------

PLAN_CACHE_VERSION = 1
PLAN_CACHE_SAVE_RETRIES = 3
_DTYPES = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}


def default_cache_path() -> str:
    """``$FASTKRON_PLAN_CACHE``, else ``~/.cache/fastkron/plans.json``: the
    reference's file, whose keys the port's ``;dev=`` keeps apart."""
    return os.environ.get(
        "FASTKRON_PLAN_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "fastkron", "plans.json"),
    )


def load_plan_cache(path: str) -> dict:
    """The cache's entries, best effort: a corrupt, truncated or
    wrong-schema file degrades to an empty cache, never an exception (the
    next save rewrites it whole), with one ``GuardWarning`` per path and a
    ``plan_cache_rebuild`` health event.  A missing file or another
    version is a normal condition and stays quiet."""
    try:
        chaos.maybe_fail("plan_cache_load")
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:  # PlanCacheError is an OSError
        guard.record_event("plan_cache_rebuild", guard.PlanCacheError(str(e)))
        guard.warn_once(
            ("plan_cache_load", path),
            f"kron guard: plan cache at {path!r} unreadable "
            f"({type(e).__name__}: {e}) — rebuilding from scratch",
        )
        return {}
    if not isinstance(data, dict) or data.get("version") != PLAN_CACHE_VERSION:
        return {}
    entries = data.get("entries", {})
    if not isinstance(entries, dict):
        return {}
    return {
        k: v for k, v in entries.items()
        if isinstance(v, dict) and isinstance(v.get("plan"), dict)
    }


def save_plan_cache(
    path: str, entries: dict, *, retries: int = PLAN_CACHE_SAVE_RETRIES
) -> None:
    """Atomic write (a temporary file in the target directory, then
    ``os.replace``), so a reader never sees a partial file.  Entries written
    to the file since our load are merged in (ours win a key), so parallel
    tuners lose at most a race, not their work.  A failed write is retried
    with exponential backoff; when every attempt fails, one
    ``GuardWarning`` per path and a ``plan_cache_save_failed`` event."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    merged = {**load_plan_cache(path), **entries}
    payload = {"version": PLAN_CACHE_VERSION, "entries": merged}
    last: OSError | None = None
    for attempt in range(max(1, retries)):
        tmp = None
        try:
            chaos.maybe_fail("plan_cache_save")
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return
        except OSError as e:  # PlanCacheError is an OSError
            last = e
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if attempt + 1 < max(1, retries):
                time.sleep(0.01 * (2 ** attempt))
    guard.record_event("plan_cache_save_failed", last)
    guard.warn_once(
        ("plan_cache_save", path),
        f"kron guard: plan-cache save to {path!r} failed after "
        f"{max(1, retries)} attempts ({type(last).__name__}: {last}) — "
        "tuning results not persisted",
    )


def _launch_tiles(plan: KronPlan, prob: KronProblem, batch: int | None,
                  dtype_bytes: int) -> tuple:
    """The block tiles a plan's forward plus full backward launches, stage
    by stage: the forward chain's (``chain_fwd``), the transposed chain's
    at the backward M-tile (``chain_bwd``) and the stage backward's
    (``grad``), each from the executor's own checks (``emit.chain_geometry``
    and ``grad_geometry``: the per-block budget, then ``emit.block_tile``);
    a single-factor stage adds the sliced kernels' tiles
    (``kron_sliced.sliced_tiles``, both kinds), which its per-factor rung
    and backward fallback run.  Raises ``VmemOverflowError`` or
    ``LoweringError`` where a kernel cannot take the plan's tiles."""
    prog = lower(plan, prob.ps, prob.qs, batched=batch is not None)
    dtype = _DTYPES.get(dtype_bytes, torch.float32)
    b = batch or 1
    k = prob.k
    out = []
    for ins in prog.instrs:
        if ins.kind == emit_mod.PREKRON:
            ps, qs = (ins.pprod,), (ins.qprod,)
            t_qs = ins.t_qs if ins.t_qs and len(ins.t_qs) == 1 else None
        else:
            ps, qs, t_qs = ins.ps, ins.qs, ins.t_qs
        acc = emit_mod._resolve_acc(ins.acc_dtype, dtype).itemsize
        fs = [(b, p, q) for p, q in zip(ps, qs)]
        k_out = k // math.prod(ps) * math.prod(qs)
        t_b = ins.t_b or 1
        t_m_bwd = ins.t_m_bwd or ins.t_m
        common = dict(t_b=t_b, acc_bytes=acc, in_bytes=dtype_bytes)
        fwd = emit_mod.chain_geometry(
            (b, prob.m, k), fs, t_m=ins.t_m, t_k=ins.t_k, t_qs=t_qs, **common)
        bwd = emit_mod.chain_geometry(
            (b, prob.m, k_out), fs, t_m=t_m_bwd, t_k=ins.t_k, t_qs=t_qs,
            direction="bwd", **common)
        grad = emit_mod.grad_geometry(
            (b, prob.m, k), (b, prob.m, k_out), fs, t_m=t_m_bwd, t_k=ins.t_k, **common)
        tiles = [(fwd.block_m, fwd.block_k), (bwd.block_m, bwd.block_k),
                 (grad.block_m, grad.block_k)]
        if len(ps) == 1:
            s = k // ps[0]
            for kind in ("fwd", "sliced_t"):
                tiles.append(kron_sliced.sliced_tiles(
                    prob.m, s, ps[0], qs[0], acc, kind, dtype_bytes))
        out.append(tuple(tiles))
        k = k_out
    return tuple(out)


def _sweep_candidates(
    base: KronPlan, prob: KronProblem, vmem_budget_elems: int = SMEM_BUDGET_ELEMS
) -> list[KronPlan]:
    """The reference's sweep (``repro.core.autotune._measured_candidates``
    before its batch-tile variants): the analytic plan, then the same plan
    with every stage retiled to ``t_m`` for each ``t_m`` in (4, 8, 16, 32)
    that divides the row count.  The reference retiles the backward stages
    to the same ``t_m``; here each is clamped as ``mirror_bwd_stages``
    clamps it (``_bwd_t_m``), or a forward M-tile would push every stage
    backward out of one block."""
    cands = [base]
    fwd_of = {st.factor_ids: st for st in base.stages}
    for t_m in (4, 8, 16, 32):
        if t_m > prob.m or prob.m % t_m:
            continue

        def retile(st, t_m):
            return Stage(st.factor_ids, st.prekron,
                         TileConfig(t_m, st.tiles.t_s, st.tiles.t_q), st.t_qs, st.acc_dtype)

        bwd = tuple(
            retile(s, _bwd_t_m(prob, fwd_of[s.factor_ids], t_m, vmem_budget_elems))
            for s in (base.bwd_stages or ())
        )
        cands.append(KronPlan(
            tuple(retile(s, t_m) for s in base.stages), bwd or None, base.t_b))
    return cands


def _measured_candidates(
    base: KronPlan, prob: KronProblem, batch: int | None, dtype_bytes: int = 4
) -> list[KronPlan]:
    """The candidates ``_measured_plan`` times: ``_sweep_candidates``, less
    the variants a kernel cannot take (``_launch_tiles`` raises: the run
    would leave the planned kernels for the ladder's rung 1 or the
    backward's per-factor fallback) and those that launch the same block
    tiles as an earlier candidate (a plan's ``t_m`` only bounds the
    kernels' block tile), the analytic plan first, so it wins a tie.  No
    ``t_b`` variants: no kernel reads ``t_b``, so they would rank identical
    launches."""
    cands, seen = [], set()
    for plan in _sweep_candidates(base, prob):
        try:
            tiles = _launch_tiles(plan, prob, batch, dtype_bytes)
        except (VmemOverflowError, LoweringError):
            if plan is base:
                cands.append(plan)
            continue
        if tiles not in seen:
            seen.add(tiles)
            cands.append(plan)
    return cands


def _outside_transforms():
    """A context that leaves any active functorch transform for its body."""
    from torch._functorch import pyfunctorch

    return pyfunctorch.temporarily_clear_interpreter_stack()


def _measure_inputs(prob: KronProblem, batch: int | None, dtype_bytes: int,
                    dev: torch.device):
    """x and factors of the measured runs, from a generator seeded 0 on
    ``dev``, requiring grad."""
    dtype = _DTYPES.get(dtype_bytes, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lead = () if batch is None else (batch,)

    def randn(*shape):
        t = torch.randn(*lead, *shape, generator=gen, device=dev, dtype=torch.float32)
        return t.to(dtype).requires_grad_()

    return randn(prob.m, prob.k), tuple(randn(p, q) for p, q in zip(prob.ps, prob.qs))


def _measured_plan(
    prob: KronProblem,
    *,
    batch: int | None = None,
    dtype_bytes: int,
    backend: str,
    cache_path: str | None,
    device: str | torch.device | None = None,
    vmem_budget_elems: int = SMEM_BUDGET_ELEMS,
    **plan_kwargs,
) -> KronPlan:
    """One measured-tuning path for single and per-sample plans.

    A cache hit returns the stored plan (``plan_cache.hit``).  Otherwise
    (``plan_cache.miss``) each of ``_measured_candidates`` runs what
    training runs: ``KronOp(plan=candidate)`` forward and
    ``torch.autograd.grad`` of ``y.float().sum()`` over x and the factors,
    timed by ``measure_best`` (1 warm-up, 3 runs) on ``device``.  The winner
    is stored with its time (``seconds``), ``measured_at``, the distinct
    candidates (``candidates``, ``describe()`` each) and their times
    (``candidate_seconds``)."""
    dev = measure_device(device)
    path = cache_path or default_cache_path()
    key = plan_cache_key(
        prob, dtype_bytes, backend, vmem_budget_elems=vmem_budget_elems, device=dev,
        **plan_kwargs,
        **({"batch": batch, "shared_factors": False} if batch is not None else {}),
    )
    entries = load_plan_cache(path)
    hit = entries.get(key)
    if hit is not None:
        telemetry.counter_inc("plan_cache.hit")
        return plan_from_json(hit["plan"])
    telemetry.counter_inc("plan_cache.miss")

    base = make_plan(prob, dtype_bytes=dtype_bytes, vmem_budget_elems=vmem_budget_elems,
                     **plan_kwargs)
    if batch is not None:
        base = KronPlan(base.stages, base.bwd_stages, 1)
    cands = _measured_candidates(base, prob, batch, dtype_bytes)
    from . import engine  # engine imports this module at load time

    def fn_of_plan(plan):
        op = engine.KronOp(
            prob.ps, prob.qs, backend=backend, plan=plan,
            **({} if batch is None else {"batch": batch, "shared_factors": False}),
        )
        return lambda: torch.autograd.grad(op(x, factors).float().sum(), (x, *factors))

    timings: list = []
    # A plan resolved inside a functorch transform (the vmap rules) is
    # measured outside it: on plain tensors, with random inputs and autograd.
    with _outside_transforms(), telemetry.span("measure_plan", candidates=len(cands)):
        x, factors = _measure_inputs(prob, batch, dtype_bytes, dev)
        best, seconds = measure_best(fn_of_plan, cands, warmup=1, iters=3, timings=timings)
    entries[key] = {
        "plan": plan_to_json(best),
        "seconds": seconds,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "candidates": [c.describe() for c, _ in timings],
        "candidate_seconds": [t for _, t in timings],
    }
    save_plan_cache(path, entries)
    return best


def _mesh_all(mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of ``mesh`` (a MIN over each
    mesh dim's group)."""
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], device=mesh.device_type)
    for d in range(mesh.ndim):
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.get_group(d))
    return bool(t.item())


def _measure_best_mesh(fn_of_plan, cands, mesh, *, warmup: int, iters: int,
                       timings: list) -> tuple[KronPlan, float]:
    """``measure_best`` on every rank of ``mesh`` at once: each candidate's
    time in a round is the slowest rank's (a MAX over the mesh), so every
    rank ranks the same numbers and picks the same plan (the ranks must
    run the same schedule, or their collectives would not pair up)."""
    import torch.distributed as dist

    runs = []
    for cfg in cands:
        try:
            fn = fn_of_plan(cfg)
            for _ in range(max(1, warmup)):
                out = fn()
        except (VmemOverflowError, LoweringError):
            continue
        runs.append((cfg, fn, _on_cuda(out)))
    if not runs:
        raise PlanError("no candidate executed successfully")
    times = torch.zeros(len(runs), max(1, iters), dtype=torch.float64)
    for it in range(max(1, iters)):
        for j, (_, fn, cuda) in enumerate(runs):
            times[j, it] = time_once(fn, cuda)[0]
    times = times.to(mesh.device_type)
    for d in range(mesh.ndim):
        dist.all_reduce(times, op=dist.ReduceOp.MAX, group=mesh.get_group(d))
    times = times.cpu().tolist()
    timings.extend((cfg, min(t)) for (cfg, _, _), t in zip(runs, times))
    incumbent = times[0]
    winners = [j for j in range(1, len(runs))
               if all(t < i for t, i in zip(times[j], incumbent))]
    best = min(winners, key=lambda j: min(times[j])) if winners else 0
    return runs[best][0], min(times[best])


def _measured_dist_plan(
    prob: KronProblem,
    *,
    batch: int,
    g_k: int,
    mesh,
    data_axis,
    model_axis: str,
    dtype_bytes: int,
    enable_fusion: bool,
    vmem_budget_elems: int,
    acc_dtype: str | None,
    backend: str,
    cache_path: str | None,
    device: str | torch.device | None = None,
) -> KronPlan:
    """Measured tuning of a per-sample distributed plan: each slab-count
    candidate runs the round runner on the caller's mesh, forward and
    ``torch.autograd.grad`` into x and the factors, timed on every rank
    (``_measure_best_mesh``); the winner is kept under the batched plan
    key plus ``;gk=<G_K>``.  Collective: every rank of ``mesh`` calls it
    with the same arguments.  The ranks agree on a cache hit before using
    it (a rank that missed would measure alone), and the mesh's first rank
    writes the cache before any rank returns."""
    dev = measure_device(device)
    path = cache_path or default_cache_path()
    key = plan_cache_key(
        prob, dtype_bytes, backend, enable_fusion=enable_fusion, enable_prekron=False,
        vmem_budget_elems=vmem_budget_elems, batch=batch, shared_factors=False,
        acc_dtype=acc_dtype, device=dev,
    ) + f";gk={g_k}"
    hit = load_plan_cache(path).get(key)
    if _mesh_all(mesh, hit is not None):
        telemetry.counter_inc("plan_cache.hit")
        return plan_from_json(hit["plan"])
    telemetry.counter_inc("plan_cache.miss")
    cands = _dist_plan_candidates(
        prob, dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
        vmem_budget_elems=vmem_budget_elems, acc_dtype=acc_dtype,
    )
    from . import distributed as D

    g_m = D._mesh_size(mesh, data_axis)
    x, factors = _measure_inputs(KronProblem(prob.m * g_m, prob.ps, prob.qs), batch,
                                 dtype_bytes, dev)
    xd = D.sharded_input_batched(x.detach(), mesh, data_axis, model_axis)
    xd.requires_grad_()
    del x  # each rank keeps its shard only

    def fn_of_plan(plan):
        def run():
            y = D.run_batched_distributed_rounds(
                xd, factors, mesh, data_axis=data_axis, model_axis=model_axis,
                backend=backend, n_slabs=plan.n_slabs,
            )
            return torch.autograd.grad(y.to_local().float().sum(), (xd, *factors))

        return run

    timings: list = []
    try:
        with telemetry.span("measure_dist_plan", candidates=len(cands), g_k=g_k):
            best, seconds = _measure_best_mesh(fn_of_plan, cands, mesh, warmup=1, iters=3,
                                               timings=timings)
    except PlanError:
        # No candidate ran on this mesh: the analytic plan, nothing cached.
        return _analytic_dist_plan(
            prob, batch, g_k, dtype_bytes=dtype_bytes, enable_fusion=enable_fusion,
            vmem_budget_elems=vmem_budget_elems, acc_dtype=acc_dtype,
        )
    if all(c == 0 for c in mesh.get_coordinate()):
        entries = load_plan_cache(path)
        entries[key] = {
            "plan": plan_to_json(best),
            "seconds": seconds,
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "candidates": [c.describe() for c, _ in timings],
            "candidate_seconds": [t for _, t in timings],
            "payload_elems": _dist_round_payload_elems(prob, g_k),
        }
        save_plan_cache(path, entries)
    _mesh_all(mesh, True)  # no rank returns before the cache is written
    return best


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
        "n_slabs": plan.n_slabs,
    }


def plan_from_json(d: dict) -> KronPlan:
    """Read a plan dict; entries written before slabs existed are serial."""
    return KronPlan(
        tuple(_stage_from_json(s) for s in d["stages"]),
        (
            tuple(_stage_from_json(s) for s in d["bwd_stages"])
            if d.get("bwd_stages") is not None
            else None
        ),
        int(d.get("t_b", 1)),
        int(d.get("n_slabs", 1)),
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
    "choose_n_slabs",
    "device_memory_budget",
    "measure_best",
    "peak_flops",
    "plan_cache_key",
    "plan_to_json",
    "plan_from_json",
    "load_plan_cache",
    "save_plan_cache",
    "default_cache_path",
    "PEAK_FLOPS",
    "PEAK_FLOPS_F64",
    "HBM_BW",
    "SMEM_BYTES",
    "NVLINK_BW",
    "A2A_LATENCY_S",
]
