"""The port's planner (repro_torch.core.autotune) against repro.core.autotune.

The port keeps the JAX planner's algorithm and swaps the TPU v5e hardware
model for an H100's.  So: under the TPU constants the two produce the same
plans (read across through ``plan_from_jax_json``) and the same programs;
under the H100 constants the grouping and Q-tiling, which only the budget
decides, still agree, and every stage the port plans for the smoke shapes
fits one block of the chain kernel."""
import dataclasses
import math

import jax
import pytest

from repro.core import autotune as JA
from repro.core.kron import KronProblem as JProblem
from repro.kernels import emit as JE
from repro_torch.convert import plan_from_jax_json
from repro_torch.core import autotune as TA
from repro_torch.core.kron import KronProblem as TProblem
from repro_torch.kernels import emit as TE
from repro_torch.runtime import guard as TG

jax.config.update("jax_enable_x64", True)

H100_BLOCK_BUDGET = 58112  # 227 KB of f32

SHAPES = [  # the Motivation table of the port's first slice, and (8, 16, 32)
    (1024, (32,) * 4, (32,) * 4),
    (16, (16,) * 6, (16,) * 6),
    (1024, (8,) * 6, (8,) * 6),
    (4096, (64, 40), (128, 76)),
    (8, (8, 16, 32), (8, 16, 32)),
]
SMOKE_SHAPES = [  # chip_smoke.py's main path: (M, ps, qs, dtype bytes)
    (1024, (32,) * 4, (32,) * 4, 4),
    (16, (16,) * 6, (16,) * 6, 4),
    (4096, (64, 40), (128, 76), 2),
    (10, (52, 65), (50, 20), 4),
]
BWD_BENCH_SHAPE = (256, (16,) * 4, (16,) * 4, 4)  # BENCH_bwd.json


@pytest.fixture
def tpu_model(monkeypatch):
    """The port's planner with the JAX package's TPU v5e constants (its f32
    rate: the plans compared here are f32).  The port's kernels contract one
    p at a time, so its model has no padding of P; the JAX model pads P and
    Q to one MXU width, which is set to 1 here on both sides."""
    monkeypatch.setattr(JA, "MXU_DIM", 1)
    for port_name, jax_value in [
        ("PEAK_FLOPS", JA.PEAK_FLOPS_F32),
        ("HBM_BW", JA.HBM_BW),
        ("SMEM_BYTES", JA.VMEM_BYTES),
        ("COL_ALIGN", 1),
        ("ROW_ALIGN", JA.SUBLANE),
    ]:
        monkeypatch.setattr(TA, port_name, jax_value)
    monkeypatch.setattr(TE, "SMEM_BUDGET_ELEMS", JE.VMEM_BUDGET_ELEMS)


def _plans(m, ps, qs, **kw):
    want = plan_from_jax_json(JA.plan_to_json(JA.make_plan(JProblem(m, ps, qs), **kw)))
    got = TA.make_plan(TProblem(m, ps, qs), **kw)
    return got, want


def _bwd_fits(stage, prob, budget):
    """Whether both backward kernels of a forward stage fit the per-block
    budget at the stage's t_k with the backward stage's M-tile ``t_m``:
    ``t_m -> bool``."""
    rps, rqs = prob.ps[::-1], prob.qs[::-1]
    sps = [rps[i] for i in stage.factor_ids]
    sqs = [rqs[i] for i in stage.factor_ids]
    if stage.prekron:
        sps, sqs = [math.prod(sps)], [math.prod(sqs)]
    t_k = stage.tiles.t_s * math.prod(sps)
    t_qs = stage.t_qs if stage.t_qs is not None and len(stage.t_qs) == len(sps) else None
    trans = t_k * TE.transposed_growth(sps, sqs, t_qs)
    live = TE.grad_live_elems(t_k, sps, sqs)
    return lambda t_m: t_m * max(trans, live) <= budget


@pytest.mark.parametrize("prekron", [False, True])
@pytest.mark.parametrize("m,ps,qs", SHAPES)
def test_make_plan_equals_jax_under_tpu_constants(tpu_model, m, ps, qs, prekron):
    """The forward plan equals the JAX planner's.  The backward stages keep
    the JAX planner's tuned tiles, with the port's repair: ``t_m`` is the
    largest divisor of the tuned M-tile at which both backward kernels fit
    the budget at the forward stage's ``t_k`` (1 when none does)."""
    got, want = _plans(
        m, ps, qs, enable_prekron=prekron, vmem_budget_elems=H100_BLOCK_BUDGET
    )
    assert got.stages == want.stages and got.t_b == want.t_b
    prob = TProblem(m, ps, qs)
    assert len(got.bwd_stages) == len(want.bwd_stages)
    for g, w, fwd in zip(got.bwd_stages, want.bwd_stages, reversed(want.stages)):
        fits = _bwd_fits(fwd, prob, H100_BLOCK_BUDGET)
        t_m = max((d for d in range(1, w.tiles.t_m + 1)
                   if w.tiles.t_m % d == 0 and fits(d)), default=1)
        assert g == dataclasses.replace(w, tiles=TA.TileConfig(t_m, w.tiles.t_s, w.tiles.t_q))


@pytest.mark.parametrize("m,ps,qs", SHAPES)
def test_make_plan_grouping_equals_jax_under_h100_constants(m, ps, qs):
    got, want = _plans(m, ps, qs, enable_prekron=False, vmem_budget_elems=H100_BLOCK_BUDGET)
    strip = lambda plan: [(s.factor_ids, s.prekron, s.t_qs) for s in plan.stages]  # noqa: E731
    assert strip(got) == strip(want)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("m,ps,qs", SHAPES + [(4, (2, 3, 2), (3, 2, 2))])
def test_lower_equals_jax(tpu_model, m, ps, qs, batched):
    jplan = JA.make_plan(JProblem(m, ps, qs), vmem_budget_elems=H100_BLOCK_BUDGET)
    want = JA.lower(jplan, ps, qs, batched=batched)
    got = TA.lower(plan_from_jax_json(JA.plan_to_json(jplan)), ps, qs, batched=batched)
    assert got.n_factors == want.n_factors
    assert [dataclasses.asdict(i) for i in got.instrs] == [
        dataclasses.asdict(i) for i in want.instrs
    ]


def test_plan_json_round_trip_reads_jax_dicts():
    jplan = JA.make_plan(JProblem(8, (8, 16, 32), (8, 16, 32)), acc_dtype="float32")
    d = JA.plan_to_json(jplan)
    assert "n_slabs" in d  # the key the mesh rounds' plans carry
    plan = plan_from_jax_json(d)
    assert TA.plan_from_json(TA.plan_to_json(plan)) == plan
    assert plan.describe() == jplan.describe()


def test_default_budget_is_one_h100_block():
    assert TE.SMEM_BYTES == 227 * 1024
    assert TE.SMEM_BUDGET_ELEMS == H100_BLOCK_BUDGET
    prob = TProblem(1024, (32,) * 4, (32,) * 4)
    assert TA.make_plan(prob) == TA.make_plan(prob, vmem_budget_elems=H100_BLOCK_BUDGET)


@pytest.mark.parametrize("m,ps,qs,dtype_bytes", SMOKE_SHAPES)
def test_smoke_stages_fit_one_block(m, ps, qs, dtype_bytes):
    prog = TA.lower(TA.make_plan(TProblem(m, ps, qs), dtype_bytes=dtype_bytes,
                                 enable_prekron=False), ps, qs)
    k = TProblem(m, ps, qs).k
    for ins in prog.instrs:
        t_qs = ins.t_qs or ins.qs
        # The smallest block tile fits: the kernel can always launch.
        assert TE.block_smem_bytes(1, ins.pprod, ins.ps, t_qs, 4,
                                   kind="chain_fwd") <= TE.SMEM_BYTES
        geo = TE.chain_geometry(
            (1, m, k), [(1, p, q) for p, q in zip(ins.ps, ins.qs)],
            t_m=ins.t_m, t_k=ins.t_k, t_qs=ins.t_qs, acc_bytes=4,
        )
        assert TE.block_smem_bytes(geo.block_m, geo.block_k, ins.ps, t_qs, 4,
                                   kind="chain_fwd") <= TE.SMEM_BYTES
        k = k // ins.pprod * ins.qprod


@pytest.mark.parametrize("m,ps,qs,dtype_bytes", SMOKE_SHAPES + [BWD_BENCH_SHAPE])
def test_backward_tiles_fit_both_backward_kernels(m, ps, qs, dtype_bytes):
    """Every stage's backward tiles (the forward t_k with the planner's
    t_m_bwd) pass the transposed chain's and the stage backward's checks,
    so no smoke shape leaves the fused backward for the per-factor
    fallback."""
    prog = TA.lower(TA.make_plan(TProblem(m, ps, qs), dtype_bytes=dtype_bytes,
                                 enable_prekron=False), ps, qs)
    k = TProblem(m, ps, qs).k
    for ins in prog.instrs:
        fs = [(1, p, q) for p, q in zip(ins.ps, ins.qs)]
        k_out = k // ins.pprod * ins.qprod
        t_ins = ins.transpose()
        TE.chain_geometry((1, m, k_out), fs, t_m=t_ins.t_m, t_k=t_ins.t_k,
                          t_qs=t_ins.t_qs, direction="bwd")
        TE.grad_geometry((1, m, k), (1, m, k_out), fs, t_m=t_ins.t_m, t_k=ins.t_k)
        k = k_out


def test_unrepaired_ffn_backward_tile_overflows():
    """The tuned transposed M-tile of the bf16 ffn shape's second stage
    (t_m=16 at t_k=4864) fits neither backward kernel: the repair clamps it."""
    m, ps, qs = 4096, (64, 40), (128, 76)
    ins = TA.lower(TA.make_plan(TProblem(m, ps, qs), dtype_bytes=2,
                                enable_prekron=False), ps, qs).instrs[1]
    tuned = TA.tune_sliced(m, 4864 // 64, 128, 64, dtype_bytes=2).t_m
    assert (ins.t_k, tuned) == (4864, 16) and ins.t_m_bwd < tuned
    fs = [(1, 64, 128)]
    with pytest.raises(TG.VmemOverflowError):
        TE.chain_geometry((1, m, 9728), fs, t_m=tuned, t_k=4864, direction="bwd")
    with pytest.raises(TG.VmemOverflowError):
        TE.grad_geometry((1, m, 4864), (1, m, 9728), fs, t_m=tuned, t_k=4864)
