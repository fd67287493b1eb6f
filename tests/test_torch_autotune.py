"""The port's planner (repro_torch.core.autotune) against repro.core.autotune.

The port keeps the JAX planner's algorithm and swaps the TPU v5e hardware
model for an H100's.  So: under the TPU constants the two produce the same
plans (read across through ``plan_from_jax_json``) and the same programs;
under the H100 constants the grouping and Q-tiling, which only the budget
decides, still agree, and every stage the port plans for the smoke shapes
fits one block of the chain kernel."""
import dataclasses

import jax
import pytest

from repro.core import autotune as JA
from repro.core.kron import KronProblem as JProblem
from repro.kernels import emit as JE
from repro_torch.convert import plan_from_jax_json
from repro_torch.core import autotune as TA
from repro_torch.core.kron import KronProblem as TProblem
from repro_torch.kernels import emit as TE

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


@pytest.mark.parametrize("prekron", [False, True])
@pytest.mark.parametrize("m,ps,qs", SHAPES)
def test_make_plan_equals_jax_under_tpu_constants(tpu_model, m, ps, qs, prekron):
    got, want = _plans(
        m, ps, qs, enable_prekron=prekron, vmem_budget_elems=H100_BLOCK_BUDGET
    )
    assert got == want


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
    assert "n_slabs" in d  # a key only the JAX mesh rounds read
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
        assert TE.block_smem_bytes(1, ins.pprod, ins.ps, t_qs, 4) <= TE.SMEM_BYTES
        geo = TE.chain_geometry(
            (1, m, k), [(1, p, q) for p, q in zip(ins.ps, ins.qs)],
            t_m=ins.t_m, t_k=ins.t_k, t_qs=ins.t_qs, acc_bytes=4,
        )
        assert TE.block_smem_bytes(geo.block_m, geo.block_k, ins.ps, t_qs, 4) <= TE.SMEM_BYTES
        k = k // ins.pprod * ins.qprod
