"""KronOp.profile and the cost model it compares against, in the port
(repro_torch.core.engine, .autotune) against repro.core.engine: the stage
cost terms, the drift flags, the report's keys, and the rate each stage is
costed at."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import make_inputs, to_jax, to_torch
from repro.core import KronOp as JKronOp
from repro.core import autotune as JA
from repro.core import engine as JEng
from repro_torch.core import KronOp
from repro_torch.core import autotune as TA
from repro_torch.core import engine as TEng
from repro_torch.core.kron import KronProblem
from repro_torch.runtime import guard, telemetry

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _fresh_state():
    telemetry.reset()
    yield
    telemetry.reset()


def _programs(m, ps, qs, prekron, batched):
    """The same lowered program in both packages (the port's plan read
    across as JSON), with each instruction's input shape."""
    plan = TA.make_plan(KronProblem(m, ps, qs), enable_prekron=prekron)
    jplan = JA.plan_from_json(TA.plan_to_json(plan))
    prog = TA.lower(plan, ps, qs, batched=batched)
    jprog = JA.lower(jplan, ps, qs, batched=batched)
    shapes, k = [], int(np.prod(ps))
    for ins in prog.instrs:
        shapes.append(((3,) if batched else ()) + (m, k))
        k = k // ins.pprod * ins.qprod
    return prog.instrs, jprog.instrs, shapes


@pytest.mark.parametrize("dtype_bytes", [2, 4, 8])
@pytest.mark.parametrize("m,ps,qs,prekron,batched", [
    (16, (4, 4, 4), (4, 4, 4), False, False),
    (16, (4, 4, 4), (4, 4, 4), True, False),
    (8, (4, 2, 3), (3, 2, 4), True, True),
    (32, (64, 40), (128, 76), False, False),
])
def test_stage_flops_bytes_equal_reference(m, ps, qs, prekron, batched, dtype_bytes):
    instrs, jinstrs, shapes = _programs(m, ps, qs, prekron, batched)
    assert len(instrs) == len(jinstrs)
    for ins, jins, shape in zip(instrs, jinstrs, shapes):
        assert TEng._stage_flops_bytes(shape, ins, dtype_bytes) == JEng._stage_flops_bytes(
            shape, jins, dtype_bytes)


@pytest.mark.parametrize("measured,predicted,threshold", [
    ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0], 2.0),
    ([1.0, 8.0, 1.0], [1.0, 1.0, 1.0], 2.0),
    ([0.1, 0.1], [1.0, 0.01], 1.5),
    ([1.0, 1.0], [0.0, 1.0], 2.0),
    ([0.0, 0.0], [1.0, 1.0], 2.0),
    ([1.0, 2.0], [1.0, 2.0], 0.0),
])
def test_stage_drift_equals_reference(measured, predicted, threshold):
    assert TEng._stage_drift(measured, predicted, threshold) == JEng._stage_drift(
        measured, predicted, threshold)


def test_profile_report_has_the_reference_keys():
    """The port's report carries every key of the reference's (a local op:
    no ``comm``), each stage's too, plus the kernel and rate each stage was
    costed at."""
    m, ps, qs = 16, (4, 4, 4), (4, 4, 4)
    x, fs = make_inputs(1, m, ps, qs)
    got = KronOp(ps, qs).profile(to_torch(x), [to_torch(f) for f in fs])
    want = JKronOp(ps, qs, backend="xla").profile(to_jax(x), [to_jax(f) for f in fs])
    assert set(got) == set(want) and "comm" not in got
    assert set(got["signature"]) == set(want["signature"])
    for g, w in zip(got["stages"], want["stages"]):
        assert set(g) == set(w) | {"kernel", "peak_flops"}
        assert g["instr"] == w["instr"] and g["flops"] == w["flops"]
        assert g["bytes"] == w["bytes"] and g["measured_s"] > 0
    assert got["plan"] == want["plan"] and got["program"] == want["program"]
    assert got["cost_flops"] == want["cost_flops"]
    assert abs(sum(s["share_measured"] for s in got["stages"]) - 1) < 1e-9


def test_profile_per_sample_op():
    x, fs = make_inputs(2, 8, (4, 4), (4, 4), batch=3)
    report = KronOp((4, 4), (4, 4), batch=3, shared_factors=False).profile(
        to_torch(x), [to_torch(f) for f in fs], warmup=0, iters=1)
    assert report["signature"]["batch"] == 3 and report["stages"]
    assert "t_b=1" in report["stages"][0]["instr"]


def test_profile_of_unfused_op_raises():
    x, fs = make_inputs(3, 8, (4, 4), (4, 4))
    with pytest.raises(guard.PlanError):
        KronOp((4, 4), (4, 4), plan=None).profile(to_torch(x), [to_torch(f) for f in fs])


def test_cost_model_drift_fires_with_telemetry_on():
    """A threshold every real split crosses flags stages: one
    ``cost_model_drift`` event each, and the report is stamped into the
    registry; with telemetry off nothing is recorded."""
    ps = qs = (4, 4, 4, 4)
    x, fs = make_inputs(4, 8, ps, qs)
    plan = TA.KronPlan(tuple(
        TA.Stage((i,), False, TA.TileConfig(8, 64, 4)) for i in range(4)))
    op = KronOp(ps, qs, plan=plan)
    xt, ft = to_torch(x), [to_torch(f) for f in fs]
    off = op.profile(xt, ft, drift_threshold=1.0 + 1e-12)
    assert off["drift_flagged"] and not telemetry.active()
    telemetry.configure()
    report = op.profile(xt, ft, drift_threshold=1.0 + 1e-12)
    snap = telemetry.snapshot()
    assert snap["counters"]["event.cost_model_drift"] == len(report["drift_flagged"]) > 0
    assert telemetry.summary_line().endswith("]") and "last_profile=never" not in (
        telemetry.summary_line())
    quiet = op.profile(xt, ft, drift_threshold=1e9)
    assert quiet["drift_flagged"] == []


@pytest.mark.parametrize("m,ps,qs,dtype,prekron", [
    (64, (64, 40), (128, 76), torch.bfloat16, False),  # ffn: single-factor bf16 stages
    (16, (16, 16, 16), (16, 16, 16), torch.float32, False),
    (16, (16, 16), (16, 16), torch.float64, False),
    (8, (4, 4), (4, 4), torch.bfloat16, True),  # one prekron stage
    (8, (8,), (8,), torch.bfloat16, False),
])
def test_profile_costs_every_stage_at_the_cuda_cores_rate(m, ps, qs, dtype, prekron):
    """The planned forward runs chain_fwd, which does every dtype's
    arithmetic on the CUDA cores: each profiled stage, bf16 single-factor
    and prekron stages included, is costed at the dtype's CUDA-core rate."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, int(np.prod(ps)), generator=gen).to(dtype)
    fs = [torch.randn(p, q, generator=gen).to(dtype) for p, q in zip(ps, qs)]
    report = KronOp(ps, qs, enable_prekron=prekron).profile(x, fs, warmup=0, iters=1)
    want = TA.PEAK_FLOPS_F64 if dtype == torch.float64 else TA.PEAK_FLOPS
    assert TA.peak_flops(x.element_size()) == want
    assert {s["kernel"] for s in report["stages"]} == {"chain_fwd"}
    assert {s["peak_flops"] for s in report["stages"]} == {want}
    for s in report["stages"]:
        assert s["predicted_s"] == pytest.approx(s["flops"] / want + s["bytes"] / TA.HBM_BW)
    assert any(s["instr"].startswith("prekron") for s in report["stages"]) == prekron


def test_predict_seconds_costs_f64_at_its_own_rate():
    """The tile model ranks the chain kernels' tiles at the CUDA cores'
    rate of the dtype: f64 at half of f32's where the compute term binds."""
    cfg = TA.TileConfig(64, 64, 256)  # 256 x 256 factor: 62 FLOP per byte
    f32 = TA.predict_seconds(64, 64, 256, 256, cfg, 4)
    f64 = TA.predict_seconds(64, 64, 256, 256, cfg, 8)
    assert f64 / f32 == pytest.approx(TA.PEAK_FLOPS / TA.PEAK_FLOPS_F64)
    assert TA.predict_seconds(64, 64, 256, 256, cfg, 2) == f32
