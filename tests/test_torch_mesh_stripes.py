"""Table 4 row 27 through the port's mesh path, at its small twin, and the
benchmark pieces that check it (``perfbench/reference_mesh.py``,
``cost_mesh.py``, the ``kron_mesh`` step's column draw and readers).

Across processes (``torch_mesh4_ranks.py``, once per module): four gloo
CPU ranks on a ``(1, 4)`` DeviceMesh, each placing only its own stripe of
``x`` (M = 16, six 4 x 4 RBF factors, K = 4,096, rounds [5, 1] as row 27's
on four cards): the output against the dense float64 reference, every slab
count bitwise equal to the serial schedule, the ``relocate`` spans and
``comm.*`` counters against the round schedule, the three planted faults
against ``y_rel``'s limit, and the memory budget (slab choice, the
ladder's gather rung).  In this process: the working-set model, the
memory-aware slab choice, the reference's columns, the per-card cost and
the mesh readers on a synthetic trace."""
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh4_ranks as DRV
from perfbench import cost, cost_mesh, harness, reference, reference_mesh, trace
from repro_torch.core import autotune as TA
from repro_torch.core import distributed as TD
from repro_torch.core import engine
from repro_torch.core.kron import KronProblem
from repro_torch.runtime import guard

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDE_TIMEOUT_S = 300
CELL = ROOT / "perfbench" / "workloads" / "ski32x6-mesh4.json"
LIMIT = json.loads(CELL.read_text())["limits"]["y_rel"]
STEP = harness.load_module(ROOT / "perfbench" / "steps" / "kron_mesh.py", "step")
GIB = 2**30


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh4") / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("FASTKRON_CHAOS", None)
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh4_ranks.py"),
                           str(out)], env=env, capture_output=True, text=True,
                          timeout=SIDE_TIMEOUT_S)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0 and "ALL-OK" in log, log[-6000:]
    return dict(np.load(out))


def _factors(run, s):
    return [torch.from_numpy(f) for f in run[f"set{s}/factors"]]


def _y_rel(got: np.ndarray, x: torch.Tensor, fs, seed: int = 5) -> float:
    """``y_rel`` as the ``kron_mesh`` step reads it: its column draw, the
    worst row's max|got - ref| / max|ref| against ``reference_mesh``."""
    cols = STEP.checked_columns(DRV.K, DRV.G_K, DRV.CHECKED_PER_RANK,
                                torch.Generator().manual_seed(seed))
    ref = reference_mesh.columns(x.double(), fs, cols, DRV.POINTS ** 4)
    return reference.row_rel(torch.from_numpy(got)[:, cols], ref)


def test_stripes_place_the_op_input_without_a_full_x(run):
    assert tuple(run["check/global_shape"]) == (DRV.M, DRV.K)
    assert run["check/no_full_x"] == 1


def test_mesh_op_from_stripes_matches_dense_float64(run):
    x = torch.from_numpy(run["x"]).double()
    want = reference.kron_apply(x, [f.double() for f in _factors(run, 0)])
    assert reference.rel_err(torch.from_numpy(run["mesh/y"]), want) <= 1e-5


@pytest.mark.parametrize("n", ["auto", "2", "4"])
def test_every_slab_count_is_bitwise_serial(run, n):
    assert run[f"check/bitwise/{n}"] == 1


def test_relocate_spans_and_comm_counters_follow_the_rounds(run):
    rounds, n = int(run["check/telemetry/rounds"]), int(run["check/telemetry/n_slabs"])
    assert (rounds, n) == (2, 2)
    assert run["check/telemetry/relocate"] == rounds * n
    assert run["check/telemetry/relocate_wait"] == rounds * n
    assert run["check/telemetry/a2a_calls"] == rounds * n
    k_loc = DRV.K // DRV.G_K
    ps = [DRV.POINTS] * DRV.DIMS
    assert run["check/telemetry/a2a_bytes"] == 4 * TD.comm_elems_per_device(
        DRV.M, k_loc, ps, ps, DRV.G_K)


@pytest.mark.parametrize("fault", ["swap", "drop", "previous_set"])
def test_planted_faults_fail_y_rel(run, fault):
    x = torch.from_numpy(run["x"])
    want_set = 1 if fault == "previous_set" else 0
    got = _y_rel(run[f"fault/{fault}/y"], x, _factors(run, want_set))
    assert got > LIMIT, got
    assert _y_rel(run["mesh/y"], x, _factors(run, 0)) <= LIMIT


def test_the_column_draw_hits_every_rank_stripe():
    k, g_k, per = 2**30, 4, 8
    cols = STEP.checked_columns(k, g_k, per, torch.Generator().manual_seed(2**31 + 11))
    assert len(cols) == 2 + g_k * per and cols[:2] == [0, k - 1]
    for r in range(g_k):
        assert sum(r * k // g_k <= j < (r + 1) * k // g_k for j in cols[2:]) == per


def test_reference_columns_equal_the_dense_reference():
    gen = torch.Generator().manual_seed(3)
    ps, qs = (4, 3, 4, 2), (3, 4, 2, 5)
    fs = [torch.randn(p, q, generator=gen, dtype=torch.float64) for p, q in zip(ps, qs)]
    x = torch.randn(5, math.prod(ps), generator=gen, dtype=torch.float64)
    want = reference.kron_apply(x, fs)
    cols = [0, 7, 33, math.prod(qs) - 1]
    for chunk in (1, 2, 8, 24, 96):
        got = reference_mesh.columns(x, fs, cols, chunk)
        assert float((got - want[:, cols]).abs().max()) <= 1e-12 * float(want.abs().max())
    k_loc = math.prod(ps) // 4
    parts = [reference_mesh.stripe_partial(
        ((k0, x[:, r * k_loc + k0:r * k_loc + k0 + 8]) for k0 in range(0, k_loc, 8)),
        [fs], cols, r * k_loc, 8)[0] for r in range(4)]
    assert torch.allclose(sum(parts), want[:, cols], rtol=0, atol=1e-12 * float(want.abs().max()))
    with pytest.raises(ValueError, match="trailing"):
        reference_mesh.columns(x, fs, cols, 5)


def test_stripe_chunks_remake_the_stripe():
    a = list(reference_mesh.stripe_chunks(torch.Generator().manual_seed(9), 3, 64, 16,
                                          torch.float32, "cpu"))
    b = list(reference_mesh.stripe_chunks(torch.Generator().manual_seed(9), 3, 64, 16,
                                          torch.float32, "cpu"))
    assert [k0 for k0, _ in a] == [0, 16, 32, 48]
    assert all(torch.equal(p, q) for (_, p), (_, q) in zip(a, b))


# ---------------------------------------------------------------------------
# The memory plan and the slab choice
# ---------------------------------------------------------------------------


ROW27 = dict(m_loc=16, k_loc=32 ** 6 // 4, ps=[32] * 6, g_k=4)


@pytest.mark.parametrize("n,gib", [(1, 64), (2, 64), (4, 48)])
def test_row27_working_set_is_what_the_card_holds(n, gib):
    """x's stripe, one output stripe and the slabs in flight: the peaks
    each rank read on four H100s (``PERF.md`` §4)."""
    got = TD.round_working_set_bytes(ROW27["m_loc"], ROW27["k_loc"], ROW27["ps"], ROW27["ps"],
                                     ROW27["g_k"], n_slabs=n)
    assert got == gib * GIB


def test_slab_choice_takes_only_counts_that_fit():
    prob = KronProblem(16, (4,) * 6, (4,) * 6)
    ws = {n: TD.round_working_set_bytes(16, 1024, [4] * 6, [4] * 6, 4, n_slabs=n)
          for n in (1, 2, 4, 8, 16)}
    assert TA.choose_n_slabs(prob, 4) == 1  # by time alone: a small payload runs serial
    assert TA.choose_n_slabs(prob, 4, memory_budget=ws[1]) == 1
    assert TA.choose_n_slabs(prob, 4, memory_budget=ws[4]) == 4  # fits only at more slabs
    assert TA.choose_n_slabs(prob, 4, memory_budget=ws[16]) == 16  # beyond the candidates
    with pytest.raises(guard.PlanError, match="budget"):
        TA.choose_n_slabs(prob, 4, memory_budget=ws[16] - 1)
    big = KronProblem(16, (32,) * 6, (32,) * 6)
    assert TA.choose_n_slabs(big, 4) == 4
    assert TA.choose_n_slabs(big, 4, memory_budget=75 * GIB) == 4
    assert TA.choose_n_slabs(big, 4, memory_budget=50 * GIB) == 4
    with pytest.raises(guard.PlanError, match="budget"):
        TA.choose_n_slabs(big, 4, memory_budget=32 * GIB)


class _StandInMesh:
    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape


def test_mesh_op_resolves_slabs_within_its_budget(monkeypatch):
    ws4 = TD.round_working_set_bytes(16, 1024, [4] * 6, [4] * 6, 4, n_slabs=4)
    op = engine.KronOp((4,) * 6, (4,) * 6, mesh=_StandInMesh((1, 4)))
    assert op._resolve_n_slabs(16, 4) == 1  # no bound off the card: by time alone
    monkeypatch.setattr(TA, "device_memory_budget", lambda device: ws4)
    assert engine.KronOp((4,) * 6, (4,) * 6, mesh=_StandInMesh((1, 4)))._resolve_n_slabs(16, 4) == 4
    monkeypatch.setattr(TA, "device_memory_budget", lambda device: 1024)
    with pytest.raises(guard.PlanError, match="budget"):
        engine.KronOp((4,) * 6, (4,) * 6, mesh=_StandInMesh((1, 4)))._resolve_n_slabs(16, 4)
    monkeypatch.undo()
    assert TA.device_memory_budget("cpu") is None and TA.device_memory_budget(None) is None


def test_mesh_op_budget_on_the_ranks(run):
    ws = run["check/ws"]
    assert ws[0] == ws[1] > ws[2]  # 1 and 2 slabs hold as much; 4 fit where they do not
    assert run["check/budget/n_slabs"] == 4 and run["check/budget/bitwise"] == 1
    assert "budget" in str(run["check/budget/none_fits"])


def test_ladder_refuses_a_gather_that_cannot_fit(run):
    msg = str(run["check/gather/refused"])
    assert "gathered x (16 x 4096)" in msg and "budget" in msg, msg


# ---------------------------------------------------------------------------
# One card's cost and the mesh readers
# ---------------------------------------------------------------------------


def test_mesh_cost_is_one_cards_share():
    ps = (32,) * 6
    c = cost_mesh.mesh_forward(16, ps, ps, 1, 4, "float32")
    assert cost_mesh.rounds(32 ** 6 // 4, ps, ps, 4) == TD.plan_rounds(32 ** 6 // 4, ps, ps, 4)
    assert c.flops == cost.forward_flops(16, ps, ps) // 4
    assert c.a2a_bytes == 4 * TD.comm_elems_per_device(16, 32 ** 6 // 4, ps, ps, 4)
    assert c.bytes == 4 * (2 * 2 * 16 * 2**28 + 6 * 32 * 32)  # two rounds, in and out
    assert c.step_roofline_s == pytest.approx(c.a2a_bytes / 450e9)
    assert c.step_roofline_s >= c.roofline_s


HOST, STREAM, NCCL = 100, 7, 9


def _x(name, cat, ts, dur, tid=HOST, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _mesh_trace(spans: bool = True):
    """Two steps of 50 us: a chain kernel [5, 25] and [55, 75]; the
    exchange's NCCL kernels [20, 40] and [70, 95], launched inside
    ``kronscope.relocate``; a copy [30, 35] beside the first."""
    ev = [
        _x("perfbench.window", "user_annotation", 0, 100),
        _x("perfbench.step", "user_annotation", 1, 48),
        _x("perfbench.step", "user_annotation", 50, 48),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 52, 1, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 29, 1, corr=3),
        _x("cuLaunchKernelEx", "cuda_driver", 12, 1, corr=2),
        _x("cuLaunchKernelEx", "cuda_driver", 62, 1, corr=5),
        _x("chain_fwd_kernel", "kernel", 5, 20, tid=STREAM, corr=1),
        _x("chain_fwd_kernel", "kernel", 55, 20, tid=STREAM, corr=4),
        _x("copy_kernel", "kernel", 30, 5, tid=STREAM, corr=3),
        _x("ncclDevKernel_SendRecv", "kernel", 20, 20, tid=NCCL, corr=2),
        _x("ncclDevKernel_SendRecv", "kernel", 70, 25, tid=NCCL, corr=5),
    ]
    if spans:
        ev += [_x("kronscope.op", "user_annotation", 1, 45),
               _x("kronscope.relocate", "user_annotation", 10, 5),
               _x("kronscope.relocate", "user_annotation", 60, 5)]
    return trace.Trace.from_chrome({"traceEvents": ev})


def _read(name, tr, run_cost=None):
    reader = harness.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", "metric")
    return reader.read(harness.Run(1.0, harness.Window(1.0, 1, [1.0]), None, run_cost, tr))


def test_mesh_readers_on_a_synthetic_trace():
    tr = _mesh_trace()
    device = _read("mesh.a2a_device_ms", tr)
    exposed = _read("mesh.a2a_exposed_ms", tr)
    assert device == pytest.approx((20 + 25) / 2 * 1e-3)
    # NCCL alone: [25, 30], [35, 40] and [75, 95]
    assert exposed == pytest.approx((5 + 5 + 20) / 2 * 1e-3)
    assert exposed <= device
    c = cost_mesh.MeshCost(10, 10, "float32", 9 * 10**3)  # 20 ns over the link
    assert _read("mesh.step_roofline", tr, c) == pytest.approx(20e-9 / 50e-6 * 100)
    assert _read("mesh.step_roofline", tr, cost.Cost(1, 1, "float32")) is None


def test_mesh_readers_read_nothing_without_the_spans():
    tr = _mesh_trace(spans=False)
    assert _read("mesh.a2a_device_ms", tr) is None
    assert _read("mesh.a2a_exposed_ms", tr) is None
