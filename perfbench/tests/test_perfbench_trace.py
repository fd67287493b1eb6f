"""The trace readers on a small synthetic profiler trace (Chrome form, us)."""
import pytest

from perfbench import harness, trace
from perfbench.cost import Cost

HOST, STREAM = 100, 7


def _x(name, cat, ts, dur, tid=HOST, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _two_steps():
    """A 100 us window of two steps.  Step 1 launches a Kron kernel inside
    ``kronscope.program`` and a CG kernel outside it; step 2 the same plus a
    memset and one kernel the trace joins to no launch.  Device intervals:
    [10, 30] kron, [25, 35] cg (overlaps), [60, 70] kron, [72, 76] memset,
    [80, 90] cg, [91, 95] unjoined elementwise kernel."""
    ev = [
        _x("perfbench.window", "user_annotation", 0, 100),
        _x("perfbench.step", "user_annotation", 1, 40),
        _x("perfbench.step", "user_annotation", 45, 40),
        _x("kronscope.program", "user_annotation", 2, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 3, 2, corr=1),
        _x("aten::add", "cpu_op", 15, 6),
        _x("cudaLaunchKernel", "cuda_runtime", 16, 2, corr=2),
        _x("kronscope.program", "user_annotation", 46, 10),
        _x("cuLaunchKernel", "cuda_driver", 47, 2, corr=3),
        _x("aten::mul", "cpu_op", 58, 20),
        _x("cudaMemsetAsync", "cuda_runtime", 59, 1, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 60, 2, corr=5),
        _x("aten::sum", "cpu_op", 86, 3),
        _x("chain_fwd_kernel", "kernel", 10, 20, tid=STREAM, corr=1),
        _x("add_kernel", "kernel", 25, 10, tid=STREAM, corr=2),
        _x("chain_fwd_kernel", "kernel", 60, 10, tid=STREAM, corr=3),
        _x("Memset (Device)", "gpu_memset", 72, 4, tid=STREAM, corr=4),
        _x("mul_kernel", "kernel", 80, 10, tid=STREAM, corr=5),
        _x("sum_kernel", "kernel", 91, 4, tid=STREAM),
        _x("before_window", "kernel", -50, 10, tid=STREAM),
        {"ph": "s", "name": "ac2g", "cat": "ac2g", "id": 1, "ts": 3},
    ]
    return trace.Trace.from_chrome({"traceEvents": ev})


def test_union_merges_and_clips():
    assert trace.union([(5, 8), (1, 3), (2, 4), (9, 20)], 0, 10) == [(1, 4), (5, 8), (9, 10)]
    assert trace.union([(5, 6)], 6, 10) == []


def test_busy_idle_and_kernels_per_step():
    tr = _two_steps()
    assert tr.steps == 2
    assert tr.window_s == pytest.approx(100e-6)
    # [10, 35] + [60, 70] + [72, 76] + [80, 90] + [91, 95]
    assert tr.busy_s == pytest.approx(53e-6)
    assert [s.name for s in tr.kernels()] == [
        "chain_fwd_kernel", "add_kernel", "chain_fwd_kernel", "mul_kernel", "sum_kernel"]
    run = harness.Run(0.0, None, None, Cost(10**9, 10**6, "float32"), tr)
    read = _reader("device.idle")
    assert read(run) == pytest.approx(47.0)
    assert _reader("launch.kernels_per_step")(run) == pytest.approx(2.5)


def _reader(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py", "metric").read


def test_roofline_and_mfu():
    tr = _two_steps()
    c = Cost(int(2 * 495e12 * 1e-6), int(3.35e12 * 2e-6), "float32")  # 2 us compute, 2 us bytes
    run = harness.Run(0.0, None, None, c, tr)
    assert _reader("kron_roofline")(run) == pytest.approx(2e-6 / 26.5e-6 * 100, rel=1e-6)
    assert _reader("step_mfu")(run) == pytest.approx(2e-6 / 50e-6 * 100, rel=1e-6)


def test_device_time_inside_and_outside_the_program_ranges():
    tr = _two_steps()
    ops = {op.corr: op for op in tr.device_ops()}
    names = ("kronscope.program", "kronscope.stage")
    assert tr.launched_in(ops[1], names) is True
    assert tr.launched_in(ops[2], names) is False
    assert tr.launched_in(ops[3], names) is True  # a driver-API launch joins as well
    unjoined = [op for op in tr.device_ops() if op.corr is None]
    assert [op.name for op in unjoined] == ["sum_kernel"]
    assert tr.launched_in(unjoined[0], names) is None
    run = harness.Run(0.0, None, None, None, tr)
    # Outside: add 10 + memset 4 + mul 10 + sum 4 (placed by name) = 28 us over 2 steps.
    assert _reader("gp.cg_device_ms")(run) == pytest.approx(14e-3)


def test_breakdown():
    tr = _two_steps()
    top = tr.top_device_ops()
    assert top[0] == ["chain_fwd_kernel", pytest.approx(30e-6)]
    assert [n for n, _ in top] == ["chain_fwd_kernel", "add_kernel", "mul_kernel",
                                   "Memset (Device)", "sum_kernel"]
    # Idle gaps, labelled at their midpoints: [0, 10] and [35, 60] in a
    # kronscope.program range (5 and 47.5), [70, 72] and [76, 80] in
    # aten::mul, [90, 91] and [95, 100] after the second step's range ended.
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(47e-6)
    assert gaps == {"kronscope.program": pytest.approx(35e-6),
                    "aten::mul": pytest.approx(6e-6),
                    "outside host ranges": pytest.approx(6e-6)}


def test_a_trace_holds_one_window():
    with pytest.raises(ValueError):
        trace.Trace.from_chrome({"traceEvents": [_x("k", "kernel", 0, 1)]})


@pytest.mark.parametrize("variant,base", [
    ("call_ms", "step_ms"), ("call_p95_ms", "step_p95_ms"), ("kron_roofline.call", "kron_roofline"),
    ("call_mfu", "step_mfu"), ("device.idle.call", "device.idle"),
    ("launch.kernels_per_call", "launch.kernels_per_step"), ("op.host_us.call", "op.host_us"),
])
def test_a_one_call_cell_reads_as_a_step_cell(variant, base):
    window = harness.Window(2.0, 4, [0.5, 0.4, 0.6, 0.5])
    c = Cost(10**9, 10**6, "float32")
    run = harness.Run(1.0, window, 2**30, c, _two_steps(), [3.0, 1.0, 2.0])
    assert _reader(variant)(run) == _reader(base)(run)
    assert _reader("step_ms")(run) == 500.0 and _reader("step_p95_ms")(run) == 0.6
    assert _reader("op.host_us")(run) == 2.0 and _reader("peak_mem_gib")(run) == 1.0
