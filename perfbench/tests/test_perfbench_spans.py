"""The span readers (``spans.py`` and the metrics that read the program's
``kronscope.*`` ranges) on small hand-built profiler traces (Chrome form, us)."""
import pytest
import torch

from perfbench import harness, spans, trace

HOST, BWD, STREAM = 100, 200, 7
HOST_READERS = ("op.self_us.call", "executor.self_us.call", "launch.host_us.call")
NEW_READERS = HOST_READERS + ("op.self_us", "gp.cg_kernels_per_epoch", "gp.cg_iter_self_us")


def _x(name, ts, dur, cat="user_annotation", tid=HOST, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(events, steps, lo=0, hi=1000):
    ev = [_x(trace.WINDOW, lo, hi - lo)]
    ev += [_x(trace.STEP, lo + 1 + i, 1) for i in range(steps)]
    return trace.Trace.from_chrome({"traceEvents": ev + events})


def _reader(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py", "metric").read


def _run(tr):
    return harness.Run(0.0, None, None, None, tr)


def _call(t0, stage_launch):
    """One forward call at ``t0``: ``kronscope.op`` [t0, t0+80] holding
    ``kronscope.program`` [t0+10, t0+70], which holds a stage per
    ``(stage, launch)`` pair of (start, end) offsets, and a cpu_op range
    that is no ``kronscope`` range."""
    ev = [_x("kronscope.op", t0, 80), _x("kronscope.program", t0 + 10, 60),
          _x("_KronFunction", t0 + 5, 70, cat="cpu_op")]
    for (a, b), (c, d) in stage_launch:
        ev += [_x("kronscope.stage", t0 + a, b - a), _x("kronscope.launch", t0 + c, d - c)]
    return ev


# Two stages: [15, 45] with a launch of 20 us, [50, 68] with one of 8 us.
CALL = (((15, 45), (20, 40)), ((50, 68), (52, 60)))


def test_self_time_of_nested_ranges_on_two_threads():
    # The backward's thread runs while the forward's ranges are open: a range
    # nests only in ranges of its own thread.
    ev = [_x("kronscope.op", 10, 40), _x("kronscope.program", 20, 20),
          _x("kronscope.stage", 22, 16),
          _x("kronscope.op_bwd", 25, 35, tid=BWD), _x("kronscope.stage_grad", 30, 25, tid=BWD),
          _x("kronscope.launch", 35, 10, tid=BWD),
          # Outside the window: left out.
          _x("kronscope.op", 2000, 50)]
    tr = _trace(ev, 1)
    assert spans.self_seconds(tr) == {
        "kronscope.op": pytest.approx(20e-6), "kronscope.program": pytest.approx(4e-6),
        "kronscope.stage": pytest.approx(16e-6), "kronscope.op_bwd": pytest.approx(10e-6),
        "kronscope.stage_grad": pytest.approx(15e-6), "kronscope.launch": pytest.approx(10e-6)}
    run = _run(tr)
    assert _reader("op.self_us.call")(run) == pytest.approx(20)
    # program 4 + stage 16 on the forward's thread, stage_grad 15 on the backward's.
    assert _reader("executor.self_us.call")(run) == pytest.approx(35)
    assert _reader("launch.host_us.call")(run) == pytest.approx(10)
    # The training step's op layer: the forward's op and the backward's entry.
    assert _reader("op.self_us")(run) == pytest.approx(20 + 10)


def test_a_child_past_its_parent_is_clipped_and_siblings_do_not_nest():
    # The stage's end rounds 0.5 us past the program's; the next call's op
    # starts after the program ended but before the stage's rounded end.
    ev = [_x("kronscope.op", 0, 30), _x("kronscope.program", 10, 20),
          _x("kronscope.stage", 12, 18.5), _x("kronscope.op", 30.2, 10)]
    selfs = spans.self_seconds(_trace(ev, 2, lo=-1, hi=100))
    assert selfs["kronscope.program"] == pytest.approx(2e-6)
    assert selfs["kronscope.stage"] == pytest.approx(18.5e-6)
    assert selfs["kronscope.op"] == pytest.approx((10 + 10) * 1e-6)


@pytest.mark.parametrize("n", [1, 3])
def test_a_window_of_n_calls_reads_per_call(n):
    ev = [e for i in range(n) for e in _call(100 * i + 5, CALL)]
    ev.append(_x("kronscope.op", -50, 20))  # before the window
    run = _run(_trace(ev, n))
    # op 80 - program 60; program 60 - stages 30 + 18; stages 10 + 10; launches 20 + 8.
    assert _reader("op.self_us.call")(run) == pytest.approx(20)
    assert _reader("executor.self_us.call")(run) == pytest.approx(12 + 20)
    assert _reader("launch.host_us.call")(run) == pytest.approx(28)


def test_the_three_host_metrics_sum_to_the_op_ranges():
    # Calls of differing shapes: one stage, two stages, a launch straight in
    # the op (a per-factor rung) outside the program.
    ev = _call(0, CALL) + _call(100, (((12, 66), (30, 31)),)) + _call(200, ())
    ev.append(_x("kronscope.launch", 272, 6))
    tr = _trace(ev, 3)
    got = sum(_reader(name)(_run(tr)) for name in HOST_READERS)
    ops = [s for s in spans.ranges(tr) if s.name == spans.OP]
    assert got == pytest.approx(sum(s.dur for s in ops) / 3 * 1e6) == pytest.approx(80)


def _cg_epoch(t0, corr):
    """One epoch at ``t0`` in ``kronscope.cg`` [t0, t0+100]: a fill and an add
    launched in it (CG's), a chain kernel launched in ``kronscope.stage``
    within ``kronscope.program`` and an elementwise kernel launched in
    ``kronscope.program`` (the Kron-Matmul's), all within ``kronscope.op``
    within one ``kronscope.cg_iter`` [t0+15, t0+95]; and after the range, a
    kernel launched outside it."""
    host = [_x("kronscope.cg", t0, 100), _x("kronscope.cg_iter", t0 + 15, 80),
            _x("kronscope.op", t0 + 20, 40),
            _x("kronscope.program", t0 + 25, 30), _x("kronscope.stage", t0 + 30, 20),
            _x("kronscope.launch", t0 + 32, 10)]
    launches = [(t0 + 5, "fill_kernel"), (t0 + 35, "chain_fwd_kernel"),
                (t0 + 52, "copy_kernel"), (t0 + 70, "add_kernel"), (t0 + 150, "after_cg_kernel")]
    ev = list(host)
    for i, (ts, name) in enumerate(launches):
        ev.append(_x("cudaLaunchKernel", ts, 1, cat="cuda_runtime", corr=corr + i))
        ev.append(_x(name, ts + 2, 3, cat="kernel", tid=STREAM, corr=corr + i))
    return ev


def test_cg_kernels_leave_out_the_kron_matmuls_and_what_lies_outside_cg():
    ev = _cg_epoch(0, 10) + _cg_epoch(300, 20)
    # Kernels the trace joins to no launch are placed by name.
    ev += [_x("chain_fwd_kernel", 600, 3, cat="kernel", tid=STREAM),
           _x("reduce_kernel", 610, 3, cat="kernel", tid=STREAM)]
    run = _run(_trace(ev, 2))
    # Each epoch: fill and add; the unjoined reduce once over the two.
    assert _reader("gp.cg_kernels_per_epoch")(run) == pytest.approx(2.5)
    assert _reader("launch.kernels_per_step")(run) == pytest.approx(6)
    # An iteration's 80 us less the op's 40, in each of the two epochs.
    assert _reader("gp.cg_iter_self_us")(run) == pytest.approx(40)


def test_cg_iter_self_time_is_per_iteration():
    # One epoch, three iterations of 30, 20 and 10 us, the first holding an
    # op of 12 us, and an iteration outside the window: (18 + 20 + 10) / 3.
    ev = [_x("kronscope.cg", 0, 100), _x("kronscope.cg_iter", 10, 30),
          _x("kronscope.op", 15, 12), _x("kronscope.cg_iter", 40, 20),
          _x("kronscope.cg_iter", 60, 10), _x("kronscope.cg_iter", 1500, 10)]
    assert _reader("gp.cg_iter_self_us")(_run(_trace(ev, 1))) == pytest.approx(16)


def test_none_without_the_ops_or_cg_ranges():
    # The parent's program: executor and CG kernels, but no op or cg range.
    ev = _call(0, CALL)[1:] + [_x("cudaLaunchKernel", 75, 1, cat="cuda_runtime", corr=1),
                               _x("add_kernel", 80, 3, cat="kernel", tid=STREAM, corr=1)]
    run = _run(_trace(ev, 1))
    for name in NEW_READERS:
        assert _reader(name)(run) is None
    assert _reader("launch.kernels_per_step")(run) == 1
    assert _reader("gp.cg_device_ms")(run) == pytest.approx(3e-3)
    for name in NEW_READERS:
        assert _reader(name)(harness.Run(0.0, None, None, None, None)) is None


def _traced(step_kind, config, traffic, n):
    """``n`` steps of a real step kind at a tiny size on the CPU, traced as
    the harness traces them."""
    kind = harness.load_module(harness.PKG / "steps" / f"{step_kind}.py", "step")
    dev = torch.device("cpu")
    step = kind.Step(config, traffic, 2**33 + 5, dev)
    step.run()
    return harness.trace_steps(step, n, dev)


def test_the_programs_spans_in_a_traced_run_on_the_cpu():
    tr = _traced("kron_fwd", {"ps": [4, 3, 5], "qs": [3, 4, 2], "dtype": "float32"},
                 {"m": 1, "x_bank": 3, "sample_range": 4, "sampled": 1}, 4)
    ops = spans.ranges(tr, (spans.OP,))
    assert len(ops) == 4 and len(spans.ranges(tr, ("kronscope.program",))) == 4
    run = _run(tr)
    got = [_reader(name)(run) for name in HOST_READERS]
    # The CPU runs the kernels' plain twins: no launch.
    assert got[0] > 0 and got[1] > 0 and got[2] == 0
    assert sum(got) == pytest.approx(sum(s.dur for s in ops) / 4 * 1e6)

    cfg = {"points": 3, "dims": 3, "m": 2, "cg_iters": 4, "noise": 0.1, "dtype": "float32",
           "lengthscale_range": [0.15, 0.4]}
    tr = _traced("gp_epoch", cfg, {"factor_sets": 2, "sample_range": 2}, 2)
    assert len(spans.ranges(tr, (spans.CG,))) == 2
    assert len(spans.ranges(tr, ("kronscope.cg_iter",))) == 8
    assert len(spans.ranges(tr, (spans.OP,))) == 2 * (4 + 1)
    assert _reader("gp.cg_kernels_per_epoch")(_run(tr)) is None  # no device kernels
    assert _reader("gp.cg_iter_self_us")(_run(tr)) > 0

    tr = _traced("kron_train", {"ps": [4, 3], "qs": [3, 4], "dtype": "float32"},
                 {"m": 6, "check_rows": 6, "factor_sets": 2}, 3)
    assert len(spans.ranges(tr, (spans.OP,))) == len(spans.ranges(tr, (spans.OP_BWD,))) == 3
    assert _reader("op.self_us")(_run(tr)) > _reader("op.self_us.call")(_run(tr)) > 0
