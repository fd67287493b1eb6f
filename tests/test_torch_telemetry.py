"""The port's KronScope telemetry (repro_torch.runtime.telemetry, .events)
against repro.runtime.telemetry on the same calls: the registry, the
percentiles, the JSONL stream and the Chrome trace; the spans the port's
KronOp records; and the off-path contract, pinned with torch.profiler on
the CPU: telemetry off enters no record_function range."""
import json
import time
import warnings

import numpy as np
import pytest
import torch

from _torch_parity import make_inputs, to_torch
from repro.runtime import telemetry as JT
from repro_torch.core import KronOp
from repro_torch.runtime import chaos, guard, telemetry
from repro_torch.runtime.events import EventSink, get_logger


@pytest.fixture(autouse=True)
def _fresh_state():
    guard.reset_health()
    telemetry.reset()
    JT.reset()
    yield
    guard.reset_health()
    telemetry.reset()
    JT.reset()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


SAMPLES = [float(v) for v in np.random.default_rng(5).permutation(np.arange(1, 101))]


def _drive(tel):
    """The same calls into either package's telemetry."""
    with tel.span("outer", tag="a"):
        with tel.span("inner", k=2):
            tel.event("ping", detail="x")
    tel.counter_inc("c", 2)
    tel.counter_inc("c")
    tel.gauge_set("g", 3.5)
    tel.gauge_set("comm.round0.elems_per_device", 96.0)
    tel.gauge_set("comm.round0.slab0.elems_per_device", 48.0)
    tel.gauge_set("comm.round0.slab1.elems_per_device", 48.0)
    tel.gauge_set("comm.round1.elems_per_device", 10.0)
    for v in SAMPLES:
        tel.observe("lat", v)
    tel.record_span("request", time.perf_counter(), 0.25, rid=7)
    tel.mark_profile({"signature": {"m": 4}, "measured_s": 0.5, "stages": [1, 2],
                      "drift_flagged": []})


_TIMES = ("ts", "dur", "tid", "pid", "at")


def _untimed(rec):
    return {k: (_untimed(v) if isinstance(v, dict) else v)
            for k, v in rec.items() if k not in _TIMES}


def test_registry_and_exports_match_the_reference(tmp_path):
    outs = {}
    for name, tel in (("port", telemetry), ("jax", JT)):
        jl, tr = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.trace.json"
        tel.configure(jsonl=str(jl), trace=str(tr), annotate=False)
        _drive(tel)
        line = tel.summary_line()
        outs[name] = dict(
            snap=tel.snapshot(), pct=tel.percentiles("lat"), comm=tel.comm_summary(),
            line=line[: line.index("last_profile=")], final=tel.shutdown(),
            jsonl=[_untimed(r) for r in _read_jsonl(jl)],
            trace=json.load(open(tr)),
        )
        assert not tel.active()
    port, ref = outs["port"], outs["jax"]
    assert port["pct"] == ref["pct"]
    assert port["comm"] == ref["comm"] and port["comm"][0]["hidden"] == 48.0
    assert port["line"] == ref["line"]
    for key in ("snap", "final"):
        a, b = port[key], ref[key]
        assert set(a) == set(b)
        for k in ("counters", "gauges", "spans", "events"):
            assert a[k] == b[k], k
        assert set(a["histograms"]) == set(b["histograms"])
        assert a["histograms"]["lat"] == b["histograms"]["lat"]
        for h in a["histograms"]:
            assert a["histograms"][h]["count"] == b["histograms"][h]["count"]
        assert _untimed(a["last_profile"]) == _untimed(b["last_profile"])
    assert port["jsonl"] == ref["jsonl"]
    spans = {r["name"]: r for r in port["jsonl"] if r["kind"] == "span"}
    assert spans["inner"]["depth"] == 1 and spans["outer"]["depth"] == 0
    assert spans["outer"]["attrs"] == {"tag": "a"}
    pt, rt = port["trace"], ref["trace"]
    assert [_untimed(e) for e in pt["traceEvents"]] == [_untimed(e) for e in rt["traceEvents"]]
    assert pt["displayTimeUnit"] == rt["displayTimeUnit"]
    assert pt["otherData"]["producer"] == rt["otherData"]["producer"] == "kronscope"
    for e in pt["traceEvents"]:
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    assert set(JT.__all__) <= set(telemetry.__all__)


def test_histogram_percentiles():
    telemetry.configure()
    JT.configure(annotate=False)
    for v in range(1, 101):
        telemetry.observe("lat", float(v))
        JT.observe("lat", float(v))
    p = telemetry.percentiles("lat")
    assert p == JT.percentiles("lat")
    assert p["count"] == 100 and p["min"] == 1.0 and p["max"] == 100.0
    assert p["p50"] == 50.0 and p["p95"] == 95.0 and p["p99"] == 99.0
    assert abs(p["mean"] - 50.5) < 1e-9
    assert telemetry.percentiles("nothing") is None


def test_span_off_is_shared_noop_and_metrics_noop():
    s1 = telemetry.span("anything", x=1)
    assert s1 is telemetry.span("else")
    with s1:
        pass
    telemetry.counter_inc("c")
    telemetry.gauge_set("g", 1.0)
    telemetry.observe("h", 1.0)
    telemetry.event("e")
    telemetry.record_span("r", 0.0, 1.0)
    assert telemetry.percentiles("h") is None
    assert telemetry.snapshot() == {} and telemetry.comm_summary() == {}
    assert telemetry.summary_line() == "kronscope[off]"
    assert telemetry.shutdown() is None and telemetry.write_chrome_trace("x") is None


def _op_call():
    x, fs = make_inputs(50, 8, (4, 4), (4, 4), dtype=np.float32)
    return KronOp((4, 4), (4, 4)), to_torch(x), [to_torch(f) for f in fs]


def _kronscope_ranges(fn) -> set:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages() if e.key.startswith("kronscope.")}


def test_off_enters_no_record_function():
    op, x, fs = _op_call()
    op(x, fs)  # plans resolved outside the profiled windows
    assert _kronscope_ranges(lambda: op(x, fs)) == set()
    telemetry.configure()
    on = _kronscope_ranges(lambda: op(x, fs))
    assert {"kronscope.program", "kronscope.stage"} <= on
    telemetry.configure(annotate=False)  # timed host-side, no ranges
    assert _kronscope_ranges(lambda: op(x, fs)) == set()
    assert telemetry.snapshot()["histograms"]["span.stage"]["count"] == 1
    telemetry.reset()
    assert _kronscope_ranges(lambda: op(x, fs)) == set()


def test_op_call_records_program_stage_and_grad_spans(tmp_path):
    op, x, fs = _op_call()
    telemetry.configure(jsonl=str(tmp_path / "op.jsonl"))
    xt = x.clone().requires_grad_()
    ft = [f.clone().requires_grad_() for f in fs]
    torch.autograd.grad(op(xt, ft).sum(), [xt, *ft])
    hists = telemetry.shutdown()["histograms"]
    assert {"span.program", "span.stage", "span.stage_grad"} <= set(hists)
    names = {r["name"] for r in _read_jsonl(tmp_path / "op.jsonl")}
    assert {"program", "stage", "stage_grad"} <= names


def test_chaos_fault_emits_rung_fallback_event(tmp_path):
    op, x, fs = _op_call()
    ref = op(x, fs)
    guard.reset_health()
    jl = tmp_path / "chaos.jsonl"
    telemetry.configure(jsonl=str(jl))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.GuardWarning)
        with chaos.inject("stage_execute:times=1"):
            y = op(x, fs)
    assert torch.equal(ref, y)
    telemetry.shutdown()
    events = [r for r in _read_jsonl(jl) if r["kind"] == "event"]
    names = [r["name"] for r in events]
    assert "chaos_injected" in names
    [fb] = [r for r in events if r["name"] == "rung_fallback"]
    assert fb["error"] == "VmemOverflowError" and fb["rung"] == 0
    [warned] = [r for r in events if r["name"] == "guard_warning"]
    assert "degrading" in warned["message"]


def test_health_report_merges_telemetry_and_describe_suffix():
    op, _, _ = _op_call()
    assert "telemetry" not in guard.health_report()
    assert "kronscope" not in op.describe()
    telemetry.configure()
    telemetry.counter_inc("plan_cache.hit", 4)
    assert guard.health_report()["telemetry"]["counters"]["plan_cache.hit"] == 4
    assert "kronscope[" in op.describe()
    telemetry.reset()
    assert "kronscope" not in op.describe()


def test_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(telemetry, "SPAN_BUFFER", 4)
    telemetry.configure()
    for _ in range(6):
        with telemetry.span("s"):
            pass
    snap = telemetry.snapshot()
    assert snap["spans"] == 6 and snap["histograms"]["span.s"]["count"] == 6


def test_event_sink_appends_valid_lines(tmp_path):
    path = tmp_path / "sink.jsonl"
    sink = EventSink(str(path))
    sink.emit({"a": 1})
    sink.emit({"b": [1, 2]})
    sink.close()
    assert _read_jsonl(path) == [{"a": 1}, {"b": [1, 2]}]
    assert sink.emitted == 2


def test_get_logger_prints_bare_message(capsys):
    log = get_logger("repro_torch.guard")
    assert log.name.startswith("repro_torch")
    log.warning("[guard] hello")
    assert capsys.readouterr().out == "[guard] hello\n"
