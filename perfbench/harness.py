"""One run of one cell: set-up, the measured window, the check, the result line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>.json``),
its step kind (``steps/<step>.py``, a class ``Step``), its traffic and the
limit of each number its check compares.  Its metrics are the entries of
``BENCHMARK.json`` that apply to it, each read by ``metrics/<metric>.py``
(a function ``read(run)``).  A later cell, traffic or metric is a new file
and a new entry; nothing here names one.

A run:

1. set-up: the step kind makes its inputs on the device from the seed and
   builds the program's op; ``warmup_steps`` steps build the kernels (the
   first run in a checkout compiles them) and warm every shape;
2. with ``--trace 1``: ``traced_steps`` steps under ``torch.profiler``
   with the program's telemetry spans on, then ``host_steps`` steps timed
   on the host clock, each started on an idle device;
3. the window: steps back to back for ``--seconds``, a CUDA event at each
   step boundary, the host at most ``LEAD`` steps ahead of the device,
   and one synchronisation that closes it;
4. the peak memory of the window is read, the program's state freed, and
   the step kind's check compares what the window produced with the plain
   reference (``reference.py``);
5. the result line: end-to-end metrics with ``--trace 0``, per-layer ones
   with ``--trace 1``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Settings of the program that change what it computes or add work to it.
REFUSED_ENV = ("FASTKRON_CHAOS", "FASTKRON_NUMERICS")
LEAD = 2  # steps the host may issue ahead of the device in the window


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, tag: str):
    """Import a step kind or metric reader from its file, by path."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(path.parents[1])}")
    name = f"perfbench_{tag}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    bench: dict

    @classmethod
    def load(cls, name: str, pkg: Path = PKG) -> "Cell":
        workload = _load_json(pkg / "workloads" / f"{name}.json")
        config = _load_json(pkg / "configs" / f"{workload['config']}.json")
        bench = _load_json(pkg.parent / "BENCHMARK.json")
        for entry in bench["workloads"]:
            if entry["name"] == name and (entry["config"], entry["chips"]) != (
                    workload["config"], workload["chips"]):
                raise ValueError(f"{name}: BENCHMARK.json and workloads/{name}.json disagree")
        return cls(name, workload, config, bench)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def metrics(self, trace: bool) -> list[dict]:
        entries = self.bench["per_layer" if trace else "end_to_end"]
        return [e for e in entries if "workloads" not in e or self.name in e["workloads"]]


@dataclass
class Window:
    seconds: float  # host clock: first step issued to the device's end
    steps: int
    step_ms: list[float]  # CUDA events at the step boundaries


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window: Window
    peak_bytes: int | None
    cost: object  # cost.Cost of one step
    trace: object = None  # trace.Trace of the traced steps
    host_us: list[float] = field(default_factory=list)


class _HostEvent:
    """``torch.cuda.Event``'s interface on the host clock, for a run on the
    CPU (the tests')."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device):
    import torch

    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()


def measure_window(step, seconds: float, device, t_start: float) -> tuple[Window, float]:
    """Steps back to back until ``seconds`` have passed on the host clock,
    then one synchronisation.  Returns the window and the set-up seconds
    (``t_start`` to the first step).

    The host stays at most ``LEAD`` steps ahead of the device: before it
    issues a step it waits for the end of the step ``LEAD`` before it.  The
    device always has the next step queued, and the window ends within a
    step of ``seconds`` (unbounded, a device-bound cell's launch queue holds
    some ten seconds of work)."""
    _sync(device)
    step.start_window()
    events = [_event(device)]
    gc.collect()
    gc.disable()  # as timeit does: no collector pass over the window's events
    try:
        t0 = time.perf_counter()
        events[0].record()
        n = 0
        while True:
            if n >= LEAD:
                events[n - LEAD + 1].synchronize()
            step.run()
            ev = _event(device)
            ev.record()
            events.append(ev)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        t1 = time.perf_counter()
    finally:
        gc.enable()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return Window(t1 - t0, n, step_ms), t0 - t_start


def trace_steps(step, n: int, device):
    """``n`` steps under ``torch.profiler`` (host and device) with the
    program's telemetry spans on, inside one ``perfbench.window`` range that
    ends after the device has finished."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.runtime import telemetry

    from . import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):  # the profiler's own start-up, left out
        step.run()
        _sync(device)
    telemetry.configure(annotate=True)
    try:
        _sync(device)
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                for _ in range(n):
                    with record_function(trace.STEP):
                        step.run()
                _sync(device)
    finally:
        telemetry.disable()
    return trace.Trace.from_profiler(prof)


def host_times(step, n: int, device) -> list[float]:
    """Host microseconds of ``n`` steps, each issued on an idle device, so
    that no launch waits for room in the queue."""
    out = []
    for _ in range(n):
        _sync(device)
        t = time.perf_counter()
        step.run()
        out.append((time.perf_counter() - t) * 1e6)
    _sync(device)
    return out


def _finite(v: float) -> float | None:
    return v if math.isfinite(v) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             impl: str = "program", t_start: float | None = None, pkg: Path = PKG) -> dict:
    """One run of cell ``name``; returns the result object.  ``impl="control"``
    puts the reference, in the precision below the configuration's, in the
    program's place."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell.load(name, pkg)
    dev = torch.device(device)
    # The configurations state float32: no library matmul may drop to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = load_module(pkg / "steps" / f"{cell.workload['step']}.py", "step")
    traffic = cell.traffic
    step = kind.Step(cell.config, traffic, seed, dev, impl)
    for _ in range(int(traffic["warmup_steps"])):
        step.run()
    _sync(dev)

    tr, host_us = None, []
    if trace:
        tr = trace_steps(step, int(traffic["traced_steps"]), dev)
        host_us = host_times(step, int(traffic.get("host_steps", 0)), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window, setup_s = measure_window(step, seconds, dev, t_start)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    run = Run(setup_s, window, peak, step.cost(), tr, host_us)

    step.finish()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = step.check()
    limits = cell.workload["limits"]
    if set(readings) != set(limits):
        raise KeyError(f"{name}: readings {sorted(readings)} but limits {sorted(limits)}")
    checks, failed = {}, 0
    for key, values in readings.items():
        # A NaN fails every comparison; a number with nothing to compare fails too.
        failed += sum(1 for v in values if not v <= limits[key]) if values else 1
        worst = max(values) if values and all(map(math.isfinite, values)) else math.inf
        checks[key] = {"value": _finite(worst), "limit": limits[key]}
    del step
    gc.collect()

    metrics = {}
    for entry in cell.metrics(trace):
        value = load_module(pkg / "metrics" / f"{entry['name']}.py", "metric").read(run)
        if value is None:
            if not trace and dev.type == "cuda":
                raise ValueError(f"{entry['name']}: no reading in {name}")
            continue
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result = {"correct": failed == 0, "attempted": window.steps, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv: list[str], t_start: float) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    refused = [v for v in REFUSED_ENV if os.environ.get(v)]
    if refused:
        print(f"perfbench: refusing to run with {', '.join(refused)} set", file=sys.stderr)
        return 2
    cell = Cell.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


__all__ = ["Cell", "Run", "Window", "run_cell", "main", "forbidden_modules", "load_module"]
