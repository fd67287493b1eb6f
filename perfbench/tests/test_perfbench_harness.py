"""The harness driven on the CPU at tiny sizes: the import guard, cells found
by name, the control and planted faults coming out not correct, the CLI's
refusals, and BENCHMARK.json against the contract's rules."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

PKG = harness.PKG
ROOT = harness.ROOT
SRC = ROOT / "src"

TINY_CONFIGS = {
    "tiny-kron": {"name": "tiny-kron", "ps": [4, 3, 5], "qs": [3, 4, 2], "dtype": "float32",
                  "reduced": []},
    "tiny-ski": {"name": "tiny-ski", "points": 4, "dims": 3, "m": 3, "cg_iters": 4,
                 "noise": 0.1, "dtype": "float32", "lengthscale_range": [0.15, 0.4],
                 "reduced": []},
}
# Each tiny cell stands for a real one: same step kind, the real cell's limits.
TINY_CELLS = {
    "tiny-train": ("kron32x4-m1024-train", "tiny-kron",
                   {"m": 8, "factor_sets": 3, "warmup_steps": 2, "traced_steps": 3,
                    "host_steps": 3, "check_rows": 3}),
    "tiny-fwd": ("kron32x4-m1-fwd", "tiny-kron",
                 {"m": 1, "x_bank": 5, "sample_range": 40, "sampled": 4, "warmup_steps": 2,
                  "traced_steps": 10, "host_steps": 5}),
    "tiny-epoch": ("ski16x6-epoch", "tiny-ski",
                   {"factor_sets": 3, "sample_range": 10, "warmup_steps": 2, "traced_steps": 3}),
}
SEED = 2**33 + 12345


def _read(path):
    return json.loads(Path(path).read_text())


@pytest.fixture
def bench(tmp_path):
    """A copy of the benchmark (``perfbench/`` and ``BENCHMARK.json``) with the
    tiny configurations and cells added; returns its ``perfbench`` dir."""
    shutil.copytree(PKG, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    pkg = tmp_path / "perfbench"
    for name, cfg in TINY_CONFIGS.items():
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, (real, cfg, traffic) in TINY_CELLS.items():
        w = _read(PKG / "workloads" / f"{real}.json")
        w.update(config=cfg, traffic=traffic)
        (pkg / "workloads" / f"{name}.json").write_text(json.dumps(w))
    return pkg


def _run(pkg, cell, impl="program", trace=False):
    return harness.run_cell(cell, SEED, 0.2, trace, device="cpu", impl=impl, pkg=pkg)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_program_is_correct_and_control_is_not(bench, cell):
    ok = _run(bench, cell)
    assert ok["correct"] and ok["failed"] == 0 and ok["attempted"] > 0, ok["checks"]
    assert list(ok)[-1] == "checks"
    for c in ok["checks"].values():
        assert c["value"] < c["limit"] / 10
    bad = _run(bench, cell, impl="control")
    assert not bad["correct"] and bad["failed"] > 0, bad["checks"]


def _altered_answer(monkeypatch):
    from repro_torch.core import engine

    orig = engine._kron_forward

    def altered(x, factors, plan, backend, batched):
        y = orig(x, factors, plan, backend, batched).clone()
        y.view(-1)[0] += 1e-3 * y.abs().max()
        return y

    monkeypatch.setattr(engine, "_kron_forward", altered)


def _nan_answer(monkeypatch):
    from repro_torch.core import engine

    orig = engine._kron_forward

    def nan(x, factors, plan, backend, batched):
        return torch.full_like(orig(x, factors, plan, backend, batched), float("nan"))

    monkeypatch.setattr(engine, "_kron_forward", nan)


def _half_batch(monkeypatch):
    """The factor gradients from the first half of the rows, scaled as a
    mean over them; the rest left out."""
    from repro_torch.core import engine

    orig = engine._program_bwd

    def half(plan, backend, x, factors, g, *rest):
        g = g.clone()
        h = g.shape[0] // 2
        g[:h] *= 2
        g[h:] = 0
        return orig(plan, backend, x, factors, g, *rest)

    monkeypatch.setattr(engine, "_program_bwd", half)


def _stale_gradients(monkeypatch):
    from repro_torch.core import engine

    orig, first = engine._program_bwd, []

    def stale(*args):
        if not first:
            first.append(orig(*args))
        return first[0]

    monkeypatch.setattr(engine, "_program_bwd", stale)


def _stale_output(monkeypatch):
    from repro_torch.core import engine

    orig, first = engine._kron_forward, []

    def stale(*args):
        if not first:
            first.append(orig(*args))
        return first[0]

    monkeypatch.setattr(engine, "_kron_forward", stale)


def _unchanged_state(monkeypatch):
    """CG hands back the previous epoch's answer unchanged."""
    from repro_torch.gp import ski

    orig, prev = ski.conjugate_gradient, []

    def stale(matvec, b, **kw):
        out = orig(matvec, b, **kw)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out

    monkeypatch.setattr(ski, "conjugate_gradient", stale)


def _zero_start(monkeypatch):
    """CG returns its start: x = 0 and the start's residual norm |v|."""
    from repro_torch.gp import ski

    monkeypatch.setattr(ski, "conjugate_gradient",
                        lambda matvec, b, **kw: (torch.zeros_like(b), b.norm(dim=-1)))


def _fewer_iterations(monkeypatch):
    """CG stops one iteration short."""
    from repro_torch.gp import ski

    orig = ski.conjugate_gradient
    monkeypatch.setattr(ski, "conjugate_gradient",
                        lambda matvec, b, *, iters=10, **kw: orig(matvec, b, iters=iters - 1, **kw))


def _half_rows(monkeypatch):
    """CG solves the first half of the rows; the rest keep the zero start."""
    from repro_torch.gp import ski

    orig = ski.conjugate_gradient

    def half(matvec, b, **kw):
        h = b.shape[0] // 2
        x, res = orig(matvec, b[:h], **kw)
        return torch.cat([x, torch.zeros_like(b[h:])]), torch.cat([res, b[h:].norm(dim=-1)])

    monkeypatch.setattr(ski, "conjugate_gradient", half)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-train", _altered_answer),
    ("tiny-train", _half_batch),
    ("tiny-train", _stale_gradients),
    ("tiny-fwd", _altered_answer),
    ("tiny-fwd", _stale_output),
    ("tiny-fwd", _nan_answer),
    ("tiny-epoch", _altered_answer),
    ("tiny-epoch", _unchanged_state),
    ("tiny-epoch", _zero_start),
    ("tiny-epoch", _fewer_iterations),
    ("tiny-epoch", _half_rows),
], ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(bench, cell)
    assert not r["correct"] and r["failed"] > 0, r["checks"]
    if fault is _nan_answer:
        assert all(c["value"] is None for c in r["checks"].values())


def test_traced_run_reads_per_layer_metrics_on_the_cpu(bench):
    r = _run(bench, "tiny-train", trace=True)
    assert r["correct"]
    assert r["device"]["platform"] == "cpu" and r["device"]["window_s"] > 0
    # No device activity on the CPU: every metric read from the device is left out.
    device_read = {m["name"] for m in _read(ROOT / "BENCHMARK.json")["per_layer"]
                   if m["source"] == "device_trace"}
    assert device_read and not device_read & set(r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_imports_no_jax_and_not_the_jax_package(bench):
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]
import perfbench
from perfbench import harness
for m in pkgutil.iter_modules(perfbench.__path__):
    importlib.import_module("perfbench." + m.name)
from pathlib import Path
pkg = Path({str(bench)!r})
for sub in ("steps", "metrics"):
    for path in sorted((harness.PKG / sub).glob("*.py")):
        harness.load_module(path, sub)
r = harness.run_cell("tiny-epoch", 5, 0.1, True, device="cpu", pkg=pkg)
assert r["correct"], r
print(sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")))
print(harness.forbidden_modules())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=bench.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "[]"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_for_test", object())
    assert harness.forbidden_modules() == ["repro"]


def test_a_new_cell_and_metric_are_found_by_name(bench):
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "tiny-kron-b.json").write_text(json.dumps(
        {**TINY_CONFIGS["tiny-kron"], "name": "tiny-kron-b", "ps": [2, 2], "qs": [3, 3]}))
    w = _read(bench / "workloads" / "tiny-fwd.json")
    w["config"] = "tiny-kron-b"
    (bench / "workloads" / "tiny-added.json").write_text(json.dumps(w))
    (bench / "metrics" / "steps_done.py").write_text(
        '"""Steps the window completed."""\n\n\ndef read(run):\n    return run.window.steps\n')
    spec = _read(bench.parent / "BENCHMARK.json")
    spec["workloads"].append({"name": "tiny-added", "config": "tiny-kron-b", "traffic": "t",
                              "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["tiny-added"]})
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    r = _run(bench, "tiny-added")
    assert r["correct"] and r["metrics"]["steps_done"]["value"] == r["attempted"]
    assert "steps_done" not in _run(bench, "tiny-fwd")["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


def _cli(cwd, *args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "perfbench/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_cli_refuses_without_a_card_and_prints_no_result():
    out = _cli(ROOT, "--workload", "kron32x4-m1-fwd", "--seed", "3000000001", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr or torch.cuda.is_available()


def test_cli_refuses_chaos_and_a_tree_without_the_program(tmp_path):
    out = _cli(ROOT, "--workload", "ski16x6-epoch", "--seed", "1", "--seconds", "1",
               env_extra={"FASTKRON_CHAOS": "1"})
    assert out.returncode != 0 and out.stdout == ""
    shutil.copytree(PKG, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _cli(tmp_path, "--workload", "ski16x6-epoch", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.')\n"
         "from perfbench import harness\n"
         "harness.run_cell('ski16x6-epoch', 1, 1, False, device='cpu')"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and "No module named 'repro_torch'" in out.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"] and spec["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"perfbench/configs/{c['name']}.json" and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        names.add(c["name"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        f = _read(PKG / "workloads" / f"{w['name']}.json")
        assert (f["config"], f["chips"], f["why"]) == (w["config"], w["chips"], w["why"])
        assert (PKG / "steps" / f"{f['step']}.py").is_file()
        assert all(isinstance(v, float) and 0 < v < 1 for v in f["limits"].values())
        cells.add(w["name"])
    assert [w["name"] for w in spec["workloads"]] == [
        "kron32x4-m1024-train", "ski16x6-epoch", "kron32x4-m1-fwd"]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert set(e2e) == {"step_ms", "step_p95_ms", "call_ms", "call_p95_ms", "peak_mem_gib",
                        "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # Every cell reports setup_s, another end-to-end metric and a per-layer one,
    # and every cell a per-layer metric lists reports the metric it moves.
    def reported(entries, cell):
        return {m["name"] for m in entries if cell in m.get("workloads", [cell])}

    for cell in cells:
        assert "setup_s" in reported(spec["end_to_end"], cell)
        assert len(reported(spec["end_to_end"], cell)) >= 2
        assert reported(spec["per_layer"], cell)
    for m in spec["per_layer"]:
        for cell in m.get("workloads", cells):
            assert m["moves"] in reported(spec["end_to_end"], cell), (m["name"], cell)
    assert len(json.dumps(spec)) < 64 * 1024
    # Every file under the benchmark's folder is named from a name's characters.
    for p in PKG.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(p.relative_to(ROOT)))
