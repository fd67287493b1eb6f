"""The dry-run tooling in the port (repro_torch.launch.dryrun,
collective_report, roofline) against repro.launch.

* ``model_flops`` equals the reference's for all 33 runnable pairs.  The
  reference's function is read out of its file: importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices in this
  process's environment.
* ``run_cell`` on a fake (2, 4) world (``--device cpu``): mamba2-130m
  decode_32k, the cell of the reference's own
  ``test_dryrun.py::test_dryrun_cell_on_small_mesh``, with that test's
  checks; and qwen3-4b train_4k at reduced size, whose all-gathers at the
  parameter views equal the explicit schedule: ``sharding.param_view``'s
  gathers of each layer, per microbatch, in the forward and again in the
  remat recompute.
* ``collective_report`` and ``roofline`` on those records: the sites add up
  to the record's collective bytes, the roofline's step time is its largest
  term (as the reference's ``step_time``), the tables and the hillclimb
  picks.
"""
from __future__ import annotations

import ast
import json
import math
import pathlib
import types

import pytest

from repro.launch import roofline as JR
from repro_torch import tree
from repro_torch.configs import SHAPES, get_config, runnable_cells
from repro_torch.launch import collective_report, dryrun, roofline
from repro_torch.models import model as TM
from repro_torch.models.config import reduced
from repro_torch.runtime import sharding as S

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference_model_flops():
    """``repro.launch.dryrun.model_flops``, compiled from its source alone."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "model_flops")
    ns: dict = {}
    exec(compile(ast.Module([node], []), "repro/launch/dryrun.py", "exec"), ns)
    return ns["model_flops"]


@pytest.mark.parametrize("arch,shape", runnable_cells())
def test_model_flops_equals_reference(arch, shape):
    from repro.configs import get_config as jget

    ref = _reference_model_flops()
    cell = types.SimpleNamespace(shape=SHAPES[shape])
    assert dryrun.model_flops(cell, get_config(arch)) == ref(cell, jget(arch)) > 0


def test_the_hardware_is_the_h100_s():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert 80e9 < dryrun.HBM_PER_CHIP < 86e9
    assert "H100" in dryrun.HW and roofline.HW == dryrun.HW


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The two cells' records on a fake (2, 4) world, written to a dir."""
    out = tmp_path_factory.mktemp("dryrun")
    mamba = dryrun.run_cell("mamba2_130m", "decode_32k", False, str(out), device="cpu",
                            mesh_shape=(2, 4))
    cfg = reduced(get_config("qwen3-4b"))
    qwen = dryrun.run_cell("qwen3-4b", "train_4k", False, str(out), device="cpu",
                           mesh_shape=(2, 4), cfg=cfg, sites=True)
    return out, mamba, qwen, cfg


def test_mamba_decode_cell_on_a_small_mesh(records):
    """The reference's own test of this cell, which fails under jax 0.9."""
    _, rec, _, _ = records
    assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    assert rec["per_device"]["hlo_flops"] > 0
    assert rec["per_device"]["hlo_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["fits_hbm"]
    # the reference's record keys, XLA's own cost_analysis aside
    assert set(rec) >= {"arch", "shape", "mesh", "chips", "meta", "lower_s", "compile_s",
                        "per_device", "memory_analysis", "peak_bytes_per_device",
                        "fits_hbm", "roofline"}
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] > 0 and ma["alias_size_in_bytes"] > 0  # the cache
    assert rec["peak_bytes_per_device"] == ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]


def _view_gathers(cfg, mesh) -> int:
    """All-gathers of one layer's parameter views (``model._views``): one
    per mesh axis of more than one rank that a leaf's spec shards it over,
    less the model axis at a tensor-parallel site; a stacked leaf sharded
    along its layer dim is gathered once for all layers instead."""
    sh = TM.param_layout(cfg, mesh)["stack"]["pos0"]
    spec = cfg.layer_plan()[cfg.prelude_len]
    layer = tree.map(lambda s: S.NamedSharding(s.mesh, tuple(s.spec[1:]), tuple(s.shape[1:])),
                     sh)
    lt = TM._tp_layout(cfg, spec, layer)
    n = 0
    for (path, s), stacked in zip(tree.leaves_with_path(layer), tree.leaves(sh)):
        if stacked.spec and stacked.spec[0] is not None:
            continue
        keep = TM._keeps_tp(path, lt)
        for _, axes in S._plan(s.spec, skip=("model",) if keep else ()):
            n += sum(S._dim_size(mesh, a) > 1 for a in axes)
    return n


def test_train_cell_gathers_follow_the_explicit_schedule(records):
    _, _, rec, cfg = records
    with dryrun.fake_world(8):
        mesh = dryrun._mesh(False, (2, 4), "cpu")
        per_layer = _view_gathers(cfg, mesh)
    views = [s for s in rec["sites"] if s["site"].endswith(" _views")]
    assert {s["kind"] for s in views} == {"all-gather"}
    passes = rec["microbatches_per_rank"] * (2 if cfg.remat else 1)
    assert per_layer > 0 and passes == 8
    assert len(views) == passes * cfg.n_layers * per_layer
    counts = {}
    for s in rec["sites"]:
        counts[s["kind"]] = counts.get(s["kind"], 0) + 1
    assert counts == rec["per_device"]["collective_counts"]
    assert sum(s["bytes"] for s in rec["sites"]) == rec["per_device"]["collective_bytes"]


def test_collective_report_adds_up_to_the_cell(records, capsys):
    _, _, rec, cfg = records
    rows = collective_report.report("qwen3-4b", "train_4k", top=5, device="cpu",
                                    mesh_shape=(2, 4), cfg=cfg)
    assert sum(r[0] for r in rows) == rec["per_device"]["collective_bytes"]
    assert sum(r[4] for r in rows) == sum(rec["per_device"]["collective_counts"].values())
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    assert len({(r[1], r[2], r[3], r[5]) for r in rows}) == len(rows)
    out = capsys.readouterr().out
    assert out.startswith("total collective bytes/device/step:")
    assert len(out.strip().splitlines()) == 6


def _as_16x16(rec, **roof):
    return dict(rec, mesh="16x16", roofline=dict(rec["roofline"], **roof))


def test_roofline_tables_and_picks(records, capsys):
    out, mamba, qwen, _ = records
    recs = roofline.load(str(out))
    assert sorted(r["arch"] for r in recs) == ["mamba2_130m", "qwen3-4b"]
    for r in recs:
        t = r["roofline"]
        assert roofline.step_time(r) == JR.step_time(r) == max(
            t["compute_s"], t["memory_s"], t["collective_s"])
    dec = next(r for r in recs if r["meta"]["kind"] == "decode")
    assert roofline.roofline_fraction(dec) == pytest.approx(
        dec["memory_analysis"]["argument_size_in_bytes"] / dryrun.HBM_BW
        / roofline.step_time(dec))
    tr = next(r for r in recs if r["meta"]["kind"] == "train")
    assert roofline.roofline_fraction(tr) == pytest.approx(
        tr["roofline"]["model_flops_per_device"] / dryrun.PEAK_FLOPS / roofline.step_time(tr))
    table = roofline.table(recs, "2x4").splitlines()
    assert len(table) == 2 + 2 and table[0] == JR.table([], "2x4").splitlines()[0]
    # picks among single-pod records: the worst fraction, the most collective-bound
    single = [_as_16x16(mamba), _as_16x16(qwen, collective_s=10.0, dominant="collective_s")]
    picks = roofline.pick_hillclimb(single)
    assert picks[1] == ("qwen3-4b", "train_4k", "most collective-bound")
    assert picks[0][2] == "worst roofline fraction"
    roofline.main(["--dir", str(out)])
    printed = capsys.readouterr().out
    assert printed.startswith(f"# Roofline ({dryrun.HW})") and "## mesh 16x16 (0 cells)" in printed
    assert json.loads(json.dumps(recs)) == recs and math.isfinite(roofline.step_time(recs[0]))


def test_serving_collectives_are_not_ranked(records):
    """A serving cell's collective term (gather-whole serving on the mesh)
    is recorded, marked in the table, and left out of the hillclimb's
    ranking; a train cell's is ranked."""
    _, mamba, qwen, _ = records
    assert mamba["meta"]["kind"] == "decode" and qwen["meta"]["kind"] == "train"
    assert mamba["roofline"]["collective_predictive"] is False
    assert qwen["roofline"]["collective_predictive"] is True
    big = dict(collective_s=10.0, dominant="collective_s")
    picks = roofline.pick_hillclimb([_as_16x16(mamba, **big), _as_16x16(qwen)])
    assert ("mamba2_130m", "decode_32k", "most collective-bound") not in picks
    assert picks[-1] == ("qwen3-4b", "train_4k", "most collective-bound")
    # ranked on its other terms, the decode cell's fraction is unchanged by its collectives
    alone = roofline.pick_hillclimb([_as_16x16(mamba, **big)])
    assert alone == [("mamba2_130m", "decode_32k", "worst roofline fraction")]
    row = roofline.table([_as_16x16(mamba, **big)], "16x16").splitlines()[-1]
    assert "| 10000.00* |" in row


def test_dryrun_main_runs_a_cell(tmp_path, capsys, monkeypatch):
    """The CLI on one cell: the reference's flags, --device cpu."""
    cfg = reduced(get_config("mamba2-130m"))
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: _one(a, k, cfg))
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--device", "cpu",
                 "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("mamba2-130m") and lines[-1] == "DRY-RUN OK"
    assert any(line.startswith("SKIP") for line in lines)


_run_cell = dryrun.run_cell


def _one(args, kwargs, cfg):
    arch, shape, multi_pod, out = args
    assert not multi_pod and kwargs == {"device": "cpu"}
    return _run_cell(arch, shape, False, out, device="cpu", mesh_shape=(2, 4), cfg=cfg)


def test_a_shampoo_cell_takes_the_refresh_branch(monkeypatch):
    """The step counter is a real 0-d tensor at 0: Shampoo's host read of it
    runs through the fake trace and its step 1 refreshes every eligible
    leaf's roots (the reference counts its refresh branch too)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.optim import ShampooConfig, shampoo

    refreshed = []
    refresh = shampoo._refresh_leaf
    monkeypatch.setattr(shampoo, "_refresh_leaf",
                        lambda *a, **k: refreshed.append(1) or refresh(*a, **k))
    cfg = reduced(get_config("qwen3-4b"))
    rec = dryrun.run_cell("qwen3-4b", "train_4k", False, None, device="cpu",
                          mesh_shape=(2, 4), cfg=cfg, shape=ShapeSpec("t", 64, 16, "train"),
                          opt_cfg=ShampooConfig(precond_every=20))
    assert rec["meta"]["optimizer"] == "shampoo"
    groups = shampoo.shape_groups(TM.init_params(cfg, None, device="meta"), ShampooConfig())
    assert len(refreshed) == sum(len(members) for members in groups.values()) > 0
