"""The port's measured planner and plan cache (repro_torch.core.autotune)
against repro.core.autotune: the cases of tests/test_autotune.py's measured
tuning, the reference's cache file read by the port, and the port's own
rules (capacity errors only are skipped, no t_b sweep, ``;dev=`` keys).
CPU runs time the plain twins with time.perf_counter."""
import json
import os
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import KronOp as JKronOp
from repro.core import autotune as JA
from repro.core.kron import KronProblem as JProblem
from repro_torch.convert import plan_from_jax_json
from repro_torch.core import KronOp
from repro_torch.core import autotune as TA
from repro_torch.core.kron import KronProblem
from repro_torch.runtime import chaos, guard, telemetry

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _fresh_state():
    guard.reset_health()
    telemetry.reset()
    yield
    guard.reset_health()
    telemetry.reset()


def _counters():
    return telemetry.snapshot()["counters"]


def _entries(path):
    return TA.load_plan_cache(str(path))


def test_measured_cache_hit_skips_measurement(tmp_path, monkeypatch):
    """The first construction measures and writes the file (a miss); the
    second reads the plan back (a hit) without measuring."""
    cache = str(tmp_path / "plans.json")
    telemetry.configure()
    op1 = KronOp((4, 4), (4, 4), m=8, tune="measure", cache_path=cache, device="cpu")
    assert os.path.exists(cache) and _counters()["plan_cache.miss"] == 1
    key = TA.plan_cache_key(KronProblem(8, (4, 4), (4, 4)), 4, "auto",
                            enable_prekron=False, device="cpu")
    assert key.endswith(";dev=cpu") and _entries(cache)[key]["seconds"] > 0

    def poisoned(*a, **k):
        raise AssertionError("measure_best called on a cache hit")

    monkeypatch.setattr(TA, "measure_best", poisoned)
    op2 = KronOp((4, 4), (4, 4), m=8, tune="measure", cache_path=cache, device="cpu")
    assert op2.plan == op1.plan
    assert _counters()["plan_cache.hit"] == 1 and _counters()["plan_cache.miss"] == 1


def test_measured_op_matches_reference(tmp_path):
    """A measured op's forward and gradients equal the reference KronOp's
    (f64), the plan measured on the call's device."""
    x, fs = make_inputs(3, 8, (4, 2, 3), (3, 2, 4))
    op = KronOp((4, 2, 3), (3, 2, 4), tune="measure", cache_path=str(tmp_path / "p.json"))
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    y = op(xt, ft)
    jop = JKronOp((4, 2, 3), (3, 2, 4), backend="xla")
    jy, vjp = jax.vjp(lambda a, b: jop(a, b), to_jax(x), [to_jax(f) for f in fs])
    assert_close(y.detach(), jy, 1e-12)
    ct = np.random.default_rng(4).standard_normal(y.shape)
    jgx, jgfs = vjp(to_jax(ct))
    got = torch.autograd.grad(y, [xt, *ft], to_torch(ct))
    for a, w in zip(got, [jgx, *jgfs]):
        assert_close(a, w, 1e-12)
    assert len(_entries(tmp_path / "p.json")) == 1


# (file text, whether load warns): unreadable files warn once and record a
# plan_cache_rebuild event; another version or shape is a quiet miss.
GARBAGE = [
    ("not json at all {{{", True),
    ('{"version": 1, "entries"', True),
    ('{"version": 99, "entries": {}}', False),
    ("[1, 2, 3]", False),
    ('{"version": 1, "entries": [1]}', False),
    ('{"version": 1, "entries": {"k": {"seconds": 1}}}', False),
    ("", True),
]


@pytest.mark.parametrize("garbage,warns", GARBAGE)
def test_plan_cache_recovers_from_corrupt_file(tmp_path, garbage, warns):
    cache = tmp_path / "plans.json"
    cache.write_text(garbage)
    assert JA.load_plan_cache(str(cache)) == {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert TA.load_plan_cache(str(cache)) == {}
        assert TA.load_plan_cache(str(cache)) == {}
    mine = [w for w in caught if issubclass(w.category, guard.GuardWarning)]
    events = guard.health_report()["events"]
    assert len(mine) == int(warns)
    assert events.get("plan_cache_rebuild", 0) == (2 if warns else 0)
    prob = KronProblem(8, (4, 4), (4, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.GuardWarning)
        plan = TA.make_plan(prob, tune="measure", cache_path=str(cache), device="cpu")
    assert plan.stages
    assert TA.plan_cache_key(prob, 4, "auto", device="cpu") in _entries(cache)


def test_plan_cache_save_merges_concurrent_entries(tmp_path):
    cache = str(tmp_path / "plans.json")
    TA.save_plan_cache(cache, {"a": {"plan": {"stages": []}, "seconds": 1}})
    TA.save_plan_cache(cache, {"b": {"plan": {"stages": []}, "seconds": 2}})
    assert set(_entries(cache)) == {"a", "b"}
    # The write is atomic: no temporary file is left beside the cache.
    assert os.listdir(tmp_path) == ["plans.json"]


def test_measured_plan_records_candidate_set(tmp_path):
    """The single and per-sample paths share one measured path; each entry
    records the distinct candidates it timed and their times, the analytic
    plan first, and the time of the one it kept."""
    cache = str(tmp_path / "plans.json")
    prob = KronProblem(8, (4, 4), (4, 4))
    TA.make_plan(prob, tune="measure", cache_path=cache, device="cpu")
    TA.make_batched_plan(prob, 8, shared_factors=False, tune="measure",
                         cache_path=cache, device="cpu")
    entries = _entries(cache)
    single = TA.plan_cache_key(prob, 4, "auto", device="cpu")
    batched = TA.plan_cache_key(prob, 4, "auto", enable_prekron=False, batch=8,
                                shared_factors=False, device="cpu")
    assert set(entries) == {single, batched}
    bases = {single: TA.make_plan(prob),
             batched: TA.make_batched_plan(prob, 8, shared_factors=False)}
    for key in entries:
        e = entries[key]
        assert len(e["candidates"]) >= 2, e
        assert len(e["candidate_seconds"]) == len(e["candidates"])
        assert e["candidates"][0] == bases[key].describe()
        won = e["candidates"].index(TA.plan_from_json(e["plan"]).describe())
        assert e["seconds"] == e["candidate_seconds"][won]
        assert e["measured_at"]
    assert entries[batched]["plan"]["t_b"] == 1


def test_measure_best_ranks_by_wallclock():
    timings = []
    best, secs = TA.measure_best(
        lambda d: (lambda: time.sleep(d)), [0.02, 0.001, 0.01],
        warmup=1, iters=2, timings=timings,
    )
    assert best == 0.001 and secs < 0.01
    assert [c for c, _ in timings] == [0.02, 0.001, 0.01]


@pytest.mark.parametrize("rounds,want", [
    ({"base": [1.0, 1.0, 1.0], "b": [0.9, 0.95, 0.9]}, "b"),  # faster in every round
    ({"base": [1.0, 1.0, 1.0], "b": [0.5, 1.1, 1.1]}, "base"),  # fastest call, one lucky round
    ({"base": [1.0, 1.0, 1.0], "b": [1.0, 1.0, 1.0]}, "base"),  # a tie
    ({"base": [1.0, 1.0, 1.0], "b": [0.9, 0.9, 0.9], "c": [0.8, 0.99, 0.7]}, "c"),
    ({"base": [1.0, 1.0, 1.0], "b": [0.9, 0.9, 0.9], "c": [0.2, 1.2, 0.2]}, "b"),
])
def test_measure_best_keeps_the_first_unless_beaten_every_round(monkeypatch, rounds, want):
    """The first candidate (the analytic plan) is replaced only by one that
    is faster in every round; among those, the fastest call wins."""
    def fn_of(cfg):
        times = iter([0.0] + rounds[cfg])  # the warm-up call, then one per round
        return lambda: next(times)

    monkeypatch.setattr(TA, "time_once", lambda fn, cuda: (fn(), None))
    best, secs = TA.measure_best(fn_of, list(rounds), warmup=1, iters=3)
    assert best == want and secs == min(rounds[want])


@pytest.mark.parametrize("error,skipped", [
    (guard.VmemOverflowError("too big"), True),
    (guard.LoweringError("bad tile"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("not a capacity error"), False),
])
def test_measure_best_skips_capacity_errors_only(error, skipped):
    """A capacity error skips its candidate (the reference skips every
    Exception); anything else, a failed build or launch included,
    propagates."""
    def fn_of(cfg):
        if cfg == "bad":
            raise error
        return lambda: torch.zeros(1)

    if skipped:
        assert TA.measure_best(fn_of, ["bad", "good"], warmup=0, iters=1)[0] == "good"
        with pytest.raises(guard.PlanError):
            TA.measure_best(fn_of, ["bad"], warmup=0, iters=1)
    else:
        with pytest.raises(type(error)):
            TA.measure_best(fn_of, ["bad", "good"], warmup=0, iters=1)


@pytest.mark.parametrize("site", ["plan_cache_load", "plan_cache_save"])
def test_chaos_sites_fire(tmp_path, site):
    """plan_cache_load degrades the load to an empty cache (one warning, a
    plan_cache_rebuild event); plan_cache_save is retried, and when every
    attempt fails warns once and records plan_cache_save_failed."""
    cache = str(tmp_path / "plans.json")
    TA.save_plan_cache(cache, {"a": {"plan": {"stages": []}}})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if site == "plan_cache_load":
            with chaos.inject("plan_cache_load:times=1"):
                assert TA.load_plan_cache(cache) == {}
            assert set(TA.load_plan_cache(cache)) == {"a"}
            want_event = "plan_cache_rebuild"
        else:
            with chaos.inject("plan_cache_save:times=2"):
                TA.save_plan_cache(cache, {"b": {"plan": {"stages": []}}})
            assert set(TA.load_plan_cache(cache)) == {"a", "b"}
            assert not [w for w in caught if issubclass(w.category, guard.GuardWarning)]
            with chaos.inject("plan_cache_save"):
                TA.save_plan_cache(cache, {"c": {"plan": {"stages": []}}}, retries=2)
            assert set(TA.load_plan_cache(cache)) == {"a", "b"}
            want_event = "plan_cache_save_failed"
    mine = [w for w in caught if issubclass(w.category, guard.GuardWarning)]
    assert len(mine) == 1
    assert guard.health_report()["events"][want_event] == 1


def test_no_t_b_sweep(tmp_path):
    """The per-sample candidates are the single-problem candidates at
    t_b=1: no kernel reads t_b, so t_b variants would time identical
    launches."""
    prob = KronProblem(16, (4, 4, 4), (4, 4, 4))
    single = TA.make_plan(prob, enable_prekron=False)
    per_sample = TA.make_batched_plan(prob, 8, shared_factors=False)
    cs = TA._measured_candidates(single, prob, None)
    cb = TA._measured_candidates(per_sample, prob, 8)
    assert {c.t_b for c in cb} == {1}
    assert [c.stages for c in cb] == [c.stages for c in cs]
    # The reference widens the same sweep over t_b.
    jb = JA._measured_candidates(
        JA.plan_from_json(TA.plan_to_json(per_sample)), JProblem(16, (4, 4, 4), (4, 4, 4)), 8)
    assert len({c.t_b for c in jb}) > 1


def test_reference_cache_file_loads_in_port(tmp_path):
    """A file the reference wrote loads in the port; none of its keys is a
    port key (``;dev=``), so the port measures its own entry beside them and
    the reference still hits its own."""
    cache = str(tmp_path / "plans.json")
    jprob, prob = JProblem(8, (4, 4), (4, 4)), KronProblem(8, (4, 4), (4, 4))
    jplan = JA.make_plan(jprob, tune="measure", backend="xla", cache_path=cache)
    loaded = TA.load_plan_cache(cache)
    jkey = JA.plan_cache_key(jprob, 4, "xla")
    assert set(loaded) == {jkey}
    assert plan_from_jax_json(loaded[jkey]["plan"]).stages
    same = TA.plan_cache_key(prob, 4, "xla", vmem_budget_elems=2 * 1024 * 1024, device="cpu")
    assert same == jkey + ";dev=cpu" and same not in loaded
    telemetry.configure()
    TA.make_plan(prob, tune="measure", backend="torch", cache_path=cache, device="cpu")
    assert _counters()["plan_cache.miss"] == 1
    entries = TA.load_plan_cache(cache)
    assert jkey in entries and len(entries) == 2
    assert JA.load_plan_cache(cache).keys() == entries.keys()
    assert JA.make_plan(jprob, tune="measure", backend="xla", cache_path=cache) == jplan


CANDIDATE_SHAPES = [
    (64, (4, 4, 4), (4, 4, 4), 4),
    (32, (8, 8), (8, 8), 4),
    (16, (4, 2, 3), (3, 2, 4), 4),
    (96, (6, 10), (5, 12), 2),
    (24, (16,), (16,), 8),
]


@pytest.mark.parametrize("m,ps,qs,dtype_bytes", CANDIDATE_SHAPES)
def test_candidates_equal_reference_sweep(m, ps, qs, dtype_bytes):
    """The port's sweep equals the reference's ``_measured_candidates`` on
    the same analytic plan (forward stages; each backward M-tile is clamped
    as the port's mirror clamps it); the measured candidates are the sweep
    less the variants a kernel cannot take and the repeated launches, the
    analytic plan first."""
    prob = KronProblem(m, ps, qs)
    base = TA.make_plan(prob, dtype_bytes=dtype_bytes)
    sweep = TA._sweep_candidates(base, prob)
    ref = JA._measured_candidates(
        JA.plan_from_json(TA.plan_to_json(base)), JProblem(m, ps, qs), None)
    assert [c.describe() for c in sweep] == [c.describe() for c in ref]
    for c, r in zip(sweep, ref):
        assert [s.factor_ids for s in c.bwd_stages] == [s.factor_ids for s in r.bwd_stages]
        for st, fwd in zip(c.bwd_stages, reversed(c.stages)):
            assert st.tiles.t_m == TA._bwd_t_m(prob, fwd, fwd.tiles.t_m, TA.SMEM_BUDGET_ELEMS)
    cands = TA._measured_candidates(base, prob, None, dtype_bytes)
    assert cands[0] is base and all(c in sweep for c in cands)
    tiles = [TA._launch_tiles(c, prob, None, dtype_bytes) for c in cands]
    assert len(set(tiles)) == len(tiles)
    for c in sweep:
        if c not in cands:
            try:
                assert TA._launch_tiles(c, prob, None, dtype_bytes) in tiles
            except (guard.VmemOverflowError, guard.LoweringError):
                pass


def test_smoke_shapes_measure_few_launch_configurations():
    """On the smoke's shapes the block rule takes the same block tiles for
    most M-tile limits: fig9 and gp16 have one distinct launch
    configuration, ffn in bf16 two."""
    counts = {}
    for name, m, ps, qs, db in [
        ("fig9", 1024, (32,) * 4, (32,) * 4, 4),
        ("gp16", 16, (16,) * 6, (16,) * 6, 4),
        ("ffn", 4096, (64, 40), (128, 76), 2),
    ]:
        prob = KronProblem(m, ps, qs)
        counts[name] = len(TA._measured_candidates(
            TA.make_plan(prob, dtype_bytes=db, enable_prekron=False), prob, None, db))
    assert counts == {"fig9": 1, "gp16": 1, "ffn": 2}


def test_measure_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: measuring on it is the smoke's to check")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.make_plan(KronProblem(8, (4, 4), (4, 4)), tune="measure", cache_path="unused.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.plan_cache_key(KronProblem(8, (4, 4), (4, 4)), 4, "auto")


def test_default_cache_path_is_the_reference_file(monkeypatch, tmp_path):
    monkeypatch.setenv("FASTKRON_PLAN_CACHE", str(tmp_path / "x.json"))
    assert TA.default_cache_path() == JA.default_cache_path() == str(tmp_path / "x.json")
    monkeypatch.delenv("FASTKRON_PLAN_CACHE")
    assert TA.default_cache_path() == JA.default_cache_path()
    assert TA.PLAN_CACHE_VERSION == JA.PLAN_CACHE_VERSION


def test_measured_vmap_and_with_batch_keep_tune(tmp_path):
    """Derived ops (with_batch) and vmap re-planning measure too, into the
    same cache."""
    cache = str(tmp_path / "p.json")
    op = KronOp((4, 4), (4, 4), tune="measure", cache_path=cache)
    x, fs = make_inputs(9, 4, (4, 4), (4, 4), batch=3)
    xt, ft = to_torch(x), [to_torch(f) for f in fs]
    per = op.with_batch(3, shared_factors=False)
    y = per(xt, ft)
    yv = torch.func.vmap(op)(xt, ft)
    assert torch.equal(y, yv)
    # One per-sample entry, shared by both; the op's call resolves its own
    # 4-row plan before the vmap rule re-plans.
    keys = list(_entries(cache))
    assert len([k for k in keys if ";B=3;shared=0;" in k]) == 1 and len(keys) == 2
    json.dumps(_entries(cache))  # the entry is plain JSON
