"""The port's guard layer (repro_torch.runtime.guard, .chaos) and the forward
degradation ladder, mirroring the local cases of tests/test_guard.py: the
taxonomy, the chaos harness against repro.runtime.chaos on the same spec
strings, run_ladder's patience and pinning, every KronOp ladder rung under
chaos.inject (bitwise equal on the CPU twins, and equal to the JAX package),
the backward's per-factor fallback, and check_finite's three policies."""
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import KronOp as JKronOp
from repro.runtime import chaos as JC
from repro.runtime import guard as JG
from repro_torch.core import engine
from repro_torch.kernels import _launch, emit, kron_sliced, ops
from repro_torch.runtime import chaos, guard

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _fresh_guard_state():
    guard.reset_health()
    guard.set_numerics_policy(None)
    yield
    guard.reset_health()
    guard.set_numerics_policy(None)


def _problem(ps, qs, m=16, seed=0, batch=None):
    x, fs = make_inputs(seed, m, ps, qs, batch=batch, dtype=np.float32)
    return to_torch(x), [to_torch(f) for f in fs], x, fs


def _kron_health():
    [(key, h)] = [(k, h) for k, h in guard.health_entries() if k[0] == "kron"]
    return key, h


# ---------------------------------------------------------------------------
# Taxonomy and chaos
# ---------------------------------------------------------------------------


def test_taxonomy_matches_the_reference():
    for name in ("KronError", "PlanError", "VmemOverflowError", "LoweringError",
                 "CollectiveError", "PlanCacheError", "NumericsError"):
        ours, ref = getattr(guard, name), getattr(JG, name)
        builtin = {b for b in ref.__mro__ if b.__module__ == "builtins"}
        assert builtin <= set(ours.__mro__), name
    assert issubclass(guard.GuardWarning, UserWarning)
    assert set(JG.__all__) <= set(guard.__all__)
    assert guard.DEFAULT_PATIENCE == JG.DEFAULT_PATIENCE
    assert guard.NUMERICS_POLICIES == JG.NUMERICS_POLICIES


def test_emit_raises_typed_errors():
    x = torch.zeros(1, 4, 16)
    f = torch.zeros(1, 4, 4)
    with pytest.raises(guard.VmemOverflowError):
        emit.chain_geometry(x.shape, [f.shape, f.shape], t_m=4, t_k=16, vmem_budget_elems=8)
    with pytest.raises(guard.LoweringError):
        emit.chain_geometry((1, 4, 15), [f.shape], t_m=4)


SPECS = [
    "stage_execute",
    "collective:p=0.5:seed=7",
    "plan_cache_save:times=2,round_chain",
    " per_factor : after=1 , pallas_lowering:times=1",
    "",
]
BAD_SPECS = ["nowhere", "stage_execute:p", "stage_execute:q=1"]


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_matches_the_reference(text):
    got = [vars(s) for s in chaos.parse_spec(text)]
    want = [vars(s) for s in JC.parse_spec(text)]
    assert got == want
    assert sorted(chaos.SITE_ERRORS) == sorted(JC.SITE_ERRORS)
    for site, err in chaos.SITE_ERRORS.items():
        assert err.__name__ == JC.SITE_ERRORS[site].__name__


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_spec_rejects_what_the_reference_rejects(text):
    with pytest.raises(JG.PlanError):
        JC.parse_spec(text)
    with pytest.raises(guard.PlanError):
        chaos.parse_spec(text)


def test_chaos_inject_fires_typed_error_and_counts():
    assert not chaos.active()
    with chaos.inject("stage_execute:times=2") as specs:
        assert chaos.active()
        for _ in range(2):
            with pytest.raises(guard.VmemOverflowError, match="chaos-injected"):
                chaos.maybe_fail("stage_execute")
        chaos.maybe_fail("stage_execute")  # times exhausted
        chaos.maybe_fail("per_factor")  # other site
    assert (specs[0].seen, specs[0].fired) == (3, 2)
    assert not chaos.active()


def _firings(mod, guard_mod, spec, n):
    out = []
    with mod.inject(spec):
        for _ in range(n):
            try:
                mod.maybe_fail("collective")
                out.append(0)
            except guard_mod.CollectiveError:
                out.append(1)
    return out


def test_chaos_probabilistic_firing_replays_the_reference():
    spec = "collective:p=0.3:seed=11"
    got = _firings(chaos, guard, spec, 64)
    assert got == _firings(chaos, guard, spec, 64)  # deterministic
    assert got == _firings(JC, JG, spec, 64)  # and the reference's pattern
    assert 0 < sum(got) < 64


def test_chaos_after_skips_initial_hits():
    with chaos.inject("per_factor:after=2:times=1"):
        chaos.maybe_fail("per_factor")
        chaos.maybe_fail("per_factor")
        with pytest.raises(guard.VmemOverflowError):
            chaos.maybe_fail("per_factor")
        chaos.maybe_fail("per_factor")


def test_chaos_env_layer(monkeypatch):
    monkeypatch.setenv("FASTKRON_CHAOS", "pallas_lowering:times=1")
    try:
        assert chaos.reload_env()[0].site == "pallas_lowering"
        assert chaos.active()
        with pytest.raises(guard.LoweringError):
            chaos.maybe_fail("pallas_lowering")
        chaos.maybe_fail("pallas_lowering")
    finally:
        monkeypatch.delenv("FASTKRON_CHAOS")
        chaos.reload_env()
    assert not chaos.active()


# ---------------------------------------------------------------------------
# run_ladder: degradation, patience, pinning
# ---------------------------------------------------------------------------


def _flaky(n_fail):
    state = {"n": 0}

    def fn():
        state["n"] += 1
        if state["n"] <= n_fail:
            raise guard.VmemOverflowError("no room")
        return "ok"

    return fn


def test_run_ladder_degrades_and_reraises():
    with pytest.warns(guard.GuardWarning, match="degrading to rung 1"):
        out = guard.run_ladder("k1", (("a", _flaky(99)), ("b", lambda: "fallback")))
    assert out == "fallback"
    h = guard.health("k1")
    assert h.degraded_calls == 1 and h.errors == {"VmemOverflowError": 1}
    with pytest.raises(guard.VmemOverflowError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            guard.run_ladder("k2", (("a", _flaky(99)), ("b", _flaky(99))))


def test_run_ladder_pins_after_patience():
    def failing():
        raise guard.VmemOverflowError("no room")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(guard.DEFAULT_PATIENCE):
            assert guard.run_ladder("k3", (("a", failing), ("b", lambda: "ok"))) == "ok"
    h = guard.health("k3")
    assert h.pinned and h.rung == 1
    n_err = h.errors["VmemOverflowError"]
    assert guard.run_ladder("k3", (("a", failing), ("b", lambda: "ok"))) == "ok"
    assert guard.health("k3").errors["VmemOverflowError"] == n_err  # rung 0 skipped
    assert guard.health("k3").consecutive == 0


def test_run_ladder_success_resets_consecutive():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        guard.run_ladder("k4", (("a", _flaky(1)), ("b", lambda: "ok")), patience=3)
    assert guard.health("k4").consecutive == 1
    guard.run_ladder("k4", (("a", lambda: "ok"), ("b", lambda: "ok")))
    assert guard.health("k4").consecutive == 0 and not guard.health("k4").pinned


def test_non_kron_errors_propagate_through_ladder():
    def buggy():
        raise TypeError("a real bug, not a capacity failure")

    with pytest.raises(TypeError):
        guard.run_ladder("k5", (("a", buggy), ("b", lambda: "ok")))
    assert guard.health("k5").degraded_calls == 0


def test_warn_once_per_token():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            guard.warn_once("tok", "first")
        guard.warn_once("other", "second")
    assert [str(w.message) for w in caught] == ["first", "second"]
    assert all(w.category is guard.GuardWarning for w in caught)


# ---------------------------------------------------------------------------
# The KronOp forward ladder: planned -> per-factor -> torch-eager
# ---------------------------------------------------------------------------


def test_ladder_rung1_per_factor_bitwise():
    ps = qs = (4, 4, 4)
    x, fs, xn, fn = _problem(ps, qs)
    op = engine.kron_op_for(ps, qs, m=16)
    ref = op(x, fs)
    guard.reset_health()
    seen = []
    orig = kron_sliced.sliced_multiply_reference
    with pytest.warns(guard.GuardWarning, match="degrading to rung 1"):
        with chaos.inject("stage_execute"):
            kron_sliced.sliced_multiply_reference = lambda *a: seen.append(1) or orig(*a)
            try:
                y = op(x, fs)
            finally:
                kron_sliced.sliced_multiply_reference = orig
    assert len(seen) == 3  # one sliced multiply per factor
    assert torch.equal(ref, y)
    key, h = _kron_health()
    assert key == ("kron", ps, qs, "torch", False)
    assert h.errors.get("VmemOverflowError") == 1 and h.degraded_calls == 1 and h.calls == 1
    assert "guard[" in op.describe() and "VmemOverflowError" in op.describe()
    assert_close(y, JKronOp(ps, qs)(to_jax(xn), [to_jax(f) for f in fn]), 1e-5)


def test_ladder_rung2_torch_eager_bitwise():
    ps = qs = (2, 4, 8)
    x, fs, xn, fn = _problem(ps, qs, seed=1)
    op = engine.kron_op_for(ps, qs, m=16)
    ref = op(x, fs)
    guard.reset_health()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.GuardWarning)
        with chaos.inject("stage_execute,per_factor"):
            y = op(x, fs)
    assert torch.equal(ref, y)
    _, h = _kron_health()
    assert h.errors.get("VmemOverflowError", 0) == 2 and h.degraded_calls == 1
    assert_close(y, JKronOp(ps, qs)(to_jax(xn), [to_jax(f) for f in fn]), 1e-5)


def test_ladder_batched_per_sample_bitwise():
    ps = qs = (4, 4)
    x, fs, xn, fn = _problem(ps, qs, m=8, batch=2)
    op = engine.kron_op_for(ps, qs, batch=2, m=8, shared_factors=False)
    ref = op(x, fs)
    guard.reset_health()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.GuardWarning)
        # The per-sample per-factor rung runs chain-of-one instructions,
        # which pass the stage_execute site too: fire it once per call.
        with chaos.inject("stage_execute:times=1"):
            y1 = op(x, fs)
        with chaos.inject("stage_execute:times=1,per_factor"):
            y2 = op(x, fs)
        with chaos.inject("stage_execute"):
            y3 = op(x, fs)  # rung 1 fails at its first chain-of-one: rung 2
    for y in (y1, y2, y3):
        assert torch.equal(ref, y)
    key, h = _kron_health()
    assert key == ("kron", ps, qs, "torch", True)
    assert h.degraded_calls == 3 and h.errors["VmemOverflowError"] == 5
    want = JKronOp(ps, qs, batch=2, shared_factors=False)(to_jax(xn), [to_jax(f) for f in fn])
    assert_close(y1, want, 1e-5)


def _on_the_card(monkeypatch):
    """A CUDA stand-in on CPU tensors: every backend resolves to "cuda" and
    the wrappers skip their device check, so each call reaches the
    kernels' dtype and tile checks (and no launch: every case here fails
    before one).  The plain twins are replaced by a tripwire."""
    monkeypatch.setattr(emit, "resolve_backend", lambda backend, x: "cuda")
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, x: "cuda")
    monkeypatch.setattr(_launch, "require_cuda", lambda *a: None)

    def tripwire(*a, **k):
        raise AssertionError("a plain twin ran in place of a kernel")

    monkeypatch.setattr(emit, "chain_reference", tripwire)
    monkeypatch.setattr(kron_sliced, "sliced_multiply_reference", tripwire)


@pytest.mark.parametrize("case", ["float16", "mixed-dtypes", "per-sample-float16", "chaos"])
def test_ladder_on_the_card_ends_at_per_factor_and_raises(monkeypatch, case):
    """On CUDA tensors the ladder has no plain-twin rung: a dtype the
    kernels do not take (or factors of another dtype than x) fails the
    planned and the per-factor rungs, and the call raises the per-factor
    rung's error, every time, without pinning; so does a call with both
    chaos sites injected."""
    _on_the_card(monkeypatch)
    ps = qs = (4, 4)
    batch = 2 if case.startswith("per-sample") else None
    x, fs, _, _ = _problem(ps, qs, m=8, seed=7, batch=batch)
    err = guard.LoweringError
    if case in ("float16", "per-sample-float16"):
        x, fs = x.half(), [f.half() for f in fs]
    elif case == "mixed-dtypes":
        fs = [f.double() for f in fs]
    if batch is None:
        op = engine.kron_op_for(ps, qs, m=8)
    else:
        op = engine.kron_op_for(ps, qs, m=8, batch=batch, shared_factors=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(guard.DEFAULT_PATIENCE + 1):
            if case == "chaos":
                err = guard.VmemOverflowError
                with chaos.inject("stage_execute,per_factor"):
                    with pytest.raises(err):
                        op(x, fs)
            else:
                with pytest.raises(err, match="float16|dtype"):
                    op(x, fs)
    key, h = _kron_health()
    assert key == ("kron", ps, qs, "cuda", batch is not None)
    n = guard.DEFAULT_PATIENCE + 1
    assert h.calls == n and h.errors[err.__name__] == 2 * n
    assert h.rung == 0 and not h.pinned and h.degraded_calls == 0
    msgs = [str(w.message) for w in caught if w.category is guard.GuardWarning]
    assert len(msgs) == 1 and "degrading to rung 1 (per-factor)" in msgs[0]


def test_ladder_pins_op_after_patience():
    ps = qs = (8, 8)
    x, fs, _, _ = _problem(ps, qs, seed=2)
    op = engine.kron_op_for(ps, qs, m=16)
    ref = op(x, fs)
    guard.reset_health()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with chaos.inject("stage_execute:times=%d" % guard.DEFAULT_PATIENCE):
            for _ in range(guard.DEFAULT_PATIENCE):
                assert torch.equal(ref, op(x, fs))
    msgs = [str(w.message) for w in caught if w.category is guard.GuardWarning]
    assert len(msgs) == 2 and "degrading" in msgs[0] and "pinned to rung 1" in msgs[1]
    key, h = _kron_health()
    assert h.pinned and h.rung == 1
    assert "pinned" in op.describe()
    seen = []
    orig = emit.run_program
    emit.run_program = lambda *a, **k: seen.append(1) or orig(*a, **k)
    try:
        assert torch.equal(ref, op(x, fs))  # starts at rung 1: no planned attempt
    finally:
        emit.run_program = orig
    assert not seen
    assert guard.health(key).errors.get("VmemOverflowError") == guard.DEFAULT_PATIENCE


def test_gradients_survive_stage_chaos():
    """Under stage_execute chaos the forward degrades and the backward's
    stage takes the per-factor fallback: counted, recorded as a
    bwd_per_factor event, with the gradients of the healthy run."""
    ps = qs = (4, 4)
    x, fs, _, _ = _problem(ps, qs, m=8, seed=3)
    op = engine.kron_op_for(ps, qs, m=8)
    xt = x.clone().requires_grad_()
    ft = [f.clone().requires_grad_() for f in fs]
    ref = torch.autograd.grad((op(xt, ft) ** 2).sum(), [xt, *ft])
    guard.reset_health()
    before = engine.bwd_per_factor_fallbacks
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", guard.GuardWarning)
        with chaos.inject("stage_execute:times=1"):
            y = op(xt, ft)
        with chaos.inject("stage_execute:times=1"):
            got = torch.autograd.grad((y ** 2).sum(), [xt, *ft])
    for a, b in zip(ref, got):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert engine.bwd_per_factor_fallbacks == before + 1
    events = guard.health_report()["events"]
    assert events["bwd_per_factor"] == 1 and events["bwd_per_factor:VmemOverflowError"] == 1


def test_numerics_error_does_not_degrade():
    ps = qs = (4, 4)
    x, fs, _, _ = _problem(ps, qs, m=8, seed=4)
    x[0, 0] = float("inf")
    op = engine.kron_op_for(ps, qs, m=8)
    with guard.numerics("raise"):
        with pytest.raises(guard.NumericsError):
            op(x, fs)
    _, h = _kron_health()
    assert h.calls == 1 and h.degraded_calls == 0 and not h.errors


# ---------------------------------------------------------------------------
# Numerics guards
# ---------------------------------------------------------------------------


def test_numerics_policy_resolution(monkeypatch):
    monkeypatch.delenv("FASTKRON_NUMERICS", raising=False)
    guard.set_numerics_policy(None)
    assert guard.numerics_policy() == "off"
    monkeypatch.setenv("FASTKRON_NUMERICS", "warn")
    assert guard.numerics_policy() == "off"  # the env is read once, not per call
    guard.set_numerics_policy(None)
    assert guard.numerics_policy() == "warn"
    guard.set_numerics_policy("raise")
    assert guard.numerics_policy() == "raise"
    guard.set_numerics_policy(None)
    assert guard.numerics_policy() == "warn"  # back to env
    monkeypatch.setenv("FASTKRON_NUMERICS", "loud")
    guard.set_numerics_policy(None)
    assert guard.numerics_policy() == "off"  # unknown env value: off, as the reference
    with pytest.raises(guard.PlanError):
        guard.set_numerics_policy("maybe")
    with guard.numerics("raise"):
        assert guard.numerics_policy() == "raise"
    assert guard.numerics_policy() == "off"


@pytest.mark.parametrize("policy", ["off", "warn", "raise"])
def test_numerics_guard_at_program_boundary(policy):
    ps = qs = (4, 4)
    x, fs, _, _ = _problem(ps, qs, m=8, seed=5)
    x[0, 0] = float("inf")
    op = engine.kron_op_for(ps, qs, m=8)
    with guard.numerics(policy):
        if policy == "raise":
            with pytest.raises(guard.NumericsError, match="run_program"):
                op(x, fs)
        elif policy == "warn":
            with pytest.warns(guard.GuardWarning, match="non-finite"):
                y = op(x, fs)
            assert not bool(torch.isfinite(y).all())
            assert guard.health_report()["events"]["nonfinite"] == 1
        else:
            y = op(x, fs)  # off: no check, inf flows through silently
            assert not bool(torch.isfinite(y).all())
            assert not guard.health_report()["events"]


def test_numerics_guard_checks_the_stage_backward_and_clean_inputs():
    ps = qs = (4, 4)
    x, fs, _, _ = _problem(ps, qs, m=8, seed=6)
    op = engine.kron_op_for(ps, qs, m=8)
    xt = x.clone().requires_grad_()
    ft = [f.clone().requires_grad_() for f in fs]
    with guard.numerics("raise"):
        y = op(xt, ft)
        assert bool(torch.isfinite(y).all())
        assert not guard.health_report()["events"]
        g = torch.full_like(y, float("nan"))
        with pytest.raises(guard.NumericsError, match="run_stage_grad"):
            torch.autograd.grad(y, [xt, *ft], g)


def test_health_report_shape_and_reset():
    guard.record_event("nonfinite")
    guard.health("some-op").record(guard.PlanError("x"))
    rep = guard.health_report()
    assert rep["events"]["nonfinite"] == 1
    assert rep["ops"]["'some-op'"]["errors"] == {"PlanError": 1}
    assert set(rep["ops"]["'some-op'"]) == set(JG.OpHealth().summary())
    guard.reset_health()
    rep = guard.health_report()
    assert not rep["events"] and not rep["ops"]
