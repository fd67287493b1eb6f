"""The optimizers in the port (repro_torch.optim) against repro.optim:
AdamW over 3 steps (compress None, bf16, int8), Shampoo's shape groups
(at qwen3-4b's full size too), both inverse-root methods, the batched
precondition (bitwise equal to the looped one), 6 Shampoo steps across a
refresh, and the reference's own contracts on the port: identity roots give
exactly AdamW, a chaos ``root_refresh`` degrades a layer and not the step,
the refresh cadence, the numerics policy, the memory report.

Inputs are numpy from a seed, handed to both packages.  Tolerances (f32,
relative to each leaf's largest value, at least 1): parameters and moments
1e-5 (Adam divides by sqrt(v), so a last-bit difference in a small
gradient moves its step by a few ulps); with a bf16 state, moments 1e-2
(where the two packages' f32 sums straddle a bf16 rounding boundary they
differ by one bf16 ulp, 2^-8) and parameters 1e-4 (that ulp of m or v,
carried at the learning rate's scale); inverse roots 1e-4 (LAPACK's and
XLA's eigensolvers round differently; 1e-4 is the reference's own test's
bound between its two root methods).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import shampoo as JS
from repro.runtime import guard as jguard
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.optim import shampoo as TS
from repro_torch.runtime import chaos, guard, telemetry
from repro_torch.train import prebuild_kron_ops

STATE_TOL, ROOT_TOL = 1e-5, 1e-4
BF16_STATE_TOL, BF16_STATE_PARAM_TOL = 1e-2, 1e-4


@pytest.fixture(autouse=True)
def _fresh_state():
    guard.reset_health()
    jguard.reset_health()
    telemetry.reset()
    yield
    guard.reset_health()
    telemetry.reset()


def _np_params(seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    return {
        "embed": n(48, 16),
        "stack": {"w1": n(2, 16, 32), "w2": n(2, 32, 16), "wq": n(2, 16, 16),
                  "ln": np.ones((2, 16), np.float32)},   # stacked norm: AdamW
        "head": n(16, 32),
        "bias": np.zeros((16,), np.float32),
    }


def _np_grads(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def _both(np_tree):
    return (jax.tree.map(jnp.asarray, np_tree),
            convert.model_params_from_numpy(np_tree, device="cpu"))


def _jax_flat(t):
    return {jax.tree_util.keystr(kp, simple=True, separator="/"): np.asarray(l)
            for kp, l in jax.tree_util.tree_flatten_with_path(t)[0]}


def _torch_flat(t):
    return {p: (l.float() if l.dtype == torch.bfloat16 else l).numpy()
            for p, l in tree.leaves_with_path(t)}


def _assert_trees_close(got, want, tol, exact=()):
    g, w = _torch_flat(got), _jax_flat(want)
    assert list(g) == list(w)
    for path in w:
        if w[path].dtype == bool or np.issubdtype(w[path].dtype, np.integer) or any(
                e in path for e in exact):
            np.testing.assert_array_equal(g[path], w[path], err_msg=path)
        else:
            assert_close(torch.from_numpy(g[path].astype(np.float64)),
                         w[path].astype(np.float64), tol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_opt_update_three_steps_equal_reference(compress, state_dtype):
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=10, compress=compress,
               state_dtype=state_dtype)
    jcfg, tcfg = JA.OptConfig(**cfg), TA.OptConfig(**cfg)
    np_p = _np_params()
    jp, tp = _both(np_p)
    jst, tst = JA.opt_init(jp, jcfg), TA.opt_init(tp, tcfg)
    for i in range(3):
        jg, tg = _both(_np_grads(np_p, seed=i + 1))
        jp, jst, jm = JA.opt_update(jg, jst, jp, jcfg)
        tp, tst, tm = TA.opt_update(tg, tst, tp, tcfg)
        f32 = state_dtype == "float32"
        _assert_trees_close(tp, jp, STATE_TOL if f32 else BF16_STATE_PARAM_TOL)
        _assert_trees_close(tst, jst, STATE_TOL if f32 else BF16_STATE_TOL)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(tst["step"]) == 3 and tst["step"].device.type == "cpu"


def test_lr_schedule_equals_reference():
    cfg = dict(lr=1.0, warmup_steps=10, decay_steps=110, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 500):
        want = float(JA.lr_at(JA.OptConfig(**cfg), jnp.int32(step)))
        assert float(TA.lr_at(TA.OptConfig(**cfg), step)) == pytest.approx(want, rel=1e-6)
        assert float(TA.lr_at(TA.OptConfig(**cfg), torch.tensor(step))) == pytest.approx(
            want, rel=1e-6)


def test_update_leaves_its_arguments_as_they_were():
    np_p = _np_params()
    _, tp = _both(np_p)
    _, tg = _both(_np_grads(np_p))
    cfg = TS.ShampooConfig()
    st = TS.shampoo_init(tp, cfg)
    before = {k: v.clone() for k, v in tree.leaves_with_path({"p": tp, "s": st})}
    TS.shampoo_update(tg, st, tp, cfg)
    for k, v in tree.leaves_with_path({"p": tp, "s": st}):
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# Shampoo: groups, roots, precondition
# ---------------------------------------------------------------------------


def test_shape_groups_equal_reference():
    jp, tp = _both(_np_params())
    cfg = dict(max_precond_dim=40)
    assert TS.shape_groups(tp, TS.ShampooConfig(**cfg)) == JS.shape_groups(
        jp, JS.ShampooConfig(**cfg))
    groups = TS.shape_groups(tp, TS.ShampooConfig())
    assert groups == JS.shape_groups(jp, JS.ShampooConfig())
    assert "stack/ln" not in str(groups) and "bias" not in str(groups)


def test_shape_groups_full_size_qwen3_4b():
    """36 stacked layers: the stacked qk-norm scales, (36, 128) 2-D
    leaves, are one layer each and eligible, as in the reference; five
    groups, five precondition calls a step."""
    jcfg = dataclasses.replace(jget("qwen3-4b"), kron_ffn=True, kron_factors=2)
    tcfg = dataclasses.replace(tget("qwen3-4b"), kron_ffn=True, kron_factors=2)
    want = JS.shape_groups(
        jax.eval_shape(functools.partial(JM.init_params, jcfg), jax.random.PRNGKey(0)),
        JS.ShampooConfig())
    got = TS.shape_groups(TM.init_params(tcfg, None, device="meta"), TS.ShampooConfig())
    assert got == want
    assert {k: sum(s for _, s in v) for k, v in got.items()} == {
        (64, 128): 72, (40, 76): 72, (128, 64): 36, (76, 40): 36, (36, 128): 2}
    assert got[(36, 128)] == [("stack/pos0/mixer/k_norm", 1), ("stack/pos0/mixer/q_norm", 1)]
    ops = prebuild_kron_ops(tcfg, opt_cfg=TS.ShampooConfig())
    assert sorted((op.ps, op.batch) for op in ops if op.batch) == sorted(
        ((p, q), b) for (p, q), b in
        {k: sum(s for _, s in v) for k, v in got.items()}.items())


@pytest.mark.parametrize("method,iters", [("eigh", 25), ("newton", 30)])
def test_inverse_quarter_root_equals_reference(method, iters):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 24, 16)).astype(np.float32)
    s = g @ np.swapaxes(g, 1, 2)  # rank-deficient, as early in training
    want, wok = JS.inverse_quarter_root(jnp.asarray(s), method=method, iters=iters)
    got, ok = TS.inverse_quarter_root(torch.from_numpy(s), method=method, iters=iters)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    for i in range(3):
        assert_close(got[i], np.asarray(want[i]), ROOT_TOL)
    one, one_ok = TS.inverse_quarter_root(torch.from_numpy(s[0]), method=method, iters=iters)
    assert one.shape == (24, 24) and bool(one_ok)
    assert_close(TS._ridge_of(torch.from_numpy(s), 1e-2),
                 np.array([float(JS._ridge_of(jnp.asarray(m), 1e-2)) for m in s]), 1e-6)
    with pytest.raises(guard.PlanError):
        TS.inverse_quarter_root(torch.from_numpy(s), method="svd")


def _refreshed(np_p, seed=1):
    """The reference's and the port's states after one step (a refresh)."""
    jp, tp = _both(np_p)
    jg, tg = _both(_np_grads(np_p, seed))
    jcfg, tcfg = JS.ShampooConfig(), TS.ShampooConfig()
    _, jst, _ = JS.shampoo_update(jg, JS.shampoo_init(jp, jcfg), jp, jcfg)
    _, tst, _ = TS.shampoo_update(tg, TS.shampoo_init(tp, tcfg), tp, tcfg)
    return jst, tst


def test_batched_precondition_bitwise_equals_looped_and_reference():
    np_p = _np_params()
    jst, tst = _refreshed(np_p)
    rng = np.random.default_rng(5)
    ups = {p: rng.standard_normal((e["ok"].shape[0], e["lroot"].shape[-1],
                                   e["rroot"].shape[-1])).astype(np.float32)
           for p, e in tst["kron"].items()}
    yb = TS.precondition({p: torch.from_numpy(u) for p, u in ups.items()}, tst["kron"])
    yl = TS.precondition({p: torch.from_numpy(u) for p, u in ups.items()}, tst["kron"],
                         looped=True)
    yt = TS.precondition({p: torch.from_numpy(u) for p, u in ups.items()}, tst["kron"],
                         backend="torch")
    assert list(yb) == list(yl) == list(tst["kron"])
    for p in yb:
        assert torch.equal(yb[p], yl[p]) and torch.equal(yb[p], yt[p])
    want = JS.precondition({p: jnp.asarray(u) for p, u in ups.items()}, jst["kron"])
    for p in want:
        assert_close(yb[p], np.asarray(want[p]), ROOT_TOL)


# ---------------------------------------------------------------------------
# Shampoo: the update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["eigh", "newton"])
def test_shampoo_six_steps_equal_reference(method):
    """precond_every=5: refreshes at steps 1 and 5, stale counting between."""
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=20, precond_every=5,
               root_method=method)
    jcfg, tcfg = JS.ShampooConfig(**cfg), TS.ShampooConfig(**cfg)
    np_p = _np_params()
    jp, tp = _both(np_p)
    jst, tst = JS.shampoo_init(jp, jcfg), TS.shampoo_init(tp, tcfg)
    stales = []
    for i in range(6):
        jg, tg = _both(_np_grads(np_p, seed=i + 1))
        jp, jst, jm = JS.shampoo_update(jg, jst, jp, jcfg)
        tp, tst, tm = TS.shampoo_update(tg, tst, tp, tcfg)
        _assert_trees_close(tp, jp, ROOT_TOL)
        _assert_trees_close(tst, jst, ROOT_TOL)
        for k in ("grad_norm", "lr", "precond_ok_frac"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
        assert int(tm["precond_stale_steps"]) == int(jm["precond_stale_steps"])
        stales.append(int(tm["precond_stale_steps"]))
    assert stales == [0, 1, 2, 3, 0, 1]


def test_identity_roots_give_adamw_exactly():
    """Fresh roots are identity: past the step-1 refresh the Shampoo step IS
    the AdamW step, bitwise, eligible and ineligible leaves alike."""
    np_p = _np_params()
    _, tp = _both(np_p)
    _, tg = _both(_np_grads(np_p))
    acfg, scfg = TA.OptConfig(), TS.ShampooConfig(precond_every=50)
    ast, sst = TA.opt_init(tp, acfg), TS.shampoo_init(tp, scfg)
    ast["step"] = sst["step"] = torch.tensor(1, dtype=torch.int32)
    ap, ast2, am = TA.opt_update(tg, ast, tp, acfg)
    sp, sst2, sm = TS.shampoo_update(tg, sst, tp, scfg)
    for a, s in zip(tree.leaves(ap), tree.leaves(sp)):
        assert torch.equal(a, s)
    for k in ("m", "v"):
        for a, s in zip(tree.leaves(ast2[k]), tree.leaves(sst2[k])):
            assert torch.equal(a, s)
    assert float(am["grad_norm"]) == float(sm["grad_norm"])


def test_refresh_cadence_and_stale_counter():
    np_p = _np_params()
    _, tp = _both(np_p)
    cfg = TS.ShampooConfig(precond_every=3)
    st = TS.shampoo_init(tp, cfg)
    stales = []
    for i in range(7):
        _, tg = _both(_np_grads(np_p, seed=i))
        _, st, m = TS.shampoo_update(tg, st, tp, cfg)
        stales.append(int(m["precond_stale_steps"]))
    assert stales == [0, 1, 0, 1, 2, 0, 1]  # refreshes at steps 1, 3, 6
    assert all(bool(e["ok"].all()) for e in st["kron"].values())


def test_chaos_root_refresh_degrades_layer_not_step():
    np_p = _np_params()
    _, tp = _both(np_p)
    _, tg = _both(_np_grads(np_p))
    cfg = TS.ShampooConfig()
    st = TS.shampoo_init(tp, cfg)
    with chaos.inject("root_refresh:times=1") as specs:
        newp, st1, _ = TS.shampoo_update(tg, st, tp, cfg)
    assert specs[0].fired == 1
    assert all(bool(torch.isfinite(l).all()) for l in tree.leaves(newp))
    down = [p for p, e in st1["kron"].items() if not bool(e["ok"].any())]
    up = [p for p, e in st1["kron"].items() if bool(e["ok"].all())]
    assert len(down) == 1 and up
    e = st1["kron"][down[0]]
    assert torch.equal(e["lroot"], st["kron"][down[0]]["lroot"])
    assert int(e["stale"].max()) == 1
    assert guard.health_report()["events"]["root_refresh_degraded"] >= 1
    # the degraded layer's update IS plain AdamW's; a healthy one's is not
    ap, _, _ = TA.opt_update(tg, TA.opt_init(tp, TA.OptConfig()), tp, TA.OptConfig())
    sh, ad = dict(tree.leaves_with_path(newp)), dict(tree.leaves_with_path(ap))
    assert torch.equal(sh[down[0]], ad[down[0]])
    assert not torch.equal(sh[up[0]], ad[up[0]])
    # a plain step fires no chaos: the site sits on the refresh only
    with chaos.inject("root_refresh") as specs:
        TS.shampoo_update(tg, st1, newp, cfg)
    assert specs[0].fired == 0


def test_numerics_policy_warn_and_raise():
    np_p = _np_params()
    _, tp = _both(np_p)
    np_g = _np_grads(np_p)
    np_g["head"][0, 0] = np.nan  # its statistics and roots go non-finite
    _, tg = _both(np_g)
    cfg = TS.ShampooConfig()
    st = TS.shampoo_init(tp, cfg)
    with guard.numerics("warn"):
        with pytest.warns(guard.GuardWarning, match="inverse-root"):
            TS.shampoo_update(tg, st, tp, cfg)
    assert guard.health_report()["events"]["root_refresh_degraded"] >= 1
    guard.reset_health()
    with guard.numerics("raise"):
        with pytest.raises(guard.NumericsError):
            TS.shampoo_update(tg, st, tp, cfg)
    _, st2, m = TS.shampoo_update(tg, st, tp, cfg)
    assert not bool(st2["kron"]["head"]["ok"].any())
    assert float(m["precond_ok_frac"]) < 1.0


def test_spans_fire_on_every_refresh():
    np_p = _np_params()
    _, tp = _both(np_p)
    cfg = TS.ShampooConfig(precond_every=2)
    st = TS.shampoo_init(tp, cfg)
    telemetry.configure()
    for i in range(4):  # refreshes at steps 1, 2 and 4
        _, tg = _both(_np_grads(np_p, seed=i))
        _, st, _ = TS.shampoo_update(tg, st, tp, cfg)
    hist = telemetry.snapshot()["histograms"]
    assert hist["span.optim.root_refresh"]["count"] == 3
    assert hist["span.optim.precondition"]["count"] == 4


def test_state_memory_report_and_opt_for_equal_reference():
    np_p = _np_params()
    jp, tp = _both(np_p)
    for dt in ("float32", "bfloat16"):
        jst = JS.shampoo_init(jp, JS.ShampooConfig(state_dtype=dt))
        tst = TS.shampoo_init(tp, TS.ShampooConfig(state_dtype=dt))
        assert TS.state_memory_report(tst) == JS.state_memory_report(jst)
        _assert_trees_close(tst, jst, 0.0)
        # carried across, the reference's state reports the same
        carried = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
        assert TS.state_memory_report(carried) == JS.state_memory_report(jst)
    assert TS.opt_for(TS.ShampooConfig()) == (TS.shampoo_init, TS.shampoo_update)
    assert TS.opt_for(TA.OptConfig()) == (TA.opt_init, TA.opt_update)
    assert dataclasses.asdict(TS.ShampooConfig()) == dataclasses.asdict(JS.ShampooConfig())
