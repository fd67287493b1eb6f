"""The port's per-sample batched KronOp (repro_torch.core.engine) against
repro.core.KronOp(shared_factors=False): forward, gradients, the vmap rules,
make_batched_plan and kron_precond_op.  The local parts of
tests/test_batched.py, on the plain twins (CPU tensors); the JAX side runs
on its XLA backend or the Pallas kernels in interpret mode."""
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import KronOp as JKronOp
from repro.core import autotune as JA
from repro.core.engine import kron_precond_op as j_kron_precond_op
from repro.core.kron import KronProblem as JProblem
from repro_torch.core import KronOp, autotune, engine, kron_matmul_batched
from repro_torch.core.kron import KronProblem
from repro_torch.kernels import emit

jax.config.update("jax_enable_x64", True)

# (b, m, ps, qs)
CASES = [
    (2, 4, (4, 4), (4, 4)),
    (3, 5, (4, 4), (4, 4)),           # batch and rows with no nice divisors
    (2, 4, (4, 2, 3), (3, 2, 4)),     # rectangular chain
    (8, 2, (4, 8), (8, 4)),           # B > M
    (2, 3, (8, 16, 32), (8, 16, 32)),
]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _jax_op(b, ps, qs, **kw):
    return JKronOp(ps, qs, batch=b, shared_factors=False, **kw)


def _loss_grads_jax(jop, x, fs, ct):
    _, vjp = jax.vjp(lambda x, fs: jop(x, fs), to_jax(x), [to_jax(f) for f in fs])
    gx, gfs = vjp(to_jax(ct))
    return gx, gfs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("b,m,ps,qs", CASES)
def test_per_sample_forward_matches_jax(b, m, ps, qs, backend, dtype):
    x, fs = make_inputs(30, m, ps, qs, batch=b, dtype=dtype)
    want = _jax_op(b, ps, qs, backend=backend)(to_jax(x), [to_jax(f) for f in fs])
    op = KronOp(ps, qs, batch=b, shared_factors=False)
    got = op(to_torch(x), [to_torch(f) for f in fs])
    assert_close(got, want, TOL[dtype])
    assert op.out_shape(x.shape) == tuple(got.shape)
    assert op.plan.t_b >= 1 and b % op.plan.t_b == 0
    assert "per-sample" in op.describe()
    assert op.cost(m).flops == _jax_op(b, ps, qs).cost(m).flops


@pytest.mark.parametrize("b,m,ps,qs", CASES)
def test_per_sample_grads_match_jax(b, m, ps, qs):
    x, fs = make_inputs(31, m, ps, qs, batch=b)
    ct = np.random.default_rng(31).standard_normal((b, m, math.prod(qs)))
    gx, gfs = _loss_grads_jax(_jax_op(b, ps, qs), x, fs, ct)
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    y = KronOp(ps, qs, batch=b, shared_factors=False)(xt, ft)
    got = torch.autograd.grad(y, [xt, *ft], to_torch(ct))
    assert_close(got[0], gx, 1e-12)
    for a, w in zip(got[1:], gfs):
        assert a.shape == w.shape
        assert_close(a, w, 1e-12)


def test_per_sample_x_only_grad_skips_factor_grads(monkeypatch):
    b, m, ps, qs = 2, 4, (4, 4), (4, 4)
    x, fs = make_inputs(32, m, ps, qs, batch=b)
    calls = []
    orig = emit.run_stage_grad
    monkeypatch.setattr(emit, "run_stage_grad", lambda *a, **k: calls.append(1) or orig(*a, **k))
    xt = to_torch(x).requires_grad_()
    y = KronOp(ps, qs, batch=b, shared_factors=False)(xt, [to_torch(f) for f in fs])
    ct = np.random.default_rng(32).standard_normal(tuple(y.shape))
    (gx,) = torch.autograd.grad(y, [xt], to_torch(ct))
    assert not calls, "the stage backward ran although no factor needs a gradient"
    want, _ = _loss_grads_jax(_jax_op(b, ps, qs), x, fs, ct)
    assert_close(gx, want, 1e-12)


def test_per_sample_q_tiled_plan_backward_falls_back():
    """Fused stages legal only through Q-tiling: the one-launch stage
    backward cannot fit a block, so the per-factor fallback (chain-of-one
    launches for per-sample factors) runs, counted and recorded, for the
    full gradients and for the x-gradient alone."""
    from repro_torch.runtime import guard

    b, m, ps, qs = 2, 8, (2, 2, 2), (64, 64, 64)
    plan = autotune.make_batched_plan(KronProblem(m, ps, qs), b, shared_factors=False)
    assert any(st.t_qs is not None for st in plan.stages), plan.describe()
    x, fs = make_inputs(33, m, ps, qs, batch=b)
    ct = np.random.default_rng(33).standard_normal((b, m, math.prod(qs)))
    gx, gfs = _loss_grads_jax(_jax_op(b, ps, qs, backend="xla"), x, fs, ct)
    op = KronOp(ps, qs, batch=b, shared_factors=False, plan=plan)
    guard.reset_health()
    before = engine.bwd_per_factor_fallbacks
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    got = torch.autograd.grad(op(xt, ft), [xt, *ft], to_torch(ct))
    assert engine.bwd_per_factor_fallbacks > before
    assert guard.health_report()["events"]["bwd_per_factor"] >= 1
    assert_close(got[0], gx, 1e-12)
    for a, w in zip(got[1:], gfs):
        assert_close(a, w, 1e-12)
    (dx,) = torch.autograd.grad(op(xt, [f.detach() for f in ft]), [xt], to_torch(ct))
    assert_close(dx, gx, 1e-12)
    guard.reset_health()


def test_per_sample_plan_none_runs_unfused_loop():
    b, m, ps, qs = 2, 4, (4, 4), (4, 4)
    x, fs = make_inputs(34, m, ps, qs, batch=b)
    op = KronOp(ps, qs, m=m, batch=b, shared_factors=False, plan=None)
    assert op.plan == engine._unfused_batched_plan(2, m)
    assert [st.factor_ids for st in op.plan.stages] == [(0,), (1,)]
    want = _jax_op(b, ps, qs, plan=None)(to_jax(x), [to_jax(f) for f in fs])
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    y = op(xt, ft)
    assert_close(y.detach(), want, 1e-12)
    ct = np.random.default_rng(34).standard_normal(tuple(y.shape))
    gx, gfs = _loss_grads_jax(_jax_op(b, ps, qs, plan=None), x, fs, ct)
    got = torch.autograd.grad(y, [xt, *ft], to_torch(ct))
    assert_close(got[0], gx, 1e-12)
    for a, w in zip(got[1:], gfs):
        assert_close(a, w, 1e-12)


def test_per_sample_shape_validation():
    x = torch.zeros(2, 4, 16)
    f2 = torch.zeros(4, 4)
    f3 = torch.zeros(2, 4, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError):
            kron_matmul_batched(x, [f3, f3], shared_factors=True)
        with pytest.raises(ValueError):
            kron_matmul_batched(x, [f2, f2], shared_factors=False)
        with pytest.raises(ValueError):  # factor batch mismatch
            kron_matmul_batched(x, [torch.zeros(3, 4, 4), f3], shared_factors=False)
        with pytest.raises(ValueError):  # wrong K
            kron_matmul_batched(torch.zeros(2, 4, 17), [f3, f3], shared_factors=False)
        with pytest.raises(ValueError):  # x batch != op batch
            KronOp((4, 4), (4, 4), batch=2, shared_factors=False)(torch.zeros(3, 4, 16), [f3, f3])


def test_with_batch_keeps_or_sets_the_sharing_mode():
    op = KronOp((4, 4), (4, 4), m=8)
    per = op.with_batch(3, shared_factors=False)
    assert per.batch == 3 and not per.shared_factors
    assert not per.with_batch(5).shared_factors  # kept
    assert per.with_batch(5, shared_factors=True).shared_factors
    j = JKronOp((4, 4), (4, 4)).with_batch(3, shared_factors=False)
    assert (per.batch, per.shared_factors) == (j.batch, j.shared_factors)


def test_leading_dims_fold_into_rows_per_sample():
    b, ps, qs = 2, (4, 4), (4, 4)
    x, fs = make_inputs(35, 6, ps, qs, batch=b)
    x = x.reshape(b, 2, 3, -1)
    got = KronOp(ps, qs, batch=b, shared_factors=False)(to_torch(x), [to_torch(f) for f in fs])
    want = _jax_op(b, ps, qs)(to_jax(x), [to_jax(f) for f in fs])
    assert got.shape == (b, 2, 3, 16)
    assert_close(got, want, 1e-12)


# ---------------------------------------------------------------------------
# The vmap rules (torch.func.vmap through _KronFunction.vmap)
# ---------------------------------------------------------------------------


def _spy_programs(monkeypatch):
    """Record (x shape, batched program) and the program of every
    run_program call."""
    seen = []
    orig = emit.run_program

    def spy(x, factors, prog, **kw):
        seen.append((tuple(x.shape), prog.batched))
        programs.append(prog)
        return orig(x, factors, prog, **kw)

    programs = []
    monkeypatch.setattr(emit, "run_program", spy)
    return seen, programs


def test_vmap_over_x_and_factors_runs_the_per_sample_plan(monkeypatch):
    b, m, ps, qs = 4, 8, (4, 4), (4, 4)
    x, fs = make_inputs(36, m, ps, qs, batch=b)
    want = jax.vmap(lambda xi, fi: JKronOp(ps, qs)(xi, fi))(to_jax(x), [to_jax(f) for f in fs])
    seen, _ = _spy_programs(monkeypatch)
    got = torch.func.vmap(KronOp(ps, qs))(to_torch(x), [to_torch(f) for f in fs])
    assert seen == [((b, m, 16), True)]
    assert_close(got, want, 1e-12)
    direct = KronOp(ps, qs, batch=b, shared_factors=False)(to_torch(x), [to_torch(f) for f in fs])
    assert torch.equal(got, direct)  # the same plan: bitwise


def test_vmap_over_x_alone_folds_into_rows(monkeypatch):
    b, m, ps, qs = 4, 8, (4, 4), (4, 4)
    x, fs = make_inputs(37, m, ps, qs, batch=b)
    fs = [f[0] for f in fs]
    want = jax.vmap(lambda xi: JKronOp(ps, qs)(xi, [to_jax(f) for f in fs]))(to_jax(x))
    seen, programs = _spy_programs(monkeypatch)
    op = KronOp(ps, qs)
    got = torch.func.vmap(lambda xi: op(xi, [to_torch(f) for f in fs]))(to_torch(x))
    assert seen == [((b * m, 16), False)]
    # Planned again for the folded row count.
    assert programs == [engine._lowered(engine._resolve_plan(b * m, ps, qs, 8, False), ps, qs)]
    assert_close(got, want, 1e-12)
    flat = op(to_torch(x).reshape(b * m, -1), [to_torch(f) for f in fs])
    assert torch.equal(got, flat.reshape(b, m, -1))


def test_vmap_over_factors_alone_broadcasts_x():
    b, m, ps, qs = 3, 4, (4, 2), (2, 4)
    x, fs = make_inputs(38, m, ps, qs, batch=b)
    got = torch.func.vmap(lambda fi: KronOp(ps, qs)(to_torch(x[0]), fi))([to_torch(f) for f in fs])
    want = jax.vmap(lambda fi: JKronOp(ps, qs)(to_jax(x[0]), fi))([to_jax(f) for f in fs])
    assert_close(got, want, 1e-12)


def test_nested_vmap_folds_into_one_batch_axis(monkeypatch):
    c, b, m, ps, qs = 2, 3, 4, (4, 4), (4, 4)
    x, fs = make_inputs(39, m, ps, qs, batch=c * b)
    xn = x.reshape(c, b, m, -1)
    fn = [f.reshape(c, b, *f.shape[1:]) for f in fs]
    want = jax.vmap(jax.vmap(lambda xi, fi: JKronOp(ps, qs)(xi, fi)))(
        to_jax(xn), [to_jax(f) for f in fn])
    seen, _ = _spy_programs(monkeypatch)
    op = KronOp(ps, qs)
    got = torch.func.vmap(torch.func.vmap(op))(to_torch(xn), [to_torch(f) for f in fn])
    assert seen == [((c * b, m, 16), True)]
    assert_close(got, want, 1e-12)
    # Gradients through the nested rule equal the flat per-sample path's.
    ct = np.random.default_rng(39).standard_normal(tuple(got.shape))
    xt = to_torch(xn).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fn]
    g_nested = torch.autograd.grad(torch.func.vmap(torch.func.vmap(op))(xt, ft), [xt, *ft],
                                   to_torch(ct))
    xf = to_torch(x).requires_grad_()
    ff = [to_torch(f).requires_grad_() for f in fs]
    yf = KronOp(ps, qs, batch=c * b, shared_factors=False)(xf, ff)
    g_flat = torch.autograd.grad(yf, [xf, *ff], to_torch(ct).reshape(c * b, m, -1))
    for a, w in zip(g_nested, g_flat):
        assert torch.equal(a.reshape(w.shape), w)


def test_vmap_gradients_match_jax():
    b, m, ps, qs = 3, 4, (4, 2, 3), (3, 2, 4)
    x, fs = make_inputs(40, m, ps, qs, batch=b)
    ct = np.random.default_rng(40).standard_normal((b, m, math.prod(qs)))
    jfn = jax.vmap(lambda xi, fi: JKronOp(ps, qs)(xi, fi))
    _, vjp = jax.vjp(jfn, to_jax(x), [to_jax(f) for f in fs])
    jgx, jgfs = vjp(to_jax(ct))
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    got = torch.autograd.grad(torch.func.vmap(KronOp(ps, qs))(xt, ft), [xt, *ft], to_torch(ct))
    assert_close(got[0], jgx, 1e-12)
    for a, w in zip(got[1:], jgfs):
        assert_close(a, w, 1e-12)


# ---------------------------------------------------------------------------
# Batched plans
# ---------------------------------------------------------------------------

PLAN_CASES = [  # (m, ps, qs, batch)
    (16, (16,) * 6, (16,) * 6, 4),      # gp16-batched
    (1, (64, 128), (64, 128), 36),      # Shampoo precondition, qwen3-4b kron_ffn
    (1, (40, 76), (40, 76), 36),
    (8, (16, 16, 16), (16, 16, 16), 8),
    (8, (4, 4), (4, 4), 4),
    (8, (2, 2, 2), (64, 64, 64), 2),    # Q-tiled
]


def test_batched_plan_shared_collapses_batch_into_m():
    prob = KronProblem(64, (16, 16, 16), (16, 16, 16))
    plan = autotune.make_batched_plan(prob, 8, shared_factors=True)
    assert plan == autotune.make_plan(KronProblem(512, (16, 16, 16), (16, 16, 16)),
                                      enable_prekron=False)
    assert plan.t_b == 1


@pytest.mark.parametrize("m,ps,qs,batch", PLAN_CASES)
def test_batched_plan_t_b_fits_the_smem_budget(m, ps, qs, batch):
    """The per-sample plan is the single-problem plan at t_b=1 (no kernel
    packs samples into a tile), and every kernel it launches passes the
    executor's geometry check at that t_b: the forward chain, and at the
    backward M-tile the transposed chain and the stage backward, unless
    that kernel cannot fit even one sample (the stage then falls back).
    Grouping and Q-tiling equal the reference's at the same budget."""
    prob = KronProblem(m, ps, qs)
    plan = autotune.make_batched_plan(prob, batch, shared_factors=False)
    single = autotune.make_plan(prob, enable_prekron=False)
    assert plan == autotune.KronPlan(single.stages, single.bwd_stages, 1)
    budget = emit.SMEM_BUDGET_ELEMS
    k = prob.k
    for ins in autotune.lower(plan, ps, qs, batched=True).instrs:
        assert ins.t_b == 1
        xs, fss = (batch, m, k), [(batch, p, q) for p, q in zip(ins.ps, ins.qs)]
        emit.chain_geometry(xs, fss, t_b=1, t_m=ins.t_m, t_k=ins.t_k, t_qs=ins.t_qs)
        t_ins = ins.transpose()
        k_out = k // ins.pprod * ins.qprod
        dys = (batch, m, k_out)
        for check in (
            lambda: emit.chain_geometry(dys, fss, t_b=1, t_m=t_ins.t_m, t_k=ins.t_k,
                                        t_qs=ins.t_qs, direction="bwd"),
            lambda: emit.grad_geometry(xs, dys, fss, t_b=1, t_m=t_ins.t_m, t_k=ins.t_k),
        ):
            try:
                check()
            except emit.VmemOverflowError:
                pass  # the stage's backward takes the per-factor fallback
        k = k_out
    jplan = JA.make_batched_plan(JProblem(m, ps, qs), batch, shared_factors=False,
                                 vmem_budget_elems=budget)
    assert [(s.factor_ids, s.prekron, s.t_qs) for s in plan.stages] == [
        (s.factor_ids, s.prekron, s.t_qs) for s in jplan.stages]


def test_batched_plan_modes_and_errors():
    prob = KronProblem(8, (4, 4), (4, 4))
    with pytest.raises(ValueError):
        autotune.make_batched_plan(prob, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        autotune.make_batched_plan(prob, 4, shared_factors=False, tune="measure")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        autotune.make_batched_plan(prob, 4, cache_path="plans.json")
    with pytest.raises(autotune.PlanError):
        autotune.make_batched_plan(prob, 4, tune="fastest")
    plan = autotune.make_batched_plan(KronProblem(4, (2, 3, 2), (3, 2, 2)), 2,
                                      shared_factors=False, enable_prekron=True)
    assert any(st.prekron for st in plan.stages)


def test_per_sample_prekron_plan_runs_forward_and_backward():
    b, m, ps, qs = 2, 4, (2, 3, 2), (3, 2, 2)
    x, fs = make_inputs(41, m, ps, qs, batch=b)
    op = KronOp(ps, qs, batch=b, shared_factors=False, enable_prekron=True)
    jop = _jax_op(b, ps, qs, enable_prekron=True)
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    y = op(xt, ft)
    assert any(st.prekron for st in op.plan.stages)
    assert_close(y.detach(), jop(to_jax(x), [to_jax(f) for f in fs]), 1e-12)
    ct = np.random.default_rng(41).standard_normal(tuple(y.shape))
    gx, gfs = _loss_grads_jax(jop, x, fs, ct)
    got = torch.autograd.grad(y, [xt, *ft], to_torch(ct))
    assert_close(got[0], gx, 1e-12)
    for a, w in zip(got[1:], gfs):
        assert_close(a, w, 1e-12)


def test_batched_plan_cache_key_includes_batch_and_matches_jax():
    prob, jprob = KronProblem(8, (4, 4), (4, 4)), JProblem(8, (4, 4), (4, 4))
    k0 = autotune.plan_cache_key(prob, 4, "cuda")
    k8 = autotune.plan_cache_key(prob, 4, "cuda", batch=8, shared_factors=False)
    k16 = autotune.plan_cache_key(prob, 4, "cuda", batch=16, shared_factors=False)
    ks = autotune.plan_cache_key(prob, 4, "cuda", batch=8, shared_factors=True)
    assert len({k0, k8, k16, ks}) == 4
    kw = dict(batch=8, shared_factors=False, acc_dtype="float32",
              vmem_budget_elems=emit.SMEM_BUDGET_ELEMS)
    assert autotune.plan_cache_key(prob, 4, "xla", **kw) == JA.plan_cache_key(jprob, 4, "xla", **kw)


def test_batched_plan_json_roundtrip_keeps_t_b():
    base = autotune.make_batched_plan(KronProblem(8, (4, 4), (4, 4)), 8, shared_factors=False)
    plan = autotune.KronPlan(base.stages, base.bwd_stages, 4)
    assert autotune.plan_from_json(autotune.plan_to_json(plan)) == plan
    legacy = autotune.plan_to_json(plan)
    del legacy["t_b"]
    assert autotune.plan_from_json(legacy).t_b == 1
    # The JAX package's JSON for its own batched plan reads back with its t_b.
    jplan = JA.make_batched_plan(JProblem(8, (4, 4), (4, 4)), 8, shared_factors=False)
    assert autotune.plan_from_json(JA.plan_to_json(jplan)).t_b == jplan.t_b


# ---------------------------------------------------------------------------
# kron_precond_op (Shampoo's precondition: one per-sample op per shape group)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,q,batch", [(4, 6, 5), (8, 3, 2), (5, 5, 1)])
def test_kron_precond_op_matches_jax(p, q, batch):
    x, fs = make_inputs(42, 1, (p, q), (p, q), batch=batch)
    op = engine.kron_precond_op(p, q, batch)
    jop = j_kron_precond_op(p, q, batch)
    assert (op.batch, op.shared_factors, op.ps, op.qs) == (jop.batch, jop.shared_factors,
                                                          jop.ps, jop.qs)
    assert op is engine.kron_precond_op(p, q, batch)  # the shared bounded factory
    assert not any(st.prekron for st in op.plan.stages)  # never densified
    got = op(to_torch(x), [to_torch(f) for f in fs])
    assert_close(got, jop(to_jax(x), [to_jax(f) for f in fs]), 1e-12)
    # row @ (A (x) B) == vec_row(A^T G B) per layer
    g = x.reshape(batch, p, q)
    want = np.einsum("bip,biq,bqj->bpj", fs[0], g, fs[1]).reshape(batch, 1, p * q)
    assert_close(got, want, 1e-12)
    with pytest.raises(ValueError):
        engine.kron_precond_op(p, q, 0)
