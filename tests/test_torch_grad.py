"""Gradients of the port's KronOp against jax.grad of repro.core.KronOp, and
the backward pieces of the executor against their JAX counterparts: the
transposed sliced multiply, the transposed chain, the stage backward, the
transposed program, and the tile checks of the backward kernels.

Inputs (and cotangents) are made with numpy from a seed and handed to both
packages.  The JAX "pallas" backend runs its kernels in interpret mode on
the CPU, as the JAX package's own tests run them; the port runs the plain
twins of its CUDA kernels, as it does for every CPU tensor."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import KronOp as JKronOp
from repro.core import autotune as JA
from repro.core.kron import KronProblem as JProblem
from repro.kernels import emit as JE
from repro.kernels import ops as JO
from repro.runtime import guard as JG
from repro_torch.core import KronOp, engine, kron_matrix
from repro_torch.core import autotune as TA
from repro_torch.core.kron import KronProblem as TProblem
from repro_torch.kernels import emit as TE
from repro_torch.kernels import _launch, kron_sliced, kron_sliced_t, ops
from repro_torch.runtime import guard as TG

jax.config.update("jax_enable_x64", True)

CASES = [  # tests/test_torch_engine.py
    (8, (4, 4), (4, 4)),
    (4, (4, 2, 3), (3, 2, 4)),
    (8, (8, 16, 32), (8, 16, 32)),
    (10, (52, 65), (50, 20)),
    (6, (5, 3), (2, 7)),
]


def _cotangent(seed, m, qs, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, math.prod(qs))).astype(dtype)


def _jax_grads(jop, x, fs, ct, *, factors=True, dtype=None):
    """jax.grad of sum(y * ct) for x (and the factors)."""
    xj = to_jax(x, dtype)
    fj = [to_jax(f, dtype) for f in fs]
    cj = to_jax(ct, dtype).astype(jnp.float64 if dtype is None else jnp.float32)

    def loss(x, fs):
        return jnp.sum(jop(x, fs).astype(cj.dtype) * cj)

    if factors:
        gx, gf = jax.grad(loss, argnums=(0, 1))(xj, fj)
        return gx, list(gf)
    return jax.grad(loss)(xj, fj), None


def _port_grads(op, x, fs, ct, *, factors=True, dtype=None):
    """torch.autograd.grad of op(x, fs) with cotangent ct."""
    xt = to_torch(x, dtype).requires_grad_()
    ft = [to_torch(f, dtype).requires_grad_(factors) for f in fs]
    y = op(xt, ft)
    got = torch.autograd.grad(y, [xt, *ft] if factors else [xt], to_torch(ct, dtype))
    return got[0], (list(got[1:]) if factors else None)


def _assert_grads(got, want, tol):
    assert_close(got[0], want[0], tol)
    if want[1] is not None:
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            assert_close(a, b, tol)


# ---------------------------------------------------------------------------
# KronOp gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,ps,qs", CASES)
def test_kronop_grads_match_jax(m, ps, qs, backend):
    x, fs = make_inputs(30, m, ps, qs)
    ct = _cotangent(31, m, qs)
    want = _jax_grads(JKronOp(ps, qs, backend=backend), x, fs, ct)
    before = engine.bwd_per_factor_fallbacks
    got = _port_grads(KronOp(ps, qs), x, fs, ct)
    _assert_grads(got, want, 1e-9)
    assert engine.bwd_per_factor_fallbacks == before  # every stage fused
    assert got[0].dtype == torch.float64 and all(g.dtype == torch.float64 for g in got[1])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,ps,qs", CASES)
def test_kronop_x_only_grads_match_jax(m, ps, qs, backend, monkeypatch):
    """Without factor grads the backward runs the transposed program alone:
    no stage backward and no rematerialized stage input."""
    x, fs = make_inputs(32, m, ps, qs)
    ct = _cotangent(33, m, qs)
    want = _jax_grads(JKronOp(ps, qs, backend=backend), x, fs, ct, factors=False)
    calls = {"grad": 0, "fwd": 0}
    orig_grad, orig_stage = TE.run_stage_grad, TE.run_stage

    def grad(*a, **k):
        calls["grad"] += 1
        return orig_grad(*a, **k)

    def stage(y, sf, instr, **k):
        calls["fwd"] += instr.direction == "fwd"
        return orig_stage(y, sf, instr, **k)

    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f) for f in fs]
    y = KronOp(ps, qs)(xt, ft)
    monkeypatch.setattr(TE, "run_stage_grad", grad)
    monkeypatch.setattr(TE, "run_stage", stage)
    (gx,) = torch.autograd.grad(y, [xt], to_torch(ct))
    assert calls == {"grad": 0, "fwd": 0}
    assert_close(gx, want[0], 1e-9)


@pytest.mark.parametrize("factors_only", [False, True])
def test_kronop_factor_grads_only_for_factors_that_ask(factors_only):
    m, ps, qs = 4, (4, 2, 3), (3, 2, 4)
    x, fs = make_inputs(34, m, ps, qs)
    ct = _cotangent(35, m, qs)
    want = _jax_grads(JKronOp(ps, qs), x, fs, ct)
    xt = to_torch(x).requires_grad_(not factors_only)
    ft = [to_torch(f).requires_grad_(i != 1) for i, f in enumerate(fs)]
    y = KronOp(ps, qs)(xt, ft)
    wrt = ([] if factors_only else [xt]) + [ft[0], ft[2]]
    got = torch.autograd.grad(y, wrt, to_torch(ct))
    if not factors_only:
        assert_close(got[0], want[0], 1e-9)
    assert_close(got[-2], want[1][0], 1e-9)
    assert_close(got[-1], want[1][2], 1e-9)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,ps,qs", CASES)
def test_unfused_plan_none_grads_match_jax(m, ps, qs, backend):
    x, fs = make_inputs(36, m, ps, qs)
    ct = _cotangent(37, m, qs)
    if backend == "pallas" and m > 8 and m % 8:
        # The JAX sliced kernels keep the TPU's default t_m=8 (ROADMAP
        # queue 3); the port picks its tiles per shape.
        backend = "xla"
    want = _jax_grads(JKronOp(ps, qs, backend=backend, plan=None), x, fs, ct)
    got = _port_grads(KronOp(ps, qs, plan=None), x, fs, ct)
    _assert_grads(got, want, 1e-9)


@pytest.mark.parametrize("factors", [True, False])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prekron_plan_grads_match_jax(backend, factors):
    m, ps, qs = 4, (2, 3, 2), (3, 2, 2)
    x, fs = make_inputs(38, m, ps, qs)
    ct = _cotangent(39, m, qs)
    op = KronOp(ps, qs, enable_prekron=True)
    assert any(st.prekron for st in op.plan.stages)
    want = _jax_grads(JKronOp(ps, qs, backend=backend, enable_prekron=True), x, fs, ct,
                      factors=factors)
    _assert_grads(_port_grads(op, x, fs, ct, factors=factors), want, 1e-9)


@pytest.mark.parametrize("factors", [True, False])
def test_q_tiled_plan_takes_the_per_factor_fallback(factors):
    """tests/test_grad_planned.py::test_pallas_backward_on_q_tiled_plan: a
    stage fused only through Q-tiling cannot hold its gradient pairs in one
    block, so its factor-grad backward runs per factor."""
    m, ps, qs = 8, (2, 2, 2), (64, 64, 64)
    plan = TA.make_plan(TProblem(m, ps, qs), enable_prekron=False)
    assert any(st.t_qs is not None for st in plan.stages), plan.describe()
    x, fs = make_inputs(40, m, ps, qs)
    ct = _cotangent(41, m, qs)
    want = _jax_grads(JKronOp(ps, qs, plan=None), x, fs, ct, factors=factors)
    before = engine.bwd_per_factor_fallbacks
    got = _port_grads(KronOp(ps, qs, plan=plan), x, fs, ct, factors=factors)
    _assert_grads(got, want, 1e-9)
    if factors:
        assert engine.bwd_per_factor_fallbacks > before


@pytest.mark.parametrize("m,ps,qs", CASES[:3])
def test_bf16_grads_match_pallas_interpret(m, ps, qs):
    """bf16 keeps the intermediates in f32 inside a stage, as the Pallas
    kernels do; the tolerance is bf16's."""
    x, fs = make_inputs(42, m, ps, qs, dtype=np.float32)
    ct = _cotangent(43, m, qs, np.float32)
    want = _jax_grads(JKronOp(ps, qs, backend="pallas"), x, fs, ct, dtype=jnp.bfloat16)
    got = _port_grads(KronOp(ps, qs), x, fs, ct, dtype=torch.bfloat16)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in got[1])
    want = (np.asarray(want[0].astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in want[1]])
    _assert_grads((got[0].float(), [g.float() for g in got[1]]), want, 1e-2)


@pytest.mark.parametrize("m,ps,qs", CASES[:3])
def test_f32_grads_match_dense_oracle(m, ps, qs):
    x, fs = make_inputs(44, m, ps, qs, dtype=np.float32)
    ct = _cotangent(45, m, qs, np.float32)
    got = _port_grads(KronOp(ps, qs), x, fs, ct)
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    want = torch.autograd.grad(xt @ kron_matrix(ft), [xt, *ft], to_torch(ct))
    _assert_grads(got, (want[0].detach(), [w.detach() for w in want[1:]]), 1e-4)


def test_grads_of_leading_dims_and_shared_factor_batch():
    m, ps, qs, b = 4, (4, 2), (3, 4), 3
    x, fs = make_inputs(46, m, ps, qs, batch=b)
    fs = [f[0] for f in fs]
    ct = np.random.default_rng(47).standard_normal((b, m, math.prod(qs)))
    jop = JKronOp(ps, qs).with_batch(b)
    xj, fj = to_jax(x), [to_jax(f) for f in fs]
    gx, gf = jax.grad(lambda x, fs: jnp.sum(jop(x, fs) * to_jax(ct)), argnums=(0, 1))(xj, fj)
    got = _port_grads(KronOp(ps, qs).with_batch(b), x, fs, ct)
    _assert_grads(got, (gx, list(gf)), 1e-9)


# ---------------------------------------------------------------------------
# The transposed program and the executor's backward pieces
# ---------------------------------------------------------------------------


def _port_program(m, ps, qs, **kw):
    return TA.lower(TA.make_plan(TProblem(m, ps, qs), **kw), ps, qs)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,ps,qs", CASES)
def test_transpose_program_is_vjp(m, ps, qs, backend):
    """emit(transpose(prog)) is the x-cotangent of emit(prog): against
    torch.autograd through the dense oracle, and against the JAX package's
    transposed program on both backends."""
    x, fs = make_inputs(48, m, ps, qs)
    ct = _cotangent(49, m, qs)
    prog = _port_program(m, ps, qs, enable_prekron=False)
    ft = [to_torch(f) for f in fs]
    got = TE.emit(TE.transpose(prog))(to_torch(ct), ft)
    xt = to_torch(x).requires_grad_()
    (vjp,) = torch.autograd.grad(xt @ kron_matrix(ft), [xt], to_torch(ct))
    assert_close(got, vjp.detach(), 1e-9)
    jprog = JA.lower(JA.make_plan(JProblem(m, ps, qs), enable_prekron=False), ps, qs)
    want = JE.emit(JE.transpose(jprog), backend=backend)(to_jax(ct), [to_jax(f) for f in fs])
    assert_close(got, want, 1e-9)


STAGE_GRADS = [  # (M, ps, qs, t_m, t_k) of one forward instruction
    (4, (4, 4), (4, 4), 2, 16),
    (6, (5, 3), (2, 7), 3, None),
    (4, (4, 2, 3), (3, 2, 4), 4, 24),
    (2, (6,), (10,), 1, 12),
]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,ps,qs,t_m,t_k", STAGE_GRADS)
def test_run_stage_grad_matches_jax(m, ps, qs, t_m, t_k, backend):
    s = 2
    k = math.prod(ps) * s
    rng = np.random.default_rng(50)
    u = rng.standard_normal((m, k))
    g = rng.standard_normal((m, math.prod(qs) * s))
    fs = [rng.standard_normal((p, q)) for p, q in zip(ps, qs)]
    kw = dict(kind="multiply", ps=ps, qs=qs, factor_ids=tuple(range(len(ps))),
              t_m=t_m, t_k=t_k)
    jdx, jdfs = JE.run_stage_grad(to_jax(u), to_jax(g), [to_jax(f) for f in fs],
                                  JE.StageInstr(**kw), backend=backend)
    dx, dfs = TE.run_stage_grad(to_torch(u), to_torch(g), [to_torch(f) for f in fs],
                                TE.StageInstr(**kw))
    assert_close(dx, jdx, 1e-9)
    assert len(dfs) == len(jdfs)
    for a, b in zip(dfs, jdfs):
        assert_close(a, b, 1e-9)


def test_run_stage_grad_per_sample_matches_jax_pallas():
    b, m, ps, qs = 3, 4, (4, 2), (2, 4)
    x, fs = make_inputs(51, m, ps, qs, batch=b)
    g = np.random.default_rng(52).standard_normal((b, m, math.prod(qs)))
    kw = dict(kind="multiply", ps=ps, qs=qs, factor_ids=(0, 1), t_m=2, t_b=1)
    jdx, jdfs = JE.run_stage_grad(to_jax(x), to_jax(g), [to_jax(f) for f in fs],
                                  JE.StageInstr(**kw), backend="pallas")
    dx, dfs = TE.run_stage_grad(to_torch(x), to_torch(g), [to_torch(f) for f in fs],
                                TE.StageInstr(**kw))
    assert_close(dx, jdx, 1e-9)
    for a, c in zip(dfs, jdfs):
        assert a.shape == (b, *c.shape[1:])
        assert_close(a, c, 1e-9)


CHAIN_BWD = [  # (B, M, ps, qs, S, tiles) -> chain_pallas(direction="bwd")
    (1, 4, (4, 4), (4, 4), 3, dict(t_m=2)),
    (1, 2, (4, 4), (8, 8), 2, dict(t_m=2, t_qs=(4, 2))),
    (1, 2, (5, 6), (3, 7), 2, dict(t_m=1, t_k=30)),
    (2, 2, (4, 3), (3, 4), 2, dict(t_m=2, t_b=1)),
    (1, 2, (2, 3, 4), (4, 3, 2), 2, dict(t_m=1, t_qs=(2, 3, 1))),
]


@pytest.mark.parametrize("b,m,ps,qs,s,tiles", CHAIN_BWD)
def test_chain_bwd_reference_matches_chain_pallas(b, m, ps, qs, s, tiles):
    rng = np.random.default_rng(53)
    dy = rng.standard_normal((b, m, math.prod(qs) * s))
    fs = [rng.standard_normal((b, p, q)) for p, q in zip(ps, qs)]
    want = JE.chain_pallas(to_jax(dy), *(to_jax(f) for f in fs), direction="bwd",
                           interpret=True, **tiles)
    got = TE.chain_bwd_reference(to_torch(dy), *(to_torch(f) for f in fs))
    assert_close(got, want, 1e-9)
    # The executor's tile checks accept what chain_pallas accepts.
    geo = TE.chain_geometry(dy.shape, [f.shape for f in fs], direction="bwd", **tiles)
    assert geo.k == math.prod(ps) * s and geo.out_cols == dy.shape[2]


@pytest.mark.parametrize("m,p,q,s", [(6, 12, 5, 3), (4, 7, 9, 2), (8, 16, 16, 4)])
def test_sliced_t_reference_and_dispatch_match_jax(m, p, q, s):
    rng = np.random.default_rng(54)
    dy = rng.standard_normal((m, q * s))
    f = rng.standard_normal((p, q))
    for backend in ("xla", "pallas"):
        if backend == "pallas" and m > 8 and m % 8:
            continue
        want = JO.sliced_multiply_t(to_jax(dy), to_jax(f), backend=backend)
        assert_close(ops.sliced_multiply_t(to_torch(dy), to_torch(f)), want, 1e-9)
        assert_close(kron_sliced_t.sliced_multiply_t_reference(to_torch(dy), to_torch(f)),
                     want, 1e-9)


def test_sliced_apply_t_matches_jax():
    rng = np.random.default_rng(55)
    g, f = rng.standard_normal((4, 15)), rng.standard_normal((6, 5))
    assert_close(TE.sliced_apply_t(to_torch(g), to_torch(f)),
                 JE.sliced_apply_t(to_jax(g), to_jax(f)), 1e-12)
    g3, f3 = rng.standard_normal((2, 4, 15)), rng.standard_normal((2, 6, 5))
    assert_close(TE.sliced_apply_t(to_torch(g3), to_torch(f3)),
                 JE.sliced_apply_t(to_jax(g3), to_jax(f3)), 1e-12)
    assert_close(TE.sliced_apply_t(to_torch(g3), to_torch(f3[0])),
                 JE.sliced_apply_t(to_jax(g3), to_jax(f3[0])), 1e-12)


@pytest.mark.parametrize("batch", [None, 3])
def test_sliced_vjp_factor_matches_jax(batch):
    from repro.core.engine import _sliced_vjp_factor as jax_vjp_factor

    rng = np.random.default_rng(57)
    lead = () if batch is None else (batch,)
    u, g = rng.standard_normal((*lead, 4, 18)), rng.standard_normal((*lead, 4, 15))
    want = jax_vjp_factor(to_jax(u), to_jax(g), 6, 5)
    got = TE.sliced_vjp_factor(to_torch(u), to_torch(g), 6, 5)
    assert tuple(got.shape) == (*lead, 6, 5)
    assert_close(got, want, 1e-12)


def test_run_stage_executes_transposed_and_prekron_bwd_instructions():
    m, ps, qs = 4, (2, 3), (3, 2)
    rng = np.random.default_rng(56)
    g = rng.standard_normal((m, math.prod(qs) * 2))
    fs = [rng.standard_normal((p, q)) for p, q in zip(ps, qs)]
    for kind in ("transposed_multiply", "prekron"):
        kw = dict(kind=kind, ps=ps, qs=qs, factor_ids=(0, 1), t_m=2,
                  direction="bwd")
        want = JE.run_stage(to_jax(g), [to_jax(f) for f in fs], JE.StageInstr(**kw),
                            backend="pallas")
        got = TE.run_stage(to_torch(g), [to_torch(f) for f in fs], TE.StageInstr(**kw))
        assert_close(got, want, 1e-9)


# ---------------------------------------------------------------------------
# The backward kernels' tile checks and block tiles
# ---------------------------------------------------------------------------

BUDGET = 4096
BWD_TILE_CASES = [  # (dY shape, factor (p, q)s, tiles) -> chain_pallas(direction="bwd")
    ((1, 8, 30), ((4, 4), (2, 2)), dict(t_m=8)),                    # dY cols % prod(Q)
    ((1, 8, 64 * 4), ((4, 4), (8, 8)), dict(t_m=8, t_qs=(4, 3))),   # t_qs must divide Q
    ((1, 8, 64 * 4), ((4, 4), (8, 8)), dict(t_m=8, t_k=48)),        # T_K % prod(P)
    ((1, 8, 64 * 64), ((4, 4), (8, 8)), dict(t_m=8, t_k=1024)),     # budget
    ((1, 6, 64 * 4), ((4, 4), (8, 8)), dict(t_m=4, t_k=64)),        # tiles divide dims
]


def _port_error(jax_type):
    return {JG.LoweringError: TG.LoweringError, JG.VmemOverflowError: TG.VmemOverflowError}[jax_type]


@pytest.mark.parametrize("dy_shape,pqs,tiles", BWD_TILE_CASES)
def test_chain_bwd_tile_checks_match_chain_pallas(dy_shape, pqs, tiles):
    b = dy_shape[0]
    with pytest.raises(JG.KronError) as jax_err:
        JE.chain_pallas(jnp.zeros(dy_shape, jnp.float32),
                        *(jnp.zeros((b, p, q), jnp.float32) for p, q in pqs),
                        direction="bwd", interpret=True, vmem_budget_elems=BUDGET, **tiles)
    with pytest.raises(_port_error(type(jax_err.value))):
        TE.chain_bwd_cuda(torch.zeros(dy_shape), *(torch.zeros(b, p, q) for p, q in pqs),
                          vmem_budget_elems=BUDGET, **tiles)


GRAD_TILE_CASES = [  # (x shape, dy shape, factor (p, q)s, tiles) -> grad_pallas
    ((1, 8, 30), (1, 8, 30), ((4, 4), (2, 2)), dict(t_m=8)),         # K % prod(P)
    ((1, 8, 64), (1, 8, 60), ((4, 4), (4, 4)), dict(t_m=8)),         # dy shape
    ((1, 8, 64), (1, 8, 256), ((4, 4), (8, 8)), dict(t_m=8, t_k=48)),  # T_K % prod(P)
    ((1, 8, 1024), (1, 8, 4096), ((4, 4), (8, 8)), dict(t_m=8)),      # live set
    ((1, 6, 64), (1, 6, 256), ((4, 4), (8, 8)), dict(t_m=4, t_k=64)),  # tiles divide dims
]


@pytest.mark.parametrize("x_shape,dy_shape,pqs,tiles", GRAD_TILE_CASES)
def test_grad_tile_checks_match_grad_pallas(x_shape, dy_shape, pqs, tiles):
    b = x_shape[0]
    with pytest.raises(JG.KronError) as jax_err:
        JE.grad_pallas(jnp.zeros(x_shape, jnp.float32), jnp.zeros(dy_shape, jnp.float32),
                       *(jnp.zeros((b, p, q), jnp.float32) for p, q in pqs),
                       interpret=True, vmem_budget_elems=BUDGET, **tiles)
    with pytest.raises(_port_error(type(jax_err.value))):
        TE.grad_cuda(torch.zeros(x_shape), torch.zeros(dy_shape),
                     *(torch.zeros(b, p, q) for p, q in pqs),
                     vmem_budget_elems=BUDGET, **tiles)


@pytest.mark.parametrize(
    "kind", [pytest.param("chain_bwd", id="bwd"), "grad", "chain_fwd"])
@pytest.mark.parametrize(
    "t_m,t_k,ps,qs",
    [(4, 8192, (32, 32), (32, 32)), (2, 4864, (64,), (128,)), (2, 3380, (65,), (20,)),
     (1, 8192, (16, 16), (16, 16))],
)
def test_backward_block_tiles_are_the_largest_that_fit(t_m, t_k, ps, qs, kind):
    # The persistent kernels (the chains and the stage backward) prefer
    # tiles that leave room for a second block on the SM, then runs of the
    # (M, Q.., S) view that fill a 32-byte sector; then the largest tile,
    # ties to the wider slab.
    tm, tk = TE.block_tile(t_m, t_k, ps, qs, 4, kind=kind)
    pprod = math.prod(ps)
    assert t_k % tk == 0 and tk % pprod == 0 and t_m % tm == 0
    share = TE.TWO_BLOCK_SMEM_BYTES

    def key(m, k):
        nbytes = TE.block_smem_bytes(m, k, ps, qs, 4, kind=kind)
        return (nbytes <= share, k // pprod * 4 >= 32, m * k, k)

    assert TE.block_smem_bytes(tm, tk, ps, qs, 4, kind=kind) <= TE.SMEM_BYTES
    for d in range(1, t_k // pprod + 1):
        for m in range(1, t_m + 1):
            if (t_k // pprod) % d or t_m % m or (m, d * pprod) == (tm, tk):
                continue
            if TE.block_smem_bytes(m, d * pprod, ps, qs, 4, kind=kind) <= TE.SMEM_BYTES:
                assert key(m, d * pprod) < key(tm, tk)


def test_backward_smem_models_count_every_region():
    # One (32, 32) stage at t_m=1, t_k=4096 in f32, by hand, for the
    # transposed chain: two slots of the flat dY block (4096 columns), the
    # flat G_1 (4096), both transposed (32, 32) panels and the table of 1024
    # dY runs (Q-tiles (16, 32): a dY block and G_1 of 2048 columns, panels
    # of 16 and 32 rows, 512 runs and the (t_m, t_k) sum of dX).
    assert TE.block_smem_bytes(1, 4096, (32, 32), (32, 32), 4, kind="chain_bwd") == 4 * (
        2 * 4096 + 4096 + 2 * 1024 + 1024)
    assert TE.block_smem_bytes(1, 4096, (32, 32), (16, 32), 4, kind="chain_bwd",
                               q_tiled=True) == 4 * (
        2 * 2048 + 2048 + 16 * 32 + 32 * 32 + 512 + 4096)
    # The stage backward on the CUDA cores (a float64 (32, 32) stage), in
    # bytes: the slot of the raw x slab (4096; a multi-factor stage copies dY
    # straight into G_2); the forward states u_0, u_1 (32 rows of 128 slices
    # at stride 129); the gradient states G_2 and G_1 (32 x 129 each); the
    # forward panel of F_0 and the transposed panels of both factors (32 x 32
    # each); the persistent dF items of both factors (64 4x4 tiles x 4 groups
    # x 16 sums).
    assert TE.block_smem_bytes(1, 4096, (32, 32), (32, 32), 8, kind="grad") == (
        4096 * 8
        + 2 * 32 * 129 * 8
        + 2 * 32 * 129 * 8
        + 32 * 32 * 8 + 2 * 32 * 32 * 8
        + 2 * 64 * 4 * 16 * 8)
    # A bf16 single-factor stage (ffn's 64 -> 128 at t_m'=2, t_k'=1216, 19
    # slices, so 38 contraction rows padded to 48 and rows padded by 8): the
    # slot of raw x (2 x 1216) and dY (2 x 2432) in bf16; the tensor-core
    # operands x^T (64 x 56), dY^T (128 x 56) and F (64 x 136) in bf16. Its
    # 64 dF output tiles of 16 x 8 stay in the warps' registers.
    assert TE.block_smem_bytes(2, 1216, (64,), (128,), 4, kind="grad", in_bytes=2) == (
        2 * 1216 * 2 + 2 * 2432 * 2
        + 2 * (64 * 56 + 128 * 56 + 64 * 136))
    # A (16, 16) bf16 stage at one slice: 2 output tiles shared by 4 warps
    # each, whose sums meet in shared memory (2 x 4 x 512 bytes) over the
    # smaller slot and operands (x^T and dY^T 16 x 24, F 16 x 24).
    assert TE.block_smem_bytes(1, 16, (16,), (16,), 4, kind="grad", in_bytes=2) == max(
        16 * 2 + 16 * 2 + 2 * (16 * 24 + 16 * 24 + 16 * 24), 2 * 4 * 512)
    # A bf16 factor with more dF tiles than the warps' registers hold
    # (128 x 128: 128 tiles) takes the CUDA-core path.
    assert TE.grad_uses_mma((64,), (128,), 2) and not TE.grad_uses_mma((128,), (128,), 2)


@pytest.mark.parametrize(
    "ps,qs,in_bytes,acc_bytes,want",
    [
        ((32, 32), (32, 32), 4, 4, "grad_tf32_kernel<1>"),  # fig9's stage
        ((16, 16), (16, 16), 4, 4, "grad_tf32_kernel<1>"),  # gp16's stage
        ((65,), (20,), 4, 4, "grad_tf32_kernel<4>"),  # odd P and Q, padded
        ((8, 8, 8), (8, 8, 8), 4, 4, "grad_tf32_kernel<4>"),  # the smallest factors it takes
        ((8,) * 4, (8,) * 4, 4, 4, "grad_kernel"),  # its layout overflows one block
        ((4, 4), (4, 4), 4, 4, "grad_kernel"),  # under 8 x 8: the CUDA cores
        ((8, 8), (4, 8), 4, 4, "grad_kernel"),
        ((128,), (128,), 4, 4, "grad_kernel"),  # 64 dF regions: over the registers
        ((40, 64), (76, 128), 4, 4, "grad_kernel"),
        ((64,), (128,), 2, 4, "grad_mma_kernel"),  # bf16 single-factor
        ((32, 32), (32, 32), 2, 4, "grad_kernel"),  # bf16 multi-factor
        ((32, 32), (32, 32), 8, 8, "grad_kernel"),  # float64
    ],
)
def test_stage_backward_kernel_follows_dtype_and_factor_shapes(ps, qs, in_bytes, acc_bytes, want):
    # grad.cu picks its kernel from what the stage shows: f32 stages whose
    # factors are at least 8 x 8 and whose dF regions fit the warps'
    # registers run on the tensor cores in 3xTF32; bf16 single-factor
    # stages on grad_mma_kernel; the rest on the CUDA cores.
    assert TE.grad_kernel_name(ps, qs, in_bytes, acc_bytes) == want
    assert TE.grad_uses_tf32(ps, qs, in_bytes, acc_bytes) == want.startswith("grad_tf32")
    assert TE.grad_uses_mma(ps, qs, in_bytes) == (want == "grad_mma_kernel")


def test_per_sample_f32_stage_backwards_take_the_tensor_cores():
    # gp16-batched's plan: B=4 samples, each stage two (16, 16) factors.
    ps = qs = (16,) * 6
    plan = TA.make_batched_plan(TProblem(16, ps, qs), 4, shared_factors=False)
    instrs = TA.lower(plan, ps, qs, batched=True).instrs
    assert instrs and all(ins.t_b is not None for ins in instrs)
    assert all(TE.grad_kernel_name(ins.ps, ins.qs, 4) == "grad_tf32_kernel<1>" for ins in instrs)


@pytest.mark.parametrize(
    "ps,rows,want",
    [
        # fig9's stage at t_m'=1, t_k'=4096: 128 rows of 32 slices.  u_0 twice
        # and u_1 row-major (128 x (32 + 4)); G_2 and G_1 feature-major (32 x
        # (128 + 8)); the split forward panel of F_0 and transposed panels of
        # both factors (hi and lo, 32 x 32 each).  The dF sums (2 factors x 4
        # regions x 256 floats: each factor's on half of the warps) stay
        # under the states.
        ((32, 32), 128, 4 * (3 * 128 * 36 + 2 * 32 * 136 + 3 * 2 * 32 * 32)),
        # gp16's stage at t_m'=1, t_k'=4096: 256 rows of 16 slices.
        ((16, 16), 256, 4 * (3 * 256 * 20 + 2 * 16 * 264 + 3 * 2 * 16 * 16)),
    ],
)
def test_tf32_smem_model_counts_every_region(ps, rows, want):
    t_k = rows * ps[0]
    assert TE.grad_uses_tf32(ps, ps, 4)
    assert TE.block_smem_bytes(1, t_k, ps, ps, 4, kind="grad") == want
    assert want <= TE.TWO_BLOCK_SMEM_BYTES
    # The block tile the stage backward takes inside the plan's (1, 8192).
    assert TE.block_tile(1, 8192, ps, ps, 4, kind="grad") == (1, t_k)


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 of finite float32 values: the low 13 bits rounded to
    nearest, ties away from zero, on the int32 view."""
    bits = a.view(np.int32).astype(np.int64)
    return ((bits + 0x1000) & ~0x1FFF).astype(np.uint32).view(np.float32)


def _tf32_read(a: np.ndarray) -> np.ndarray:
    """What an mma.sync .tf32 operand reads of a float32: its top 19 bits."""
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_is_float32_grade_and_tf32_is_not():
    # One dF contraction of fig9's stage (u^T G, 32 x 32) over the rows of
    # four x rows (4 x 2^15 slices), each sum in float32 the same way.  The
    # grad kernel's split: hi = cvt.rna.tf32(a), lo = a - hi as the mma reads
    # it, and lo*hi + hi*lo + hi*hi.  Against float64 it reads like plain
    # float32; one product of the hi parts (TF32) is far worse.
    rng = np.random.default_rng(26)
    u = rng.standard_normal((4 * 2 ** 15, 32)).astype(np.float32)
    g = rng.standard_normal((4 * 2 ** 15, 32)).astype(np.float32)
    exact = u.astype(np.float64).T @ g.astype(np.float64)

    def err(got):
        return float(np.abs(got.astype(np.float64) - exact).max() / np.abs(exact).max())

    uh, gh = _tf32_rna(u), _tf32_rna(g)
    ul, gl = _tf32_read(u - uh), _tf32_read(g - gh)
    three = (ul.T @ gh + uh.T @ gl) + uh.T @ gh
    f32, split, tf32 = err(u.T @ g), err(three), err(uh.T @ gh)
    assert split <= 4 * f32
    assert tf32 >= 100 * split


def test_sliced_t_smem_model_counts_every_region():
    # Three ring slots of the (t_m, t_q, t_s) dY box and the (Q, P) panel
    # once; Q-tiled, a (t_q, P) panel slice rides in every slot.
    assert kron_sliced.sliced_t_smem_bytes(1, 128, 32, 32, 32, 4, 4) == (
        3 * 32 * 128 * 4 + 32 * 32 * 4)
    assert kron_sliced.sliced_t_smem_bytes(2, 8, 256, 256, 32, 4, 4) == 3 * (
        2 * 32 * 8 * 4 + 32 * 256 * 4)
    assert kron_sliced.sliced_t_smem_bytes(3, 39, 40, 76, 76, 2, 4) == (
        3 * ((3 * 76 * 39 * 2 + 15) // 16 * 16) + 76 * 40 * 4)


SMOKE_STAGES = [  # (M, ps, qs, input bytes) of chip_smoke.py's backward cases
    (1024, (32,) * 4, (32,) * 4, 4),
    (16, (16,) * 6, (16,) * 6, 4),
    (4096, (64, 40), (128, 76), 2),
    (10, (52, 65), (50, 20), 4),
]


def _stage_block_tiles(m, ps, qs, in_bytes):
    plan = TA.make_plan(TProblem(m, ps, qs), dtype_bytes=in_bytes, enable_prekron=False)
    prog = TA.lower(plan, ps, qs)
    k = TProblem(m, ps, qs).k
    out = []
    for ins in prog.instrs:
        k_out = k // ins.pprod * ins.qprod
        geo = TE.grad_geometry(
            (1, m, k), (1, m, k_out), [(1, p, q) for p, q in zip(ins.ps, ins.qs)],
            t_m=ins.transpose().t_m, t_k=ins.t_k, in_bytes=in_bytes,
        )
        out.append((ins.ps, ins.qs, geo.block_m, geo.block_k))
        k = k_out
    return out


@pytest.mark.parametrize(
    "m,ps,qs,in_bytes,want",
    [
        (*SMOKE_STAGES[0], [((32, 32), (32, 32), 1, 4096)] * 2),
        (*SMOKE_STAGES[1], [((16, 16), (16, 16), 1, 4096)] * 3),
        (*SMOKE_STAGES[2], [((40,), (76,), 2, 2560), ((64,), (128,), 1, 4864)]),
        (*SMOKE_STAGES[3], [((65,), (20,), 1, 3380), ((52,), (50,), 2, 1040)]),
    ],
)
def test_stage_backward_block_tiles_at_the_smoke_shapes(m, ps, qs, in_bytes, want):
    got = _stage_block_tiles(m, ps, qs, in_bytes)
    assert got == want
    for sps, sqs, bm, bk in got:
        nbytes = TE.block_smem_bytes(bm, bk, sps, sqs, 4, kind="grad", in_bytes=in_bytes)
        assert nbytes <= TE.TWO_BLOCK_SMEM_BYTES


def test_sliced_t_tiles_at_the_smoke_shapes():
    # fig9-unfused-grad: one (32, 32) factor, M=1024, S=32768: a (1, 128)
    # tile gives each of the 256 threads one 4x4 register tile, Q whole.
    assert kron_sliced.sliced_tiles(1024, 32768, 32, 32, 4, kind="sliced_t") == (1, 128, 32)
    # A panel of 256 x 256 f32 cannot stay whole: Q is tiled.
    t_m, t_s, t_q = kron_sliced.sliced_tiles(16, 64, 256, 256, 4, kind="sliced_t")
    assert t_q < 256 and kron_sliced.sliced_t_smem_bytes(
        t_m, t_s, 256, 256, t_q, 4, 4) <= TE.TWO_BLOCK_SMEM_BYTES
    # Slices not a multiple of 4 are taken whole.
    assert kron_sliced.sliced_tiles(6, 39, 32, 32, 4, kind="sliced_t") == (3, 39, 32)


@pytest.mark.parametrize(
    "sms,per_sm,tiles,b,want",
    [(132, 2, 524288, 1, 264), (132, 2, 10, 1, 10), (132, 2, 5, 3, 5),
     (132, 1, 100, 300, 1), (132, 2, 1000, 4, 66), (132, 3, 4096, 1, 396)],
)
def test_grad_blocks_is_a_function_of_sms_occupancy_tiles_and_batch(sms, per_sm, tiles, b, want):
    assert _launch.grad_blocks(sms, per_sm, tiles, b) == want


def test_backward_wrappers_on_cpu_tensors_raise():
    dy, f = torch.zeros(1, 2, 16), torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        TE.chain_bwd_cuda(dy, f, f, t_m=2)
    with pytest.raises(ValueError, match="CUDA"):
        TE.grad_cuda(torch.zeros(1, 2, 16), dy, f, f, t_m=2)
    with pytest.raises(ValueError, match="CUDA"):
        kron_sliced_t.sliced_multiply_t_cuda(torch.zeros(2, 16), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.sliced_multiply_t(torch.zeros(2, 16), torch.zeros(4, 4), backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        TE.run_stage_grad(torch.zeros(2, 16), torch.zeros(2, 16), (torch.eye(4),) * 2,
                          TE.StageInstr("multiply", (4, 4), (4, 4), (0, 1)), backend="cuda")
