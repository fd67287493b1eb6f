"""The fused CG updates (repro_torch.kernels.cg_update, csrc/cg_update.cu) on
the card against the eager shift-form recurrence of
``gp.ski.conjugate_gradient`` in float32: each pass, a whole solve, its
determinism and its freedom from host synchronisation.  Every test here
needs a CUDA card and skips without one.

Each element of a pass rounds as the eager operations do, so a pass whose
row sums are given exactly (one nonzero partial a row) equals the eager
formula bit for bit.  The row sums themselves are held to float64 at 1e-6
of the sum of absolute terms (float32 accumulation over at most 256
elements a thread).  A whole solve sums in another order than the eager one
at every dot product; the two are held to each other at 1e-4 of the
solution's largest element and 1e-3 of each residual norm, where a dropped
iteration moves the solution by about 1e-1.  In float64 the passes hold
bit for bit the same way, and a whole solve holds to the eager one at
1e-10."""
import math

import pytest
import torch

from repro_torch.gp import ski
from repro_torch.kernels import _launch
from repro_torch.kernels import cg_update as CU

SHAPES = [(16, 16 ** 4), (1, 4099), (3, 16, 4096)]
SHIFT = 0.1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/cg_update.cu runs only there")
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def _eager(matvec, b, iters=10):
    """The plain twin: the eager shift-form updates."""
    return ski._cg_eager(matvec, b, iters, SHIFT, ski._row_dot)


def _sums(part, which):
    """Row sums of one partial buffer, float64, of b's leading shape."""
    return part[which].sum(-1)


def _exact_partials(cg, which, totals):
    """Write each row's total as its first partial, zeros after it, so the
    kernels' row sums are exact."""
    cg.part[which].zero_()
    cg.part[which][:, 0] = totals.reshape(-1)


def _state(shape, device):
    b = _randn(shape, 1, device)
    cg = CU.FusedCG(b, torch.zeros_like(b), SHIFT)
    return b, cg


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_start_forms_r_p_and_the_residual_partials(card, shape):
    b, cg = _state(shape, card)
    y = _randn(shape, 2, card)
    cg.start(y)
    torch.cuda.synchronize()
    r = b - y
    assert torch.equal(cg.r, r) and torch.equal(cg.p, r)
    assert cg.r.data_ptr() != cg.p.data_ptr()
    want = (r.double() ** 2).sum(-1).reshape(-1)
    assert torch.allclose(_sums(cg.part, 1), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_dot_sums_p_against_y_plus_shift_p(card, shape):
    _, cg = _state(shape, card)
    cg.p.copy_(_randn(shape, 3, card))
    y = _randn(shape, 4, card)
    cg.dot(y)
    torch.cuda.synchronize()
    terms = cg.p.double() * (y + SHIFT * cg.p).double()
    got = _sums(cg.part, 0)
    assert ((got - terms.sum(-1).reshape(-1)).abs()
            <= 1e-6 * terms.abs().sum(-1).reshape(-1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_step_updates_x_and_r_as_the_eager_recurrence(card, shape):
    _, cg = _state(shape, card)
    rows = cg.rows
    for t, seed in ((cg.x, 5), (cg.r, 6), (cg.p, 7)):
        t.copy_(_randn(shape, seed, card))
    y = _randn(shape, 8, card)
    denom = torch.rand(rows, device=card, dtype=torch.float64) + 0.5
    rs = torch.rand(rows, device=card, dtype=torch.float64) + 0.5
    denom[0] = 0.0  # the clamp: alpha = rs / 1e-20 would overflow f32, so rs is 0 there
    rs[0] = 0.0
    _exact_partials(cg, 0, denom)
    _exact_partials(cg, 1, rs)
    x0, r0, p0 = cg.x.clone(), cg.r.clone(), cg.p.clone()
    cg.step(y)
    torch.cuda.synchronize()
    alpha = (rs / denom.clamp(min=1e-20)).float().reshape(*shape[:-1], 1)
    ap = y + SHIFT * p0
    assert torch.equal(cg.x, x0 + alpha * p0)
    r = r0 - alpha * ap
    assert torch.equal(cg.r, r) and torch.equal(cg.p, p0)
    assert cg.cur == 1
    want = (r.double() ** 2).sum(-1).reshape(-1)
    assert torch.allclose(_sums(cg.part, 2), want, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_direction_and_norm_as_the_eager_recurrence(card, shape):
    _, cg = _state(shape, card)
    rows = cg.rows
    cg.r.copy_(_randn(shape, 9, card))
    cg.p.copy_(_randn(shape, 10, card))
    rs_new = torch.rand(rows, device=card, dtype=torch.float64)
    rs_old = torch.rand(rows, device=card, dtype=torch.float64) + 0.5
    rs_old[-1] = 0.0  # the clamp
    cg.cur = 1  # a step has run: the new residual's partials sit at [2]
    _exact_partials(cg, 2, rs_new)
    _exact_partials(cg, 1, rs_old)
    r0, p0 = cg.r.clone(), cg.p.clone()
    cg.direction()
    res = cg.norm()
    torch.cuda.synchronize()
    beta = (rs_new / rs_old.clamp(min=1e-20)).float().reshape(*shape[:-1], 1)
    assert torch.equal(cg.p, r0 + beta * p0) and torch.equal(cg.r, r0)
    assert res.shape == shape[:-1]
    assert torch.equal(res, rs_new.sqrt().float().reshape(shape[:-1]))


def _problem(shape, device, dtype=torch.float32):
    """A (K + shift I) system on the card: RBF Kron factors for 16^4 and the
    batched (3, 16, 4096) (16^3 per kernel), a dense SPD matrix for 4099."""
    k = shape[-1]
    b = _randn(shape, 11, device, dtype)
    if k == 4099:
        g = torch.Generator(device=device).manual_seed(12)
        a = torch.randn(k, k, generator=g, device=device, dtype=torch.float64) / math.sqrt(k)
        a = (a @ a.T).to(dtype)
        return (lambda v: v @ a), b
    grid = torch.linspace(0, 1, 16, device=device, dtype=dtype)
    dims = round(math.log(k, 16))
    if len(shape) == 2:
        kernel = ski.KronKernel(tuple(ski.rbf_kernel_1d(grid, 0.15 + 0.05 * i)
                                      for i in range(dims)))
    else:
        kernel = ski.BatchedKronKernel(tuple(
            torch.stack([ski.rbf_kernel_1d(grid, 0.15 + 0.05 * i + 0.02 * j)
                         for j in range(shape[0])]) for i in range(dims)))
    return kernel.matmul, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_solve_equals_the_eager_solve(card, shape):
    matvec, b = _problem(shape, card)
    before = _launch.launches["cg_update"]
    x, res = ski.conjugate_gradient(matvec, b, iters=10, shift=SHIFT)
    assert _launch.launches["cg_update"] - before == 1 + 3 * 10 - 1 + 1
    xe, rese = _eager(matvec, b)
    assert res.shape == rese.shape == shape[:-1]
    assert float((x - xe).abs().max()) <= 1e-4 * float(xe.abs().max())
    assert ((res - rese).abs() <= 1e-3 * rese).all()


@pytest.mark.cuda
def test_fused_solve_is_deterministic_and_never_syncs(card):
    matvec, b = _problem((16, 16 ** 4), card)
    x0, res0 = ski.conjugate_gradient(matvec, b, shift=SHIFT)  # builds and plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x1, res1 = ski.conjugate_gradient(matvec, b, shift=SHIFT)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(x0, x1) and torch.equal(res0, res1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_f64_passes_and_solve_as_the_eager_recurrence(card, shape):
    """The float64 instantiation: start, step and direction bit for bit
    against the eager formulas given exact row sums, 16-byte accesses of two
    doubles where the rows allow, and a whole solve at 1e-10 of the eager
    one."""
    f64 = torch.float64
    b = _randn(shape, 1, card, f64)
    cg = CU.FusedCG(b, torch.zeros_like(b), SHIFT)
    assert cg.vec == (2 if shape[-1] % 2 == 0 else 1) and cg.res.dtype == f64
    y = _randn(shape, 2, card, f64)
    cg.start(y)
    torch.cuda.synchronize()
    r = b - y
    assert torch.equal(cg.r, r) and torch.equal(cg.p, r)
    want = (r ** 2).sum(-1).reshape(-1)
    assert torch.allclose(_sums(cg.part, 1), want, rtol=1e-12, atol=0)
    y = _randn(shape, 3, card, f64)
    denom = torch.rand(cg.rows, device=card, dtype=f64) + 0.5
    rs = torch.rand(cg.rows, device=card, dtype=f64) + 0.5
    _exact_partials(cg, 0, denom)
    _exact_partials(cg, 1, rs)
    x0, r0, p0 = cg.x.clone(), cg.r.clone(), cg.p.clone()
    cg.step(y)
    alpha = (rs / denom).reshape(*shape[:-1], 1)
    assert torch.equal(cg.x, x0 + alpha * p0)
    r1 = r0 - alpha * (y + SHIFT * p0)
    assert torch.equal(cg.r, r1)
    rs_new = torch.rand(cg.rows, device=card, dtype=f64)
    _exact_partials(cg, 2, rs_new)
    cg.direction()
    res = cg.norm()
    torch.cuda.synchronize()
    beta = (rs_new / rs).reshape(*shape[:-1], 1)
    assert torch.equal(cg.p, r1 + beta * p0)
    assert torch.equal(res, rs_new.sqrt().reshape(shape[:-1]))

    matvec, b = _problem(shape, card, f64)
    x, res = ski.conjugate_gradient(matvec, b, iters=10, shift=SHIFT)
    xe, rese = _eager(matvec, b)
    assert x.dtype == res.dtype == f64
    assert float((x - xe).abs().max()) <= 1e-10 * float(xe.abs().max())
    assert ((res - rese).abs() <= 1e-10 * rese).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_solve_reads_strided_inputs(card, shape):
    """A strided right-hand side and an MVM that returns a strided view of
    its result solve to the same bits as their contiguous forms."""
    matvec, b = _problem(shape, card)

    def strided(t):  # every other element of a buffer twice as long
        out = t.new_empty(*t.shape[:-1], 2 * t.shape[-1])[..., ::2]
        return out.copy_(t)

    x, res = ski.conjugate_gradient(matvec, b, iters=10, shift=SHIFT)
    bs = strided(b)
    assert not bs.is_contiguous()
    xs, ress = ski.conjugate_gradient(lambda v: strided(matvec(v)), bs, iters=10, shift=SHIFT)
    assert torch.equal(x, xs) and torch.equal(res, ress)
