"""The plain reference against explicit products, and its control's precision."""
import math

import pytest
import torch

from perfbench import reference


def _factors(gen, ps, qs, dtype=torch.float64):
    return [torch.randn(p, q, generator=gen, dtype=dtype) for p, q in zip(ps, qs)]


def _dense(factors):
    k = factors[0]
    for f in factors[1:]:
        k = torch.kron(k, f)
    return k


@pytest.mark.parametrize("m,ps,qs", [(3, (2, 3, 4), (3, 2, 2)), (5, (4, 4), (4, 4)), (1, (3,), (5,))])
def test_kron_apply_is_the_dense_product(m, ps, qs):
    gen = torch.Generator().manual_seed(1)
    fs = _factors(gen, ps, qs)
    x = torch.randn(m, math.prod(ps), generator=gen, dtype=torch.float64)
    torch.testing.assert_close(reference.kron_apply(x, fs), x @ _dense(fs), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,ps,qs", [(3, (2, 3, 4), (3, 2, 2)), (4, (3, 3), (2, 5))])
def test_kron_grads_are_the_dense_gradients(m, ps, qs):
    gen = torch.Generator().manual_seed(2)
    fs = _factors(gen, ps, qs)
    x = torch.randn(m, math.prod(ps), generator=gen, dtype=torch.float64)
    g = torch.randn(m, math.prod(qs), generator=gen, dtype=torch.float64)
    y, dx, dfs = reference.kron_grads(x, g, fs, want_x=True)
    xd = x.clone().requires_grad_()
    fd = [f.clone().requires_grad_() for f in fs]
    yd = xd @ _dense(fd)
    want = torch.autograd.grad(yd, [xd, *fd], g)
    torch.testing.assert_close(y, yd.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dx, want[0], rtol=1e-12, atol=1e-12)
    for got, ref in zip(dfs, want[1:]):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    _, none, dfs2 = reference.kron_grads(x, g, fs, want_x=False)
    assert none is None
    for a, b in zip(dfs, dfs2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tf32_rounds_to_ten_mantissa_bits():
    t = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 2**-12, -3.0 - 2**-9, 1e-30])
    r = reference.tf32(t)
    assert r.tolist()[:5] == [1.0, 1 + 2**-10, 1 + 2**-10, 1.0, -3.0 - 2**-9]
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3))
    rel = ((reference.tf32(x) - x).abs() / x.abs()).max()
    assert 2**-13 < rel <= 2**-11


def test_control_reads_tf32_error_and_float32_does_not():
    gen = torch.Generator().manual_seed(4)
    ps = qs = (8, 8, 8)
    fs = [f / math.sqrt(8) for f in _factors(gen, ps, qs)]
    x = torch.randn(16, 512, generator=gen, dtype=torch.float64)
    ref = reference.kron_apply(x, fs)
    f32 = reference.kron_apply(x.float(), [f.float() for f in fs])
    ctl = reference.kron_apply(x.float(), [f.float() for f in fs], tf32=True)
    assert reference.rel_err(f32, ref) < 1e-6
    assert reference.rel_err(ctl, ref) > 1e-4


def test_cg_solves_a_small_ski_kernel():
    fs = [reference.rbf_factor(4, ls, dtype=torch.float64) for ls in (0.3, 0.5)]
    k = _dense(fs)
    v = torch.randn(3, 16, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    x, res = reference.gp_solve(v, fs, noise=0.1, iters=40)
    want = torch.linalg.solve(k + 0.1 * torch.eye(16, dtype=torch.float64), v.T).T
    torch.testing.assert_close(x, want, rtol=1e-8, atol=1e-8)
    assert float(res.max()) < 1e-8
    # A few iterations leave a residual: the recurrence's norm is the true one.
    x3, res3 = reference.gp_solve(v, fs, noise=0.1, iters=3)
    true = (v - x3 @ (k + 0.1 * torch.eye(16, dtype=torch.float64))).norm(dim=-1)
    torch.testing.assert_close(reference.true_residual(x3, v, fs, noise=0.1), true)
    torch.testing.assert_close(res3, true, rtol=1e-9, atol=0)


def test_rel_err_is_infinite_on_non_finite_output():
    ref = torch.ones(4)
    assert reference.rel_err(torch.tensor([1.0, float("nan"), 1, 1]), ref) == math.inf
    assert reference.rel_err(torch.tensor([1.0, 1, 1, 1.5]), ref) == pytest.approx(0.5)
    acc = reference.MaxRel()
    acc.add(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 4.0]))
    acc.add(torch.tensor([9.0]), torch.tensor([8.0]))
    assert acc.value == pytest.approx(2 / 8)
    with pytest.raises(ValueError):
        reference.rel_err(torch.ones(3), ref)


def test_row_rel_keeps_the_worst_row():
    ref = torch.tensor([[1.0, 4.0], [100.0, 1.0]])
    # Row 0 is off by 1 of 4; row 1 by 2 of 100: the worst row's, not the
    # whole tensor's 2 / 100.
    assert reference.row_rel(torch.tensor([[1.0, 3.0], [98.0, 1.0]]), ref) == pytest.approx(0.25)
    assert reference.row_rel(torch.zeros(2, 2), ref) == pytest.approx(1.0)
    assert reference.row_rel(torch.tensor([[1.0, 4.0], [float("inf"), 1.0]]), ref) == math.inf
    with pytest.raises(ValueError):
        reference.row_rel(torch.ones(2, 3), ref)
