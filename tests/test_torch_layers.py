"""KronLinear in the port (repro_torch.core.layers) against
repro.core.layers: parameters made by the reference's init cross through
``convert.kron_linear_params_from_numpy``; values and gradients compared in
f64 (1e-12) and f32 (1e-5).  The port's own init draws from a
torch.Generator, so it is checked by its variance, not by its values."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_jax, to_torch
from repro.core import layers as JL
from repro_torch import convert
from repro_torch.core import layers as TL
from repro_torch.core import KronLinear, KronLinearSpec

jax.config.update("jax_enable_x64", True)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("d", [1, 2, 7, 12, 64, 96, 360, 2560, 9728, 1024, 4096, 11008])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_balanced_factorization_equals_reference(d, n):
    got = TL.balanced_factorization(d, n)
    assert got == JL.balanced_factorization(d, n) and math.prod(got) == d


def test_balanced_factorization_rejects_bad_input():
    for d, n in [(8, 0), (0, 2), (-4, 2)]:
        with pytest.raises(ValueError):
            TL.balanced_factorization(d, n)


def test_spec_properties_equal_reference():
    for args in [(2560, 9728, 2, False), (9728, 2560, 2, True), (96, 64, 3, True)]:
        got, want = KronLinearSpec.balanced(*args), JL.KronLinearSpec.balanced(*args)
        assert (got.ps, got.qs, got.use_bias) == (want.ps, want.qs, want.use_bias)
        assert (got.d_in, got.d_out, got.n_params) == (want.d_in, want.d_out, want.n_params)
    spec = KronLinearSpec((4, 4), (3, 5))
    op = spec.op()
    assert (op.ps, op.qs) == (spec.ps, spec.qs) and spec.op() is op


def _jax_params(seed, spec, dtype, bias):
    jspec = JL.KronLinearSpec(spec.ps, spec.qs, bias)
    p = JL.kron_linear_init(jax.random.PRNGKey(seed), jspec, dtype)
    if bias:  # the reference inits the bias to zero; a nonzero one is checked
        p["bias"] = jnp.asarray(np.random.default_rng(seed).standard_normal(spec.d_out), dtype)
    return p


def _np(p):
    return jax.tree_util.tree_map(np.asarray, p)


# (x shape without d_in, ps, qs, bias)
APPLY_CASES = [
    ((6,), (4, 4), (3, 5), False),
    ((6,), (4, 3, 2), (2, 3, 4), True),
    ((2, 5), (4, 4), (3, 5), True),
    ((2, 3, 4), (6, 4), (4, 6), False),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lead,ps,qs,bias", APPLY_CASES)
def test_kron_linear_apply_and_grads_equal_reference(lead, ps, qs, bias, dtype):
    spec = KronLinearSpec(ps, qs, bias)
    jp = _jax_params(1, spec, dtype, bias)
    tp = convert.kron_linear_params_from_numpy(_np(jp), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((*lead, spec.d_in)).astype(dtype)
    ct = rng.standard_normal((*lead, spec.d_out)).astype(dtype)

    def jloss(p, xx):
        return jnp.sum(JL.kron_linear_apply(p, xx, backend="xla") * ct)

    want_y = JL.kron_linear_apply(jp, to_jax(x), backend="xla")
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, to_jax(x))
    xt = to_torch(x).requires_grad_()
    leaves = [f.requires_grad_() for f in tp["factors"]]
    if bias:
        tp["bias"].requires_grad_()
        leaves.append(tp["bias"])
    y = TL.kron_linear_apply(tp, xt)
    assert_close(y.detach(), want_y, TOL[dtype])
    got = torch.autograd.grad(y, [xt, *leaves], to_torch(ct))
    assert_close(got[0], jgx, TOL[dtype])
    for g, w in zip(got[1:1 + len(ps)], jgp["factors"]):
        assert_close(g, w, TOL[dtype])
    if bias:
        assert_close(got[-1], jgp["bias"], TOL[dtype])


@pytest.mark.parametrize("bias_rank", [0, 1, 2])
def test_kron_linear_apply_batched_equals_reference(bias_rank):
    b, m, ps, qs = 3, 4, (4, 2), (2, 5)
    rng = np.random.default_rng(7)
    p = {"factors": tuple(rng.standard_normal((b, pp, q)) for pp, q in zip(ps, qs))}
    if bias_rank == 1:
        p["bias"] = rng.standard_normal(10)
    elif bias_rank == 2:
        p["bias"] = rng.standard_normal((b, 10))
    x = rng.standard_normal((b, m, 8))
    ct = rng.standard_normal((b, m, 10))
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def jloss(pp, xx):
        return jnp.sum(JL.kron_linear_apply_batched(pp, xx, backend="xla") * ct)

    want = JL.kron_linear_apply_batched(jp, to_jax(x), backend="xla")
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, to_jax(x))
    tp = convert.kron_linear_params_from_numpy(p, device="cpu")
    xt = to_torch(x).requires_grad_()
    for f in tp["factors"]:
        f.requires_grad_()
    y = TL.kron_linear_apply_batched(tp, xt)
    assert_close(y.detach(), want, 1e-12)
    got = torch.autograd.grad(y, [xt, *tp["factors"]], to_torch(ct))
    assert_close(got[0], jgx, 1e-12)
    for g, w in zip(got[1:], jgp["factors"]):
        assert_close(g, w, 1e-12)


def test_materialize_equals_reference_and_the_op():
    spec = KronLinearSpec((4, 3, 2), (2, 3, 4))
    jp = _jax_params(3, spec, np.float64, False)
    tp = convert.kron_linear_params_from_numpy(_np(jp), device="cpu")
    w = TL.kron_linear_materialize(tp)
    assert_close(w, JL.kron_linear_materialize(jp), 1e-12)
    x = torch.randn(5, spec.d_in, dtype=torch.float64)
    assert_close(TL.kron_linear_apply(tp, x), (x @ w).numpy(), 1e-12)


def test_module_registers_parameters_and_matches_the_function():
    gen = torch.Generator().manual_seed(0)
    spec = KronLinearSpec((4, 4), (3, 5), use_bias=True)
    mod = KronLinear(gen, spec, torch.float64, device="cpu", m=6)
    names = dict(mod.named_parameters())
    assert set(names) == {"factors.0", "factors.1", "bias"}
    assert sum(p.numel() for p in mod.parameters()) == spec.n_params
    assert mod.op.ps == spec.ps and mod.op.plan is not None
    jp = _jax_params(4, spec, np.float64, True)
    convert.load_kron_linear_(mod, _np(jp))
    x = np.random.default_rng(5).standard_normal((2, 3, 16))
    y = mod(to_torch(x))
    assert_close(y.detach(), JL.kron_linear_apply(jp, to_jax(x), backend="xla"), 1e-12)
    y.sum().backward()
    assert all(p.grad is not None for p in mod.parameters())
    other = convert.kron_linear_params_from_numpy(_np(_jax_params(6, spec, np.float64, True)),
                                                  device="cpu")
    assert_close(mod(to_torch(x), other).detach(),
                 TL.kron_linear_apply(other, to_torch(x)).numpy(), 1e-12)
    with pytest.raises(ValueError):
        convert.load_kron_linear_(mod, {"factors": _np(jp)["factors"][:1], "bias": jp["bias"]})
    plain = KronLinear(gen, KronLinearSpec((4, 4), (3, 5)), device="cpu")
    assert plain.bias is None and "bias" not in plain.params


@pytest.mark.parametrize("ps,qs", [((64, 40), (128, 76)), ((16, 16, 16), (16, 16, 16))])
def test_init_variance_matches_dense_fan_in(ps, qs):
    """std_i = d_in^(-1/(2N)): the factors' pooled variance, in units of
    std_i^2, is 1 within three standard errors (sqrt(2/n) for n draws), and
    so is the composed operator's mean square (a Kronecker product's mean
    square is the product of its factors') times d_in."""
    spec = KronLinearSpec(ps, qs)
    gen = torch.Generator().manual_seed(1)
    p = TL.kron_linear_init(gen, spec, torch.float64, "cpu")
    std = spec.d_in ** (-1.0 / (2 * len(ps)))
    pooled = torch.cat([f.flatten() / std for f in p["factors"]])
    tol = 3 * math.sqrt(2 / pooled.numel())
    assert abs(float(pooled.square().mean()) - 1) < tol
    w_ms = math.prod(float(f.square().mean()) for f in p["factors"])
    assert abs(w_ms * spec.d_in - 1) < len(ps) * tol
    assert p.keys() == {"factors"}
    pb = TL.kron_linear_init(gen, KronLinearSpec(ps, qs, True), torch.bfloat16, "cpu")
    assert pb["bias"].dtype == torch.bfloat16 and not pb["bias"].any()
