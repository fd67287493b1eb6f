"""The port's compatibility shims against the JAX package's: the six
``kernels.ops.fused_kron*`` wrappers, ``kernels.kron_fused`` /
``kron_fused_t``, the ``core.fastkron`` entry points ``kron_matmul*``, and
one DeprecationWarning per process per shim."""
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import fastkron as JF
from repro.kernels import kron_fused as JKF
from repro.kernels import kron_fused_t as JKFT
from repro.kernels import ops as JO
from repro_torch.core import engine, fastkron
from repro_torch.kernels import kron_fused, kron_fused_t, ops
from repro_torch.runtime import guard

jax.config.update("jax_enable_x64", True)


def _quiet(fn, *a, **k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **k)


def _once_per_process(warned: set, name: str, call):
    """``call()`` twice after forgetting ``name``: exactly one warning."""
    warned.discard(name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = call()
        call()
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and name in str(dep[0].message), [str(w.message) for w in caught]
    return out


# factors in application order (last problem factor first), with tiles
CHAIN = dict(m=4, ps=(4, 2, 3), qs=(3, 2, 4), t_m=2, t_k=24)


def _chain_inputs(seed, batch=None):
    c = CHAIN
    x, fs = make_inputs(seed, c["m"], c["ps"], c["qs"], batch=batch)
    rng = np.random.default_rng(seed + 1)
    lead = () if batch is None else (batch,)
    dy = rng.standard_normal((*lead, c["m"], math.prod(c["qs"]) * (x.shape[-1] // math.prod(c["ps"]))))
    return x, fs, dy


def test_fused_kron_shims_match_jax():
    x, fs, dy = _chain_inputs(60)
    tiles = dict(t_m=CHAIN["t_m"], t_k=CHAIN["t_k"])
    xt, ft, dyt = to_torch(x), [to_torch(f) for f in fs], to_torch(dy)
    xj, fj, dyj = to_jax(x), [to_jax(f) for f in fs], to_jax(dy)
    got = _once_per_process(guard._DEPRECATED, "fused_kron",
                            lambda: ops.fused_kron(xt, ft, **tiles))
    assert_close(got, _quiet(JO.fused_kron, xj, fj, backend="xla", **tiles), 1e-12)
    got = _once_per_process(guard._DEPRECATED, "fused_kron_t",
                            lambda: ops.fused_kron_t(dyt, ft, **tiles))
    assert_close(got, _quiet(JO.fused_kron_t, dyj, fj, backend="xla", **tiles), 1e-12)
    dx, dfs = _once_per_process(guard._DEPRECATED, "fused_kron_bwd",
                                lambda: ops.fused_kron_bwd(xt, dyt, ft, **tiles))
    jdx, jdfs = _quiet(JO.fused_kron_bwd, xj, dyj, fj, backend="xla", **tiles)
    assert_close(dx, jdx, 1e-12)
    for a, w in zip(dfs, jdfs):
        assert_close(a, w, 1e-12)


def test_fused_kron_batched_shims_match_jax():
    b = 3
    x, fs, dy = _chain_inputs(61, batch=b)
    tiles = dict(t_b=1, t_m=CHAIN["t_m"], t_k=CHAIN["t_k"])
    xt, ft, dyt = to_torch(x), [to_torch(f) for f in fs], to_torch(dy)
    xj, fj, dyj = to_jax(x), [to_jax(f) for f in fs], to_jax(dy)
    got = _once_per_process(guard._DEPRECATED, "fused_kron_batched",
                            lambda: ops.fused_kron_batched(xt, ft, **tiles))
    assert_close(got, _quiet(JO.fused_kron_batched, xj, fj, backend="xla", **tiles), 1e-12)
    got = _once_per_process(guard._DEPRECATED, "fused_kron_t_batched",
                            lambda: ops.fused_kron_t_batched(dyt, ft, **tiles))
    assert_close(got, _quiet(JO.fused_kron_t_batched, dyj, fj, backend="xla", **tiles), 1e-12)
    dx, dfs = _once_per_process(guard._DEPRECATED, "fused_kron_bwd_batched",
                                lambda: ops.fused_kron_bwd_batched(xt, dyt, ft, **tiles))
    jdx, jdfs = _quiet(JO.fused_kron_bwd_batched, xj, dyj, fj, backend="xla", **tiles)
    assert_close(dx, jdx, 1e-12)
    for a, w in zip(dfs, jdfs):
        assert a.shape == (b, *w.shape[1:])
        assert_close(a, w, 1e-12)


def test_kron_fused_modules_match_jax_pallas_interpret():
    x, fs, dy = _chain_inputs(62)
    kw = dict(t_m=CHAIN["t_m"], t_k=CHAIN["t_k"])
    xt, ft, dyt = to_torch(x), [to_torch(f) for f in fs], to_torch(dy)
    xj, fj, dyj = to_jax(x), [to_jax(f) for f in fs], to_jax(dy)
    assert_close(kron_fused.fused_kron_pallas(xt, *ft, **kw),
                 JKF.fused_kron_pallas(xj, *fj, interpret=True, **kw), 1e-12)
    assert_close(kron_fused_t.fused_kron_t_pallas(dyt, *ft, **kw),
                 JKFT.fused_kron_t_pallas(dyj, *fj, interpret=True, **kw), 1e-12)
    dx, dfs = kron_fused_t.fused_kron_bwd_pallas(xt, dyt, *ft, **kw)
    jdx, jdfs = JKFT.fused_kron_bwd_pallas(xj, dyj, *fj, interpret=True, **kw)
    assert_close(dx, jdx, 1e-12)
    for a, w in zip(dfs, jdfs):
        assert_close(a, w, 1e-12)
    b = 2
    x, fs, dy = _chain_inputs(63, batch=b)
    xt, ft, dyt = to_torch(x), [to_torch(f) for f in fs], to_torch(dy)
    xj, fj, dyj = to_jax(x), [to_jax(f) for f in fs], to_jax(dy)
    kw["t_b"] = 1
    assert_close(kron_fused.fused_kron_batched_pallas(xt, *ft, **kw),
                 JKF.fused_kron_batched_pallas(xj, *fj, interpret=True, **kw), 1e-12)
    assert_close(kron_fused_t.fused_kron_t_batched_pallas(dyt, *ft, **kw),
                 JKFT.fused_kron_t_batched_pallas(dyj, *fj, interpret=True, **kw), 1e-12)
    dx, dfs = kron_fused_t.fused_kron_bwd_batched_pallas(xt, dyt, *ft, **kw)
    jdx, jdfs = JKFT.fused_kron_bwd_batched_pallas(xj, dyj, *fj, interpret=True, **kw)
    assert_close(dx, jdx, 1e-12)
    for a, w in zip(dfs, jdfs):
        assert_close(a, w, 1e-12)
    # f32 with an explicit accumulator dtype, as the reference takes it
    x32 = to_torch(x[0], torch.float32)
    f32 = [to_torch(f[0], torch.float32) for f in fs]
    assert_close(kron_fused.fused_kron_pallas(x32, *f32, acc_dtype=torch.float64, **{
        k: v for k, v in kw.items() if k != "t_b"}),
        JKF.fused_kron_pallas(to_jax(x[0], np.float32), *(to_jax(f[0], np.float32) for f in fs),
                              interpret=True, acc_dtype=np.float64, t_m=2, t_k=24), 1e-5)


@pytest.mark.parametrize("plan", ["auto", None])
def test_kron_matmul_shims_match_jax(plan):
    m, ps, qs = 6, (4, 2, 3), (3, 2, 4)
    x, fs = make_inputs(64, m, ps, qs)
    xt, ft = to_torch(x), [to_torch(f) for f in fs]
    want = _quiet(JF.kron_matmul, to_jax(x), [to_jax(f) for f in fs], plan=plan)
    got = _once_per_process(guard._DEPRECATED, "kron_matmul",
                            lambda: fastkron.kron_matmul(xt, ft, plan=plan))
    assert_close(got, want, 1e-12)
    guard._DEPRECATED.add("kron_matmul")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        unfused = fastkron.kron_matmul_unfused(xt, ft)  # warned once already
    assert_close(unfused, _quiet(JF.kron_matmul_unfused, to_jax(x), [to_jax(f) for f in fs]),
                 1e-12)
    assert engine.kron_op_for(ps, qs) is engine.kron_op_for(ps, qs)


@pytest.mark.parametrize("shared", [True, False])
def test_kron_matmul_batched_shim_matches_jax(shared):
    b, m, ps, qs = 3, 4, (4, 4), (2, 4)
    x, fs = make_inputs(65, m, ps, qs, batch=b)
    if shared:
        fs = [f[0] for f in fs]
    xt = to_torch(x).requires_grad_()
    ft = [to_torch(f).requires_grad_() for f in fs]
    jfn = lambda x, fs: _quiet(JF.kron_matmul_batched, x, fs, shared_factors=shared)  # noqa: E731
    y = _once_per_process(
        guard._DEPRECATED, "kron_matmul_batched",
        lambda: fastkron.kron_matmul_batched(xt, ft, shared_factors=shared))
    assert_close(y.detach(), jfn(to_jax(x), [to_jax(f) for f in fs]), 1e-12)
    ct = np.random.default_rng(65).standard_normal(tuple(y.shape))
    _, vjp = jax.vjp(jfn, to_jax(x), [to_jax(f) for f in fs])
    jgx, jgfs = vjp(to_jax(ct))
    got = torch.autograd.grad(y, [xt, *ft], to_torch(ct))
    assert_close(got[0], jgx, 1e-12)
    for a, w in zip(got[1:], jgfs):
        assert_close(a, w, 1e-12)
    with pytest.raises(ValueError):
        _quiet(fastkron.kron_matmul_batched, to_torch(x[0, 0]), ft, shared_factors=shared)


def test_kron_matmul_left_out_modes_raise():
    x, fs = make_inputs(66, 2, (4,), (4,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _quiet(fastkron.kron_matmul, to_torch(x), [to_torch(fs[0])], tune="measure")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _quiet(fastkron.kron_matmul, to_torch(x), [to_torch(fs[0])], cache_path="p.json")
