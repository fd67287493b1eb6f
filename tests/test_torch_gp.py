"""The SKI GP substrate in the port (repro_torch.gp.ski) against
repro.gp.ski: the kernel and interpolation matrices, CG, and one training
epoch on every MVM backend, on the same numpy inputs (f64, 1e-12 before a
solve and 1e-4 after one, relative to the largest value)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_jax, to_torch
from repro.gp import ski as JS
from repro_torch.core import engine
from repro_torch.gp import ski as TS

jax.config.update("jax_enable_x64", True)

SOLVE_TOL = 1e-4


def _kernels(seed, sizes, batch=None):
    """Per-dimension RBF kernels on jittered grids, as numpy (B, P, P) or (P, P)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    out = []
    for p in sizes:
        grids = np.sort(rng.uniform(0, 1, (*lead, p)), axis=-1)
        ls = rng.uniform(0.15, 0.4, lead)
        ks = [np.asarray(JS.rbf_kernel_1d(jnp.asarray(g), float(l)))
              for g, l in zip(grids.reshape(-1, p), np.reshape(ls, -1))]
        out.append(np.stack(ks).reshape(*lead, p, p))
    return out


@pytest.mark.parametrize("p,lengthscale", [(4, 0.2), (16, 0.1), (7, 0.5)])
def test_rbf_kernel_equals_reference(p, lengthscale):
    grid = np.linspace(0, 1, p)
    got = TS.rbf_kernel_1d(to_torch(grid), lengthscale)
    assert_close(got, JS.rbf_kernel_1d(to_jax(grid), lengthscale), 1e-12)


@pytest.mark.parametrize("n,sizes", [(9, (4, 3)), (5, (4, 4, 4)), (12, (6,))])
def test_interp_matrix_equals_reference(n, sizes):
    x = np.random.default_rng(n).uniform(0, 1, (n, len(sizes)))
    x[0] = 1.0  # the clamp at the grid's last point
    got = TS.interp_matrix(to_torch(x), sizes)
    want = JS.interp_matrix(to_jax(x), sizes)
    assert_close(got, want, 1e-12)
    assert_close(got.sum(-1), np.ones(n), 1e-12)


def test_cg_solves_an_spd_system():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((12, 12))
    a = a @ a.T + 12 * np.eye(12)
    b = rng.standard_normal((5, 12))
    at = to_torch(a)
    x, res = TS.conjugate_gradient(lambda r: r @ at, to_torch(b), iters=12)
    assert_close(x, np.linalg.solve(a, b.T).T, 1e-9)
    assert float(res.max()) < 1e-8
    jx, jres = JS.conjugate_gradient(lambda r: r @ to_jax(a), to_jax(b), iters=12)
    assert_close(x, jx, 1e-9)
    assert_close(res, jres, 1e-6)
    # The 1e-20 clamps: a zero right-hand side stays zero, with no NaN.
    x0, r0 = TS.conjugate_gradient(lambda r: r @ at, torch.zeros(2, 12, dtype=torch.float64))
    assert not x0.any() and not r0.any()


@pytest.mark.parametrize("backend", ["fastkron", "shuffle", "naive"])
def test_gp_train_epoch_equals_reference(backend):
    sizes, m = (4, 4, 4), 16
    factors = _kernels(1, sizes)
    v = np.random.default_rng(2).standard_normal((m, 64))
    jk = JS.KronKernel(tuple(to_jax(f) for f in factors))
    jx, jres = JS.gp_train_epoch(jk, to_jax(v), backend=backend)
    tk = TS.KronKernel(tuple(to_torch(f) for f in factors))
    x, res = TS.gp_train_epoch(tk, to_torch(v), backend=backend)
    assert_close(x, jx, SOLVE_TOL)
    assert_close(res, jres, SOLVE_TOL)
    assert tk.dim == jk.dim == 64
    if backend == "fastkron":
        assert tk.op is tk.op and tk.op.ps == sizes


def test_kernel_matmul_rejects_unknown_backend():
    tk = TS.KronKernel(tuple(to_torch(f) for f in _kernels(1, (4, 4))))
    with pytest.raises(ValueError):
        tk.matmul(torch.zeros(2, 16, dtype=torch.float64), backend="xla")


def test_batched_epoch_equals_per_kernel_solves():
    """The batched epoch (one per-sample KronOp per MVM) equals B separate
    epochs, in the port and against the reference's batched epoch."""
    b, sizes, m = 3, (4, 3, 2), 8
    factors = _kernels(4, sizes, batch=b)
    v = np.random.default_rng(5).standard_normal((b, m, 24))
    bk = TS.BatchedKronKernel(tuple(to_torch(f) for f in factors))
    x, res = TS.gp_train_epoch_batched(bk, to_torch(v))
    jx, jres = JS.gp_train_epoch_batched(
        JS.BatchedKronKernel(tuple(to_jax(f) for f in factors)), to_jax(v))
    assert_close(x, jx, SOLVE_TOL)
    assert_close(res, jres, SOLVE_TOL)
    for i in range(b):
        k = TS.KronKernel(tuple(to_torch(f[i]) for f in factors))
        xi, ri = TS.gp_train_epoch(k, to_torch(v[i]))
        assert_close(x[i], xi.numpy(), SOLVE_TOL)
        assert_close(res[i], ri.numpy(), SOLVE_TOL)
    assert (bk.batch, bk.dim) == (b, 24)
    assert bk.op.batch == b and not bk.op.shared_factors


def test_stack_equals_reference():
    kernels = [_kernels(s, (4, 3)) for s in range(3)]
    got = TS.BatchedKronKernel.stack(
        [TS.KronKernel(tuple(to_torch(f) for f in k)) for k in kernels])
    want = JS.BatchedKronKernel.stack(
        [JS.KronKernel(tuple(to_jax(f) for f in k)) for k in kernels])
    assert len(got.factors) == len(want.factors) == 2
    for g, w in zip(got.factors, want.factors):
        assert_close(g, w, 0)


def test_mesh_raises_naming_the_mesh_slice(tmp_path):
    """The mesh forms no longer raise: the mesh slice is ported.  On a
    one-rank gloo world's (1, 1) mesh, ``matmul(mesh=)`` and the epochs with
    ``mesh=`` equal the local calls (tests/test_torch_distributed.py holds
    them against the reference on eight ranks)."""
    import torch.distributed as dist

    from repro_torch.core import distributed as TD
    from repro_torch.launch.mesh import make_debug_mesh

    bk = TS.BatchedKronKernel(tuple(to_torch(f) for f in _kernels(6, (4, 4), batch=2)))
    tk = TS.KronKernel(tuple(f[0] for f in bk.factors))
    v = to_torch(np.random.default_rng(6).standard_normal((2, 3, 16)))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        assert_close(TD.gather(bk.matmul(TD.sharded_input_batched(v, mesh), mesh=mesh)),
                     bk.matmul(v).numpy(), 1e-12)
        for got, want in zip(TS.gp_train_epoch_batched(bk, v, cg_iters=3, mesh=mesh),
                             TS.gp_train_epoch_batched(bk, v, cg_iters=3)):
            assert_close(got, want.numpy(), 1e-12)
        for got, want in zip(TS.gp_train_epoch(tk, v[0], cg_iters=3, mesh=mesh),
                             TS.gp_train_epoch(tk, v[0], cg_iters=3)):
            assert_close(got, want.numpy(), 1e-12)
    finally:
        dist.destroy_process_group()


def test_epoch_mvms_go_through_the_op(monkeypatch):
    """Every CG iteration's MVM, and the one on the zero start, is a call of
    the kernel's KronOp: cg_iters + 1 calls."""
    tk = TS.KronKernel(tuple(to_torch(f) for f in _kernels(8, (4, 4))))
    calls = []
    real = engine.KronOp.__call__

    def counted(self, x, fs):
        calls.append(tuple(x.shape))
        return real(self, x, fs)

    monkeypatch.setattr(engine.KronOp, "__call__", counted)
    TS.gp_train_epoch(tk, torch.ones(16, 16, dtype=torch.float64), cg_iters=7)
    assert calls == [(16, 16)] * 8
