"""The SKI GP substrate in the port (repro_torch.gp.ski) against
repro.gp.ski: the kernel and interpolation matrices, CG, and one training
epoch on every MVM backend, on the same numpy inputs (f64, 1e-12 before a
solve and 1e-4 after one, relative to the largest value)."""
import contextlib
import types

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


@pytest.mark.parametrize("shape", [(5, 12), (2, 3, 12), (12,)])
def test_cg_shift_equals_the_shift_in_the_matvec(shape):
    """``shift=s`` solves (A + s I) x = b: the same recurrence as a matvec
    that adds ``s * r`` itself."""
    rng = np.random.default_rng(len(shape))
    a = rng.standard_normal((12, 12))
    at = to_torch(a @ a.T + np.eye(12))
    b = to_torch(rng.standard_normal(shape))

    def mv(r):
        return r @ at

    x, res = TS.conjugate_gradient(mv, b, iters=7, shift=0.3)
    xs, ress = TS.conjugate_gradient(lambda r: mv(r) + 0.3 * r, b, iters=7)
    assert_close(x, xs.numpy(), 1e-12)
    assert_close(res, ress.numpy(), 1e-12)
    assert res.shape == shape[:-1]


class _Rows:
    """A stand-in right-hand side with the properties the dispatch reads."""

    def __init__(self, is_cuda=True, dtype=torch.float32, contiguous=True):
        self.is_cuda, self.dtype, self._contiguous = is_cuda, dtype, contiguous

    def is_contiguous(self):
        return self._contiguous

    def contiguous(self):
        return self if self._contiguous else _Rows(self.is_cuda, self.dtype)


@pytest.mark.parametrize("case,path", [
    ({}, "fused"),
    ({"dtype": torch.float64}, "fused"),
    ({"contiguous": False}, "fused"),
    ({"is_cuda": False}, "eager"),
    ({"dot": True}, "eager"),
])
def test_cg_fuses_every_cuda_block_with_the_row_dot(monkeypatch, case, path):
    """On the card every block with the default row dot takes the fused
    updates (a strided one made contiguous first; what the kernels cannot
    take raises there); CPU tensors and a custom ``dot=`` (the sharded
    solve's all-reduce) take the eager ones."""
    monkeypatch.setattr(TS, "_cg_fused", lambda mv, b, iters, shift: ("fused", b))
    monkeypatch.setattr(TS, "_cg_eager", lambda mv, b, iters, shift, dot: ("eager", b))
    case = dict(case)
    kw = {"dot": lambda a, c: a} if case.pop("dot", False) else {}
    b = _Rows(**case)
    got, seen = TS.conjugate_gradient(lambda r: r, b, **kw)
    assert got == path
    assert seen.is_contiguous() if path == "fused" else seen is b


def _stub_launches(monkeypatch):
    """Run ``FusedCG`` on CPU tensors: no CUDA check, each launch recorded
    as its argument list instead of run."""
    from repro_torch.kernels import _launch, cg_update

    calls = []
    monkeypatch.setattr(_launch, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_launch, "kernel_fn", lambda name: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return cg_update, calls


@pytest.mark.parametrize("case", ["bfloat16", "requires_grad", "empty", "x_dtype"])
def test_fused_cg_raises_for_what_the_kernels_cannot_take(monkeypatch, case):
    cg_update, calls = _stub_launches(monkeypatch)
    b = torch.ones(4, 16, dtype=torch.bfloat16 if case == "bfloat16" else torch.float32)
    if case == "requires_grad":
        b.requires_grad_()
    if case == "empty":
        b = torch.ones(4, 0)
    x = torch.zeros_like(b, dtype=torch.float64 if case == "x_dtype" else None).detach()
    with pytest.raises(ValueError, match="FusedCG"):
        cg_update.FusedCG(b, x, 0.1)
    assert calls == []


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.float64, 2)])
def test_fused_cg_passes_dtype_and_vector_width(monkeypatch, dtype, vec):
    cg_update, calls = _stub_launches(monkeypatch)
    b = torch.ones(3, 16, dtype=dtype)
    cg = cg_update.FusedCG(b, torch.zeros_like(b), 0.1)
    cg.start(torch.ones_like(b))
    assert cg.vec == vec and cg.res.dtype == dtype
    assert calls[0][1] == cg_update.DTYPES[dtype] and calls[0][-2] == vec


@pytest.mark.parametrize("case", ["strided", "misaligned", "shape", "dtype"])
def test_fused_cg_copies_a_strided_mvm_output_and_refuses_a_wrong_one(monkeypatch, case):
    """The kernels read ``y`` as a dense aligned block: a strided or
    misaligned ``y`` is copied first; a ``y`` of another shape, dtype or
    device raises."""
    cg_update, calls = _stub_launches(monkeypatch)
    b = torch.ones(8, 16)
    cg = cg_update.FusedCG(b, torch.zeros_like(b), 0.1)
    if case in ("shape", "dtype"):
        y = torch.ones(8, 8) if case == "shape" else torch.ones(8, 16, dtype=torch.float64)
        with pytest.raises(ValueError, match="the MVM gave"):
            cg.dot(y)
        assert calls == []
        return
    if case == "strided":
        y = torch.ones(16, 8).T
    else:
        base = torch.ones(8 * 16 + 1)
        y = base[1:].view(8, 16)
        assert y.data_ptr() % 16
    cg.dot(y)
    passed = calls[0][3]
    assert passed != y.data_ptr() and passed % 16 == 0


@pytest.mark.parametrize("kind", ["cpu_f32", "f64", "dot"])
def test_cpu_f64_and_a_custom_dot_run_the_eager_updates(kind):
    """CPU tensors, float32 or float64, and a custom ``dot=`` (the mesh's
    all-reduce) take the eager updates: ``cg.eager_iters`` counts each
    iteration once and no CG kernel launches."""
    from repro_torch.kernels import _launch
    from repro_torch.runtime import telemetry

    dtype = torch.float64 if kind == "f64" else torch.float32
    b = torch.ones(3, 8, dtype=dtype)
    kw = {"dot": lambda a, c: torch.sum(a * c, dim=-1, keepdim=True)} if kind == "dot" else {}
    launches = _launch.launches["cg_update"]
    telemetry.configure()
    try:
        TS.conjugate_gradient(lambda r: 2 * r, b, iters=5, shift=0.1, **kw)
        counters = telemetry.snapshot()["counters"]
    finally:
        telemetry.reset()
    assert counters.get("cg.eager_iters") == 5 and "cg.fused_iters" not in counters
    assert _launch.launches["cg_update"] == launches
