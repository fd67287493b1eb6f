"""The port's StageProgram IR and executor (repro_torch.kernels.emit) against
repro.kernels.emit: IR fields, growth models, emitted programs on the CPU
(the chain kernel's plain twin) against both JAX backends, and the chain
kernel wrapper's tile checks against chain_pallas's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import autotune as JA
from repro.core.kron import KronProblem as JProblem
from repro.kernels import emit as JE
from repro.runtime import guard as JG
from repro_torch.core import autotune as TA
from repro_torch.core.kron import KronProblem as TProblem
from repro_torch.kernels import emit as TE
from repro_torch.kernels import _launch, kron_sliced, ops
from repro_torch.runtime import guard as TG

jax.config.update("jax_enable_x64", True)

CHAINS = [  # tests/test_emit.py
    (8, (4, 4), (4, 4)),
    (4, (4, 2, 3), (3, 2, 4)),
    (8, (8, 16, 32), (8, 16, 32)),     # the mixed-shape acceptance chain
    (6, (5, 3), (2, 7)),
]

INSTRS = [
    dict(kind="multiply", ps=(4, 4), qs=(4, 4), factor_ids=(0, 1), t_m=2, t_k=64),
    dict(kind="multiply", ps=(8,), qs=(16,), factor_ids=(0,), t_qs=(4,), t_m_bwd=4),
    dict(kind="transposed_multiply", ps=(3, 2), qs=(2, 7), t_b=2, acc_dtype="float64"),
    dict(kind="prekron", ps=(2, 3), qs=(3, 2), factor_ids=(1, 2), t_m=1, t_k=6),
    dict(kind="prekron", ps=(2,), qs=(2,), direction="bwd", t_m_bwd=8),
]


@pytest.mark.parametrize("kw", INSTRS)
def test_instr_fields_and_transpose_match_jax(kw):
    j, t = JE.StageInstr(**kw), TE.StageInstr(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.transpose()) == dataclasses.asdict(j.transpose())
    assert t.describe() == j.describe()
    assert (t.pprod, t.qprod, t.batched) == (j.pprod, j.qprod, j.batched)


def test_program_and_transpose_match_jax():
    mk = lambda E: E.StageProgram(  # noqa: E731
        (
            E.StageInstr("multiply", (4, 4), (4, 4), (0, 1), t_m=2, t_m_bwd=4),
            E.StageInstr("prekron", (2, 3), (3, 2), (2, 3), t_k=6),
        ),
        4,
    )
    j, t = mk(JE), mk(TE)
    assert t.describe() == j.describe()
    assert TE.transpose(t).describe() == JE.transpose(j).describe()
    assert TE.transpose(TE.transpose(t)).describe() == t.describe()
    for bad in ((0, 1), (0, 1, 2, 2)):
        with pytest.raises(ValueError):
            TE.StageProgram((TE.StageInstr("multiply", (2,) * len(bad), (2,) * len(bad), bad),), 4)
    with pytest.raises(ValueError):
        TE.StageInstr(kind="frobnicate", ps=(4,), qs=(4,))


@pytest.mark.parametrize(
    "ps,qs,t_qs",
    [((4, 4), (4, 4), None), ((8, 16, 32), (8, 16, 32), (8, 4, 16)),
     ((2, 3), (7, 5), (1, 5)), ((40, 64), (76, 128), None)],
)
def test_growth_models_match_jax(ps, qs, t_qs):
    assert TE.fused_growth(ps, qs, t_qs) == JE.fused_growth(ps, qs, t_qs)
    assert TE.transposed_growth(ps, qs, t_qs) == JE.transposed_growth(ps, qs, t_qs)
    for t_k in (1, 8, 64, 96, 4096):
        for p in (2, 3, 8):
            assert TE.max_n_fused(t_k, p) == JE.max_n_fused(t_k, p)


def _port_program(m, ps, qs, **kw):
    plan = TA.make_plan(TProblem(m, ps, qs), **kw)
    return TA.lower(plan, ps, qs)


def _jax_program(m, ps, qs, **kw):
    plan = JA.make_plan(JProblem(m, ps, qs), **kw)
    return JA.lower(plan, ps, qs)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-5)])
@pytest.mark.parametrize("m,ps,qs", CHAINS)
def test_run_program_matches_jax_emit(backend, dtype, tol, m, ps, qs):
    x, fs = make_inputs(10, m, ps, qs, dtype=dtype)
    want = JE.emit(_jax_program(m, ps, qs, enable_prekron=False), backend=backend)(
        to_jax(x), [to_jax(f) for f in fs]
    )
    got = TE.run_program(
        to_torch(x), [to_torch(f) for f in fs],
        _port_program(m, ps, qs, enable_prekron=False),
    )
    assert got.dtype == to_torch(x).dtype
    assert_close(got, want, tol)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prekron_program_matches_jax_emit(backend):
    m, ps, qs = 4, (2, 3, 2), (3, 2, 2)
    x, fs = make_inputs(11, m, ps, qs)
    prog = _port_program(m, ps, qs, enable_prekron=True, prekron_max_p=4)
    assert any(i.kind == TE.PREKRON for i in prog.instrs)
    want = JE.emit(
        _jax_program(m, ps, qs, enable_prekron=True, prekron_max_p=4), backend=backend
    )(to_jax(x), [to_jax(f) for f in fs])
    got = TE.emit(prog)(to_torch(x), [to_torch(f) for f in fs])
    assert_close(got, want, 1e-9)


@pytest.mark.parametrize("m,ps,qs", CHAINS[:3])
def test_bf16_run_program_matches_pallas_interpret(m, ps, qs):
    """bf16 keeps the intermediates in f32 inside a stage, as the Pallas
    kernel does (XLA rounds after every factor, so it is not the reference)."""
    x, fs = make_inputs(12, m, ps, qs, dtype=np.float32)
    want = JE.emit(_jax_program(m, ps, qs, enable_prekron=False), backend="pallas")(
        to_jax(x, jnp.bfloat16), [to_jax(f, jnp.bfloat16) for f in fs]
    )
    got = TE.run_program(
        to_torch(x, torch.bfloat16), [to_torch(f, torch.bfloat16) for f in fs],
        _port_program(m, ps, qs, enable_prekron=False),
    )
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-2)


def test_batched_per_sample_stage_matches_jax_pallas():
    b, m, ps, qs = 3, 4, (4, 8), (8, 4)
    x, fs = make_inputs(13, m, ps, qs, batch=b)
    rev = list(reversed(fs))
    kw = dict(ps=tuple(reversed(ps)), qs=tuple(reversed(qs)), factor_ids=(0, 1), t_m=2, t_b=1)
    want = JE.run_stage(to_jax(x), [to_jax(f) for f in rev], JE.StageInstr("multiply", **kw),
                        backend="pallas")
    got = TE.run_stage(to_torch(x), [to_torch(f) for f in rev], TE.StageInstr("multiply", **kw))
    assert_close(got, want, 1e-9)


# ---------------------------------------------------------------------------
# The chain kernel wrapper on the CPU: device rule and tile checks
# ---------------------------------------------------------------------------


def test_chain_cuda_on_cpu_tensors_raises():
    x = torch.zeros(1, 2, 16)
    f = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        TE.chain_cuda(x, f, f, t_m=2, t_k=16)
    with pytest.raises(ValueError, match="CUDA"):
        kron_sliced.sliced_multiply_cuda(torch.zeros(2, 16), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.sliced_multiply(torch.zeros(2, 16), torch.zeros(4, 4), backend="cuda")


class _OnCuda:
    """Stands in for a CUDA tensor: resolve_backend reads only these."""

    is_cuda = True
    device = "cuda:0"


def test_resolve_backend_device_rule():
    cpu = torch.zeros(1)
    assert TE.resolve_backend("auto", cpu) == "torch"
    assert TE.resolve_backend("torch", cpu) == "torch"
    for bad in ("cuda", "xla", "pallas"):
        with pytest.raises(ValueError):
            TE.resolve_backend(bad, cpu)
    # "torch" runs the plain twins on either device; "auto" follows it.
    assert TE.resolve_backend("torch", _OnCuda()) == "torch"
    assert TE.resolve_backend("auto", _OnCuda()) == "cuda"
    assert TE.resolve_backend("cuda", _OnCuda()) == "cuda"


@pytest.mark.cuda
def test_torch_backend_runs_the_twins_on_cuda_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the plain twins on CUDA tensors")
    from repro_torch.core import KronOp

    x, fs = make_inputs(19, 8, (8, 8), (8, 8))
    xc = to_torch(x).cuda()
    fc = [to_torch(f).cuda() for f in fs]
    before = _launch.launches["chain_fwd"]
    got = KronOp((8, 8), (8, 8), backend="torch")(xc, fc)
    assert _launch.launches["chain_fwd"] == before and got.is_cuda
    want = KronOp((8, 8), (8, 8))(to_torch(x), [to_torch(f) for f in fs])
    assert_close(got.cpu(), want.numpy(), 1e-12)
    assert_close(ops.sliced_multiply(xc, fc[0], backend="torch").cpu(),
                 ops.sliced_multiply(to_torch(x), to_torch(fs[0])).numpy(), 1e-12)


BUDGET = 4096
TILE_CASES = [  # (x shape, factor (p, q)s, tiles) -> the error chain_pallas raises
    ((1, 8, 30), ((4, 4), (2, 2)), dict(t_m=8)),                  # K % prod(P)
    ((1, 8, 32), ((4, 4), (8, 8)), dict(t_m=8, t_qs=(4, 3))),     # t_qs must divide Q
    ((1, 8, 64), ((4, 4), (8, 8)), dict(t_m=8, t_k=48)),          # T_K % prod(P)
    ((1, 8, 1024), ((4, 4), (8, 8)), dict(t_m=8, t_k=1024)),      # budget
    ((1, 6, 64), ((4, 4), (8, 8)), dict(t_m=4, t_k=64)),          # tiles divide dims
    ((1, 8, 64), ((4, 4), (8, 8)), dict(t_m=2, t_k=64, t_qs=(4,))),  # t_qs length
]


@pytest.mark.parametrize("x_shape,pqs,tiles", TILE_CASES)
def test_chain_tile_checks_match_chain_pallas(x_shape, pqs, tiles):
    b = x_shape[0]
    xj = jnp.zeros(x_shape, jnp.float32)
    fj = [jnp.zeros((b, p, q), jnp.float32) for p, q in pqs]
    with pytest.raises(JG.KronError) as jax_err:
        JE.chain_pallas(xj, *fj, interpret=True, vmem_budget_elems=BUDGET, **tiles)
    want = type(jax_err.value)
    assert want in (JG.LoweringError, JG.VmemOverflowError)
    port_type = {JG.LoweringError: TG.LoweringError, JG.VmemOverflowError: TG.VmemOverflowError}[want]
    xt = torch.zeros(x_shape)
    ft = [torch.zeros(b, p, q) for p, q in pqs]
    with pytest.raises(port_type):
        TE.chain_cuda(xt, *ft, vmem_budget_elems=BUDGET, **tiles)


@pytest.mark.parametrize(
    "m,s,p,q,in_bytes",
    [(1024, 32768, 32, 32, 4), (4096, 76, 64, 128, 2), (10, 52, 65, 20, 4),
     (16, 64, 256, 256, 4)],
)
def test_block_tile_is_the_largest_that_fits_half_a_block(m, s, p, q, in_bytes):
    # The sliced kernel's tile rule: among the tiles whose block leaves room
    # for a second one on the SM, the widest Q-tile, then output runs that
    # fill a 32-byte sector, then the largest t_m * t_s, ties to longer runs.
    tm, ts, tq = kron_sliced.sliced_tiles(m, s, p, q, 4, in_bytes=in_bytes)
    assert m % tm == 0 and s % ts == 0 and q % tq == 0
    mma = kron_sliced.sliced_uses_mma(p, q, in_bytes)

    def key(t_m, t_s, t_q):
        return (t_q, t_s * in_bytes >= 32, t_m * t_s, t_s)

    assert kron_sliced.sliced_smem_bytes(tm, ts, p, q, tq, in_bytes, 4, mma) <= (
        TE.TWO_BLOCK_SMEM_BYTES)
    for t_q in [q] if mma else [d for d in range(1, q + 1) if q % d == 0]:
        for t_s in (d for d in range(1, s + 1) if s % d == 0):
            for t_m in (d for d in range(1, m + 1) if m % d == 0):
                if (t_m, t_s, t_q) == (tm, ts, tq):
                    continue
                nbytes = kron_sliced.sliced_smem_bytes(t_m, t_s, p, q, t_q, in_bytes, 4, mma)
                if nbytes <= TE.TWO_BLOCK_SMEM_BYTES:
                    assert key(t_m, t_s, t_q) < key(tm, ts, tq)


def test_block_tile_overflow_raises_typed_error():
    # A factor whose panel alone exceeds the two-block share at any tile.
    with pytest.raises(TG.VmemOverflowError):
        kron_sliced.sliced_tiles(4, 8, 2048, 8, 8)
    # The chain kernels' tile rule takes no default kernel: the sliced
    # routine's model is gone.
    with pytest.raises(TypeError):
        TE.block_tile(1, 1024, (32, 32), (32, 32), 4)
    with pytest.raises(ValueError, match="kind"):
        TE.block_smem_bytes(1, 1024, (32, 32), (32, 32), 4, kind="fwd")


@pytest.mark.parametrize(
    "dtype,m,p,q,tol",
    [pytest.param(None, 6, 12, 5, 1e-9, id="f64"),
     pytest.param("bfloat16", 8, 40, 76, 1e-2, id="bf16-40x76")],
)
def test_sliced_reference_and_dispatch_match_jax(dtype, m, p, q, tol):
    from repro.kernels import ops as JO

    x, (f,) = make_inputs(14, m, (p,), (q,))
    x = np.concatenate([x] * 3, axis=1)  # K = 3P, S = 3
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype else (None, None)
    xj, fj, xt, ft = to_jax(x, jdt), to_jax(f, jdt), to_torch(x, tdt), to_torch(f, tdt)
    for backend in ("xla", "pallas"):  # pallas: sliced_multiply_pallas in interpret mode
        want = JO.sliced_multiply(xj, fj, backend=backend)
        assert_close(ops.sliced_multiply(xt, ft), want, tol)
        assert_close(kron_sliced.sliced_multiply_reference(xt, ft), want, tol)
    tiles = kron_sliced.sliced_tiles(4096, 76, 64, 128, 4, in_bytes=2)
    assert kron_sliced.sliced_smem_bytes(
        *tiles[:2], 64, 128, tiles[2], 2, 4, mma=True) <= TE.TWO_BLOCK_SMEM_BYTES
    assert 4096 % tiles[0] == 0 and 76 % tiles[1] == 0 and 128 % tiles[2] == 0


def test_prekron_product_matches_jax():
    _, fs = make_inputs(15, 1, (2, 3, 4), (3, 2, 2))
    assert_close(TE.prekron_product([to_torch(f) for f in fs]),
                 JE.prekron_product([to_jax(f) for f in fs]), 1e-12)
    _, fb = make_inputs(16, 1, (2, 3), (3, 2), batch=3)
    assert_close(TE.prekron_product([to_torch(f) for f in fb]),
                 JE.prekron_product([to_jax(f) for f in fb]), 1e-12)
    x, (f,) = make_inputs(17, 4, (6,), (5,))
    assert_close(TE.sliced_apply(to_torch(x), to_torch(f)),
                 JE.sliced_apply(to_jax(x), to_jax(f)), 1e-12)
    assert TE.acc_dtype_for(torch.bfloat16) == torch.float32
    assert TE.acc_dtype_for(torch.float64) == torch.float64
