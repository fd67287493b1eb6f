"""The port's core oracles (repro_torch.core.kron) against repro.core.kron."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import kron as JK
from repro_torch.core import kron as TK

jax.config.update("jax_enable_x64", True)

CASES = [
    (2, (2, 2), (2, 2)),
    (3, (4, 4, 4), (4, 4, 4)),
    (1, (16, 16), (16, 16)),
    (4, (4, 2), (2, 4)),
    (2, (8, 2, 4), (2, 8, 4)),
    (3, (5, 3), (2, 7)),
    (6, (52,), (50,)),
    (1, (2, 3, 5), (5, 3, 2)),
]
ALGORITHMS = [
    "kron_matmul_naive",
    "kron_matmul_shuffle",
    "kron_matmul_ftmmt",
    "kron_matmul_fastkron",
]


@pytest.mark.parametrize("algo", ALGORITHMS)
@pytest.mark.parametrize("m,ps,qs", CASES)
def test_algorithms_match_jax(algo, m, ps, qs):
    x, fs = make_inputs(0, m, ps, qs)
    want = getattr(JK, algo)(to_jax(x), [to_jax(f) for f in fs])
    got = getattr(TK, algo)(to_torch(x), [to_torch(f) for f in fs])
    assert_close(got, want, 1e-9)


@pytest.mark.parametrize("m,ps,qs", CASES)
def test_kron_matrix_and_sliced_multiply_match_jax(m, ps, qs):
    x, fs = make_inputs(1, m, ps, qs)
    assert_close(
        TK.kron_matrix([to_torch(f) for f in fs]),
        JK.kron_matrix([to_jax(f) for f in fs]),
        1e-9,
    )
    assert_close(
        TK.sliced_multiply(to_torch(x), to_torch(fs[-1])),
        JK.sliced_multiply(to_jax(x), to_jax(fs[-1])),
        1e-9,
    )


def test_shuffle_steps_match_jax():
    rng = np.random.default_rng(2)
    y = rng.standard_normal((3, 24))
    f = rng.standard_normal((4, 5))
    assert_close(
        TK.shuffle_iteration(to_torch(y), to_torch(f)),
        JK.shuffle_iteration(to_jax(y), to_jax(f)),
        1e-9,
    )
    t = rng.standard_normal((3 * 6, 5))
    assert_close(
        TK.shuffle_transpose_only(to_torch(t), 3, 6, 5),
        JK.shuffle_transpose_only(to_jax(t), 3, 6, 5),
        1e-9,
    )


def test_pair_factors_matches_jax():
    _, fs = make_inputs(3, 1, (2, 4, 32, 3, 3), (4, 2, 8, 3, 5))
    want = JK.pair_factors([to_jax(f) for f in fs])
    got = TK.pair_factors([to_torch(f) for f in fs])
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert_close(g, w, 1e-12)


@pytest.mark.parametrize("m,ps,qs", CASES)
def test_kron_problem_fields_match_jax(m, ps, qs):
    j, t = JK.KronProblem(m, ps, qs), TK.KronProblem(m, ps, qs)
    for field in ("m", "ps", "qs", "n", "k", "k_out", "flops", "intermediate_elems"):
        assert getattr(t, field) == getattr(j, field), field
    assert TK.KronProblem.uniform(m, 3, 5, 2) == TK.KronProblem(m, (3, 3), (5, 5))


def test_check_rejects_bad_shapes():
    with pytest.raises(ValueError):
        TK.kron_matmul_naive(torch.zeros(2, 5), [torch.zeros(2, 2), torch.zeros(2, 2)])
    with pytest.raises(ValueError):
        TK.kron_matmul_fastkron(torch.zeros(2, 2, 4), [torch.zeros(2, 2)])


@pytest.mark.parametrize("m,ps,qs", CASES[:6])
def test_kernel_oracles_match_jax(m, ps, qs):
    """Both packages' oracles contract in f32 whatever the input dtype."""
    from repro.kernels import ref as JR
    from repro_torch.kernels import ref as TR

    x, fs = make_inputs(4, m, ps, qs)
    xs, fj, ft = to_jax(x), [to_jax(f) for f in fs], [to_torch(f) for f in fs]
    assert_close(TR.fused_kron_ref(to_torch(x), ft), JR.fused_kron_ref(xs, fj), 1e-5)
    assert_close(TR.sliced_multiply_ref(to_torch(x), ft[0]), JR.sliced_multiply_ref(xs, fj[0]), 1e-5)
    dy = np.asarray(JR.fused_kron_ref(xs, fj))
    assert_close(TR.fused_kron_t_ref(to_torch(dy), ft), JR.fused_kron_t_ref(to_jax(dy), fj), 1e-5)
