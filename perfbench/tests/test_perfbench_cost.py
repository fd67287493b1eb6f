"""The yardstick's counts: hand counts for the three cells, and the sliced
algorithm's multiply-adds counted one by one at tiny sizes."""
import itertools
import math

import pytest

from perfbench import cost

P32 = (32,) * 4


def test_training_step_at_fig9_size():
    c = cost.kron_train_step(1024, P32, P32, "float32")
    assert cost.forward_flops(1024, P32, P32) == 2**38
    assert c.flops == 3 * 2**38  # forward, dX, every dF
    assert c.bytes == 16 * 2**30 + 2 * 4 * 32 * 32 * 4  # X, G, Y, dX once; factors and dF
    assert c.bound == "memory"
    assert c.roofline_s == pytest.approx(c.bytes / 3.35e12)
    assert c.roofline_s * 1e3 == pytest.approx(5.128, abs=1e-3)
    assert c.compute_s == pytest.approx(3 * 2**38 / 495e12)


def test_one_row_forward():
    c = cost.kron_forward(1, P32, P32, "float32")
    assert c.flops == 2**28
    assert c.bytes == (2 * 2**20 + 4 * 32 * 32) * 4
    assert c.roofline_s * 1e6 == pytest.approx(2.509, abs=1e-3)


def test_gp_epoch_table4_row26():
    c = cost.gp_epoch(16, (16,) * 6, 10, "float32")
    assert c.flops == 11 * 6 * 2 * 16 * 16**6 * 16
    assert c.flops == pytest.approx(5.67e11, rel=1e-3)
    assert c.bytes == (2 * 16 * 16**6 + 6 * 16 * 16 + 16) * 4
    assert c.bound == "compute"


def test_peaks_are_the_published_ones():
    assert cost.PEAK_FLOPS["float32"] == 495e12
    assert cost.PEAK_FLOPS["bfloat16"] == 989e12
    assert cost.HBM_BYTES_PER_S == 3.35e12


def _brute_macs(m, ps, qs):
    """Multiply-adds of Algorithm 1, executed index by index: the last factor
    first, each output element of an (M, K) -> (M, K / P * Q) step summing P
    products.  Returns the count per factor, in problem order."""
    macs = [0] * len(ps)
    k = math.prod(ps)
    for i in reversed(range(len(ps))):
        s = k // ps[i]
        for _row, _q, _slice in itertools.product(range(m), range(qs[i]), range(s)):
            for _p in range(ps[i]):
                macs[i] += 1
        k = s * qs[i]
    return macs


@pytest.mark.parametrize("m,ps,qs", [
    (2, (2, 3, 4), (3, 2, 2)),
    (3, (5, 2), (1, 4)),
    (1, (4, 4, 4), (4, 4, 4)),
])
def test_counts_match_the_algorithm_executed(m, ps, qs):
    macs = _brute_macs(m, ps, qs)
    assert cost.sliced_multiply_flops(m, ps, qs) == [2 * n for n in macs]
    assert cost.kron_forward(m, ps, qs, "float32").flops == 2 * sum(macs)
    # dX runs the chain over the transposed factors; each dF contracts what
    # its forward multiply contracted.
    dx_macs = _brute_macs(m, qs, ps)
    assert cost.kron_train_step(m, ps, qs, "float32").flops == 2 * (2 * sum(macs) + sum(dx_macs))
    k, k_out = math.prod(ps), math.prod(qs)
    factors = sum(p * q for p, q in zip(ps, qs))
    assert cost.kron_train_step(m, ps, qs, "float32").bytes == 4 * (2 * m * k + 2 * m * k_out
                                                                    + 2 * factors)
