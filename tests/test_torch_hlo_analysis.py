"""Collective accounting in the port (repro_torch.runtime.hlo_analysis)
against repro.runtime.hlo_analysis: the five kind names, ``shape_bytes`` of
the same dtypes and shapes (the reference reads them from an HLO type
string, the port from a tensor or a (dtype, shape) pair), ``CollectiveStats``
and its summary; and every c10d collective the port's steps make, as a
``CostMode`` records it on a fake process group of eight ranks: its kind and
its output bytes per participant."""
from __future__ import annotations

import math

import pytest
import torch
import torch.distributed as dist

from repro.runtime import hlo_analysis as JA
from repro_torch.runtime import hlo_analysis as TA
from repro_torch.runtime.hlo_cost import CostMode

# (HLO element type, torch dtype)
DTYPES = [("f64", torch.float64), ("f32", torch.float32), ("bf16", torch.bfloat16),
          ("f16", torch.float16), ("s64", torch.int64), ("s32", torch.int32),
          ("s16", torch.int16), ("s8", torch.int8), ("u8", torch.uint8), ("pred", torch.bool),
          ("c64", torch.complex64), ("c128", torch.complex128)]
SHAPES = [(), (7,), (4, 3), (2, 16, 5), (1, 0, 9)]


def test_kind_names_are_the_reference_s():
    assert TA.COLLECTIVE_OPS == JA.COLLECTIVE_OPS


@pytest.mark.parametrize("hlo,dtype", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_shape_bytes_equals_reference(hlo, dtype, shape):
    ref = JA.shape_bytes(f"{hlo}[{','.join(map(str, shape))}]{{0}}")
    assert TA.shape_bytes((dtype, shape)) == ref
    assert TA.shape_bytes(torch.empty(shape, dtype=dtype)) == ref


def test_shape_bytes_of_a_tuple_sums_like_the_reference():
    ref = JA.shape_bytes("(f32[4,2]{1,0}, bf16[3]{0}, s32[])")
    assert TA.shape_bytes([torch.empty(4, 2), (torch.bfloat16, (3,)),
                           torch.empty((), dtype=torch.int32)]) == ref


def test_collective_stats_and_summary_equal_reference():
    trace = [("all-gather", 3_000_000), ("all-reduce", 1_500_000), ("all-gather", 500_000)]
    port = TA.collective_stats(trace)
    ref = JA.CollectiveStats(bytes_by_op={"all-gather": 3_500_000, "all-reduce": 1_500_000},
                             count_by_op={"all-gather": 2, "all-reduce": 1})
    assert port.bytes_by_op == ref.bytes_by_op and port.count_by_op == ref.count_by_op
    assert port.summary() == ref.summary()
    assert (port.total_bytes, port.total_count) == (ref.total_bytes, ref.total_count)
    assert TA.collective_bytes(trace) == 5_000_000
    assert TA.CollectiveStats().summary() == JA.CollectiveStats().summary()
    with pytest.raises(ValueError):
        TA.collective_stats([("broadcast", 4)])


@pytest.fixture(scope="module")
def world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _calls():
    """(name, kind, call, payload bytes per rank): each on 8 ranks."""
    x = torch.empty(6, 5)
    n = 8

    def gather_into():
        dist.all_gather_into_tensor(torch.empty(n * 6, 5), x)

    def gather_list():
        dist.all_gather([torch.empty(6, 5) for _ in range(n)], x)

    def reduce_():
        dist.all_reduce(x)

    def reduce_scatter():
        dist.reduce_scatter_tensor(torch.empty(6, 5), torch.empty(n * 6, 5))

    def all_to_all():
        dist.all_to_all_single(torch.empty(n * 2, 5), torch.empty(n * 2, 5))

    def send():
        dist.send(x, dst=1)

    def recv():
        dist.recv(x, src=1)

    b = x.numel() * 4
    return [("all_gather_into_tensor", "all-gather", gather_into, n * b),
            ("all_gather", "all-gather", gather_list, n * b),
            ("all_reduce", "all-reduce", reduce_, b),
            ("reduce_scatter_tensor", "reduce-scatter", reduce_scatter, b),
            ("all_to_all_single", "all-to-all", all_to_all, n * 2 * 5 * 4),
            ("send", "collective-permute", send, b),
            ("recv", "collective-permute", recv, b)]


@pytest.mark.parametrize("name", [c[0] for c in _calls()])
def test_c10d_collective_kind_and_bytes(world, name):
    _, kind, call, nbytes = next(c for c in _calls() if c[0] == name)
    with CostMode(sites=True) as mode:
        call()
    assert mode.cost.collective_counts == {kind: 1}
    assert mode.cost.collective_bytes == {kind: nbytes}
    (site,) = mode.sites
    assert (site.kind, site.nbytes) == (kind, nbytes)
    assert TA.collective_stats(mode.sites).bytes_by_op == {kind: nbytes}


def test_the_sharding_moves_are_seen(world):
    """The port's direct dist.* moves (sharding._join, _all_reduce) on a
    fake (2, 4) mesh: one all-gather per sharded mesh dim (its output the
    chunks gathered so far), one all-reduce per axis."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import sharding as S

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    local = torch.empty(3, 5)
    with CostMode() as mode:
        full = S._join(local, mesh, [(0, ("data",)), (1, ("model",))])
        S._all_reduce(full, mesh, ("data", "model"))
    assert full.shape == (6, 20)
    assert mode.cost.collective_counts == {"all-gather": 2, "all-reduce": 2}
    assert mode.cost.collective_bytes == {
        "all-gather": (2 * 15 + 8 * 15) * 4, "all-reduce": 2 * math.prod(full.shape) * 4}
