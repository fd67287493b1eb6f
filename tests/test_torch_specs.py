"""The dry-run cells in the port (repro_torch.launch.specs) against
repro.launch.specs on the production grids.

For every runnable (arch, shape) pair of ``configs.runnable_cells()`` on the
(16, 16) and (2, 16, 16) grids: the port's ``build_cell`` on a real
``DeviceMesh`` over a fake world of 256 or 512 ranks, the reference's on a
JAX ``AbstractMesh`` of the same grid (no devices needed).  Every leaf of
``in_specs`` has the reference's global shape, dtype and ``PartitionSpec``
(the port's ``in_shardings`` carry the global shape and spec; its stand-ins
are this rank's fake shards at the spec's local shape, the token batch
global), and ``meta`` is the reference's, apart from ``fsdp_pods``: the
reference judges pod FSDP against 16e9 bytes a chip, the port against the
H100's memory, which flips it to False in every cell of
jamba-1.5-large-398b and mixtral-8x22b on (2, 16, 16) (pinned below).
"""
from __future__ import annotations

import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensor

from repro.launch import specs as JSpecs
from repro.runtime import sharding as JS
from repro_torch import tree
from repro_torch.configs import runnable_cells
from repro_torch.launch import specs as TSpecs
from repro_torch.launch.mesh import make_production_mesh

GRIDS = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}
# (arch, grid) whose fsdp_pods the port flips to False (state bytes against
# a quarter of one pod's HBM: 3.18 TB and 1.13 TB against 1.02 TB at 16e9 a
# chip, 5.4 TB at the H100's).
FSDP_FLIPS = {("jamba_1_5_large_398b", "2x16x16"), ("mixtral_8x22b", "2x16x16")}


@pytest.fixture(scope="module", params=list(GRIDS))
def grid(request):
    """(name, the port's mesh, the reference's AbstractMesh) in a fake world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = GRIDS[request.param]
    names = ("pod", "data", "model")[-len(shape):]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield (request.param,
               make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu"),
               AbstractMesh(shape, names))
    finally:
        dist.destroy_process_group()


def _ref_leaves(t) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    out = {}
    for kp, leaf in flat:
        sh = getattr(leaf, "sharding", None)
        spec = tuple(sh.spec) if sh is not None else ()
        out[JS._path_str(kp)] = (tuple(leaf.shape), leaf.dtype.name,
                                 spec + (None,) * (len(leaf.shape) - len(spec)))
    return out


def _port_leaves(specs, shardings) -> dict:
    out = {}
    for (path, leaf), sh in zip(tree.leaves_with_path(specs), tree.leaves(shardings)):
        full = tuple(sh.shape) if sh.shape is not None else tuple(leaf.shape)
        spec = tuple(sh.spec) + (None,) * (len(full) - len(sh.spec))
        if sh.shape is not None:  # a shard (the batch and the counters are whole)
            assert tuple(leaf.shape) == sh.shard_shape(full), (path, leaf.shape, full, spec)
        assert isinstance(leaf, FakeTensor) or (leaf.ndim == 0 and leaf.device.type == "cpu")
        out[path] = (full, str(leaf.dtype).removeprefix("torch."), spec)
    return out


CELLS = runnable_cells()


def test_thirty_three_runnable_pairs():
    assert len(CELLS) == 33


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_cell_equals_reference(grid, arch, shape, monkeypatch):
    name, mesh, amesh = grid
    ref = JSpecs.build_cell(arch, shape, amesh)
    got = TSpecs.build_cell(arch, shape, mesh, device="cpu")
    assert ref.meta["fsdp_pods"] is ((arch, name) in FSDP_FLIPS)
    assert got.meta["fsdp_pods"] is False
    if ref.meta["fsdp_pods"]:  # the reference's cell as it lays out without pod FSDP
        monkeypatch.setattr(JSpecs, "_needs_pod_fsdp", lambda *a: False)
        ref = JSpecs.build_cell(arch, shape, amesh)
    assert _port_leaves(got.in_specs, got.in_shardings) == _ref_leaves(ref.in_specs)
    assert got.meta == dict(ref.meta, mesh={k: int(v) for k, v in ref.meta["mesh"].items()})
    assert (got.cfg.name, got.cfg.kv_quant) == (ref.cfg.name, ref.cfg.kv_quant)


def test_overrides_are_the_reference_s():
    assert TSpecs.TRAIN_OVERRIDES == JSpecs.TRAIN_OVERRIDES
    assert TSpecs.DEFAULT_MICROBATCHES == JSpecs.DEFAULT_MICROBATCHES
    assert TSpecs.SERVE_OVERRIDES == JSpecs.SERVE_OVERRIDES


def test_a_train_cell_runs_its_microbatches_on_this_rank_s_rows(grid):
    """jamba's 16 microbatches split a rank's rows: 16 on (16, 16), at most
    one a row (8) on (2, 16, 16); the step counter is a real CPU tensor."""
    name, mesh, _ = grid
    cell = TSpecs.build_cell("jamba-1.5-large-398b", "train_4k", mesh, device="cpu")
    assert cell.meta["microbatches"] == 16
    assert cell.microbatches == {"16x16": 16, "2x16x16": 8}[name]
    state, batch = cell.in_specs
    assert not isinstance(state.step, FakeTensor) and int(state.step) == 0
    assert tuple(batch["tokens"].shape) == (256, 4096)
    assert torch.equal(torch.tensor(state.opt["step"].shape), torch.tensor([]))
