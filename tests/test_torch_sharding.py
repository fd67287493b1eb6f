"""The port's sharding rules (repro_torch.runtime.sharding) against the
reference's (repro.runtime.sharding) on the production grids.

The port's meshes are real ``DeviceMesh`` objects over a fake process group
of 256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``), made
and destroyed by a module fixture, so no worker keeps a process group.  The
reference's rules read only the mesh's axis names and sizes, which a JAX
``AbstractMesh`` of the same grid gives.  For every config in ``configs/``:
every parameter leaf (shapes from the port's ``meta`` init, which must
equal the reference's ``eval_shape``), every cache leaf at a batch the
batch axes divide and at B=1, and the tokens get the reference's spec, and
each spec's DTensor placements turn back into it.  The shard order of a
tensor dim over several mesh dims is checked on a stub mesh at chosen
coordinates (pod major, as JAX lays out a tuple entry).
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.runtime import sharding as JS
from repro_torch import tree
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.runtime import sharding as TS

GRIDS = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
CACHE_LEN = 4096


@pytest.fixture(scope="module", params=list(GRIDS))
def grid(request):
    """(name, the port's DeviceMesh, the reference's AbstractMesh) over a fake
    world of the grid's size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = GRIDS[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield (request.param, init_device_mesh("cpu", shape, mesh_dim_names=names),
               AbstractMesh(shape, names))
    finally:
        dist.destroy_process_group()


def _padded(spec, nd: int) -> tuple:
    """A reference PartitionSpec as the port's tuple: one entry per dim."""
    out = tuple(spec)
    return out + (None,) * (nd - len(out))


def _ref_leaves(tree_shape) -> list[tuple[str, tuple[int, ...]]]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_shape)
    return [(JS._path_str(kp), tuple(leaf.shape)) for kp, leaf in flat]


def _port_leaves(t) -> list[tuple[str, tuple[int, ...]]]:
    return [(path, tuple(leaf.shape)) for path, leaf in tree.leaves_with_path(t)]


_SHAPES: dict = {}


def _param_shapes(arch):
    """(port leaves, reference leaves) of the arch's parameter tree."""
    if ("params", arch) not in _SHAPES:
        ref = jax.eval_shape(lambda: JM.init_params(jget(arch), jax.random.PRNGKey(0)))
        port = TM.init_params(tget(arch), None, device="meta")
        _SHAPES["params", arch] = (port, _ref_leaves(ref))
    return _SHAPES["params", arch]


def _cache_shapes(arch, batch):
    if ("cache", arch, batch) not in _SHAPES:
        ref = jax.eval_shape(lambda: JM.init_cache(jget(arch), batch, CACHE_LEN))
        port = TM.init_cache(tget(arch), batch, CACHE_LEN, device="meta")
        _SHAPES["cache", arch, batch] = (port, _ref_leaves(ref))
    return _SHAPES["cache", arch, batch]


def _round_trips(mesh, spec, nd):
    pl = TS.placements_of(mesh, spec)
    assert len(pl) == mesh.ndim
    assert all(isinstance(p, (Shard, Replicate)) for p in pl)
    assert TS.spec_of(mesh, pl, nd) == spec


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(grid, arch):
    _, tmesh, jmesh = grid
    port, ref = _param_shapes(arch)
    assert _port_leaves(port) == ref  # the meta init is the reference's eval_shape
    cfg = tget(arch)
    shardings = TS.param_shardings(port, tmesh, tied_embed=cfg.tie_embeddings)
    for (path, shape), sh in zip(ref, tree.leaves(shardings)):
        want = _padded(JS.param_spec(path, shape, jmesh, tied_embed=cfg.tie_embeddings),
                       len(shape))
        assert TS.param_spec(path, shape, tmesh) == want, path
        assert sh.spec == want and sh.shape == shape, path
        _round_trips(tmesh, want, len(shape))
        # every shard is even: the local shape times the shard counts is the leaf
        local = sh.shard_shape()
        assert all(n % m == 0 for n, m in zip(shape, local)), path
        assert math.prod(shape) == math.prod(local) * math.prod(
            TS._size(tmesh, TS._entry_axes(e)) for e in want), path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", ["divides", 1])
def test_cache_specs_equal_reference(grid, arch, batch):
    _, tmesh, jmesh = grid
    if batch == "divides":
        batch = 2 * TS._size(tmesh, TS._axes(tmesh)[0])
    port, ref = _cache_shapes(arch, batch)
    assert _port_leaves(port) == ref
    shardings = TS.cache_shardings(port, tmesh, batch)
    for (path, shape), sh in zip(ref, tree.leaves(shardings)):
        want = _padded(JS.cache_spec(path, shape, jmesh, batch), len(shape))
        assert sh.spec == want, path
        _round_trips(tmesh, want, len(shape))


@pytest.mark.parametrize("batch", [1, 2, 3, 16, 32, 64, 256])
def test_token_and_batch_specs_equal_reference(grid, batch):
    _, tmesh, jmesh = grid
    want = _padded(JS.token_sharding(jmesh, batch).spec, 2)
    got = TS.token_sharding(tmesh, batch)
    assert got.spec == want
    _round_trips(tmesh, want, 2)
    assert TS.batch_spec(tmesh) == _padded(JS.batch_spec(jmesh), 1)


class _StubMesh:
    """Axis names, sizes and one chosen coordinate: enough for the cut."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self._coord = shape, names, coord
        self.ndim = len(shape)

    def get_coordinate(self):
        return list(self._coord)


@pytest.mark.parametrize("coord", [(0, 0, 0), (1, 0, 3), (0, 15, 7), (1, 15, 15), (1, 7, 0)])
def test_tuple_entry_shards_pod_major(coord):
    """``(("pod", "data"), "model")`` on (2, 16, 16): the rank at (p, d, m)
    holds row block ``p * 16 + d`` and column block ``m``, JAX's order for a
    tuple entry, and DTensor's Shard(0) on both mesh dims."""
    shape, names = GRIDS["2x16x16"]
    mesh = _StubMesh(shape, names, coord)
    full = torch.arange(64 * 32).reshape(64, 32)
    sh = TS.NamedSharding(mesh, (("pod", "data"), "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    local = TS.local_shard(full, sh)
    p, d, m = coord
    assert local.shape == (2, 2)
    assert torch.equal(local, full[(p * 16 + d) * 2:(p * 16 + d + 1) * 2, m * 2:(m + 1) * 2])


def test_placements_refuse_a_tuple_out_of_mesh_order():
    mesh = _StubMesh((2, 16, 16), ("pod", "data", "model"), (0, 0, 0))
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements_of(mesh, (("data", "pod"), None))


def test_fit_keeps_shards_even():
    """A rule whose axis does not divide its dim falls back to replication
    on that dim only (``_fit``)."""
    mesh = _StubMesh((16, 16), ("data", "model"), (0, 0))
    assert TS.param_spec("stack/pos0/mixer/wq", (3, 48, 40), mesh) == (None, "data", None)
    assert TS.param_spec("final_norm", (2560,), mesh) == ("model",)
    assert TS.param_spec("final_norm", (1000,), mesh) == (None,)
    assert TS.param_spec("ffn/ew1", (8, 64, 32), mesh) == (None, "data", "model")
    assert TS.param_spec("ffn/ew2", (8, 32, 64), mesh) == (None, "model", "data")
    assert TS.param_spec("ffn/ew1", (64, 64, 32), mesh) == ("model", "data", None)


def test_off_the_mesh_everything_is_a_no_op():
    """No ambient mesh: ``constrain``, ``constrain_like_params``, ``tp_size``
    and the tensor-parallel moves leave their inputs alone."""
    assert TS.ambient_mesh() is None and TS.tp_size() == 1 and TS.batch_shards() == 1
    x = torch.randn(2, 4, 8)
    assert TS.constrain(x, "batch", None, "tp") is x
    t = {"a": x}
    assert TS.constrain_like_params(t) is t
    assert TS.reduce_tp(x) is x and TS.tp_partial_grad(x) is x and TS.tp_join(x, 1) is x
    assert TS.param_view(x, None) is x
    assert torch.equal(TS.tp_pick(x, 2, [1, 3]), x[:, :, [1, 3]])


def test_use_mesh_installs_and_removes_the_ambient_mesh():
    mesh = _StubMesh((2, 4), ("data", "model"), (1, 2))
    with TS.use_mesh(mesh) as m:
        assert m is mesh and TS.ambient_mesh() is mesh
        assert TS.tp_size() == 4 and TS.tp_rank() == 2 and TS.batch_axes() == ("data",)
        assert TS.batch_shards() == 2
        with TS.use_mesh(mesh, batch_axes=()):
            assert TS.batch_shards() == 1
        assert TS.batch_axes() == ("data",)
    assert TS.ambient_mesh() is None
    with TS.use_mesh(None) as m:
        assert m is None and TS.ambient_mesh() is None


def test_constrain_like_params_cuts_full_leaves_and_keeps_shards():
    mesh = _StubMesh((2, 4), ("data", "model"), (1, 3))
    full = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    sh = {"w": TS.NamedSharding(mesh, ("data", "model"), (8, 16))}
    with TS.use_mesh(mesh):
        cut = TS.constrain_like_params({"w": full}, sh)["w"]
        assert torch.equal(cut, full[4:8, 12:16])
        assert TS.constrain_like_params({"w": cut}, sh)["w"] is cut
        with pytest.raises(ValueError, match="neither"):
            TS.constrain_like_params({"w": full[:3]}, sh)


def test_meta_init_costs_no_memory_at_full_size():
    """The rules run on the full-size configs' meta trees (no storage)."""
    port, _ = _param_shapes("qwen3-4b")
    assert all(leaf.device.type == "meta" for leaf in tree.leaves(port))
    n = sum(leaf.numel() for leaf in tree.leaves(port))
    assert n == pytest.approx(tget("qwen3-4b").param_count(), rel=1e-2)
    assert np.isfinite(n)
