"""Production and debug meshes, and the world the launchers' mesh flags run
on.

Functions, never module-level constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the ranks of an
initialised ``torch.distributed`` world (the caller gives
``init_process_group`` its address, world size and rank); a world too small
for the shape raises.  ``init_world`` is the launchers' way in: the world
already initialised, or one made from ``torchrun``'s environment.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None) -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks of the world."""
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"need {need} ranks for {shape}, have {have}: initialise "
            f"torch.distributed with a world of at least {need}"
        )
    ranks = torch.arange(need, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type or "cuda", ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None) -> DeviceMesh:
    """The reference's production grids: ``(data, model) = (16, 16)``, or
    ``(pod, data, model) = (2, 16, 16)`` with ``multi_pod``."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(data: int = 2, model: int = 4, *, device_type: str | None = None) -> DeviceMesh:
    """A small ``(data, model)`` mesh for tests (8 gloo ranks on the CPU:
    ``device_type="cpu"``)."""
    return _mesh((int(data), int(model)), ("data", "model"), device_type)


def init_world(device: torch.device) -> int:
    """The world size a launcher's mesh flag runs on.  An initialised world
    is taken as it is (its ranks share ``device``).  Otherwise one is made
    from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``): NCCL with one card per rank
    (``LOCAL_RANK``) on the card, gloo on the CPU.  With neither, raises:
    a mesh flag never quietly runs on one rank."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "a mesh flag needs a torch.distributed world: launch under torchrun "
            "(torchrun --nproc-per-node N -m ...), or initialise the process group "
            "before calling main()")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size()


__all__ = ["make_production_mesh", "make_debug_mesh", "init_world"]
