"""Atomic, keep-k, optionally asynchronous checkpointing.

The port of ``repro.checkpoint.manager``, with its on-disk layout:

    <dir>/step_<n>/           (written as step_<n>.tmp, then renamed)
        manifest.json         leaf paths, shapes, dtypes
        leaf_<i>.npy          one file per tree leaf, in flatten order

Leaf paths and order are the reference's (``repro_torch.tree``), so a
checkpoint written by either package restores in the other.  A bfloat16
leaf is written as the reference writes it, two-byte words under the
``.npy`` descriptor ``'<V2'`` with ``"bfloat16"`` in the manifest, and read
back as raw words (``numpy`` has no bfloat16 of its own).

  * atomicity: a crash mid-save leaves only a ``.tmp`` directory, which
    restore ignores and the next save removes;
  * keep-k: the oldest checkpoints go after each successful rename;
  * async: the save copies every leaf to the host, then a thread writes
    the files (``wait()`` joins it; every save and restore waits first).

On a mesh (``shardings=``, a tree of ``sharding.NamedSharding`` matching
the state) every rank calls ``save``: the leaves are gathered one at a time,
each in pieces of at most 256 MiB that go to the host as they arrive
(``sharding.gather_to_host``), so a rank's card holds less than one whole
leaf beside its shards; rank 0 keeps the host copies and alone writes, so the files are the ones a single-device save
makes and the reference reads them.  ``restore(target, shardings=)`` reads
the whole leaves on every rank and keeps each rank's shard, as the
reference puts each leaf with its target's sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import tree
from ..runtime import sharding as S

_BF16_DESCR = "<V2"


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as numpy and its dtype's name; bfloat16 as uint16 words."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype_name: str) -> None:
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _load_leaf(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._sharded = False  # the last save was collective: wait() meets the ranks
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, shardings: Any = None) -> None:
        """Write ``state``.  ``shardings``: its leaves are this rank's
        shards; every rank of the mesh must call it."""
        self.wait()
        leaves = tree.leaves_with_path(state)
        if shardings is None:
            # snapshot to the host while the device state is live
            host = [(path, _to_host(leaf)) for path, leaf in leaves]
        else:
            # one leaf at a time, in pieces, to the host (rank 0) or dropped
            self._sharded = True
            writer = dist.get_rank() == 0
            host = []
            for (path, leaf), sh in zip(leaves, tree.leaves(shardings)):
                full = S.gather_to_host(leaf, sh, keep=writer)  # None off rank 0
                if writer:
                    host.append((path, _to_host(full)))
            if not writer:
                return
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host))
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: list) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # The reference writes its treedef's repr under "treedef"; neither
        # package's restore reads it.
        manifest = {"step": step, "leaves": [], "treedef": "repro_torch.tree"}
        for i, (path, (arr, dtype)) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:  # the writer's files are published for every rank
            self._sharded = False
            dist.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        # orphaned tmp dirs from crashes
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: int | None = None, *, shardings: Any = None) -> Any:
        """``target``: a tree of tensors (shape, dtype and device per leaf);
        returns a tree of its structure with the checkpoint's values.
        ``shardings``: ``target`` holds this rank's shards, and each leaf
        comes back as this rank's shard of the checkpoint's."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {l["path"]: l for l in manifest["leaves"]}
        leaves = tree.leaves_with_path(target)
        shs = [None] * len(leaves) if shardings is None else tree.leaves(shardings)
        out = []
        for (path, tgt), sh in zip(leaves, shs):
            meta = by_path.get(path)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {path!r}")
            t = _load_leaf(os.path.join(d, meta["file"]), meta["dtype"])
            shape = tuple(t.shape) if sh is None else sh.shard_shape(tuple(t.shape))
            if shape != tuple(tgt.shape):
                raise ValueError(
                    f"shape mismatch for {path}: ckpt {tuple(t.shape)} vs target "
                    f"{tuple(tgt.shape)}")
            if sh is not None:
                t = S.local_shard(t, sh)
            out.append(t.to(device=tgt.device, dtype=tgt.dtype))
        return tree.unflatten_like(target, out)


__all__ = ["CheckpointManager"]
