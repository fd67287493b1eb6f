"""Serving on a mesh in the port (``make_prefill_step(mesh=)``,
``make_serve_step(mesh=)``: the steps the dry-run's prefill and decode cells
run) against the reference's jitted serving steps on the same mesh, and
against the port's own steps on one rank.

Four gloo CPU ranks as a (data, model) = (2, 2) ``DeviceMesh``, each holding
its shards of the reduced qwen3-4b's parameters (f32; dense and with the
Kron FFN; the numpy parameters of ``torch_mesh_driver.model_arrays``) and
serving its rows of a 4-row batch: a 12-token prompt, then two decode
steps on ``torch_mesh_driver.serve_tokens``.  After each phase a rank keeps
its logits (its rows, and its vocabulary columns where the head splits
them) and its shards of the cache by ``cache_shardings``.

* Against the reference (``torch_mesh_driver.py serve-jax``: the reference's
  ``make_prefill_step``/``make_serve_step`` under ``jax.jit`` on four host
  devices as a mesh of ``AxisType.Auto`` axes, the parameters put by
  ``param_shardings``, the cache by ``cache_shardings``): each rank's logits
  and cache shards against the reference's addressable shard on the device
  at the same mesh coordinates, at 1e-4 of max|ref| (whole-model f32 logits,
  as ``test_torch_serve_model.py`` holds them).
* Against one rank (``model.prefill``/``decode_step`` on the whole
  parameters): the same quantities at 1e-5 of max|ref| (the rank's layers
  read whole weights gathered for them, so only the order of a few sums
  differs).
"""
from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_mesh_driver as DRV

ROOT = pathlib.Path(__file__).resolve().parent.parent
ONE_RANK_TOL, REF_TOL = 1e-5, 1e-4
RANKS = 4
REF_TIMEOUT_S = 300


def _err(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> str | None:
    """None when ``got`` is within ``tol`` of max|want| (at least 1) of ``want``."""
    if got.shape != want.shape:
        return f"{what}: shape {got.shape} against {want.shape}"
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    return None if err <= tol * scale else f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _serve(mesh, name: str) -> tuple[dict, list[str]]:
    """This rank's logits and cache shards after each phase (keys as the
    reference's ``serve/<config>/<phase>/...``), and its disagreements with
    the single-rank steps."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.runtime import sharding as S
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = DRV.serve_cfg(name, get_config, reduced)
    meta = M.init_params(cfg, None, device="meta")
    leaves = [(path, tuple(x.shape)) for path, x in tree.leaves_with_path(meta)]
    params = tree.unflatten_like(meta, [torch.from_numpy(a) for a in DRV.model_arrays(leaves)])
    local = tree.map(S.local_shard, params, M.param_layout(cfg, mesh))
    prompt, steps = (torch.from_numpy(a) for a in DRV.serve_tokens(cfg.vocab))
    batch, max_len = DRV.SERVE_BATCH, DRV.SERVE_MAX_LEN
    rows = S.token_sharding(mesh, batch)
    cache_sh = S.cache_shardings(M.init_cache(cfg, batch, max_len, device="meta"), mesh, batch)
    split = M.logits_split(cfg, mesh)
    out, errors = {}, []

    def mine(logits):  # this rank's rows (and vocabulary columns) of whole logits
        got = rank_rows(logits, rows)
        if split:
            got = S.local_shard(got, S.NamedSharding(mesh, (None, None, "model")))
        return got

    def keep(phase, logits, cache, ref_logits, ref_cache):
        key = f"serve/{name}/{phase}"
        out[f"{key}/logits"] = logits.numpy()
        errors.append(_err(logits.numpy(), mine(ref_logits).numpy(), ONE_RANK_TOL,
                           f"{phase} logits"))
        for i, (got, want) in enumerate(zip(tree.leaves(cache),
                                            tree.leaves(tree.map(S.local_shard, ref_cache,
                                                                 cache_sh)))):
            out[f"{key}/cache/{i}"] = got.numpy().copy()
            errors.append(_err(got.numpy(), want.numpy(), ONE_RANK_TOL, f"{phase} cache {i}"))

    ref_logits, ref_cache = M.prefill(cfg, params, prompt, max_len)
    logits, cache = make_prefill_step(cfg, max_len, mesh=mesh)(local, prompt)
    keep("prefill", logits, cache, ref_logits, ref_cache)
    step = make_serve_step(cfg, mesh=mesh, cache_shardings=cache_sh)
    for i in range(DRV.SERVE_STEPS):
        pos = DRV.SERVE_PROMPT + i
        ref_logits, ref_cache = M.decode_step(cfg, params, ref_cache, steps[i], pos)
        logits, cache = step(local, cache, steps[i], pos)
        keep(f"decode{i}", logits, cache, ref_logits, ref_cache)
    return out, [e for e in errors if e]


def _rank(rank: int, store: str, out: str) -> None:
    """Every config on this rank: its shards into ``out.<rank>.<config>.npz``
    and its disagreements with one rank into ``out.<rank>.<config>.txt``."""
    import traceback

    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=RANKS, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = DeviceMesh("cpu", torch.arange(RANKS).reshape(DRV.SERVE_GRID),
                          mesh_dim_names=("data", "model"))
        for name in DRV.SERVE:
            try:
                shards, errors = _serve(mesh, name)
                np.savez(f"{out}.{rank}.{name}.npz", **shards)
                result = "\n".join(errors) or "ok"
            except AssertionError:
                result = traceback.format_exc()
            with open(f"{out}.{rank}.{name}.txt", "w") as f:
                f.write(result)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """(the port's outputs' prefix, the reference's npz): the reference
    runs in its own process while the four ranks run."""
    d = tmp_path_factory.mktemp("serve_mesh")
    ref = os.path.join(d, "reference.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH")]))}
    jax_side = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_driver.py"),
                                 "serve-jax", ref], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        mp.start_processes(_rank, args=(os.path.join(d, "store"), os.path.join(d, "out")),
                           nprocs=RANKS, join=True, start_method="spawn")
        log, _ = jax_side.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
            jax_side.wait()
    assert jax_side.returncode == 0 and "ALL-OK" in log, log[-4000:]
    return os.path.join(d, "out"), ref


@pytest.mark.parametrize("name", list(DRV.SERVE))
def test_mesh_serving_equals_one_rank(outcomes, name):
    prefix, _ = outcomes
    for rank in range(RANKS):
        with open(f"{prefix}.{rank}.{name}.txt") as f:
            assert f.read() == "ok", f"rank {rank}"


@pytest.mark.parametrize("name", list(DRV.SERVE))
def test_mesh_serving_equals_reference(outcomes, name):
    prefix, ref_path = outcomes
    ref = np.load(ref_path)
    want_keys = sorted(k for k in ref.files if k.startswith(f"serve/{name}/"))
    errors = []
    for rank in range(RANKS):
        got = np.load(f"{prefix}.{rank}.{name}.npz")
        assert sorted(got.files) == want_keys, (rank, sorted(got.files), want_keys)
        for key in want_keys:
            errors.append(_err(got[key], ref[key][rank], REF_TOL, f"rank {rank} {key}"))
    errors = [e for e in errors if e]
    assert not errors, "\n".join(errors)
