"""input_specs: fake-tensor stand-ins (no device memory, this rank's shards)
for every (arch x shape) dry-run cell, plus the step each cell runs.

The port of ``repro.launch.specs``.  The reference makes sharded
``ShapeDtypeStruct``s and jits one global program.  The port is explicit
SPMD (each rank runs its own step on its shards, ROADMAP queue 3 item 38),
so a cell's ``in_specs`` are ``FakeTensor``s (``cell.mode``, a
``FakeTensorMode``) at the LOCAL shapes of this rank's shards, laid out by
the rules of ``runtime/sharding.py``; ``in_shardings`` carry the global
shapes and the reference's ``PartitionSpec``s.  The token batch is the
global batch, which each step cuts to this rank's rows (item 39); a
step's counter and a decode position are 0-d CPU tensors, as the port's
steps keep them.

Cell kinds:
  train_4k    -> train_step(state, batch)
  prefill_32k -> prefill_step(params, tokens[, embeds])
  decode_32k / long_500k -> serve_step(params, cache, tokens, pos)

A mesh of one rank runs the steps off the mesh (nothing to shard).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import tree
from ..configs import SHAPES, ShapeSpec, get_config
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import shampoo as _shampoo
from ..optim.adamw import OptConfig, opt_init
from ..optim.shampoo import ShampooConfig
from ..runtime.sharding import NamedSharding, cache_shardings, param_shardings, token_sharding
from ..train.steps import (
    TrainState,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    opt_state_shardings,
)

# per-arch training overrides for the production meshes: activation memory
# (microbatches), optimizer-state dtype (100B+ models keep bf16 m/v to fit
# 256 chips), and optimizer selection (``optimizer="shampoo"`` routes the
# cell through the Kron-factored preconditioner + its ``precond_every``
# cadence).  The reference's values.
TRAIN_OVERRIDES: dict[str, dict] = {
    "jamba-1.5-large-398b": dict(
        microbatches=16, state_dtype="bfloat16", acc_dtype="bfloat16"
    ),
    "mixtral-8x22b": dict(microbatches=8, state_dtype="bfloat16"),
    "qwen2.5-32b": dict(microbatches=4),
}
DEFAULT_MICROBATCHES = 4

# decode-cell overrides: int8 KV cache for the archs whose bf16 cache is the
# dominant serving buffer on the single-pod mesh (the reference's values).
SERVE_OVERRIDES: dict[str, dict] = {
    "qwen2.5-32b": dict(kv_quant=True),
    "musicgen-large": dict(kv_quant=True),
    "jamba-1.5-large-398b": dict(kv_quant=True),
}


@dataclasses.dataclass
class Cell:
    """Everything the dry-run needs to run one (arch x shape x mesh)."""

    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Any                 # the step
    in_specs: tuple         # this rank's fake shards (cell.mode's)
    in_shardings: tuple     # global shapes and specs
    out_shardings: Any
    meta: dict
    mode: FakeTensorMode | None = None
    microbatches: int | None = None   # per rank, as run (train cells)


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _mesh_shape(mesh) -> dict:
    return dict(zip(_names(mesh), (int(n) for n in mesh.shape)))


def _needs_pod_fsdp(cfg: ModelConfig, mesh, state_dtype: str) -> bool:
    """Shard weights over pods too when one pod's HBM is tight for the
    state (params + m + v + grad/accumulator headroom); the card's HBM is
    ``dryrun.HBM_PER_CHIP``."""
    from .dryrun import HBM_PER_CHIP

    if "pod" not in _names(mesh):
        return False
    shape = _mesh_shape(mesh)
    bytes_per_param = 2 + 2 + 2 * (4 if state_dtype == "float32" else 2)
    pod_devices = shape["data"] * shape["model"]
    return cfg.param_count() * bytes_per_param > 0.25 * pod_devices * HBM_PER_CHIP


def _stand_ins(shapes: Any, shardings: Any, device: str) -> Any:
    """This rank's fake shards: one empty tensor per leaf at its sharding's
    local shape (call inside the cell's FakeTensorMode)."""
    return tree.map(lambda t, sh: torch.empty(sh.shard_shape(tuple(t.shape)), dtype=t.dtype,
                                              device=device), shapes, shardings)


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def build_cell(arch: str, shape_name: str, mesh, *, device: str = "cuda",
               cfg: ModelConfig | None = None, shape: ShapeSpec | None = None,
               opt_cfg: OptConfig | None = None,
               microbatches: int | None = None) -> Cell:
    """The cell of ``arch`` at ``shape_name`` on ``mesh`` (a ``DeviceMesh``
    over a fake world), its stand-ins fake ``device`` tensors.  ``cfg``,
    ``shape``, ``opt_cfg``, ``microbatches``: run another configuration of
    the same arch (defaults: the published config, ``SHAPES[shape_name]``,
    the overrides' optimizer and microbatches)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if shape.kind == "decode":
        sov = SERVE_OVERRIDES.get(cfg.name, {})
        if sov:
            cfg = dataclasses.replace(cfg, **sov)
    s, b = shape.seq_len, shape.global_batch
    ov = TRAIN_OVERRIDES.get(cfg.name, {})
    state_dtype = ov.get("state_dtype", "float32")
    fsdp_pods = _needs_pod_fsdp(cfg, mesh, state_dtype)
    if fsdp_pods:
        raise NotImplementedError(
            f"{arch} on {_mesh_shape(mesh)} needs its weights sharded over pods, and the "
            f"port's model stack lays them out without (model.param_layout)")
    step_mesh = mesh if mesh.size() > 1 else None
    p_meta = M.init_params(cfg, None, device="meta")
    p_shard = param_shardings(p_meta, mesh, tied_embed=cfg.tie_embeddings)
    tok_sh = token_sharding(mesh, b)
    n_fe = cfg.n_frontend_tokens
    meta = dict(arch=arch, shape=shape_name, kind=shape.kind,
                mesh=_mesh_shape(mesh), fsdp_pods=fsdp_pods)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dtype = getattr(torch, cfg.dtype)
    # a real 0-d CPU tensor: the step's host reads of it (Shampoo's refresh
    # branch) see its value through the fake trace
    zero = torch.zeros((), dtype=torch.int32)

    def tokens(cols: int):
        return torch.zeros((b, cols), dtype=torch.int32, device=device)

    def embeds():
        e_sh = NamedSharding(mesh, (tok_sh.spec[0], None, None))  # global, like the tokens
        return torch.empty((b, n_fe, cfg.d_model), dtype=dtype, device=device), e_sh

    with mode:
        params = _stand_ins(p_meta, p_shard, device)

        if shape.kind == "train":
            if opt_cfg is None:
                opt_cfg = (ShampooConfig(state_dtype=state_dtype,
                                         precond_every=ov.get("precond_every", 20))
                           if ov.get("optimizer") == "shampoo"
                           else OptConfig(state_dtype=state_dtype))
            opt = {**opt_init(params, opt_cfg), "step": zero}
            if isinstance(opt_cfg, ShampooConfig):  # from the whole parameters
                opt["kron"] = _shampoo.kron_state_init(
                    tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                             p_meta), opt_cfg)
            opt_shard = opt_state_shardings(opt, p_shard, _replicated(mesh))
            state = TrainState(params, opt, zero)
            state_sh = TrainState(p_shard, opt_shard, _replicated(mesh))
            batch = {"tokens": tokens(s - n_fe), "labels": tokens(s - n_fe)}
            batch_sh = {"tokens": tok_sh, "labels": tok_sh}
            if n_fe:
                batch["embeds"], batch_sh["embeds"] = embeds()
            mb = microbatches or ov.get("microbatches", DEFAULT_MICROBATCHES)
            # microbatches split each rank's rows: at most one a row
            rows = tok_sh.shard_shape((b, s))[0] if step_mesh is not None else b
            mb_run = min(mb, rows)
            fn = make_train_step(
                cfg, opt_cfg, microbatches=mb_run, with_embeds=bool(n_fe),
                acc_dtype=getattr(torch, ov.get("acc_dtype", "float32")), mesh=step_mesh,
            )
            meta.update(microbatches=mb, state_dtype=state_dtype,
                        optimizer=("shampoo" if isinstance(opt_cfg, ShampooConfig)
                                   else "adamw"),
                        params=cfg.param_count(),
                        params_active=cfg.param_count(active_only=True))
            return Cell(arch, shape, cfg, fn, (state, batch), (state_sh, batch_sh),
                        (state_sh, None), meta, mode, mb_run)

        c_meta = M.init_cache(cfg, b, s, device="meta")
        cache_sh = cache_shardings(c_meta, mesh, b)
        meta.update(params=cfg.param_count())
        if shape.kind == "prefill":
            fn = make_prefill_step(cfg, max_len=s, with_embeds=bool(n_fe), mesh=step_mesh)
            args = [params, tokens(s - n_fe)]
            shards = [p_shard, tok_sh]
            if n_fe:
                e, e_sh = embeds()
                args.append(e)
                shards.append(e_sh)
            return Cell(arch, shape, cfg, fn, tuple(args), tuple(shards),
                        (None, cache_sh), meta, mode)

        # decode: one new token against a seq_len-deep cache
        cache = _stand_ins(c_meta, cache_sh, device)
        fn = make_serve_step(cfg, mesh=step_mesh, cache_shardings=cache_sh)
        return Cell(arch, shape, cfg, fn,
                    (params, cache, tokens(1), zero),
                    (p_shard, cache_sh, tok_sh, _replicated(mesh)),
                    (None, cache_sh), meta, mode)


__all__ = ["build_cell", "Cell", "TRAIN_OVERRIDES", "SERVE_OVERRIDES",
           "DEFAULT_MICROBATCHES"]
