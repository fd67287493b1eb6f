"""AdamW with a cosine schedule, global-norm clipping, a configurable state
dtype and gradient compression with error feedback.

The port of ``repro.optim.adamw``.  Parameters and states are trees of
tensors (``repro_torch.tree``); ``m``/``v`` mirror the parameter tree.  The
update is functional, as the reference's: it returns new trees and leaves
its arguments as they were.  Parameters stay in their own dtype with no
master copy: each update is computed in f32 and cast back.

The step counter is a 0-d int32 tensor on the host: the schedule and
Shampoo's refresh cadence read it without waiting for the device, and a
0-d CPU tensor combines with CUDA tensors as a scalar.

Gradient compression (``compress="bf16"|"int8"``) quantizes the gradients
with a persistent error-feedback residual, as the reference does after its
reduction.

On a mesh the trees hold this rank's shards and ``shardings`` (the
parameters' ``NamedSharding`` tree) says how: the update is elementwise,
so it runs on the shards as they are, and the two whole-tree reductions
(the global norm, the int8 scale) are summed, or maxed, over the mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .. import tree
from ..runtime import sharding as S


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"
    compress: str | None = None        # None | "bf16" | "int8"


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), as an f32
    tensor on the step's device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def opt_init(params: Any, cfg: OptConfig) -> dict:
    sd = getattr(torch, cfg.state_dtype)
    state = {
        "m": tree.map(lambda p: torch.zeros(p.shape, dtype=sd, device=p.device), params),
        "v": tree.map(lambda p: torch.zeros(p.shape, dtype=sd, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32),
    }
    if cfg.compress:
        state["err"] = tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


def _sharded_axes(sh) -> tuple[str, ...]:
    """The mesh axes a leaf's sharding splits it over."""
    return tuple(a for e in sh.spec for a in S._entry_axes(e))


def _quantize(g: torch.Tensor, mode: str, sh=None) -> torch.Tensor:
    if mode == "bf16":
        return g.to(torch.bfloat16).float()
    if mode == "int8":
        amax = g.abs().max()
        if sh is not None:  # the whole leaf's max, over its shards
            S._all_reduce(amax, sh.mesh, _sharded_axes(sh), op=torch.distributed.ReduceOp.MAX)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127)
        return q * scale
    raise ValueError(mode)


def global_norm(t: Any, shardings: Any = None) -> torch.Tensor:
    """The tree's L2 norm; with ``shardings``, of the whole tree its shards
    on this rank belong to (each leaf's square sum divided among the ranks
    that hold the same shard, then summed over the mesh)."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree.leaves(t)))
    total, mesh = None, None
    for leaf, sh in zip(tree.leaves(t), tree.leaves(shardings)):
        mesh = sh.mesh
        copies = mesh.size() // S._size(mesh, _sharded_axes(sh))
        part = torch.sum(torch.square(leaf.float())) / copies
        total = part if total is None else total + part
    S._all_reduce(total, mesh, S._names(mesh))
    return torch.sqrt(total)


def _compressed(grads: Any, state: dict, cfg: OptConfig, shardings: Any = None):
    """``(grads, err, gnorm, scale)``: the gradients, compressed with error
    feedback (in f32) when ``cfg.compress`` says so; the new residual; their
    global norm; the clipping factor.  Each leaf is taken to f32 and scaled
    where the update reads it (``_clipped``), so no f32 copy of the whole
    gradient tree is made without compression."""
    if cfg.compress:
        compensated = tree.map(lambda g, e: g.float() + e, grads, state["err"])
        if shardings is None:
            quant = tree.map(lambda g: _quantize(g, cfg.compress), compensated)
        else:
            quant = tree.map(lambda g, sh: _quantize(g, cfg.compress, sh), compensated,
                             shardings)
        new_err = tree.map(lambda c, q: c - q, compensated, quant)
        grads = quant
    else:
        new_err = state.get("err")
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return grads, new_err, gnorm, scale


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return g.float() * scale


def _moments(g, m, v, b1: float, b2: float):
    return m.float() * b1 + g * (1 - b1), v.float() * b2 + g * g * (1 - b2)


def _apply(p: torch.Tensor, u: torch.Tensor, lr, cfg: OptConfig) -> torch.Tensor:
    if p.ndim >= 2:  # decay matrices only (standard: skip norms/bias)
        u = u + cfg.weight_decay * p.float()
    return (p.float() - lr * u).to(p.dtype)


@torch.no_grad()
def opt_update(
    grads: Any, state: dict, params: Any, cfg: OptConfig, *, shardings: Any = None,
) -> tuple[Any, dict, dict]:
    """Returns ``(new_params, new_state, metrics)``.  ``shardings``: the
    parameters' ``NamedSharding`` tree when the trees hold shards."""
    grads, new_err, gnorm, scale = _compressed(grads, state, cfg, shardings)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    sd = getattr(torch, cfg.state_dtype)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state["m"]), tree.leaves(state["v"])):
        g = _clipped(g, scale)
        m32, v32 = _moments(g, m, v, b1, b2)
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        new_p.append(_apply(p, u, lr, cfg))
        new_m.append(m32.to(sd))
        new_v.append(v32.to(sd))

    new_state = {
        "m": tree.unflatten_like(params, new_m),
        "v": tree.unflatten_like(params, new_v),
        "step": step,
    }
    if cfg.compress:
        new_state["err"] = new_err
    metrics = {"grad_norm": gnorm, "lr": lr}
    return tree.unflatten_like(params, new_p), new_state, metrics


__all__ = ["OptConfig", "opt_init", "opt_update", "lr_at", "global_norm"]
