"""The train step: CE loss + MoE aux, gradients, the optimizer update.

The port of the training half of ``repro.train.steps``.  ``make_train_step``
returns a ``(state, batch) -> (state, metrics)`` function as the
reference's: the state is a ``TrainState`` of trees, and the update is
functional.  ``microbatches > 1`` accumulates the gradients over batch
slices in a Python loop (the reference's ``lax.scan``).  The serving steps
(``make_prefill_step``, ``make_serve_step``) come with the serving slice.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Sequence

import torch

from .. import tree
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import shampoo as _shampoo
from ..optim.adamw import OptConfig
from ..optim.shampoo import ShampooConfig, opt_for


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def prebuild_kron_ops(
    cfg: ModelConfig, *, batch: int | None = None, seq_len: int | None = None,
    mesh=None, prefill_shapes: Sequence[tuple[int, int]] = (),
    decode_batch: int | None = None, opt_cfg: OptConfig | None = None,
) -> tuple:
    """Construct the ``KronOp`` handles behind every Kron-compressed
    projection in ``cfg`` before the first step; with ``batch`` and
    ``seq_len``, resolve the plan of the ``(batch*seq_len)``-row problem too.
    ``opt_cfg``: with a ``ShampooConfig``, also the optimizer's shape-group
    ops, sized from the parameter shapes (a ``meta``-device init).

    ``mesh`` belongs to the mesh slice and ``prefill_shapes``/
    ``decode_batch`` to the serving slice (ROADMAP.md queue 1): they raise.
    """
    if mesh is not None:
        raise NotImplementedError("prebuild_kron_ops(mesh=...): the mesh is not ported "
                                  "yet (ROADMAP.md queue 1)")
    if prefill_shapes or decode_batch is not None:
        raise NotImplementedError("prebuild_kron_ops(prefill_shapes=, decode_batch=): "
                                  "serving is not ported yet (ROADMAP.md queue 1)")
    opt_ops: tuple = ()
    if isinstance(opt_cfg, ShampooConfig):
        opt_ops = _shampoo.prewarm(M.init_params(cfg, None, device="meta"), opt_cfg)
    if not getattr(cfg, "kron_ffn", False):
        return opt_ops
    from ..core.engine import kron_op_for
    from ..core.layers import KronLinearSpec

    dtype_bytes = {"bfloat16": 2, "float16": 2, "float64": 8}.get(
        str(getattr(cfg, "dtype", "float32")), 4)
    up = KronLinearSpec.balanced(cfg.d_model, cfg.d_ff, cfg.kron_factors)
    down = KronLinearSpec.balanced(cfg.d_ff, cfg.d_model, cfg.kron_factors)
    ops = []
    for spec in (up, down):
        if batch is not None and seq_len is not None:
            ops.append(kron_op_for(spec.ps, spec.qs, m=int(seq_len), batch=int(batch),
                                   shared_factors=True, dtype_bytes=dtype_bytes))
        else:
            ops.append(kron_op_for(spec.ps, spec.qs))
    return tuple(ops) + opt_ops


def train_state_init(
    cfg: ModelConfig, opt_cfg: OptConfig, generator: torch.Generator | None, *,
    device: str | torch.device = "cuda",
) -> TrainState:
    params = M.init_params(cfg, generator, device=device)
    init_fn, _ = opt_for(opt_cfg)
    return TrainState(params, init_fn(params, opt_cfg), torch.zeros((), dtype=torch.int32))


def loss_fn(
    cfg: ModelConfig,
    params: Any,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    embeds: torch.Tensor | None = None,
    aux_weight: float = 0.01,
    *,
    backend: str = "auto",
):
    logits, aux = M.forward(cfg, params, tokens, embeds, backend=backend)
    n_fe = cfg.n_frontend_tokens if embeds is not None else 0
    logits = logits[:, n_fe:, :]
    ll = torch.log_softmax(logits, dim=-1)
    nll = -ll.gather(-1, labels.long()[..., None]).mean()
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    *,
    microbatches: int = 1,
    with_embeds: bool = False,
    acc_dtype: torch.dtype = torch.float32,
    backend: str = "auto",
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: dict(tokens (B,S), labels (B,S)[, embeds (B,n_fe,D)]).
    ``acc_dtype``: the gradient accumulator's dtype over microbatches.
    ``backend`` reaches every KronOp of the step, the model's and
    Shampoo's (``"torch"``: the kernels' plain twins).
    """
    prebuild_kron_ops(cfg, opt_cfg=opt_cfg)
    _, update_fn = opt_for(opt_cfg)
    if isinstance(opt_cfg, ShampooConfig):
        update_fn = functools.partial(update_fn, backend=backend)

    def grads_of(params, tokens, labels, embeds):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(cfg, tree.unflatten_like(params, leaves), tokens, labels,
                                  embeds, backend=backend)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        parts = {k: v.detach() for k, v in parts.items()}
        return loss.detach(), parts, tree.unflatten_like(params, grads)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        tokens, labels = batch["tokens"], batch["labels"]
        embeds = batch.get("embeds") if with_embeds else None

        if microbatches == 1:
            loss, parts, grads = grads_of(params, tokens, labels, embeds)
        else:
            mb = tokens.shape[0] // microbatches
            grads = tree.map(lambda p: torch.zeros(p.shape, dtype=acc_dtype, device=p.device),
                             params)
            loss = 0.0
            for k in range(microbatches):
                sl = slice(k * mb, (k + 1) * mb)
                l_k, _, g_k = grads_of(params, tokens[sl], labels[sl],
                                       embeds[sl] if embeds is not None else None)
                grads = tree.map(lambda a, g: a + g.to(a.dtype), grads, g_k)
                loss = loss + l_k
            grads = tree.map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            parts = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                     device=loss.device)}

        new_params, new_opt, opt_metrics = update_fn(grads, state.opt, params, opt_cfg)
        metrics = {"loss": loss, **parts, **opt_metrics}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


__all__ = [
    "TrainState",
    "train_state_init",
    "prebuild_kron_ops",
    "loss_fn",
    "make_train_step",
]
