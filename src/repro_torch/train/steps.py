"""Train / prefill / serve step builders.

The port of ``repro.train.steps``.  ``make_train_step`` returns a
``(state, batch) -> (state, metrics)`` function as the reference's: the
state is a ``TrainState`` of trees, and the update is functional.
``microbatches > 1`` accumulates the gradients over batch slices in a
Python loop (the reference's ``lax.scan``).  ``make_prefill_step`` and
``make_serve_step`` are the serving entry points (``model.prefill`` and
``model.decode_step``); ``prebuild_kron_ops`` resolves the plans of every
serving shape before the first request.
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


def _kron_ffn_specs(cfg: ModelConfig) -> list:
    """The (up, down) ``KronLinearSpec`` pair of every Kron FFN width the
    model runs: ``d_ff`` where a layer has a dense FFN, ``n_shared *
    d_expert`` where a MoE layer has shared experts."""
    from ..core.layers import KronLinearSpec

    plan = cfg.layer_plan()
    widths = []
    if cfg.d_ff and any(not spec.moe for spec in plan):
        widths.append(cfg.d_ff)
    if cfg.moe is not None and cfg.moe.n_shared and any(spec.moe for spec in plan):
        widths.append(cfg.moe.n_shared * cfg.moe.d_expert)
    return [(KronLinearSpec.balanced(cfg.d_model, f, cfg.kron_factors),
             KronLinearSpec.balanced(f, cfg.d_model, cfg.kron_factors))
            for f in dict.fromkeys(widths)]


def prebuild_kron_ops(
    cfg: ModelConfig, *, batch: int | None = None, seq_len: int | None = None,
    mesh=None, prefill_shapes: Sequence[tuple[int, int]] = (),
    decode_batch: int | None = None, opt_cfg: OptConfig | None = None,
) -> tuple:
    """Construct the ``KronOp`` handles behind every Kron-compressed
    projection in ``cfg`` before the first step.

    With ``batch`` and ``seq_len``, the plan of the ``(batch*seq_len)``-row
    problem is resolved here.  ``prefill_shapes``: more ``(batch,
    seq_len)`` pairs (the serving engine prefills each padding bucket at
    its own shape); ``decode_batch``: the decode step's ``(slots, 1)``.
    Each shape gives one op per projection (up and down, for each Kron FFN
    width: the dense FFN's and the shared experts'), its plan resolved
    through the engine's plan memo (``engine._resolve_plan``) under the
    key a call on ``(B, S, d)`` activations of the model's dtype resolves
    at serving time: the op of the call is another object
    (``kron_linear_apply`` asks ``kron_op_for`` without ``m=``), but its
    plan is a memo hit, so a prewarmed shape never plans again.  Without
    shapes the ops are constructed and their plans resolve on first call.
    ``opt_cfg``: with a ``ShampooConfig``, also the optimizer's
    shape-group ops, sized from the parameter shapes (a ``meta``-device
    init).  ``mesh``: also each projection's mesh op (what a
    ``kron_distributed(mesh)`` scope runs), where the mesh can host the
    shape; one with no legal round schedule is skipped (the scope runs it
    local).
    """
    opt_ops: tuple = ()
    if isinstance(opt_cfg, ShampooConfig):
        opt_ops = _shampoo.prewarm(M.init_params(cfg, None, device="meta"), opt_cfg)
    if not getattr(cfg, "kron_ffn", False):
        return opt_ops
    from ..core.engine import kron_op_for

    # The call's key: x.element_size() of the model's dtype.
    dtype_bytes = getattr(torch, cfg.dtype).itemsize
    shapes: list[tuple[int, int]] = []
    if batch is not None and seq_len is not None:
        shapes.append((int(batch), int(seq_len)))
    shapes.extend((int(b), int(s)) for b, s in prefill_shapes)
    if decode_batch is not None:
        shapes.append((int(decode_batch), 1))
    ops = []
    for pair in _kron_ffn_specs(cfg):
        for spec in pair:
            for b, s in dict.fromkeys(shapes):
                # (B, S, d) folds into B*S rows: that plan, resolved now
                ops.append(kron_op_for(spec.ps, spec.qs, m=s, batch=b,
                                       shared_factors=True, dtype_bytes=dtype_bytes))
            if not shapes:
                ops.append(kron_op_for(spec.ps, spec.qs))
            if mesh is not None:
                try:
                    ops.append(kron_op_for(spec.ps, spec.qs, mesh=mesh))
                except ValueError:
                    pass  # no legal round schedule: the scope runs it local
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


def make_prefill_step(cfg: ModelConfig, max_len: int, *, with_embeds: bool = False):
    """``prefill_step(params, tokens, embeds=None) -> (logits, cache)``."""

    def prefill_step(params, tokens, embeds=None):
        return M.prefill(cfg, params, tokens, max_len, embeds if with_embeds else None)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, tokens (B,1), pos) -> (next_token_logits,
    cache)``; the cache is updated in place (``model.decode_step``)."""

    def serve_step(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos)

    return serve_step


__all__ = [
    "TrainState",
    "train_state_init",
    "prebuild_kron_ops",
    "loss_fn",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]
