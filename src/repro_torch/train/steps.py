"""Train / prefill / serve step builders.

The port of ``repro.train.steps``.  ``make_train_step`` returns a
``(state, batch) -> (state, metrics)`` function as the reference's: the
state is a ``TrainState`` of trees, and the update is functional.
``microbatches > 1`` accumulates the gradients over batch slices in a
Python loop (the reference's ``lax.scan``).  ``make_prefill_step`` and
``make_serve_step`` are the serving entry points (``model.prefill`` and
``model.decode_step``); ``prebuild_kron_ops`` resolves the plans of every
serving shape before the first request.

On a mesh (``make_train_step(..., mesh=)``, or an ambient
``sharding.use_mesh``) the step is explicit SPMD: the state holds this
rank's shards (``train_state_init(mesh=)``; the parameters by
``model.param_layout``, the optimizer state by ``opt_state_shardings``),
the batch is the global batch, of which the step takes its rows by
``token_sharding`` (``data.pipeline.rank_rows``), and every gradient comes
back as this rank's shard of the global gradient (``sharding.param_view``),
which ``constrain_like_params`` checks.  The loss is the global batch's:
each rank adds its rows' part, and the vocabulary-split cross-entropy sums
its softmax over the model axis.  ``microbatches`` split each rank's own
rows, so a MoE model's aux loss is taken over a rank's microbatch rather
than over the global one.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Sequence

import torch

from .. import tree
from ..data.pipeline import rank_rows
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import shampoo as _shampoo
from ..optim.adamw import OptConfig, opt_init
from ..optim.shampoo import ShampooConfig, opt_for
from ..runtime import sharding as S


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
    device: str | torch.device = "cuda", mesh=None,
) -> TrainState:
    """The initial state.  ``mesh``: this rank's shards of it (every rank
    draws the same parameters from ``generator``, keeps its shards, and
    makes its optimizer state at their shapes; Shampoo's ``kron`` subtree
    whole, from the whole parameters), never the whole optimizer state."""
    params = M.init_params(cfg, generator, device=device)
    init_fn, _ = opt_for(opt_cfg)
    step = torch.zeros((), dtype=torch.int32)
    if mesh is None:
        return TrainState(params, init_fn(params, opt_cfg), step)
    local = tree.map(S.local_shard, params, M.param_layout(cfg, mesh))
    opt = opt_init(local, opt_cfg)
    if isinstance(opt_cfg, ShampooConfig):
        opt["kron"] = _shampoo.kron_state_init(params, opt_cfg)
    return TrainState(local, opt, step)


def opt_state_shardings(opt_state: Any, param_shardings: Any, replicated) -> Any:
    """Shardings for an optimizer-state tree: ``m``/``v``/``err`` mirror the
    parameter shardings (FSDP'd parameters give ZeRO-3 partitioned state),
    everything else (``step``, Shampoo's ``kron`` statistics subtree) is
    replicated: the kron subtree is ``O(p^2 + q^2)`` per layer, small next
    to the ``p*q`` parameters it preconditions."""
    out = {}
    for key in opt_state:
        if key in ("m", "v", "err"):
            out[key] = param_shardings
        else:
            out[key] = tree.map(lambda _: replicated, opt_state[key])
    return out


def state_shardings(state: TrainState, cfg: ModelConfig, mesh) -> dict:
    """The ``NamedSharding`` tree of a ``TrainState``'s ``_asdict()`` (what
    ``CheckpointManager.save``/``restore`` take on a mesh; ``local_shard``
    by it cuts a whole state to this rank's)."""
    p_sh = M.param_layout(cfg, mesh)
    rep = S.NamedSharding(mesh, ())
    return {"params": p_sh, "opt": opt_state_shardings(state.opt, p_sh, rep), "step": rep}


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor, split: bool) -> torch.Tensor:
    """The summed token NLL.  ``split``: the logits are this rank's columns
    of a vocabulary split over the model axis, whose log-sum-exp and label
    logit are summed over the axis."""
    labels = labels.long()
    n_cols = logits.shape[-1]
    if not split:
        ll = torch.log_softmax(logits, dim=-1)
        return -ll.gather(-1, labels[..., None]).sum()
    first = S.tp_rank() * n_cols
    with torch.no_grad():  # the shift: the max over every rank's columns
        m = torch.zeros((S.tp_size(), *logits.shape[:-1]), dtype=logits.dtype,
                        device=logits.device)
        m[S.tp_rank()] = logits.amax(dim=-1)
        m = S.reduce_tp(m).amax(dim=0)
    sumexp = S.reduce_tp(torch.exp(logits - m[..., None]).sum(dim=-1))
    idx = labels - first
    mine = (idx >= 0) & (idx < n_cols)
    picked = logits.gather(-1, idx.clamp(0, n_cols - 1)[..., None])[..., 0]
    target = S.reduce_tp(torch.where(mine, picked, torch.zeros((), dtype=picked.dtype,
                                                                 device=picked.device)))
    return (torch.log(sumexp) + m - target).sum()


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
    """CE loss + MoE aux.  Inside ``sharding.use_mesh`` ``tokens`` are this
    rank's rows and its loss is its rows' part of the global batch's (the
    parts add up over the batch axes)."""
    logits, aux = M.forward(cfg, params, tokens, embeds, backend=backend)
    n_fe = cfg.n_frontend_tokens if embeds is not None else 0
    logits = logits[:, n_fe:, :]
    n_tok = labels.numel() * S.batch_shards()
    nll = _nll_sum(logits, labels, M.logits_split(cfg, S.ambient_mesh())) / n_tok
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptConfig,
    *,
    microbatches: int = 1,
    with_embeds: bool = False,
    acc_dtype: torch.dtype = torch.float32,
    backend: str = "auto",
    mesh=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: dict(tokens (B,S), labels (B,S)[, embeds (B,n_fe,D)]).
    ``acc_dtype``: the gradient accumulator's dtype over microbatches.
    ``backend`` reaches every KronOp of the step, the model's and
    Shampoo's (``"torch"``: the kernels' plain twins).  ``mesh`` (default:
    the ambient mesh): the state holds this rank's shards
    (``train_state_init(mesh=)``) and the batch is the global batch.
    """
    mesh = S.ambient_mesh() if mesh is None else mesh
    prebuild_kron_ops(cfg, opt_cfg=opt_cfg)
    _, update_fn = opt_for(opt_cfg)
    if isinstance(opt_cfg, ShampooConfig):
        update_fn = functools.partial(update_fn, backend=backend)
    p_sh = None
    if mesh is not None:
        p_sh = M.param_layout(cfg, mesh)
        update_fn = functools.partial(update_fn, shardings=p_sh)

    def grads_of(params, tokens, labels, embeds):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(cfg, tree.unflatten_like(params, leaves), tokens, labels,
                                  embeds, backend=backend)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        parts = {k: v.detach() for k, v in parts.items()}
        loss = loss.detach()
        if mesh is not None:  # the global batch's loss: every rank's part
            nll_local = parts["nll"]
            parts["nll"] = S.batch_sum(nll_local)
            loss = loss - nll_local + parts["nll"]
        return loss, parts, S.constrain_like_params(
            tree.unflatten_like(params, grads), p_sh)

    def train_step(state: TrainState, batch: dict):
        if mesh is None:
            return _step(state, batch)
        rows = S.token_sharding(mesh, batch["tokens"].shape[0])
        local = {k: rank_rows(v, rows) for k, v in batch.items()}
        with S.use_mesh(mesh, batch_axes=S._entry_axes(rows.spec[0])):
            return _step(state, local)

    def _step(state: TrainState, batch: dict):
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


def _serving_rows(mesh, batch: int):
    """(this rank's rows of a global serving batch, the mesh axes that cut
    them) by ``token_sharding``."""
    rows = S.token_sharding(mesh, batch)
    return rows, S._entry_axes(rows.spec[0])


def make_prefill_step(cfg: ModelConfig, max_len: int, *, with_embeds: bool = False,
                      mesh=None):
    """``prefill_step(params, tokens, embeds=None) -> (logits, cache)``.

    ``mesh``: ``params`` are this rank's shards (``model.param_layout``),
    ``tokens`` (and ``embeds``) the global batch, of which the step serves
    this rank's rows; it returns those rows' logits (this rank's vocabulary
    columns where the head splits them) and this rank's shards of the
    cache by ``cache_shardings``."""

    def prefill_step(params, tokens, embeds=None):
        embeds = embeds if with_embeds else None
        if mesh is None:
            return M.prefill(cfg, params, tokens, max_len, embeds)
        b = tokens.shape[0]
        rows, axes = _serving_rows(mesh, b)
        cache_sh = S.cache_shardings(M.init_cache(cfg, b, max_len, device="meta"), mesh, b)
        with S.use_mesh(mesh, batch_axes=axes):
            return M.prefill_on_mesh(cfg, params, rank_rows(tokens, rows), max_len,
                                     None if embeds is None else rank_rows(embeds, rows),
                                     cache_shardings=cache_sh)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None, cache_shardings: Any = None):
    """``serve_step(params, cache, tokens (B,1), pos) -> (next_token_logits,
    cache)``; the cache is updated in place (``model.decode_step``).

    ``mesh``: ``params`` and ``cache`` are this rank's shards (the cache's
    by ``cache_shardings``, the global cache's ``sharding.cache_shardings``),
    ``tokens`` the global batch, of which the step serves this rank's
    rows."""
    if mesh is not None and cache_shardings is None:
        raise ValueError("a serve step on a mesh needs the cache's cache_shardings")

    def serve_step(params, cache, tokens, pos):
        if mesh is None:
            return M.decode_step(cfg, params, cache, tokens, pos)
        rows, axes = _serving_rows(mesh, tokens.shape[0])
        with S.use_mesh(mesh, batch_axes=axes):
            return M.decode_step_on_mesh(cfg, params, cache, rank_rows(tokens, rows), pos,
                                         cache_shardings=cache_shardings)

    return serve_step


__all__ = [
    "TrainState",
    "train_state_init",
    "prebuild_kron_ops",
    "loss_fn",
    "opt_state_shardings",
    "state_shardings",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step",
]
