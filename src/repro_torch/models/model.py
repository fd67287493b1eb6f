"""Model assembly: embedding -> (prelude + periodic stack) -> head.

The port of the training half of ``repro.models.model``.  The parameter
tree keeps the reference's stacked layout: ``params["stack"]["pos{k}"]``
holds position ``k`` of the layer period for every period at once, each
leaf with a leading ``n_periods`` dimension (the reference's ``jax.vmap``
init), so leaf paths, shapes and the optimizer's shape groups are the
reference's.  The forward splits each stacked leaf once (``unbind``: its
backward writes the whole leaf's gradient in one ``stack``) and runs the
periods in a Python loop, the reference's ``lax.scan``.  With ``cfg.remat``
each period, and each layer inside it, runs under ``torch.utils.checkpoint``
(the reference's nested ``jax.checkpoint``): only period boundaries live
through the backward pass, and every layer's forward runs once more in it.

Layer kinds: attention with a dense or Kron FFN.  Mamba and MoE layers
(``models/ssm.py``, ``models/moe.py``) and the serving entry points
(``prefill``, ``decode_step``, the caches) come with the serving slice.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from . import attention as attn
from . import ffn as ffn_mod
from .common import embed_init, rms_norm
from .config import LayerSpec, ModelConfig

_NOT_PORTED = ("{what} layers are not ported yet (ROADMAP.md queue 1, the "
               "serving slice: models/moe.py and models/ssm.py)")


def _check_supported(spec: LayerSpec) -> None:
    if spec.kind != "attn":
        raise NotImplementedError(_NOT_PORTED.format(what="Mamba"))
    if spec.moe:
        raise NotImplementedError(_NOT_PORTED.format(what="MoE"))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> dict:
    _check_supported(spec)
    p: dict[str, Any] = {"ln1": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    p["mixer"] = attn.attn_init(generator, cfg, dtype, device=device)
    if cfg.d_ff:
        p["ln2"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
        p["ffn"] = ffn_mod.ffn_init(generator, cfg, dtype, device=device)
    return p


def _stack(trees: list) -> Any:
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading dim (the reference's ``jax.vmap`` of the layer init)."""
    return tree.map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def _unstack(stacked: Any, n: int) -> list:
    """The inverse of ``_stack``: ``n`` trees, one per leading index, from
    one ``unbind`` per leaf (whose backward writes the leaf's whole
    gradient in one ``stack``)."""
    parts = [t.unbind(0) for t in tree.leaves(stacked)]
    return [tree.unflatten_like(stacked, [p[i] for p in parts]) for i in range(n)]


def init_params(
    cfg: ModelConfig, generator: torch.Generator | None, *,
    device: str | torch.device = "cuda",
) -> dict:
    """The parameter tree, drawn from ``generator`` on ``device``
    (``device="meta"`` with ``generator=None`` gives the shapes alone, the
    reference's ``jax.eval_shape``)."""
    dtype = getattr(torch, cfg.dtype)
    plan = cfg.layer_plan()
    params: dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype, device),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(
            generator, cfg.padded_vocab, cfg.d_model, dtype, device).T.contiguous()
    pre = cfg.prelude_len
    params["prelude"] = [
        _layer_init(generator, cfg, plan[i], dtype, device) for i in range(pre)]
    params["stack"] = {
        f"pos{pos}": _stack([
            _layer_init(generator, cfg, plan[pre + pos], dtype, device)
            for _ in range(cfg.n_periods)])
        for pos in range(cfg.period)
    }
    return params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _layer_forward(cfg, spec: LayerSpec, p, x, positions, backend: str = "auto"):
    """Full-sequence layer.  Returns ``(x, aux, kv)``."""
    _check_supported(spec)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, kv = attn.attn_forward(cfg, p["mixer"], h, positions, return_kv=True)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_apply(cfg, p["ffn"], h2, backend=backend)
    return x, aux, kv


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens, embeds):
    x = params["embed"][tokens.long()]  # (B, S, D) gather
    if cfg.embed_scale:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def _head(cfg, params, x):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["lm_head"]
    logits = logits.float()
    # mask padded vocab rows so they never win the softmax
    if cfg.padded_vocab != cfg.vocab:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = torch.where(pad_mask, -1e9, logits)
    return logits


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    embeds: torch.Tensor | None = None,
    *,
    backend: str = "auto",
):
    """Teacher-forced forward.  Returns ``(logits, aux_loss)``: f32 logits
    ``(B, S, padded_vocab)``.  ``backend`` reaches the Kron FFN's
    KronLinears (``"torch"``: the kernels' plain twins)."""
    x = _embed(cfg, params, tokens, embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    plan = cfg.layer_plan()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for i, p_l in enumerate(params["prelude"]):
        x, aux, _ = _layer_forward(cfg, plan[i], p_l, x, positions, backend)
        aux_total = aux_total + aux

    pre, period = cfg.prelude_len, cfg.period
    specs = tuple(plan[pre:pre + period])

    def one_layer(spec, p_l, x):
        y, aux, _ = _layer_forward(cfg, spec, p_l, x, positions, backend)
        return y, aux

    def run(fn, *args):
        # Nested remat: the period is checkpointed (only period boundaries
        # survive the forward) and so is each layer inside it (the period's
        # backward re-materializes one layer at a time). The stack draws no
        # random numbers, so the RNG state is not carried.
        if cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def body(x, p_period):
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos in range(period):
            x, aux = run(one_layer, specs[pos], p_period[f"pos{pos}"], x)
            aux_acc = aux_acc + aux
        return x, aux_acc

    for p_period in _unstack(params["stack"], cfg.n_periods):
        x, aux = run(body, x, p_period)
        aux_total = aux_total + aux
    return _head(cfg, params, x), aux_total


__all__ = ["init_params", "forward"]
