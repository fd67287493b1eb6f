"""Model assembly: embedding -> (prelude + periodic stack) -> head.

The port of ``repro.models.model``.  The parameter tree keeps the
reference's stacked layout: ``params["stack"]["pos{k}"]`` holds position
``k`` of the layer period for every period at once, each leaf with a
leading ``n_periods`` dimension (the reference's ``jax.vmap`` init), so
leaf paths, shapes and the optimizer's shape groups are the reference's.
The forward splits each stacked leaf once (``unbind``: its backward writes
the whole leaf's gradient in one ``stack``) and runs the periods in a
Python loop, the reference's ``lax.scan``.  With ``cfg.remat`` each period,
and each layer inside it, runs under ``torch.utils.checkpoint`` (the
reference's nested ``jax.checkpoint``): only period boundaries live
through the backward pass, and every layer's forward runs once more in it.

Layer kinds: attention or Mamba2 (``models/ssm.py``), each with a dense or
Kron FFN or a MoE block (``models/moe.py``).  Three entry points::

  forward(cfg, params, tokens, embeds=None)        -> (logits, aux)  train
  prefill(cfg, params, tokens, max_len, ...)       -> (logits, cache)
  decode_step(cfg, params, cache, tokens, pos)     -> (logits, cache)

The cache keeps the reference's layout: a list for the prelude (batch on
axis 0) and stacked ``(n_periods, B, ...)`` leaves for the stack (batch on
axis 1).  ``prefill`` and ``decode_step`` run without autograd; a decode
step writes the new entries into the cache's buffers in place (the
reference donates the cache to XLA instead) and returns that cache.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from . import attention as attn
from . import ffn as ffn_mod
from . import moe as moe_mod
from . import ssm
from .common import embed_init, rms_norm
from .config import LayerSpec, ModelConfig


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> dict:
    p: dict[str, Any] = {"ln1": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    if spec.kind == "attn":
        p["mixer"] = attn.attn_init(generator, cfg, dtype, device=device)
    else:
        p["mixer"] = ssm.mamba_init(generator, cfg, dtype, device=device)
    if spec.moe:
        p["ln2"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
        p["ffn"] = moe_mod.moe_init(generator, cfg, dtype, device=device)
    elif cfg.d_ff:
        p["ln2"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
        p["ffn"] = ffn_mod.ffn_init(generator, cfg, dtype, device=device)
    return p


def _stack_init(make, n: int) -> Any:
    """``n`` trees from ``make()``, each leaf stacked on a new leading dim
    (the reference's ``jax.vmap`` of the layer init).  The stacked leaves
    are allocated once and filled a layer at a time, so the peak holds one
    layer beside them, not a second copy of the stack."""
    first = make()
    out = tree.map(lambda l: l.new_empty((n, *l.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make()
        tree.map(lambda dst, src: dst[i].copy_(src), out, layer)
    return out


def _unstack(stacked: Any, n: int) -> list:
    """The inverse of ``_stack_init``: ``n`` trees, one per leading index, from
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
        f"pos{pos}": _stack_init(
            lambda spec=plan[pre + pos]: _layer_init(generator, cfg, spec, dtype, device),
            cfg.n_periods)
        for pos in range(cfg.period)
    }
    return params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _ffn(cfg, spec: LayerSpec, p, x, backend: str):
    """The layer's FFN half (MoE, dense or Kron FFN, or none): ``(x, aux)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, aux = moe_mod.moe_apply(cfg, p["ffn"], h2, backend=backend)
        x = x + y
    elif cfg.d_ff:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_apply(cfg, p["ffn"], h2, backend=backend)
    return x, aux


def _layer_forward(cfg, spec: LayerSpec, p, x, positions, backend: str = "auto"):
    """Full-sequence layer.  Returns ``(x, aux, kv | (conv tail, state))``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        mix, cache_out = attn.attn_forward(cfg, p["mixer"], h, positions, return_kv=True)
    else:
        mix, cache_out = ssm.mamba_forward(cfg, p["mixer"], h, return_state=True)
    x, aux = _ffn(cfg, spec, p, x + mix, backend)
    return x, aux, cache_out


def _layer_decode(cfg, spec: LayerSpec, p, x, cache, pos, backend: str = "auto"):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        mix, cache = attn.attn_decode(cfg, p["mixer"], h, cache, pos)
    else:
        mix, cache = ssm.mamba_decode(cfg, p["mixer"], h, cache)
    x, _ = _ffn(cfg, spec, p, x + mix, backend)
    return x, cache


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


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *, device: str | torch.device = "cuda",
) -> dict:
    """An empty decode cache: one attention or Mamba cache per layer, in the
    parameters' layout (stacked leaves ``(n_periods, B, ...)``)."""
    dtype = getattr(torch, cfg.dtype)
    plan = cfg.layer_plan()

    def one(spec: LayerSpec):
        if spec.kind == "attn":
            return attn.attn_cache_init(cfg, batch, max_len, dtype, device=device)
        return ssm.mamba_cache_init(cfg, batch, dtype, device=device)

    pre, n_periods = cfg.prelude_len, cfg.n_periods
    return {
        "prelude": [one(plan[i]) for i in range(pre)],
        "stack": {
            f"pos{pos}": tree.map(
                lambda l: l[None].repeat(n_periods, *([1] * l.ndim)), one(plan[pre + pos]))
            for pos in range(cfg.period)
        },
    }


# ---------------------------------------------------------------------------
# Slot-form caches (continuous batching)
#
# ``prefill``/``init_cache`` build caches whose attention ``pos`` leaf is
# shared across the batch, shape (L,): every row at the same position.
# Continuous batching mixes requests at different positions in one decode
# batch, so the serving engine converts to "slot form": pos per row, (B, L),
# after which every cache leaf carries the batch on one axis (prelude: axis
# 0; stack: axis 1, behind n_periods) and whole requests move between
# caches by slicing and copying.
# ---------------------------------------------------------------------------


def _is_cache(x) -> bool:
    return isinstance(x, (attn.KVCache, attn.QuantKVCache))


def cache_to_slots(cache: dict, true_lens=None) -> dict:
    """Broadcast shared attention ``pos`` leaves to per-row (B, L), as new
    tensors (the K/V buffers are shared with ``cache``).

    ``true_lens`` (B,) marks each row's real prompt length: a bucketed
    prefill pads every prompt to the bucket, and the pad tokens' K/V land
    in entries with position >= true_len; those are set to pos = -1
    (empty) so no decode step attends to them.  Mamba caches are left as
    they are (the reference masks attention caches only).
    """

    def one(c, stacked: bool):
        if not _is_cache(c):
            return c
        pos = c.pos
        if stacked:  # (n_periods, L) -> (n_periods, B, L)
            b, l = c.k.shape[1], c.k.shape[2]
            if pos.ndim == 2:
                pos = pos[:, None, :].expand(pos.shape[0], b, l)
        else:  # (L,) -> (B, L)
            b, l = c.k.shape[0], c.k.shape[1]
            if pos.ndim == 1:
                pos = pos[None, :].expand(b, l)
        if true_lens is not None:
            tl = torch.as_tensor(true_lens, dtype=torch.int32, device=pos.device)
            keep = pos < (tl[None, :, None] if stacked else tl[:, None])
            pos = torch.where(keep, pos, -1)
        return c._replace(pos=pos.to(torch.int32).contiguous())

    return {
        "prelude": [one(c, False) for c in cache["prelude"]],
        "stack": {k: one(v, True) for k, v in cache["stack"].items()},
    }


def cache_take(cache: dict, row: int) -> dict:
    """One request's rows as a batch-1 slot-form cache: views into
    ``cache`` (slot form, ``cache_to_slots``)."""
    row = int(row)
    return {
        "prelude": tree.map(lambda a: a.narrow(0, row, 1), cache["prelude"]),
        "stack": tree.map(lambda a: a.narrow(1, row, 1), cache["stack"]),
    }


def cache_put(dst: dict, src: dict, slot: int) -> dict:
    """Copy a batch-1 slot-form cache (``cache_take`` of a prefill) into
    decode slot ``slot`` of ``dst``, in place; returns ``dst``.  The
    admission primitive of the continuous-batching engine.  Cache lengths
    L must match (both sides built with the same ``max_len``)."""
    slot = int(slot)
    tree.map(lambda d, s: d.narrow(0, slot, 1).copy_(s), dst["prelude"], src["prelude"])
    tree.map(lambda d, s: d.narrow(1, slot, 1).copy_(s), dst["stack"], src["stack"])
    return dst


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    max_len: int,
    embeds: torch.Tensor | None = None,
    *,
    backend: str = "auto",
):
    """Full-sequence pass that also builds the decode cache.  Returns
    ``(logits (B, S, padded_vocab) f32, cache)``."""
    x = _embed(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    plan = cfg.layer_plan()

    def to_cache(spec: LayerSpec, raw):
        if spec.kind == "attn":
            k, v = raw
            return attn.attn_prefill_cache(cfg, k, v, positions, max_len)
        conv_tail, h = raw
        return ssm.MambaCache(conv=conv_tail.contiguous(), h=h)

    prelude_cache = []
    for i, p_l in enumerate(params["prelude"]):
        x, _, raw = _layer_forward(cfg, plan[i], p_l, x, positions, backend)
        prelude_cache.append(to_cache(plan[i], raw))

    pre, period, n_periods = cfg.prelude_len, cfg.period, cfg.n_periods
    specs = tuple(plan[pre:pre + period])
    stack_cache: dict[str, Any] = {}
    for i, p_period in enumerate(_unstack(params["stack"], n_periods)):
        for pos in range(period):
            x, _, raw = _layer_forward(cfg, specs[pos], p_period[f"pos{pos}"], x, positions,
                                       backend)
            c = to_cache(specs[pos], raw)
            key = f"pos{pos}"
            if key not in stack_cache:  # the stacked leaves, allocated once
                stack_cache[key] = tree.map(lambda l: l.new_empty((n_periods, *l.shape)), c)
            tree.map(lambda dst, src: dst[i].copy_(src), stack_cache[key], c)
    return _head(cfg, params, x), {"prelude": prelude_cache, "stack": stack_cache}


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,   # (B, 1)
    pos,                    # scalar int32, or (B,) per slot (slot-form cache)
    *,
    backend: str = "auto",
):
    """One incremental token.  Returns ``(logits (B, 1, padded_vocab),
    cache)``; ``cache`` is updated in place and returned.

    Scalar ``pos``: all rows at the same position (one-shot serving).
    Vector ``pos`` (B,): each decode slot on its own clock; the cache must
    be in slot form (``cache_to_slots``); see ``attention.attn_decode``.
    ``pos`` may be a Python int or a device tensor; a device tensor keeps
    the step free of host syncs."""
    x = _embed(cfg, params, tokens, None)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    plan = cfg.layer_plan()

    for i, (p_l, c_l) in enumerate(zip(params["prelude"], cache["prelude"])):
        x, _ = _layer_decode(cfg, plan[i], p_l, x, c_l, pos, backend)

    pre, period, n_periods = cfg.prelude_len, cfg.period, cfg.n_periods
    specs = tuple(plan[pre:pre + period])
    # Per-period views of the stacked cache: each layer writes through them.
    for p_period, c_period in zip(_unstack(params["stack"], n_periods),
                                  _unstack(cache["stack"], n_periods)):
        for k in range(period):
            x, _ = _layer_decode(cfg, specs[k], p_period[f"pos{k}"], x,
                                 c_period[f"pos{k}"], pos, backend)
    return _head(cfg, params, x), cache


__all__ = [
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
    "cache_to_slots",
    "cache_take",
    "cache_put",
]
