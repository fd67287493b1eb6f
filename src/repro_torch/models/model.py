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

On a mesh (``forward`` inside ``sharding.use_mesh``) the parameters are
this rank's shards by ``param_layout`` and the tokens its rows of the
batch.  Each layer reads its parameters through ``sharding.param_view``
inside the layer's checkpoint, so the gathered copies are not kept for the
backward pass.  The reference's constraint sites move the activations:
the embedding is a masked lookup in this rank's vocabulary rows summed over
the model axis, the period boundaries (the remat carry) are kept
d_model-sharded over the model axis and gathered at the next period's
start, and the head gives this rank's vocabulary columns of the logits.
Which sites run tensor-parallel is decided once per layer from its
parameters' shardings (``_tp_layout``, a ``LayerTP``) and passed to the
attention, FFN and MoE code, which do not infer it from shapes.

``prefill`` and ``decode_step`` serve on one device.  Their mesh forms,
``prefill_on_mesh`` and ``decode_step_on_mesh`` (inside
``sharding.use_mesh``), serve this rank's rows with no tensor-parallel
site: each layer reads its parameters whole (``_serve_views``, gathered for
that layer) and, in a decode step, its cache gathered over every sharded
dim but the rows (``sharding.cache_view``), then writes its shards of the
updated cache back (``cache_write``); ``prefill_on_mesh`` returns this
rank's shards of the cache (``cache_cut``).  The dry-run's serving cells
run these steps.  This layout gathers every layer's weights and caches
each step, which the reference's partitioner does not: the serving cells'
collective term measures this layout, not tensor-parallel serving.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..runtime import sharding as S
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


@functools.lru_cache(maxsize=16)
def param_layout(cfg: ModelConfig, mesh) -> dict:
    """The parameters' ``NamedSharding`` tree on ``mesh`` (the reference's
    ``param_shardings`` of the ``eval_shape`` of the init)."""
    return S.param_shardings(init_params(cfg, None, device="meta"), mesh,
                             tied_embed=cfg.tie_embeddings)


class LayerTP(NamedTuple):
    """A layer's tensor-parallel layout on the mesh, decided once from its
    parameters' shardings (``_tp_layout``); every site off outside a mesh."""

    heads: bool = False         # attention: this rank's q heads (wq's columns, wo's rows, bq)
    ffn: bool = False           # dense FFN or the MoE's shared experts: d_ff columns and rows
    experts: str | None = None  # MoE: "ep" this rank's experts, "tp" its d_expert slice


_NO_TP = LayerTP()


def _tp_layout(cfg, spec: LayerSpec, sh) -> LayerTP:
    """Which of the layer's sites run tensor-parallel: a site whose weights
    the rules cut over the model axis (``sharding.tp_dim``), and attention
    only where the heads divide (else context parallelism, on whole
    weights)."""
    if sh is None:
        return _NO_TP
    heads = (spec.kind == "attn" and not attn._use_context_parallel(cfg)
             and S.tp_dim(sh["mixer"]["wq"]) is not None)
    f = sh.get("ffn")  # None in a layer with no FFN
    dense = None if f is None or cfg.kron_ffn else f.get("shared") if spec.moe else f
    ffn = dense is not None and S.tp_dim(dense["w1"]) is not None
    experts = None
    if spec.moe:
        d = S.tp_dim(f["ew1"])
        experts = None if d is None else "ep" if d == len(f["ew1"].spec) - 3 else "tp"
    return LayerTP(heads, ffn, experts)


def _keeps_tp(path: str, lt: LayerTP) -> bool:
    """Whether a layer's leaf enters its site as this rank's model-axis chunk."""
    head, _, last = path.rpartition("/")
    if head == "mixer":
        return lt.heads and last in ("wq", "wo", "bq")
    if head in ("ffn", "ffn/shared"):
        return (lt.ffn and last in ("w1", "w2", "w3")) or (
            lt.experts is not None and last in ("ew1", "ew2", "ew3"))
    return False


def _views(cfg, spec: LayerSpec, p, sh) -> tuple[Any, LayerTP]:
    """The tensors a layer reads for its parameter shards ``p`` (their
    shardings ``sh``; None off the mesh), and the layer's ``LayerTP``.  A
    head-parallel layer whose ``bq`` the rules keep whole reads its heads'
    part of it."""
    if sh is None:
        return p, _NO_TP
    lt = _tp_layout(cfg, spec, sh)
    out = []
    for (path, leaf), s in zip(tree.leaves_with_path(p), tree.leaves(sh)):
        keep = _keeps_tp(path, lt)
        view = S.param_view(leaf, s, keep_tp=keep)
        if keep and path == "mixer/bq" and S.tp_dim(s) is None:
            n = view.shape[0] // S.tp_size()
            view = S.tp_pick(view, 0, range(S.tp_rank() * n, (S.tp_rank() + 1) * n))
        out.append(view)
    return tree.unflatten_like(p, out), lt


def _unstack_sharded(stacked: Any, sh: Any, n: int) -> tuple[list, Any]:
    """``_unstack`` of stacked shards, and the per-period shardings.  A leaf
    whose stacked dim is itself sharded (a stacked vector, which the rules
    shard as a matrix) is gathered whole here, once, and reads as it is
    (``VIEW``); the others are unbound locally and viewed layer by layer."""
    leaves, shs = [], []
    for leaf, s in zip(tree.leaves(stacked), tree.leaves(sh)):
        if s.spec and s.spec[0] is not None:
            leaves.append(S.param_view(leaf, s))
            shs.append(S.VIEW)
        else:
            leaves.append(leaf)
            shs.append(S.NamedSharding(s.mesh, tuple(s.spec[1:]), tuple(s.shape[1:])))
    parts = [t.unbind(0) for t in leaves]
    periods = [tree.unflatten_like(stacked, [p[i] for p in parts]) for i in range(n)]
    return periods, tree.unflatten_like(stacked, shs)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _ffn(cfg, spec: LayerSpec, p, x, backend: str, lt: LayerTP = _NO_TP):
    """The layer's FFN half (MoE, dense or Kron FFN, or none): ``(x, aux)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, aux = moe_mod.moe_apply(cfg, p["ffn"], h2, backend=backend,
                                   experts=lt.experts, shared_tp=lt.ffn)
        x = x + y
    elif cfg.d_ff:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_apply(cfg, p["ffn"], h2, backend=backend, tp=lt.ffn)
    return x, aux


def _layer_forward(cfg, spec: LayerSpec, p, x, positions, backend: str = "auto",
                   lt: LayerTP = _NO_TP):
    """Full-sequence layer.  Returns ``(x, aux, kv | (conv tail, state))``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        mix, cache_out = attn.attn_forward(cfg, p["mixer"], h, positions, return_kv=True,
                                           tp=lt.heads)
    else:
        mix, cache_out = ssm.mamba_forward(cfg, p["mixer"], h, return_state=True)
    x, aux = _ffn(cfg, spec, p, x + mix, backend, lt)
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


def _vocab_split(sh, name: str) -> bool:
    """Whether the rules cut the vocabulary of table ``name`` (``embed`` or
    ``lm_head``) over the model axis (``sh``: the parameters' shardings)."""
    return sh is not None and S.tp_dim(sh[name]) is not None


def logits_split(cfg: ModelConfig, mesh) -> bool:
    """Whether ``forward`` on ``mesh`` gives this rank's columns of the
    padded vocabulary, not all of them."""
    return mesh is not None and _vocab_split(
        param_layout(cfg, mesh), "embed" if cfg.tie_embeddings else "lm_head")


def _vocab_rows(table, tokens, split: bool):
    """Rows of an embedding table; ``split``: ``table`` is this rank's rows
    of a vocabulary split over the model axis, read by a masked local
    gather and one sum of the ``(B, S, D)`` result over the axis."""
    if not split:
        return table[tokens.long()]  # (B, S, D) gather
    idx = tokens.long() - S.tp_rank() * table.shape[0]
    mine = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return S.reduce_tp(torch.where(mine[..., None], rows, zero))


def _embed(cfg, params, tokens, embeds, sh=None):
    table = params["embed"] if sh is None else S.param_view(
        params["embed"], sh["embed"], keep_tp=True)
    x = _vocab_rows(table, tokens, _vocab_split(sh, "embed"))
    if cfg.embed_scale:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return S.constrain(x, "batch", None, None)


def _head(cfg, params, x, sh=None):
    """f32 logits; on a mesh this rank's columns of the padded vocabulary
    where the head's vocabulary is split over the model axis (the
    reference's ``("batch", None, "tp")`` logits)."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    split = _vocab_split(sh, name)

    def view(leaf):
        return params[leaf] if sh is None else S.param_view(
            params[leaf], sh[leaf], keep_tp=leaf != "final_norm")

    h = rms_norm(x, view("final_norm"), cfg.norm_eps)
    w = view("embed").T if cfg.tie_embeddings else view("lm_head")  # (D, V or V/tp)
    n_cols = w.shape[1]
    if split:  # column-parallel: each rank adds to dh
        h = S.tp_partial_grad(h)
    logits = (h @ w).float()
    # mask padded vocab rows so they never win the softmax
    if cfg.padded_vocab != cfg.vocab:
        first = S.tp_rank() * n_cols if split else 0
        pad_mask = torch.arange(first, first + n_cols, device=logits.device) >= cfg.vocab
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
    KronLinears (``"torch"``: the kernels' plain twins).

    Inside ``sharding.use_mesh``: ``params`` are this rank's shards
    (``param_layout``), ``tokens`` its rows, and the logits its columns of
    the padded vocabulary where the head splits it over the model axis."""
    mesh = S.ambient_mesh()
    sh = param_layout(cfg, mesh) if mesh is not None else None
    x = _embed(cfg, params, tokens, embeds, sh)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    plan = cfg.layer_plan()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for i, p_l in enumerate(params["prelude"]):
        p_v, lt = _views(cfg, plan[i], p_l, None if sh is None else sh["prelude"][i])
        x, aux, _ = _layer_forward(cfg, plan[i], p_v, x, positions, backend, lt)
        aux_total = aux_total + aux

    pre, period = cfg.prelude_len, cfg.period
    specs = tuple(plan[pre:pre + period])

    def one_layer(spec, p_l, sh_l, x):
        p_v, lt = _views(cfg, spec, p_l, sh_l)
        y, aux, _ = _layer_forward(cfg, spec, p_v, x, positions, backend, lt)
        return y, aux

    def run(fn, *args):
        # Nested remat: the period is checkpointed (only period boundaries
        # survive the forward) and so is each layer inside it (the period's
        # backward re-materializes one layer at a time). The stack draws no
        # random numbers, so the RNG state is not carried.
        if cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    if sh is None:
        periods, sh_period = _unstack(params["stack"], cfg.n_periods), None
    else:
        periods, sh_period = _unstack_sharded(params["stack"], sh["stack"], cfg.n_periods)

    def body(x, p_period):
        # The period boundaries (the remat carry, all live through the
        # backward pass) are stored d_model-sharded over the model axis, as
        # the reference pins them ("batch", None, "tp"): one gather of
        # (B, S, D) per period and direction.
        if x.shape[-1] != cfg.d_model:
            x = S.tp_join(x, -1)
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos in range(period):
            key = f"pos{pos}"
            x, aux = run(one_layer, specs[pos], p_period[key],
                         None if sh_period is None else sh_period[key], x)
            aux_acc = aux_acc + aux
        return S.constrain(x, "batch", None, "tp"), aux_acc

    x = S.constrain(x, "batch", None, "tp")
    for p_period in periods:
        x, aux = run(body, x, p_period)
        aux_total = aux_total + aux
    if x.shape[-1] != cfg.d_model:
        x = S.tp_join(x, -1)
    return _head(cfg, params, x, sh), aux_total


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


def _serve_views(p, sh):
    """A serving layer's parameters on the ambient mesh: every leaf whole
    (``param_view``, gathered over its sharded mesh dims).  Serving runs no
    tensor-parallel site: each rank serves its rows with whole weights, one
    layer's gathered at a time."""
    return tree.unflatten_like(p, [S.param_view(leaf, s)
                                   for leaf, s in zip(tree.leaves(p), tree.leaves(sh))])


def _serve_layout(cfg: ModelConfig, params: dict):
    """(the parameters' shardings, each period's stacked parameters and
    their per-period shardings) for serving on the ambient mesh."""
    mesh = S.ambient_mesh()
    if mesh is None:
        raise ValueError("serving on a mesh runs inside sharding.use_mesh")
    sh = param_layout(cfg, mesh)
    periods, sh_period = _unstack_sharded(params["stack"], sh["stack"], cfg.n_periods)
    return sh, periods, sh_period


def _period_shardings(cache_sh: Any) -> Any:
    """Per-period cache shardings of stacked cache shardings (the leading
    ``n_periods`` dim, never sharded, dropped)."""
    return tree.map(lambda s: S.NamedSharding(s.mesh, tuple(s.spec[1:]), tuple(s.shape[1:])),
                    cache_sh)


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


@torch.no_grad()
def prefill_on_mesh(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,
    max_len: int,
    embeds: torch.Tensor | None = None,
    *,
    cache_shardings: Any,
    backend: str = "auto",
):
    """``prefill`` inside ``sharding.use_mesh``: ``params`` are this rank's
    shards (``param_layout``), ``tokens`` its rows, ``cache_shardings`` the
    global cache's ``sharding.cache_shardings``.  Each layer runs on whole
    weights gathered for it (``_serve_views``).  Returns this rank's rows of
    the logits (its vocabulary columns where the head splits them) and its
    shards of the cache (``sharding.cache_cut``)."""
    sh, periods, sh_period = _serve_layout(cfg, params)
    x = _embed(cfg, params, tokens, embeds, sh)
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
        x, _, raw = _layer_forward(cfg, plan[i], _serve_views(p_l, sh["prelude"][i]), x,
                                   positions, backend)
        prelude_cache.append(to_cache(plan[i], raw))

    pre, period, n_periods = cfg.prelude_len, cfg.period, cfg.n_periods
    specs = tuple(plan[pre:pre + period])
    stack_cache: dict[str, Any] = {}
    for i, p_period in enumerate(periods):
        for pos in range(period):
            key = f"pos{pos}"
            x, _, raw = _layer_forward(cfg, specs[pos],
                                       _serve_views(p_period[key], sh_period[key]), x,
                                       positions, backend)
            c = to_cache(specs[pos], raw)
            if key not in stack_cache:  # the stacked leaves, allocated once
                stack_cache[key] = tree.map(lambda l: l.new_empty((n_periods, *l.shape)), c)
            tree.map(lambda dst, src: dst[i].copy_(src), stack_cache[key], c)
    cache = S.cache_cut({"prelude": prelude_cache, "stack": stack_cache}, cache_shardings)
    return _head(cfg, params, x, sh), cache


@torch.no_grad()
def decode_step_on_mesh(
    cfg: ModelConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,   # (B, 1), this rank's rows
    pos,
    *,
    cache_shardings: Any,
    backend: str = "auto",
):
    """``decode_step`` inside ``sharding.use_mesh``: ``params`` and
    ``cache`` are this rank's shards (the cache's by ``cache_shardings``),
    ``tokens`` its rows.  Each layer reads whole weights and its cache
    gathered but for the rows (``sharding.cache_view``), and writes its
    shards of the updated cache back in place (``cache_write``)."""
    sh, periods, sh_period = _serve_layout(cfg, params)
    x = _embed(cfg, params, tokens, None, sh)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    plan = cfg.layer_plan()

    def layer(spec, p_l, p_sh, c_l, c_sh):
        nonlocal x
        view = S.cache_view(c_l, c_sh)
        x, view = _layer_decode(cfg, spec, _serve_views(p_l, p_sh), x, view, pos, backend)
        S.cache_write(c_l, view, c_sh)

    for i, (p_l, c_l) in enumerate(zip(params["prelude"], cache["prelude"])):
        layer(plan[i], p_l, sh["prelude"][i], c_l, cache_shardings["prelude"][i])

    pre, period, n_periods = cfg.prelude_len, cfg.period, cfg.n_periods
    specs = tuple(plan[pre:pre + period])
    c_sh = _period_shardings(cache_shardings["stack"])
    for p_period, c_period in zip(periods, _unstack(cache["stack"], n_periods)):
        for k in range(period):
            key = f"pos{k}"
            layer(specs[k], p_period[key], sh_period[key], c_period[key], c_sh[key])
    return _head(cfg, params, x, sh), cache


__all__ = [
    "init_params",
    "param_layout",
    "logits_split",
    "forward",
    "prefill",
    "decode_step",
    "prefill_on_mesh",
    "decode_step_on_mesh",
    "init_cache",
    "cache_to_slots",
    "cache_take",
    "cache_put",
]
