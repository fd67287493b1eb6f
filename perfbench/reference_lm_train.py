"""The plain float32 reference of a Qwen3 decoder's training step: the loss
and every parameter's gradient.  Qwen3 (arXiv:2505.09388) as the benchmark
trains it, with Kron FFNs.

Plain PyTorch, independent of the program under test: it imports nothing
of it.  It takes the weights and the tokens, and works out the loss and the
gradients again itself by autograd, one causal forward pass over whole
sequences: no cache, no chunked attention, no fused kernels.

The decoder, layer by layer, in float32 with TF32 off:

* ``x = embed[tokens]``;
* ``h = rmsnorm(x, ln1)``; grouped-query attention: ``q = h Wq``, ``k = h
  Wk``, ``v = h Wv``, split into heads; a per-head RMSNorm on every q and k
  head (qk-norm, ``q_norm``, ``k_norm``) before RoPE (the rotation of the
  two halves of each head, ``reference_lm.rope``); each KV head serves the
  ``n_heads / n_kv_heads`` query heads next to each other (query head ``j``
  reads KV head ``j // group``); causal softmax over ``q k / sqrt(hd)``;
  ``x += (probs v) Wo``;
* ``h = rmsnorm(x, ln2)``; a SwiGLU FFN whose projections are Kron
  products (``reference_lm.ffn``: ``(silu(h W1) * (h W3)) W2``, each ``x @
  (F^1 (x) F^2)`` through ``reference.kron_apply``); ``x += ffn``;
* logits ``rmsnorm(x, final_norm) @ embed[:vocab].T``: the head is the
  embedding table (tied, as published), so the table's gradient is the
  lookup's part and the head's part added;
* the loss: the mean over every token of ``-log softmax(logits)[label]``.

Every layer runs under ``torch.utils.checkpoint``, so only the layers'
inputs live through the backward pass and the reference fits beside what
the benchmark's check holds.

The program's conventions are taken where they are only a
parameterization: ``rmsnorm(x, w) = x / sqrt(mean(x^2) + eps) * (1 + w)``,
the scale stored as an offset from 1 (zero at initialisation; the
published checkpoints store ``1 + w``).  The weights' layout
(``Weights``): every layer's leaves stacked on a leading layer axis, and
each Kron projection a tuple of factors in problem order.

Departure from the published model, on purpose: **Kron-factored FFNs.**
Each of w1, w3 and w2 is ``F^1 (x) F^2`` at the width it replaces
(FastKron section 6, Table 4 rows 6-8).

``precision="e4m3"`` is the control: every weight, and every layer's
input, rounded to float8 e4m3 (``reference_lm.e4m3``, one absmax scale per
tensor), a lower precision than the configuration's bfloat16; the
rounding passes gradients straight through.

The optimizer (``AdamW``): AdamW (Loshchilov and Hutter, arXiv:1711.05101)
with decoupled weight decay scaled by the learning rate, a linear warm-up
then a cosine decay to a floor, and a global-norm clip (``clip_scale``).
Its conventions are the program's: decay on every leaf of two or more
axes as stored (the matrices, the Kron factors, the table, and the
stacked per-layer norm scales; not ``final_norm``); the schedule and the
bias corrections computed in float32 arithmetic, as float32 scalars;
the new parameter computed in float32 and rounded to the parameter's
dtype, with no master copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import reference_lm

# name -> a layer leaf's role; a Kron projection is a tuple of factors
LAYER_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "q_norm", "k_norm", "ln2", "w1", "w3", "w2")


@dataclass(frozen=True)
class LMConfig:
    """The shape of the decoder, in the public config.json's terms."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float

    @classmethod
    def from_config(cls, c: dict) -> "LMConfig":
        """From a configuration file of ``perfbench/configs``."""
        return cls(
            n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
            head_dim=c["head_dim"], d_ff=c["intermediate_size"], vocab=c["vocab_size"],
            rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]))


# ``Weights``: a dict of ``embed`` (V', D) with V' >= vocab rows (rows past
# the vocabulary are padding, never read), ``final_norm`` (D,), and each of
# ``LAYER_LEAVES`` stacked over the layers: ``ln1``, ``ln2`` (L, D), ``wq``
# (L, D, H*hd), ``wk``, ``wv`` (L, D, Hkv*hd), ``wo`` (L, H*hd, D),
# ``q_norm``, ``k_norm`` (L, hd), ``w1``, ``w3`` (tuples of (L, P_i, Q_i)
# factors, D -> d_ff) and ``w2`` (d_ff -> D).  Any float dtype.
Weights = dict


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _straight_through_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 in the forward pass, its gradient passed as is."""
    return t + (reference_lm.e4m3(t.detach()) - t.detach())


def _rounding(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "float32":
        return _identity
    if precision == "e4m3":
        return _straight_through_e4m3
    raise ValueError(f"unknown precision {precision!r}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in tree for l in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def attention(cfg: LMConfig, w: dict, h: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention with qk-norm of ``h`` (B, S, D), one
    sequence at a time."""
    b, s, _ = h.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = reference_lm.rms_norm((h @ w["wq"]).reshape(b, s, nh, hd), w["q_norm"], cfg.norm_eps)
    k = reference_lm.rms_norm((h @ w["wk"]).reshape(b, s, nkv, hd), w["k_norm"], cfg.norm_eps)
    q = reference_lm.rope(q, cfg.rope_theta)
    k = reference_lm.rope(k, cfg.rope_theta)
    v = (h @ w["wv"]).reshape(b, s, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    outs = []
    for r in range(b):
        scores = torch.einsum("qhd,khd->hqk", q[r], k[r]) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
        outs.append(torch.einsum("hqk,khd->qhd", probs, v[r]))
    return torch.stack(outs).reshape(b, s, nh * hd) @ w["wo"]


def layer(cfg: LMConfig, w: dict, x: torch.Tensor, rnd=_identity) -> torch.Tensor:
    """One decoder layer on ``x`` (B, S, D); ``w`` holds this layer's
    leaves (no layer axis)."""
    w = _tree_map(lambda t: rnd(t.float()), w)
    x = rnd(x)
    x = x + attention(cfg, w, reference_lm.rms_norm(x, w["ln1"], cfg.norm_eps))
    h = reference_lm.rms_norm(x, w["ln2"], cfg.norm_eps)
    return x + reference_lm.ffn({k: w[k] for k in ("w1", "w3", "w2")}, h)


def loss(cfg: LMConfig, weights: Weights, tokens: torch.Tensor, labels: torch.Tensor, *,
         precision: str = "float32") -> torch.Tensor:
    """The mean token NLL of ``labels`` (B, S) after ``tokens`` (B, S), a
    float32 scalar that autograd can differentiate into every weight."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rnd = _rounding(precision)
    table = weights["embed"][:cfg.vocab]
    x = rnd(table.float())[tokens.long()]
    for i in range(cfg.n_layers):
        w = {k: _tree_map(lambda t: t[i], weights[k]) for k in LAYER_LEAVES}
        x = checkpoint(layer, cfg, w, x, rnd, use_reentrant=False)
    h = reference_lm.rms_norm(x, rnd(weights["final_norm"].float()), cfg.norm_eps)
    logits = h @ rnd(table.float()).T
    return F.cross_entropy(logits.reshape(-1, cfg.vocab), labels.reshape(-1).long())


def loss_and_grads(cfg: LMConfig, weights: Weights, tokens: torch.Tensor,
                   labels: torch.Tensor, *, precision: str = "float32"):
    """``(loss, grads)``: the loss and its gradient with respect to every
    weight, float32, ``grads`` in ``weights``' layout (the padding rows of
    ``embed`` read zero)."""
    leaves = _tree_map(lambda t: t.detach().float().requires_grad_(), weights)
    with torch.enable_grad():
        value = loss(cfg, leaves, tokens, labels, precision=precision)
        flat = _leaves(leaves)
        grads = torch.autograd.grad(value, flat, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return value.detach(), _tree_map(lambda _: next(it), leaves)


def clip_scale(grads: Weights, clip_norm: float) -> tuple[float, float]:
    """``(norm, scale)``: the global L2 norm of every leaf of ``grads``, and
    the factor ``min(1, clip_norm / norm)`` that clips the gradient to it."""
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.double()))) for g in _leaves(grads)))
    return norm, min(1.0, clip_norm / max(norm, 1e-12))


@dataclass(frozen=True)
class AdamW:
    """AdamW's hyperparameters, and the parameter it writes."""

    lr: float
    warmup_steps: int
    decay_steps: int
    min_lr_ratio: float
    b1: float
    b2: float
    eps: float
    weight_decay: float

    def lr_at(self, count: int) -> torch.Tensor:
        """The learning rate of the ``count``-th update (1 for the first),
        a float32 scalar computed in float32 arithmetic."""
        t = torch.tensor(float(count), dtype=torch.float32)
        warm = torch.clamp(t / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((t - self.warmup_steps) / max(self.decay_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (self.min_lr_ratio + (1 - self.min_lr_ratio) * cos)

    def write(self, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              count: int) -> torch.Tensor:
        """``p`` after the ``count``-th update, in ``p``'s dtype, from the
        first and second moments ``m``, ``v`` that update produced."""
        t = torch.tensor(float(count), dtype=torch.float32)
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        lr = self.lr_at(count)
        u = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + self.eps)
        if p.ndim >= 2:
            u = u + self.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)


__all__ = ["LMConfig", "Weights", "LAYER_LEAVES", "AdamW", "attention", "layer", "loss",
           "loss_and_grads", "clip_scale"]
