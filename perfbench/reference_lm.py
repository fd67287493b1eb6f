"""The plain float32 reference of a decoder language model with fine-grained
MoE and Kron FFNs: DeepSeekMoE (arXiv:2401.06066) as the benchmark runs it.

Plain PyTorch, independent of the program under test: it imports nothing
of it.  It takes the weights, the tokens and, for the choice of experts
only, the router logits the program recorded; it computes every gate
value and every router logit again itself.  No cache, no batching tricks,
no capacity buckets: one causal forward pass over whole sequences.

The decoder, layer by layer, in float32 with TF32 off:

* ``x = embed[tokens]``;
* ``h = rmsnorm(x, ln1)``; causal multi-head attention with RoPE (the
  rotation of the two halves of each head, theta from the config);
  ``x += attn``;
* ``h = rmsnorm(x, ln2)``; the first ``first_dense`` layers run a SwiGLU
  FFN, the rest a MoE: router logits ``h @ router``, the softmax scores
  ``s``, the top-k experts, gates ``g_i = s_i`` (the paper's gating
  equation; renormalized over the k where the config says
  ``norm_topk``), the routed experts each over its own tokens, dropless,
  plus the shared experts' FFN on every token; ``x += ffn``;
* logits ``rmsnorm(x, final_norm) @ lm_head`` over the real vocabulary.

``rmsnorm(x, w) = x / sqrt(mean(x^2) + eps) * (1 + w)``: the scale is
stored as an offset from 1, zero at initialisation.

Departures from the published model, each on purpose:

* **Replayed picks.**  Which experts a token goes to is the top-k of the
  router logits handed in (the program's own), not of the reference's.
  A bf16 program's router logits differ from float32 ones by about 1e-2,
  while the 6th and 7th largest of 64 lie about 0.09 apart on average,
  so some picks flip between any bf16 program and a float32 reference,
  and one flip moves a token's output by a whole expert.  The gate values
  are the reference's own softmax scores at those picks.
* **Kron-factored FFNs.**  The dense layer's FFN and the shared experts
  are Kron FFNs: each projection ``x @ (F^1 (x) F^2)`` with factors at
  the widths they replace (FastKron section 6, Table 4 rows 6-8), computed
  by ``reference.kron_apply``.  The routed experts are dense.

``precision="e4m3"`` is the control: every weight, and every layer's
input, rounded to float8 e4m3 (one absmax scale per tensor), a lower
precision than the configuration's bfloat16.  The picks then come from
its own router logits unless others are handed in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from perfbench import reference


@dataclass(frozen=True)
class LMConfig:
    """The shape of the decoder, in the public config.json's terms."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    first_dense: int
    n_experts: int
    top_k: int
    d_expert: int
    norm_topk: bool
    rope_theta: float
    norm_eps: float

    @classmethod
    def from_config(cls, c: dict) -> "LMConfig":
        """From a configuration file of ``perfbench/configs`` (the public
        config.json's keys)."""
        return cls(
            n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
            head_dim=c["hidden_size"] // c["num_attention_heads"], vocab=c["vocab_size"],
            first_dense=c["first_k_dense_replace"], n_experts=c["n_routed_experts"],
            top_k=c["num_experts_per_tok"], d_expert=c["moe_intermediate_size"],
            norm_topk=c["norm_topk_prob"],
            rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]))

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.first_dense


class Weights:
    """What the reference reads: ``embed`` (V, D), ``final_norm`` (D,),
    ``lm_head`` (D, V) and ``layer(i)``, a dict of layer ``i``'s weights:
    ``ln1``, ``wq``, ``wk``, ``wv`` (D, H*hd), ``wo`` (H*hd, D), ``ln2``,
    and ``ffn`` (dense layers) or ``router`` (D, E), ``ew1``, ``ew3`` (E, D,
    F), ``ew2`` (E, F, D) and ``shared`` (MoE layers).  An FFN is a dict of
    ``w1``, ``w3``, ``w2``, each a matrix or a tuple of Kron factors.
    Any float dtype: the reference casts what it reads to float32, one
    layer at a time."""

    embed: torch.Tensor
    final_norm: torch.Tensor
    lm_head: torch.Tensor

    def layer(self, i: int) -> dict:
        raise NotImplementedError


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one absmax scale (its largest
    magnitude to e4m3's 448), back in float32."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _cast(tree, rnd: Callable[[torch.Tensor], torch.Tensor]):
    if isinstance(tree, dict):
        return {k: _cast(v, rnd) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_cast(v, rnd) for v in tree)
    return rnd(tree.float())


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) at positions 0..S-1: each head's two halves rotated
    by the angle ``pos * theta^(-2i/hd)``."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: LMConfig, w: dict, h: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``h`` (B, S, D), one sequence at a time."""
    b, s, _ = h.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = rope((h @ w["wq"]).reshape(b, s, nh, hd), cfg.rope_theta)
    k = rope((h @ w["wk"]).reshape(b, s, nkv, hd), cfg.rope_theta)
    v = (h @ w["wv"]).reshape(b, s, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(b, s, nh, hd, device=h.device)
    for r in range(b):
        scores = torch.einsum("qhd,khd->hqk", q[r], k[r]) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
        out[r] = torch.einsum("hqk,khd->qhd", probs, v[r])
    return out.reshape(b, s, nh * hd) @ w["wo"]


def _project(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., d_in) @ W``, ``W`` a matrix or a tuple of Kron factors."""
    if isinstance(w, torch.Tensor):
        return x @ w
    lead = x.shape[:-1]
    y = reference.kron_apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, y.shape[-1])


def ffn(w: dict, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(h W1) * (h W3)) W2``."""
    return _project(torch.nn.functional.silu(_project(h, w["w1"])) * _project(h, w["w3"]),
                    w["w2"])


def moe(cfg: LMConfig, w: dict, h: torch.Tensor, picks_from: torch.Tensor | None):
    """The MoE block on ``h`` (B, S, D).  Returns ``(y, router logits (B, S,
    E))``.  ``picks_from``: logits (B, S, E) whose top-k are the experts
    each token goes to; None: the block's own."""
    logits = h @ w["router"]
    scores = torch.softmax(logits, dim=-1)
    picks = torch.topk(logits if picks_from is None else picks_from.float(), cfg.top_k,
                       dim=-1).indices  # (B, S, k)
    gates = scores.gather(-1, picks)
    if cfg.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    d = h.shape[-1]
    flat, picks, gates = h.reshape(-1, d), picks.reshape(-1, cfg.top_k), gates.reshape(-1, cfg.top_k)
    y = torch.zeros_like(flat)
    for e in range(cfg.n_experts):
        tok, slot = (picks == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat[tok]
        out = (torch.nn.functional.silu(xe @ w["ew1"][e]) * (xe @ w["ew3"][e])) @ w["ew2"][e]
        y.index_add_(0, tok, out * gates[tok, slot, None])
    return y.reshape(h.shape) + ffn(w["shared"], h), logits


@torch.no_grad()
def forward(cfg: LMConfig, weights: Weights, tokens: torch.Tensor,
            picks_from: Sequence[torch.Tensor] | None = None, *,
            logits_at: torch.Tensor | slice = slice(None), precision: str = "float32"):
    """The decoder over ``tokens`` (B, S), causal from position 0.

    ``picks_from``: one ``(B, S, E)`` tensor of router logits per MoE
    layer, in layer order, whose top-k pick each token's experts (None:
    the reference's own).  ``logits_at``: the positions whose logits are
    returned.  ``precision``: ``"float32"``, or ``"e4m3"`` for the control.
    Returns ``(logits (B, len(logits_at), vocab) f32, [router logits (B,
    S, E) f32 per MoE layer])``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if precision == "float32":
        rnd = _identity
    elif precision == "e4m3":
        rnd = e4m3
    else:
        raise ValueError(f"unknown precision {precision!r}")
    x = rnd(weights.embed.float())[tokens]
    routers = []
    for i in range(cfg.n_layers):
        w = _cast(weights.layer(i), rnd)
        x = rnd(x)
        x = x + attention(cfg, w, rms_norm(x, w["ln1"], cfg.norm_eps))
        h = rms_norm(x, w["ln2"], cfg.norm_eps)
        if i < cfg.first_dense:
            x = x + ffn(w["ffn"], h)
        else:
            j = i - cfg.first_dense
            y, logits = moe(cfg, w, h, None if picks_from is None else picks_from[j])
            x = x + y
            routers.append(logits)
        del w
    h = rms_norm(x[:, logits_at], rnd(weights.final_norm.float()), cfg.norm_eps)
    return h @ rnd(weights.lm_head[:, :cfg.vocab].float()), routers


__all__ = ["LMConfig", "Weights", "e4m3", "rms_norm", "rope", "attention", "ffn", "moe",
           "forward"]
