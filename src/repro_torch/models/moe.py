"""Mixture-of-Experts: token-choice top-k routing with capacity buckets.

The port of ``repro.models.moe``: Mixtral (8 experts, top-2), DeepSeek-MoE
(2 shared + 64 routed, top-6, fine-grained) and Jamba (16 experts, top-2,
every other layer).  Tokens are ranked within their expert by a stable
argsort, their ids written into an ``(E, C)`` index map, gathered into
``(E, C, D)`` capacity buckets, run through per-expert stacked-weight
einsums (``torch.einsum``, as the reference computes them outside any
Pallas kernel) and gathered back, weighted by the router's renormalized
top-k probabilities.  Routing is per sequence: no token competes for
capacity with another row of the batch.  Tokens beyond capacity are
dropped (Switch-style); a load-balancing aux loss is returned for the
trainer.  The shared experts are one FFN block (a Kron FFN under
``kron_ffn``).

One difference from the reference, kept: the index map is written only
from kept slots.  The reference sends a dropped slot's write to expert 0,
slot 0, an index in range, so whenever a token overflows capacity it
overwrites the token held there (which then loses that expert's
contribution).  The reference's sharding hints belong to the next mesh slice
(``runtime/sharding.py``).
"""
from __future__ import annotations

import torch

from .common import act_fn, dense_init
from .config import ModelConfig, MoEConfig
from .ffn import ffn_apply, ffn_init


def moe_init(
    generator: torch.Generator | None, cfg: ModelConfig, dtype: torch.dtype,
    *, device: str | torch.device = "cuda",
) -> dict:
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_expert, mc.n_experts

    def trunc(shape, std):
        w = torch.empty(shape, device=device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (w * std).to(dtype)

    p = {
        "router": dense_init(generator, d, e, torch.float32, device),
        "ew1": trunc((e, d, f), d ** -0.5),
        "ew3": trunc((e, d, f), d ** -0.5),
        "ew2": trunc((e, f, d), f ** -0.5),
    }
    if mc.n_shared:
        p["shared"] = ffn_init(generator, cfg, dtype, d_ff=mc.n_shared * f, device=device)
    return p


def _capacity(s: int, mc: MoEConfig) -> int:
    c = int(s * mc.top_k * mc.capacity_factor / mc.n_experts) + 1
    return min(max(8, -(-c // 8) * 8), s * mc.top_k)  # mult of 8, <= all slots


def _route(router_logits: torch.Tensor, mc: MoEConfig, capacity: int):
    """router_logits: (B, S, E) f32.  Returns the ``(B, E, C)`` index map
    (token id, -1 = empty) and per slot ``(slot_e, slot_c, w_flat, keep)``,
    each ``(B, S*k)``; the reference's ``_route_one_seq`` for every row."""
    b, s, e = router_logits.shape
    k = mc.top_k
    dev = router_logits.device
    probs = torch.softmax(router_logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)  # (B, S, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalize

    e_flat = top_i.reshape(b, s * k)
    w_flat = top_p.reshape(b, s * k)
    t_flat = torch.arange(s, device=dev).repeat_interleave(k)  # token of each slot

    # rank of each slot within its expert (stable by token order)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_e = e_flat.gather(-1, order)
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous())
    rank_sorted = torch.arange(s * k, device=dev) - seg_start.gather(-1, sorted_e)
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)

    keep = rank < capacity
    slot_e = torch.where(keep, e_flat, 0)
    slot_c = torch.where(keep, rank, 0)
    # Only kept slots write the index map: a dropped slot goes to a spare
    # column past the end, cut off after the scatter.
    flat = torch.where(keep, slot_e * capacity + slot_c, e * capacity)
    src = torch.full((b, e * capacity + 1), -1, dtype=torch.long, device=dev)
    src.scatter_(-1, flat, t_flat.expand(b, -1))
    return src[:, : e * capacity].reshape(b, e, capacity), (slot_e, slot_c, w_flat, keep)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, backend: str = "auto"):
    """x: (B, S, D) -> (y, aux_loss).  ``backend`` reaches the shared
    experts' Kron FFN."""
    mc = cfg.moe
    b, s, d = x.shape
    e = mc.n_experts
    capacity = _capacity(s, mc)

    router_logits = x.float() @ p["router"]  # (B, S, E)
    src, (slot_e, slot_c, w_flat, keep) = _route(router_logits, mc, capacity)

    # dispatch: (B, E*C, D) gather from token-major x
    valid = src >= 0
    buckets = x.gather(1, src.clamp_min(0).reshape(b, e * capacity, 1).expand(-1, -1, d))
    buckets = buckets.reshape(b, e, capacity, d)
    buckets = torch.where(valid[..., None], buckets, torch.zeros((), dtype=x.dtype, device=x.device))

    act = act_fn(cfg.ffn_act)
    h = act(torch.einsum("becd,edf->becf", buckets, p["ew1"])) * torch.einsum(
        "becd,edf->becf", buckets, p["ew3"])
    buckets_out = torch.einsum("becf,efd->becd", h, p["ew2"]).to(x.dtype)

    # combine: slot-major gather back, token-major reshape-sum
    flat_idx = slot_e * capacity + slot_c  # (B, S*k)
    gathered = buckets_out.reshape(b, e * capacity, d).gather(
        1, flat_idx[..., None].expand(-1, -1, d))  # (B, S*k, D)
    contrib = gathered * torch.where(keep, w_flat, 0.0)[..., None].to(x.dtype)
    y = contrib.reshape(b, s, mc.top_k, d).sum(dim=2)

    # Switch-style load-balance aux: E * sum_e (frac_tokens_e * frac_prob_e)
    probs = torch.softmax(router_logits, dim=-1)
    top1 = router_logits.argmax(dim=-1)
    frac_tokens = torch.nn.functional.one_hot(top1, e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)

    if mc.n_shared:
        y = y + ffn_apply(cfg, p["shared"], x, backend=backend)
    return y, aux


__all__ = ["moe_init", "moe_apply"]
