"""Mixture-of-Experts: token-choice top-k routing with capacity buckets.

The port of ``repro.models.moe``: Mixtral (8 experts, top-2), DeepSeek-MoE
(2 shared + 64 routed, top-6, fine-grained) and Jamba (16 experts, top-2,
every other layer).  Tokens are ranked within their expert by a stable
argsort, their ids written into an ``(E, C)`` index map, gathered into
``(E, C, D)`` capacity buckets, run through per-expert stacked-weight
einsums (``torch.einsum``, as the reference computes them outside any
Pallas kernel) and gathered back, weighted by the router's top-k
probabilities: renormalized over the k (Mixtral, Jamba), or as they are
under ``norm_topk=False`` (DeepSeekMoE's gate, g_i = s_i).  Routing is per
sequence: no token competes for capacity with another row of the batch.
Tokens beyond capacity are dropped (Switch-style); a load-balancing aux
loss is returned for the trainer.  The shared experts are one FFN block (a
Kron FFN under ``kron_ffn``).

Two differences from the reference, kept.  The index map is written only
from kept slots: the reference sends a dropped slot's write to expert 0,
slot 0, an index in range, so whenever a token overflows capacity it
overwrites the token held there (which then loses that expert's
contribution).  And the reference renormalizes the top-k gates of every
model; the port's deepseek-moe-16b keeps the published gate.

Tracing (``runtime/telemetry.py``): ``moe_apply`` runs in a ``moe`` span,
its router and ``_route`` in ``moe_route``, dispatch, the expert einsums
and the combine in ``moe_experts``; the counters ``moe.tokens`` (tokens
routed) and ``moe.slots`` (expert rows computed, B*E*C) come from shapes
alone.  Inside a ``route_record`` block each call computes its router
logits into a buffer the caller holds.

On a mesh (``sharding.use_mesh``) routing runs on every rank over its own
rows, and the reference's expert hints place the expert einsums: with
``n_experts % tp == 0`` each rank runs its own experts (expert
parallelism: the buckets are cut over the expert axis and gathered back),
otherwise every expert runs tensor-parallel over ``d_expert`` (the first
einsums column-parallel, the last row-parallel, its partial sums added
over the model axis).  The aux loss's token and probability fractions are
means over the global batch.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from ..runtime import telemetry
from ..runtime.sharding import (
    batch_shards, batch_sum, constrain, reduce_tp, tp_join, tp_partial_grad,
)
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


# [buffers, calls so far] while a ``route_record`` block is open.
_RECORD: list | None = None


@contextlib.contextmanager
def route_record(buffers: Sequence[torch.Tensor]):
    """Inside the block the ``i``-th ``moe_apply`` call computes its router
    logits, ``(B, S, E)`` f32, straight into ``buffers[i]`` (the router
    matmul's ``out=``), so the caller holds them: no added device op, no
    host sync, no allocation.  ``out=`` takes no gradient: a block is for
    passes without autograd (``prefill``, ``decode_step``).  Outside any
    block (the default) a call pays one check.  Blocks do not nest."""
    global _RECORD
    if _RECORD is not None:
        raise RuntimeError("route_record blocks do not nest")
    _RECORD = [buffers, 0]
    try:
        yield
    finally:
        _RECORD = None


def _next_record() -> torch.Tensor:
    buffers, i = _RECORD
    if i >= len(buffers):
        raise IndexError(f"route_record: {len(buffers)} buffers, call {i + 1}")
    _RECORD[1] = i + 1
    return buffers[i]


def _capacity(s: int, mc: MoEConfig) -> int:
    c = int(s * mc.top_k * mc.capacity_factor / mc.n_experts) + 1
    return min(max(8, -(-c // 8) * 8), s * mc.top_k)  # mult of 8, <= all slots


def _route(router_logits: torch.Tensor, mc: MoEConfig, capacity: int):
    """router_logits: (B, S, E) f32.  Returns the ``(B, E, C)`` index map
    (token id, -1 = empty) and per slot ``(slot_e, slot_c, w_flat, keep)``,
    each ``(B, S*k)``; the reference's ``_route_one_seq`` for every row.
    The gates ``w_flat`` are the top-k softmax scores, renormalized to sum
    to 1 where ``mc.norm_topk``."""
    b, s, e = router_logits.shape
    k = mc.top_k
    dev = router_logits.device
    probs = torch.softmax(router_logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)  # (B, S, k)
    if mc.norm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)

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


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *, backend: str = "auto",
              experts: str | None = None, shared_tp: bool = False):
    """x: (B, S, D) -> (y, aux_loss).  ``backend`` reaches the shared
    experts' Kron FFN.  On a mesh, ``experts``: ``"ep"`` where ``ew*`` hold
    this rank's experts, ``"tp"`` where they hold its slice of
    ``d_expert``; ``shared_tp``: the shared experts' dense FFN is
    tensor-parallel (``ffn_apply(tp=)``)."""
    with telemetry.span("moe"):
        mc = cfg.moe
        b, s, _ = x.shape
        capacity = _capacity(s, mc)
        telemetry.counter_inc("moe.tokens", b * s)
        telemetry.counter_inc("moe.slots", b * mc.n_experts * capacity)

        with telemetry.span("moe_route"):
            if _RECORD is None:
                router_logits = x.float() @ p["router"]  # (B, S, E)
            else:
                router_logits = torch.matmul(x.float(), p["router"], out=_next_record())
            src, slots = _route(router_logits, mc, capacity)
        with telemetry.span("moe_experts"):
            y = _experts(cfg, p, x, src, slots, capacity, experts)

        # Switch-style load-balance aux: E * sum_e (frac_tokens_e * frac_prob_e)
        e = mc.n_experts
        probs = torch.softmax(router_logits, dim=-1)
        top1 = router_logits.argmax(dim=-1)
        n_tok = b * s * batch_shards()  # the global batch's tokens
        frac_tokens = batch_sum(torch.nn.functional.one_hot(top1, e).float().sum(dim=(0, 1))) / n_tok
        frac_probs = batch_sum(probs.sum(dim=(0, 1))) / n_tok
        aux = e * torch.sum(frac_tokens * frac_probs)

        if mc.n_shared:
            y = y + ffn_apply(cfg, p["shared"], x, backend=backend, tp=shared_tp)
        return y, aux


def _experts(cfg: ModelConfig, p: dict, x: torch.Tensor, src: torch.Tensor, slots,
             capacity: int, experts: str | None) -> torch.Tensor:
    """Dispatch into the ``(B, E, C, D)`` buckets, the expert einsums, and
    the gate-weighted combine back to ``(B, S, D)``."""
    slot_e, slot_c, w_flat, keep = slots
    b, s, d = x.shape
    e = cfg.moe.n_experts

    # dispatch: (B, E*C, D) gather from token-major x
    valid = src >= 0
    buckets = x.gather(1, src.clamp_min(0).reshape(b, e * capacity, 1).expand(-1, -1, d))
    buckets = buckets.reshape(b, e, capacity, d)
    buckets = torch.where(valid[..., None], buckets, torch.zeros((), dtype=x.dtype, device=x.device))

    act = act_fn(cfg.ffn_act)

    def run_experts(bk):
        h = act(torch.einsum("becd,edf->becf", bk, p["ew1"])) * torch.einsum(
            "becd,edf->becf", bk, p["ew3"])
        return torch.einsum("becf,efd->becd", h, p["ew2"])

    if experts == "ep":
        # expert parallelism: this rank's experts (the reference's
        # ("batch", "tp", None, None) buckets), gathered back for the combine
        local = run_experts(constrain(buckets, "batch", "tp", None, None))
        buckets_out = tp_join(local.to(x.dtype), 1)
    elif experts == "tp":
        # TP inside each expert: h is ("batch", None, None, "tp"), the down
        # projection's partial sums are added over the model axis
        buckets_out = reduce_tp(run_experts(tp_partial_grad(buckets))).to(x.dtype)
    else:
        buckets_out = run_experts(buckets).to(x.dtype)

    # combine: slot-major gather back, token-major reshape-sum
    flat_idx = slot_e * capacity + slot_c  # (B, S*k)
    gathered = buckets_out.reshape(b, e * capacity, d).gather(
        1, flat_idx[..., None].expand(-1, -1, d))  # (B, S*k, D)
    contrib = gathered * torch.where(keep, w_flat, 0.0)[..., None].to(x.dtype)
    return contrib.reshape(b, s, cfg.moe.top_k, d).sum(dim=2)


__all__ = ["moe_init", "moe_apply", "route_record"]
