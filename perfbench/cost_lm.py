"""The yardstick of a language model's decode step: operations and bytes.

Frozen with the benchmark, beside ``cost.py`` (whose peaks it uses).
Every count comes from the model's shapes and the traffic alone, never
from what the program does:

* Bytes, each read once and each output written once: the attention
  weights; the KV cache up to the step's position, at the cycle's mean
  (``prompt + (cycle + 1) / 2`` entries a sequence), and the new entries;
  the routed experts that some token of the batch picks, at the number
  expected under uniform routing, ``E (1 - (1 - k/E)^B)`` a layer; the
  Kron FFNs' factors, inputs and outputs (``cost.kron_forward`` of each
  call at ``M = B``); the routers (float32), the norms, the embedding
  rows, the head and the float32 logits.
* FLOPs: ``2 B`` times the weights each token uses (the attention
  projections, its k routed experts, the router, the head), the
  attention's scores and sums at the mean position, and the Kron FFNs'
  sliced multiplies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from perfbench import cost


@dataclass(frozen=True)
class DecodeCost(cost.Cost):
    """A decode step's cost, with its Kron FFN calls' own (``kron``) and the
    routed experts expected to be read a layer (``experts_hit``)."""

    kron: cost.Cost = None
    experts_hit: float = 0.0


def experts_hit(n_experts: int, top_k: int, batch: int) -> float:
    """Experts some token of ``batch`` picks, expected under uniform routing."""
    return n_experts * (1 - (1 - top_k / n_experts) ** batch)


def decode_step(lm, batch: int, prompt: int, cycle: int,
                kron_shapes: Sequence[tuple[Sequence[int], Sequence[int]]],
                dtype: str = "bfloat16") -> DecodeCost:
    """One step of ``batch`` sequences, one token each, at the mean
    position of a cycle of ``cycle`` positions after a ``prompt``-token
    prompt.  ``lm``: a ``reference_lm.LMConfig``; ``kron_shapes``: ``(ps,
    qs)`` of each Kron projection the step runs."""
    size = cost.ITEMSIZE[dtype]
    d, v, e = lm.d_model, lm.vocab, lm.n_experts
    hd_all = lm.n_heads * lm.head_dim
    kv_all = lm.n_kv_heads * lm.head_dim
    n_moe = lm.n_moe
    attended = prompt + (cycle + 1) / 2  # cache entries a query reads, on average
    hit = experts_hit(e, lm.top_k, batch)

    attn_w = lm.n_layers * (d * hd_all * 2 + d * kv_all * 2)
    expert_w = 3 * d * lm.d_expert
    kron = [cost.kron_forward(batch, ps, qs, dtype) for ps, qs in kron_shapes]
    kron_cost = cost.Cost(sum(c.flops for c in kron), sum(c.bytes for c in kron), dtype)

    byte_count = (
        attn_w * size
        + lm.n_layers * 2 * batch * kv_all * (attended + 1) * size  # K/V read and written
        + n_moe * hit * expert_w * size
        + kron_cost.bytes
        + n_moe * d * e * 4  # routers, float32
        + (2 * lm.n_layers + 1) * d * size  # norms
        + batch * d * size  # embedding rows
        + d * v * size  # head
        + batch * v * 4  # logits, float32
    )
    flops = (
        2 * batch * (attn_w + n_moe * lm.top_k * expert_w + n_moe * d * e + d * v)
        + 4 * batch * lm.n_layers * hd_all * attended  # scores and weighted sums
        + kron_cost.flops
    )
    return DecodeCost(int(flops), int(round(byte_count)), dtype, kron=kron_cost,
                      experts_hit=hit)


__all__ = ["DecodeCost", "experts_hit", "decode_step"]
