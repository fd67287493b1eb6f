"""The yardstick of a language model's training step: operations and bytes.

Frozen with the benchmark, beside ``cost.py`` (whose peaks it uses).
Every count comes from the model's shapes and the traffic alone, never
from what the program does (remat's second forward pass is not counted):

* FLOPs: ``6 T`` times the matrix parameters each token multiplies (the
  attention projections and the tied head; forward, input gradient and
  weight gradient), with ``T`` the tokens of the step; the causal
  attention's scores and weighted sums over the ``S (S + 1) / 2`` pairs a
  sequence holds, times 3 for the same three passes; and each Kron
  projection's forward, input gradient and factor gradients
  (``cost.kron_train_step`` at ``M = T``).
* Bytes: AdamW's, the step's one pass over every parameter: each
  parameter's value, gradient and two moments read and its value and
  moments written (22 bytes at bf16 parameters and gradients and f32
  moments), and the gradient read once more for the global norm (2):
  ``optim``.  The model's own activations are not counted: at these sizes
  the step is bound by its FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from perfbench import cost

MOMENT_BYTES = 4  # AdamW's m and v, float32


@dataclass(frozen=True)
class TrainCost(cost.Cost):
    """A training step's cost, with its Kron projections' own (``kron``), the
    optimizer's pass (``optim``) and the parameters it updates."""

    kron: cost.Cost = None
    optim: cost.Cost = None
    params: int = 0


def param_count(lm, kron_shapes: Sequence[tuple[Sequence[int], Sequence[int]]]) -> int:
    """The parameters of a Qwen3 decoder with a tied head and Kron FFNs:
    the table, the final norm, every layer's attention projections, qk-norm
    and two norms, and the Kron factors.  ``lm``: a
    ``reference_lm_train.LMConfig``."""
    d, hd = lm.d_model, lm.head_dim
    attn = d * lm.n_heads * hd * 2 + d * lm.n_kv_heads * hd * 2
    layer = attn + 2 * hd + 2 * d
    kron = sum(sum(p * q for p, q in zip(ps, qs)) for ps, qs in kron_shapes)
    return lm.vocab * d + d + lm.n_layers * layer + kron


def train_step(lm, batch: int, seq: int,
               kron_shapes: Sequence[tuple[Sequence[int], Sequence[int]]],
               dtype: str = "bfloat16") -> TrainCost:
    """One AdamW step on ``batch`` sequences of ``seq`` tokens.  ``lm``: a
    ``reference_lm_train.LMConfig``; ``kron_shapes``: ``(ps, qs)`` of each
    Kron projection the step runs."""
    tokens = batch * seq
    d, hd = lm.d_model, lm.head_dim
    matrices = lm.n_layers * (d * lm.n_heads * hd * 2 + d * lm.n_kv_heads * hd * 2) + lm.vocab * d
    # q k and probs v, 2 FLOPs a multiply-add, over the causal pairs
    attn_fwd = lm.n_layers * 2 * 2 * batch * lm.n_heads * hd * (seq * (seq + 1) // 2)
    kron = [cost.kron_train_step(tokens, ps, qs, dtype) for ps, qs in kron_shapes]
    kron_cost = cost.Cost(sum(c.flops for c in kron), sum(c.bytes for c in kron), dtype)
    n = param_count(lm, kron_shapes)
    size = cost.ITEMSIZE[dtype]
    optim = cost.Cost(0, n * (3 * size + 4 * MOMENT_BYTES + size), dtype)
    flops = 6 * tokens * matrices + 3 * attn_fwd + kron_cost.flops
    return TrainCost(int(flops), optim.bytes, dtype, kron=kron_cost, optim=optim, params=n)


__all__ = ["TrainCost", "MOMENT_BYTES", "param_count", "train_step"]
