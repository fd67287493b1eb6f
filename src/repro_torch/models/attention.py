"""GQA/MQA/MHA attention: RoPE, qk-norm, QKV-bias, sliding window.

The port of the training half of ``repro.models.attention``: the
parameters, the projections and the causal full-sequence forward.  Queries
run in chunks of ``q_chunk`` with one ``(B, Hkv, G, q_chunk, S)`` score
block live, and each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) instead of
saved.  GQA keeps K/V un-repeated through a grouped einsum.  Scores and
probabilities are f32, computed with ``torch.einsum`` as the reference
computes them outside any Pallas kernel (with TF32 off, PyTorch's default,
they stay f32 on the card).  The KV cache and the decode path belong to
the serving slice; the reference's context parallelism to the mesh slice.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .common import apply_rope, dense_init, rms_norm
from .config import ModelConfig

NEG_INF = -1e9


def attn_init(
    generator: torch.Generator | None, cfg: ModelConfig, dtype: torch.dtype,
    *, device: str | torch.device = "cuda",
) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(generator, d, h * hd, dtype, device),
        "wk": dense_init(generator, d, hkv * hd, dtype, device),
        "wv": dense_init(generator, d, hkv * hd, dtype, device),
        "wo": dense_init(generator, h * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(hkv * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(hkv * hd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.zeros(hd, dtype=dtype, device=device)
    return p


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), RoPE'd."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,H,hd), k (B,Sk,Hkv,hd) -> (B,Hkv,G,Sq,Sk) in f32."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(hd)


def _grouped_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,Hkv,G,Sq,Sk), v (B,Sk,Hkv,hd) -> (B,Sq,H,hd)."""
    b, hkv, g, sq, _ = probs.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hkv * g, v.shape[-1])


def attn_forward(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    q_chunk: int = 1024,
    return_kv: bool = False,
):
    """Causal full-sequence attention (training)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    qb = min(q_chunk, s)
    if s % qb:
        qb = math.gcd(s, qb)
    k_pos = positions if positions.ndim == 2 else positions.expand(b, s)

    def chunk_attn(qi, qpos):
        """One q-chunk: (B, qb, H, hd), (B, qb) -> (B, qb, H, hd)."""
        scores = _grouped_scores(qi, k)  # (B,Hkv,G,qb,S)
        causal = k_pos[:, None, None, None, :] <= qpos[:, None, None, :, None]
        if cfg.sliding_window:
            causal &= (
                k_pos[:, None, None, None, :]
                > qpos[:, None, None, :, None] - cfg.sliding_window
            )
        scores = torch.where(causal, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return _grouped_out(probs, v).to(qi.dtype)

    # Flash-attention-style backward: each chunk's (qb, S) score block is
    # recomputed, not saved. The stack draws no random numbers, so the RNG
    # state need not be carried into the recompute.
    outs = [
        checkpoint(chunk_attn, q[:, i:i + qb], k_pos[:, i:i + qb],
                   use_reentrant=False, preserve_rng_state=False)
        for i in range(0, s, qb)
    ]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    y = out.reshape(b, s, -1).to(x.dtype) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


__all__ = ["attn_init", "attn_forward", "NEG_INF"]
