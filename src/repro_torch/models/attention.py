"""GQA/MQA/MHA attention: RoPE, qk-norm, QKV-bias, sliding window.

The port of the training half of ``repro.models.attention``: the
parameters, the projections and the causal full-sequence forward.  Queries
run in chunks of ``q_chunk`` with one ``(B, Hkv, G, q_chunk, S)`` score
block live, and each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) instead of
saved.  GQA keeps K/V un-repeated through a grouped einsum.  Scores and
probabilities are f32, computed with ``torch.einsum`` as the reference
computes them outside any Pallas kernel (with TF32 off, PyTorch's default,
they stay f32 on the card).

On a mesh (``sharding.use_mesh``) a layer runs head-parallel when the model
axis divides ``n_heads`` (the model passes ``tp=True``): ``wq`` and ``bq``
arrive as this rank's columns (its q heads) and ``wo`` as its rows, K/V are
projected whole and each rank picks the KV heads its q heads read, and the
output projection's partial sums are added over the model axis.  Otherwise
the reference's context parallelism (``_use_context_parallel``): each rank
takes its share of the query sequence and attends to the whole K/V, and the
outputs are gathered before the output projection.

The serving half: ``KVCache`` / ``QuantKVCache`` (int8 with per-(token,
head) absmax scales), ``attn_prefill_cache`` (the sliding-window ring order
included) and ``attn_decode`` (scalar or per-slot ``(B,)`` positions).  The
reference donates the cache to its jitted decode so XLA updates it in
place; the port writes the new entry into the preallocated buffers with
``index_copy_``/``index_put_`` and returns a cache that holds the same
tensors, so the caller's cache is updated too.  Positions stay on the
device: a decode step makes no host sync.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime import telemetry
from ..runtime.sharding import (
    constrain, reduce_tp, tp_join, tp_partial_grad, tp_pick, tp_rank, tp_size,
)
from .common import apply_rope, dense_init, rms_norm
from .config import ModelConfig

NEG_INF = -1e9


def _use_context_parallel(cfg: ModelConfig) -> bool:
    """Head-parallel TP needs ``n_heads % tp == 0``; where it fails, context
    parallelism shards the query sequence over the model axis instead:
    scores stay local against the whole (small) K/V, and the added
    communication is one gather of the outputs before the output
    projection.  The trigger is the q heads only, as the reference's."""
    tp = tp_size()
    return tp > 1 and cfg.n_heads % tp != 0


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


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 tp: bool = False):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), RoPE'd.

    ``tp`` (head-parallel; ``wq`` and ``bq`` hold this rank's columns
    only): q has this rank's ``H/tp`` heads, the whole K/V is projected
    (every rank the same), and ``_local_kv`` picks the heads those q heads
    read."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    h_loc = h // tp_size() if tp else h
    xq = tp_partial_grad(x) if tp else x  # each rank's heads add to dx
    q = xq @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h_loc, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q_norm = tp_partial_grad(p["q_norm"]) if tp else p["q_norm"]
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, tp: bool):
    """The K/V heads this rank's q heads read where ``tp`` (head-parallel),
    one per q head (the heads ``[r*H/tp, (r+1)*H/tp)`` read KV head
    ``i // (H/Hkv)``); whole K/V otherwise."""
    if not tp:
        return k, v
    h_loc = cfg.n_heads // tp_size()
    g = cfg.n_heads // cfg.n_kv_heads
    lo = tp_rank() * h_loc
    idx = [(lo + j) // g for j in range(h_loc)]
    return tp_pick(k, 2, idx), tp_pick(v, 2, idx)


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
    tp: bool = False,
):
    """Causal full-sequence attention (training), in an ``attn`` span.
    ``tp``: head-parallel, ``p`` holds this rank's heads (``wq``'s and
    ``bq``'s columns, ``wo``'s rows) and the output is summed over the
    model axis."""
    with telemetry.span("attn"):
        return _attn_forward(cfg, p, x, positions, q_chunk, return_kv, tp)


def _attn_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  q_chunk: int, return_kv: bool, tp: bool):
    b, s, _ = x.shape
    q, k_all, v_all = _project_qkv(cfg, p, x, positions, tp)
    k, v = _local_kv(cfg, k_all, v_all, tp)
    k_pos = positions if positions.ndim == 2 else positions.expand(b, s)
    q_pos = k_pos
    if _use_context_parallel(cfg):
        # context parallelism: queries S-sharded over the model axis, K/V
        # whole (Hkv*hd is small), so the scores stay local; each rank's
        # queries add their part to dK/dV
        q = constrain(q, "batch", "tp", None, None)
        q_pos = constrain(k_pos, "batch", "tp")
        if q.shape[1] != s:
            k, v = tp_partial_grad(k), tp_partial_grad(v)
    s_q = q.shape[1]
    qb = min(q_chunk, s_q)
    if s_q % qb:
        qb = math.gcd(s_q, qb)

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
        checkpoint(chunk_attn, q[:, i:i + qb], q_pos[:, i:i + qb],
                   use_reentrant=False, preserve_rng_state=False)
        for i in range(0, s_q, qb)
    ]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    if s_q != s:  # the query shares back together before the projection
        out = tp_join(out, 1)
    y = out.reshape(b, s, -1).to(x.dtype) @ p["wo"]
    if tp:  # row-parallel: partial sums
        y = reduce_tp(y)
    if return_kv:
        return y, (k_all, v_all)
    return y


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, L, Hkv, hd) model dtype
    v: torch.Tensor
    pos: torch.Tensor   # (L,) absolute position of each slot, -1 = empty; (B, L) in slot form


class QuantKVCache(NamedTuple):
    """int8 KV cache (``cfg.kv_quant``): per-(token, head) absmax scales.
    Halves the serving buffer that every decode step reads in full."""

    k: torch.Tensor        # (B, L, Hkv, hd) int8
    v: torch.Tensor        # int8
    k_scale: torch.Tensor  # (B, L, Hkv, 1) f32
    v_scale: torch.Tensor
    pos: torch.Tensor


def _quantize_kv(t: torch.Tensor):
    """(..., hd) -> int8 values + f32 absmax scale over hd."""
    t32 = t.float()
    scale = t32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.round(t32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def attn_cache_init(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
    *, device: str | torch.device = "cuda",
):
    l = cache_len(cfg, max_len)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    pos = torch.full((l,), -1, dtype=torch.int32, device=device)
    if cfg.kv_quant:
        return QuantKVCache(
            k=torch.zeros(batch, l, hkv, hd, dtype=torch.int8, device=device),
            v=torch.zeros(batch, l, hkv, hd, dtype=torch.int8, device=device),
            k_scale=torch.zeros(batch, l, hkv, 1, dtype=torch.float32, device=device),
            v_scale=torch.zeros(batch, l, hkv, 1, dtype=torch.float32, device=device),
            pos=pos,
        )
    return KVCache(
        k=torch.zeros(batch, l, hkv, hd, dtype=dtype, device=device),
        v=torch.zeros(batch, l, hkv, hd, dtype=dtype, device=device),
        pos=pos,
    )


def attn_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,   # (B, 1, D)
    cache,
    pos,               # int32 scalar, or (B,) for per-slot positions
):
    """One incremental token against the KV cache; returns ``(y, cache)``.

    Scalar ``pos`` (one-shot serving): every row at the same position,
    ``cache.pos`` shared, shape (L,).  Vector ``pos`` of shape (B,)
    (continuous batching): each decode slot on its own clock, ``cache.pos``
    per row, (B, L) (``model.cache_to_slots``); positions are
    request-relative, so RoPE matches a batch-of-one run.  The new entry
    is written into ``cache``'s buffers in place (slot ``pos % L``: a ring
    under a sliding window).  Runs in an ``attn`` span.
    """
    with telemetry.span("attn"):
        return _attn_decode(cfg, p, x, cache, pos)


def _attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache, pos):
    b = x.shape[0]
    l = cache.k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_slot = pos.ndim == 1
    positions = pos[:, None] if per_slot else pos.expand(b, 1)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    slot = pos % l
    quant = isinstance(cache, QuantKVCache)

    if per_slot:
        rows = torch.arange(b, device=x.device)

        def scatter(buf, new):
            # row i writes its own slot: buf[i, slot[i]] = new[i, 0]
            buf.index_put_((rows, slot.long()), new[:, 0].to(buf.dtype))
    else:
        idx = slot.long().view(1)

        def scatter(buf, new):
            buf.index_copy_(1, idx, new.to(buf.dtype))

    if quant:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        for buf, new in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs)):
            scatter(buf, new)
        k = _dequantize_kv(cache.k, cache.k_scale, x.dtype)
        v = _dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        scatter(cache.k, k_new)
        scatter(cache.v, v_new)
        k, v = cache.k, cache.v
    cpos = cache.pos
    if per_slot:
        cpos.index_put_((rows, slot.long()), pos)
        cur = pos[:, None]
        valid = (cpos >= 0) & (cpos <= cur)
        if cfg.sliding_window:
            valid &= cpos > cur - cfg.sliding_window
        vmask = valid[:, None, None, None, :]
    else:
        cpos.index_copy_(0, slot.long().view(1), pos.view(1))
        valid = (cpos >= 0) & (cpos <= pos)
        if cfg.sliding_window:
            valid &= cpos > pos - cfg.sliding_window
        vmask = valid[None, None, None, None, :]
    scores = _grouped_scores(q, k)  # (B,Hkv,G,1,L)
    scores = torch.where(vmask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _grouped_out(probs, v).to(x.dtype)  # (B,1,H,hd)
    return out.reshape(b, 1, -1) @ p["wo"], cache


def attn_prefill_cache(
    cfg: ModelConfig,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    max_len: int,
):
    """Build a cache from full-sequence K/V (used by prefill)."""
    s = k.shape[1]
    l = cache_len(cfg, max_len)
    pp = positions if positions.ndim == 1 else positions[0]
    pp = pp.to(torch.int32)
    if s >= l:
        # keep the last l entries, in ring order (slot = pos % l)
        kk, vv, pp = k[:, s - l:], v[:, s - l:], pp[s - l:]
        order = torch.argsort(pp % l, stable=True)
        kk, vv, pp = kk[:, order], vv[:, order], pp[order]
    else:
        pad = l - s
        kk = F.pad(k, (0, 0, 0, 0, 0, pad))
        vv = F.pad(v, (0, 0, 0, 0, 0, pad))
        pp = F.pad(pp, (0, pad), value=-1)
    if cfg.kv_quant:
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        return QuantKVCache(kq, vq, ks, vs, pp)
    return KVCache(kk.contiguous(), vv.contiguous(), pp.contiguous())


__all__ = [
    "attn_init",
    "attn_forward",
    "attn_decode",
    "attn_cache_init",
    "attn_prefill_cache",
    "KVCache",
    "QuantKVCache",
    "cache_len",
    "NEG_INF",
]
