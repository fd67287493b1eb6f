"""Mamba2 (SSD, state-space duality) block: the chunked prefill/train scan
and the O(1)-state recurrent decode.  [arXiv:2405.21060]

The port of ``repro.models.ssm``.  Recurrence (per head h, A a scalar per
head)::

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t (x) x_t      h: (N, P)
    y_t = C_t . h_t + D * x_t

The full-sequence form is chunked: within a chunk the output is a masked
``(C B^T)``-weighted matmul; across chunks a Python loop carries the
``(H, N, P)`` state (the reference's ``lax.scan``).  The streams (x, B, C
and the weights built from them) stay in the model dtype; the decay math
(cumulative sums, exponentials) and the carried state stay in f32, and the
contractions the reference runs with ``preferred_element_type=f32`` take
f32 operands here.  The einsums are ``torch.einsum``: the reference
computes them outside any Pallas kernel.  ``mamba_decode`` writes the new
conv tail and state into the cache in place, as ``attention.attn_decode``
does.  The reference's tensor-parallel hints belong to the next mesh
slice (``runtime/sharding.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, rms_norm
from .config import ModelConfig


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    d = cfg.d_model
    return mc, d, mc.d_inner(d), mc.n_heads(d), mc.d_state, mc.n_groups


def mamba_init(
    generator: torch.Generator | None, cfg: ModelConfig, dtype: torch.dtype,
    *, device: str | torch.device = "cuda",
) -> dict:
    mc, d, din, nh, n, g = _dims(cfg)
    conv_dim = din + 2 * g * n
    f32 = dict(device=device, dtype=torch.float32)
    # dt in [1e-3, 1e-1] log-uniform; stored as its inverse softplus
    u = torch.rand(nh, generator=generator, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_init = 1.0 + 15.0 * torch.rand(nh, generator=generator, **f32)
    p = {
        "wz": dense_init(generator, d, din, dtype, device),
        "wx": dense_init(generator, d, din, dtype, device),
        "wb": dense_init(generator, d, g * n, dtype, device),
        "wc": dense_init(generator, d, g * n, dtype, device),
        "wdt": dense_init(generator, d, nh, dtype, device),
        "dt_bias": dt_bias,
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(nh, **f32),
        "conv_w": (torch.randn(mc.d_conv, conv_dim, generator=generator, **f32)
                   * mc.d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "norm": torch.zeros(din, dtype=dtype, device=device),
    }
    p["wo"] = dense_init(generator, din, d, dtype, device)
    return p


def _proj_conv(cfg, p, x, conv_state=None):
    """Project + causal depthwise conv.  x: (B,S,D).
    Returns z, xh (B,S,H,P), bh/ch (B,S,G,N), dt (B,S,H) f32 and the new
    conv tail."""
    mc, d, din, nh, n, g = _dims(cfg)
    b, s, _ = x.shape
    z = x @ p["wz"]
    xbc = torch.cat([x @ p["wx"], x @ p["wb"], x @ p["wc"]], dim=-1)
    width = mc.d_conv
    if conv_state is None:
        pad = torch.zeros(b, width - 1, xbc.shape[-1], dtype=xbc.dtype, device=x.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xbc_pad = torch.cat([pad, xbc], dim=1)  # (B, S+w-1, C)
    # causal depthwise conv as a sum of shifted slices (w is tiny: 4)
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + xbc_pad[:, i:i + s] * p["conv_w"][i]
    xbc = F.silu(out + p["conv_b"])
    new_tail = xbc_pad[:, -(width - 1):] if width > 1 else pad
    xh = xbc[..., :din].reshape(b, s, nh, mc.head_dim)
    bh = xbc[..., din:din + g * n].reshape(b, s, g, n)
    ch = xbc[..., din + g * n:].reshape(b, s, g, n)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])  # (B,S,H) f32
    return z, xh, bh, ch, dt, new_tail


def _expand_groups(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(B,S,G,N) -> (B,S,H,N), each group broadcast over H/G heads."""
    b, s, g, n = t.shape
    return t[:, :, :, None, :].expand(b, s, g, nh // g, n).reshape(b, s, nh, n)


def mamba_forward(cfg: ModelConfig, p: dict, x: torch.Tensor, *, return_state: bool = False):
    """Chunked SSD scan.  x: (B,S,D); the chunk is the largest divisor of
    S up to ``cfg.mamba.chunk``."""
    mc, d, din, nh, n, g = _dims(cfg)
    b, s, _ = x.shape
    z, xh, bh, ch, dt, conv_tail = _proj_conv(cfg, p, x)
    sdt = x.dtype
    bh = _expand_groups(bh, nh).to(sdt)
    ch = _expand_groups(ch, nh).to(sdt)
    xh = xh.to(sdt)
    a = -torch.exp(p["a_log"])            # (H,) negative
    da = dt * a                           # (B,S,H) log-decay per step, f32

    lc = min(mc.chunk, s)
    if s % lc:
        lc = math.gcd(s, lc)
    nc = s // lc
    ph = mc.head_dim

    def chunk(arr, *feat):
        return arr.reshape(b, nc, lc, *feat)

    xc, bc, cc = chunk(xh, nh, ph), chunk(bh, nh, n), chunk(ch, nh, n)
    dac, dtc = chunk(da, nh), chunk(dt, nh)

    cum = torch.cumsum(dac, dim=2)         # (B,nc,lc,H) inclusive, f32
    total = cum[:, :, -1:, :]              # (B,nc,1,H)

    # intra-chunk: Y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j X_j
    smat = torch.einsum("bclhn,bckhn->bchlk", cc, bc)  # (B,nc,H,lc,lc)
    cum_t = cum.transpose(2, 3)            # (B,nc,H,lc)
    logw = cum_t[..., :, None] - cum_t[..., None, :]
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=x.device))
    # masked in log space before exp: no inf * 0 in the gradient
    logw = torch.where(mask, logw, -1e30)
    dt_j = dtc.transpose(2, 3)[..., None, :]          # (B,nc,H,1,lc)
    w = (torch.exp(logw) * dt_j).to(sdt)
    y_intra = torch.einsum("bchlk,bckhp->bclhp", (smat * w).float(), xc.float())

    # chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j (x) X_j  (H,N,P)
    decay_to_end = (torch.exp(total - cum) * dtc).to(sdt)  # (B,nc,lc,H)
    sstate = torch.einsum("bclh,bclhn,bclhp->bchnp",
                          decay_to_end.float(), bc.float(), xc.float())

    # inter-chunk recurrence over nc: h_c = h_{c-1} * exp(total_c) + S_c
    chunk_decay = torch.exp(total[:, :, 0, :])  # (B,nc,H)
    h = torch.zeros(b, nh, n, ph, dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + sstate[:, c]
    h_prev = torch.stack(h_prevs, dim=1)   # (B,nc,H,N,P) state entering each chunk

    # inter contribution: Y[i] += C_i . (h_prev * exp(cum_i))
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           (cc * torch.exp(cum).to(sdt)[..., None]).float(), h_prev)

    y = (y_intra + y_inter).reshape(b, s, nh, ph)
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(b, s, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["wo"]
    if return_state:
        return out, (conv_tail, h)
    return out


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim)
    h: torch.Tensor      # (B, H, N, P) f32


def mamba_cache_init(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, *, device: str | torch.device = "cuda",
) -> MambaCache:
    mc, d, din, nh, n, g = _dims(cfg)
    conv_dim = din + 2 * g * n
    return MambaCache(
        conv=torch.zeros(batch, mc.d_conv - 1, conv_dim, dtype=dtype, device=device),
        h=torch.zeros(batch, nh, n, mc.head_dim, dtype=torch.float32, device=device),
    )


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: MambaCache):
    """One token.  x: (B, 1, D).  Returns ``(y, cache)``, the cache's conv
    tail and state overwritten in place."""
    mc, d, din, nh, n, g = _dims(cfg)
    b = x.shape[0]
    z, xh, bh, ch, dt, conv_tail = _proj_conv(cfg, p, x, conv_state=cache.conv)
    bh = _expand_groups(bh, nh).float()[:, 0]   # (B,H,N)
    ch = _expand_groups(ch, nh).float()[:, 0]
    xh32 = xh.float()[:, 0]                      # (B,H,P)
    dt = dt[:, 0]                                # (B,H)
    dec = torch.exp(dt * -torch.exp(p["a_log"]))  # (B,H)
    h = cache.h * dec[..., None, None] + torch.einsum("bh,bhn,bhp->bhnp", dt, bh, xh32)
    y = torch.einsum("bhn,bhnp->bhp", ch, h) + xh32 * p["d_skip"][:, None]
    y = y.reshape(b, 1, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    cache.conv.copy_(conv_tail)
    cache.h.copy_(h)
    return y @ p["wo"], cache


__all__ = [
    "mamba_init",
    "mamba_forward",
    "mamba_decode",
    "mamba_cache_init",
    "MambaCache",
]
