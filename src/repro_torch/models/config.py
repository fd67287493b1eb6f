"""Model configuration covering all assigned architecture families.

One frozen dataclass describes dense / GQA / MoE / SSM / hybrid / frontend-
stub models.  ``layer_plan`` expands it into the per-layer kinds; the stack
is scanned over the repeating *period* of that plan (hybrids like Jamba have
period 8: 1 attention + 7 mamba, MoE on odd positions).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Literal


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                     # per-expert FFN hidden dim
    n_shared: int = 0                 # DeepSeek-style always-on experts
    capacity_factor: float = 1.25
    # Top-k gates renormalized to sum to 1 (Mixtral, Jamba and the JAX
    # package for every model); False: the top-k softmax scores as they
    # are, DeepSeekMoE's g_i = s_i (its config.json: norm_topk_prob false).
    norm_topk: bool = True
    every: int = 1                    # MoE layer period (Jamba: 2)
    offset: int = 0                   # first MoE layer index within period
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128                  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class LayerSpec:
    kind: Literal["attn", "mamba"]
    moe: bool


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                       # 0 => attention-free
    n_kv_heads: int
    d_ff: int                          # dense-FFN hidden (0 => no dense FFN)
    vocab: int
    head_dim: int | None = None        # default d_model // n_heads
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    # ffn
    ffn_act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    # moe / ssm / hybrid
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    attn_layer_period: int | None = None   # hybrid: 1 attn per this many
    attn_layer_offset: int = 0
    moe_skip_first: int = 0            # DeepSeek: first layer is dense
    # embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False          # Gemma multiplies embeds by sqrt(d)
    # modality frontend stub ([vlm]/[audio]): forward takes precomputed
    # frame/patch embeddings alongside (or instead of) token ids.
    frontend: str | None = None        # None | "vision" | "audio"
    n_frontend_tokens: int = 0         # patch/frame tokens prepended
    # kron compression (the paper's technique as a first-class feature)
    kron_ffn: bool = False
    kron_proj: bool = False
    kron_factors: int = 2
    # numerics / runtime
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128      # pad embedding rows for TP
    remat: bool = True
    kv_quant: bool = False             # int8 KV cache (serving memory)

    # -- derived ----------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    def layer_plan(self) -> list[LayerSpec]:
        plan = []
        for i in range(self.n_layers):
            if self.attn_free:
                kind = "mamba"
            elif self.attn_layer_period is not None:
                kind = (
                    "attn"
                    if i % self.attn_layer_period == self.attn_layer_offset
                    else "mamba"
                )
            else:
                kind = "attn"
            moe = (
                self.moe is not None
                and i >= self.moe_skip_first
                and i % self.moe.every == self.moe.offset % self.moe.every
            )
            plan.append(LayerSpec(kind, moe))
        return plan

    @property
    def period(self) -> int:
        """Smallest repeating suffix period of the layer plan (after the
        irregular prefix ``prelude_len``)."""
        plan = self.layer_plan()[self.prelude_len:]
        n = len(plan)
        cand = 1
        if self.attn_layer_period:
            cand = math.lcm(cand, self.attn_layer_period)
        if self.moe:
            cand = math.lcm(cand, self.moe.every)
        # verify
        if n % cand == 0 and all(
            plan[i] == plan[i % cand] for i in range(n)
        ):
            return cand
        return n  # fallback: no scan sharing (single period)

    @property
    def prelude_len(self) -> int:
        """Leading layers that break the periodic pattern (unscanned)."""
        return self.moe_skip_first if self.moe is not None else 0

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.prelude_len) // self.period

    # -- parameter counting (for roofline MODEL_FLOPS) ---------------------

    def param_count(self, *, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim_
        total = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        for spec in self.layer_plan():
            if spec.kind == "attn":
                total += d * self.n_heads * hd  # wq
                total += 2 * d * self.n_kv_heads * hd  # wk, wv
                total += self.n_heads * hd * d  # wo
            else:
                mc = self.mamba
                din = mc.d_inner(d)
                nh = mc.n_heads(d)
                conv_dim = din + 2 * mc.n_groups * mc.d_state
                total += d * (2 * din + 2 * mc.n_groups * mc.d_state + nh)
                total += conv_dim * mc.d_conv
                total += din * d  # out_proj
                total += 3 * nh  # A, D, dt_bias
            if spec.moe:
                mc = self.moe
                e = mc.top_k if active_only else mc.n_experts
                total += 3 * d * mc.d_expert * e + d * mc.n_experts  # router
                if mc.n_shared:
                    total += 3 * d * mc.d_expert * mc.n_shared
            elif self.d_ff:
                total += 3 * d * self.d_ff
        return total


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    base = dict(
        n_layers=max(2, cfg.period + cfg.prelude_len),
        d_model=64,
        n_heads=0 if cfg.attn_free else 4,
        n_kv_heads=0 if cfg.attn_free else max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16 if not cfg.attn_free else None,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        vocab_pad_multiple=32,
    )
    if cfg.moe is not None:
        # capacity_factor = E/k makes capacity == S: routing never drops, so
        # prefill+decode is bit-consistent with the full forward (drop
        # behaviour is unit-tested separately in tests/test_moe.py).
        base["moe"] = replace(
            cfg.moe, n_experts=4, top_k=2, d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1), capacity_factor=2.0,
        )
    if cfg.mamba is not None:
        base["mamba"] = replace(
            cfg.mamba, d_state=16, head_dim=16, chunk=8,
        )
    if cfg.attn_layer_period is not None:
        base["n_layers"] = cfg.attn_layer_period
        base["attn_layer_offset"] = min(cfg.attn_layer_offset, base["n_layers"] - 1)
    if cfg.n_frontend_tokens:
        base["n_frontend_tokens"] = 4
    base.update(overrides)
    return replace(cfg, **base)


__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "LayerSpec", "reduced"]
