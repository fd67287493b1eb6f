"""The serving half of the model stack in the port against the JAX package:
the KV caches and decode attention (``repro_torch.models.attention`` against
``repro.models.attention``: scalar and per-slot positions, the sliding-window
ring, the int8 cache) at 1e-5, and ``prefill``/``decode_step``/``init_cache``
with the slot-form helpers (``cache_to_slots``, ``cache_take``,
``cache_put``) on reduced configs (qwen3-4b with the Kron FFN on and off,
gemma-2b, deepseek-moe-16b, mamba2-130m, jamba) for the logits (1e-4) and
every cache leaf.  A model's parameters are drawn once by the port's init
and handed to both packages; ``convert.cache_from_numpy`` carries a
reference cache across; inputs are numpy from a seed; the JAX model
functions run jitted.  Also pinned: the decode step writes the cache in place
(the reference donates it), and ``cache_to_slots`` masks the pads of a
bucketed prefill in attention caches only, as the reference does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_gate, model_params
from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.config import reduced as jreduced
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.config import reduced as treduced

ATTN_TOL, LOGIT_TOL = 1e-5, 1e-4


def _cfgs(arch, **kw):
    return (dataclasses.replace(jreduced(jget(arch), dtype="float32"), **kw),
            # deepseek-moe-16b with the reference's renormalized gate (jax_gate)
            dataclasses.replace(jax_gate(treduced(tget(arch), dtype="float32")), **kw))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


_J_ATTN = jax.jit(JA.attn_forward, static_argnums=0, static_argnames=("return_kv",))
_J_PREFILL_CACHE = jax.jit(JA.attn_prefill_cache, static_argnums=(0, 4))
_J_ATTN_DECODE = jax.jit(JA.attn_decode, static_argnums=0)
_J_PREFILL = jax.jit(JM.prefill, static_argnums=(0, 3))
_J_DECODE = jax.jit(JM.decode_step, static_argnums=0)


def _assert_cache(got, want, tol=LOGIT_TOL):
    """Every leaf of a port cache against the reference's (paths in the
    reference's flatten order; int leaves exactly)."""
    jl = jax.tree.leaves(want)
    tl = tree.leaves(got)
    assert len(tl) == len(jl)
    for g, w in zip(tl, jl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert_close(g, w, tol)


# ---------------------------------------------------------------------------
# Attention: the caches and decode
# ---------------------------------------------------------------------------


def _attn_case(arch, seed, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = JA.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.model_params_from_numpy(_np_tree(jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch,kw,s,max_len", [
    ("qwen3-4b", {}, 12, 16),                         # padded cache
    ("mixtral-8x22b", {"sliding_window": 8}, 13, 16),  # ring: s >= L = 8
    ("gemma-2b", {"kv_quant": True}, 12, 16),         # int8 + scales
])
def test_prefill_cache_and_scalar_decode_equal_reference(arch, kw, s, max_len):
    jcfg, tcfg, jp, tp = _attn_case(arch, 0, **kw)
    rng = np.random.default_rng(0)
    b = 2
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    _, (jk, jv) = _J_ATTN(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    jc = _J_PREFILL_CACHE(jcfg, jk, jv, jnp.asarray(pos), max_len)
    _, (tk, tv) = TA.attn_forward(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                  return_kv=True)
    tc = TA.attn_prefill_cache(tcfg, tk.detach(), tv.detach(), torch.from_numpy(pos), max_len)
    assert type(tc).__name__ == type(jc).__name__
    _assert_cache(tc, jc, ATTN_TOL)
    # three decode steps on from the prefill (the ring wraps for mixtral)
    for step in range(3):
        xd = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = _J_ATTN_DECODE(jcfg, jp, jnp.asarray(xd), jc, jnp.int32(s + step))
        with torch.no_grad():
            ty, tc = TA.attn_decode(tcfg, tp, torch.from_numpy(xd), tc, s + step)
        assert_close(ty, np.asarray(jy), ATTN_TOL)
        _assert_cache(tc, jc, ATTN_TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_per_slot_decode_equal_reference(kv_quant):
    """Vector positions: each row on its own clock, pos per row (B, L)."""
    jcfg, tcfg, jp, tp = _attn_case("qwen3-4b", 1, kv_quant=kv_quant)
    b, max_len = 3, 16
    jc = JA.attn_cache_init(jcfg, b, max_len, jnp.float32)
    jc = jc._replace(pos=jnp.broadcast_to(jc.pos[None], (b, max_len)))
    tc = TA.attn_cache_init(tcfg, b, max_len, torch.float32, device="cpu")
    tc = tc._replace(pos=tc.pos[None].repeat(b, 1))
    rng = np.random.default_rng(1)
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(4):
        xd = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = _J_ATTN_DECODE(jcfg, jp, jnp.asarray(xd), jc, jnp.asarray(pos))
        with torch.no_grad():
            ty, tc = TA.attn_decode(tcfg, tp, torch.from_numpy(xd), tc, torch.from_numpy(pos))
        assert_close(ty, np.asarray(jy), ATTN_TOL)
        _assert_cache(tc, jc, ATTN_TOL)
        pos = pos + 1


def test_cache_init_and_len_equal_reference():
    for arch, kw in (("mixtral-8x22b", {"sliding_window": 8}), ("gemma-2b", {"kv_quant": True})):
        jcfg, tcfg = _cfgs(arch, **kw)
        assert TA.cache_len(tcfg, 32) == JA.cache_len(jcfg, 32)
        _assert_cache(TA.attn_cache_init(tcfg, 2, 32, torch.float32, device="cpu"),
                      JA.attn_cache_init(jcfg, 2, 32, jnp.float32))


def test_quantize_kv_equals_reference():
    x = np.random.default_rng(2).standard_normal((2, 5, 2, 16)).astype(np.float32)
    jq, js = JA._quantize_kv(jnp.asarray(x))
    tq, ts = TA._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert_close(ts, np.asarray(js), 1e-7)
    assert_close(TA._dequantize_kv(tq, ts, torch.float32),
                 np.asarray(JA._dequantize_kv(jq, js, jnp.float32)), 1e-7)


# ---------------------------------------------------------------------------
# The model: prefill, decode_step and the cache helpers
# ---------------------------------------------------------------------------

ARCHS = [("qwen3-4b", {"kron_ffn": True}), ("qwen3-4b", {}), ("gemma-2b", {}),
         ("deepseek-moe-16b", {}), ("mamba2-130m", {}), ("jamba-1.5-large-398b", {})]


@pytest.mark.parametrize("arch,kw", ARCHS, ids=[f"{a}{'-kron' if k else ''}" for a, k in ARCHS])
def test_prefill_and_decode_equal_reference(arch, kw):
    """``prefill`` then two scalar-pos ``decode_step``s: logits and every
    cache leaf; ``init_cache`` equal too."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = model_params(tcfg)
    rng = np.random.default_rng(3)
    b, s, max_len = 2, 8, 12
    toks = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    jl, jc = _J_PREFILL(jcfg, jp, jnp.asarray(toks), max_len)
    tl, tc = TM.prefill(tcfg, tp, torch.from_numpy(toks), max_len)
    assert tl.shape == (b, s, tcfg.padded_vocab) and tl.dtype == torch.float32
    assert_close(tl, np.asarray(jl), LOGIT_TOL)
    _assert_cache(tc, jc)
    for i in range(2):
        nxt = rng.integers(0, jcfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = _J_DECODE(jcfg, jp, jc, jnp.asarray(nxt), jnp.int32(s + i))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(nxt), s + i)
        assert tl.shape == (b, 1, tcfg.padded_vocab)
        assert_close(tl, np.asarray(jl), LOGIT_TOL)
        _assert_cache(tc, jc)
    _assert_cache(TM.init_cache(tcfg, b, max_len, device="cpu"), JM.init_cache(jcfg, b, max_len))


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b", "jamba-1.5-large-398b"])
def test_slot_helpers_equal_reference(arch):
    """``cache_to_slots`` with pad masking, ``cache_take`` of a prefilled
    row, ``cache_put`` into a decode slot, then a per-slot decode step,
    from a reference cache carried across by ``cache_from_numpy``."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = model_params(tcfg)
    rng = np.random.default_rng(4)
    bucket, max_len, slots = 8, 12, 3
    toks = rng.integers(0, jcfg.vocab, (2, bucket)).astype(np.int32)
    lens = np.array([5, 8], np.int32)
    _, jg = _J_PREFILL(jcfg, jp, jnp.asarray(toks), max_len)
    jg = JM.cache_to_slots(jg, true_lens=jnp.asarray(lens))
    tg = TM.cache_to_slots(convert.cache_from_numpy(
        _np_tree(_J_PREFILL(jcfg, jp, jnp.asarray(toks), max_len)[1]), device="cpu"),
        true_lens=lens)
    _assert_cache(tg, jg)
    jd = JM.cache_to_slots(JM.init_cache(jcfg, slots, max_len))
    td = TM.cache_to_slots(TM.init_cache(tcfg, slots, max_len, device="cpu"))
    _assert_cache(td, jd)
    _assert_cache(TM.cache_take(tg, 1), JM.cache_take(jg, 1))
    jd = JM.cache_put(jd, JM.cache_take(jg, 1), 2)
    td = TM.cache_put(td, TM.cache_take(tg, 1), 2)
    jd = JM.cache_put(jd, JM.cache_take(jg, 0), 0)
    td = TM.cache_put(td, TM.cache_take(tg, 0), 0)
    _assert_cache(td, jd)
    nxt = rng.integers(0, jcfg.vocab, (slots, 1)).astype(np.int32)
    pos = np.array([5, 0, 8], np.int32)
    jl, jd = _J_DECODE(jcfg, jp, jd, jnp.asarray(nxt), jnp.asarray(pos))
    tl, td = TM.decode_step(tcfg, tp, td, torch.from_numpy(nxt), torch.from_numpy(pos))
    assert_close(tl, np.asarray(jl), LOGIT_TOL)
    _assert_cache(td, jd)


def test_decode_writes_the_cache_in_place():
    """Kept difference: the reference donates the cache to XLA; the port
    writes the new entries into the cache's own buffers and returns them."""
    _, tcfg = _cfgs("jamba-1.5-large-398b")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    _, cache = TM.prefill(tcfg, tp, torch.zeros(2, 4, dtype=torch.int32), 8)
    before = [l.clone() for l in tree.leaves(cache)]
    ptrs = [l.data_ptr() for l in tree.leaves(cache)]
    _, out = TM.decode_step(tcfg, tp, cache, torch.ones(2, 1, dtype=torch.int32), 4)
    assert out is cache and [l.data_ptr() for l in tree.leaves(out)] == ptrs
    changed = [not torch.equal(a, b) for a, b in zip(before, tree.leaves(cache))]
    assert all(changed), changed  # k, v, pos of the attention layer, conv and h of Mamba's


def test_bucketed_mamba_prefill_keeps_its_pads_like_the_reference():
    """A note, not a fault of the port: ``cache_to_slots`` masks the pad
    entries of attention caches only, so a right-padded Mamba prefill's
    state has run over the pads, in the reference and in the port alike."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    jp, tp = model_params(tcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (1, 8)).astype(np.int32)
    padded = np.concatenate([toks[:, :5], np.zeros((1, 3), np.int32)], axis=1)
    jc = JM.cache_to_slots(_J_PREFILL(jcfg, jp, jnp.asarray(padded), 12)[1],
                           true_lens=jnp.asarray([5]))
    tc = TM.cache_to_slots(TM.prefill(tcfg, tp, torch.from_numpy(padded), 12)[1],
                           true_lens=[5])
    _assert_cache(tc, jc)
    _, unpadded = TM.prefill(tcfg, tp, torch.from_numpy(toks[:, :5]), 12)
    assert not torch.allclose(tc["stack"]["pos0"].h, unpadded["stack"]["pos0"].h)


def test_cache_from_numpy_refuses_other_trees():
    Other = type("Other", (tuple,), {"_fields": ("a",)})
    with pytest.raises(ValueError, match="not a cache"):
        convert.cache_from_numpy({"prelude": [Other((np.zeros(1),))], "stack": {}},
                                 device="cpu")
