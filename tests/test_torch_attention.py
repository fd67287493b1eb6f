"""Attention in the port (repro_torch.models.attention) against
repro.models.attention: ``attn_forward`` on the reduced qwen3-4b (qk-norm,
GQA, RoPE) with the query chunk shorter than the sequence, the parameters
made by the reference's init and carried across as numpy.  f32: forward
1e-5, gradients 1e-4 (``jax.grad`` against autograd: the f32 scores,
softmax and their backward are summed in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_jax, to_torch
from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models.config import reduced as jreduced
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as TA
from repro_torch.models.config import reduced as treduced

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _cfgs(**kw):
    return (dataclasses.replace(jreduced(jget("qwen3-4b"), dtype="float32"), **kw),
            dataclasses.replace(treduced(tget("qwen3-4b"), dtype="float32"), **kw))


@pytest.mark.parametrize("q_chunk,extra", [
    (4, {}),                                   # 4 chunks of a 16-token sequence
    (6, {}),                                   # 6 does not divide 16: gcd chunks of 2
    (16, {"qkv_bias": True, "sliding_window": 5}),
])
def test_attn_forward_and_grads_equal_reference(q_chunk, extra):
    jcfg, tcfg = _cfgs(**extra)
    jp = JA.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    if jcfg.qkv_bias:  # non-zero biases and norm scales, so their grads matter
        jp = {k: (v + 0.1 if v.ndim == 1 else v) for k, v in jp.items()}
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.arange(16)

    def jloss(p, xx):
        return jnp.sum(JA.attn_forward(jcfg, p, xx, jnp.asarray(pos), q_chunk=q_chunk) * ct)

    want = JA.attn_forward(jcfg, jp, to_jax(x), jnp.asarray(pos), q_chunk=q_chunk)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, to_jax(x))

    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    xt = to_torch(x).requires_grad_()
    y = TA.attn_forward(tcfg, leaves, xt, torch.from_numpy(pos), q_chunk=q_chunk)
    assert_close(y.detach(), np.asarray(want), FWD_TOL)
    keys = sorted(leaves)
    grads = torch.autograd.grad(y, [xt] + [leaves[k] for k in keys], to_torch(ct))
    assert_close(grads[0], np.asarray(jgx), GRAD_TOL)
    for k, g in zip(keys, grads[1:]):
        assert_close(g, np.asarray(jgp[k]), GRAD_TOL)


def test_attn_return_kv_and_batched_positions():
    jcfg, tcfg = _cfgs()
    jp = JA.attn_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(8), np.arange(8) + 3])  # (B, S) positions
    jy, (jk, jv) = JA.attn_forward(jcfg, jp, to_jax(x), jnp.asarray(pos), q_chunk=4,
                                   return_kv=True)
    ty, (tk, tv) = TA.attn_forward(tcfg, tp, to_torch(x), torch.from_numpy(pos), q_chunk=4,
                                   return_kv=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        assert_close(got, np.asarray(want), FWD_TOL)


def test_attn_init_shapes_equal_reference():
    jcfg, tcfg = _cfgs(qkv_bias=True)
    jp = JA.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    gen = torch.Generator().manual_seed(0)
    tp = TA.attn_init(gen, tcfg, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
