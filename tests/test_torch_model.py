"""The model stack in the port (repro_torch.models.model) against
repro.models.model: the parameter tree (paths, shapes, dtypes; the stacked
layout, at qwen3-4b's full size through a ``meta`` init beside
``jax.eval_shape``), and ``forward`` on the reduced qwen3-4b with the
reference's parameters carried across by ``convert.model_params_from_numpy``:
f32 logits at 1e-4 with ``kron_ffn`` on and off, remat on and off, and a
padded vocabulary; gradients into every parameter at 1e-4 (relative to
each leaf's largest; the two packages sum the f32 attention and the
LM head in different orders); the Mamba and MoE models' tree and forward
too, their parameters drawn once by the port's init and handed to both
(their serving half is in test_torch_serve_model.py)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_gate, model_params
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import reduced as jreduced
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.models.config import reduced as treduced

LOGIT_TOL, GRAD_TOL = 1e-4, 1e-4


def _cfgs(arch="qwen3-4b", **kw):
    return (dataclasses.replace(jreduced(jget(arch), dtype="float32"), **kw),
            # deepseek-moe-16b with the reference's renormalized gate (jax_gate)
            dataclasses.replace(jax_gate(treduced(tget(arch), dtype="float32")), **kw))


def _params(jcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_paths(t):
    return [(jax.tree_util.keystr(kp, simple=True, separator="/"), tuple(l.shape),
             str(l.dtype)) for kp, l in jax.tree_util.tree_flatten_with_path(t)[0]]


def _torch_paths(t):
    return [(p, tuple(l.shape), str(l.dtype).removeprefix("torch."))
            for p, l in tree.leaves_with_path(t)]


@pytest.mark.parametrize("kron", [True, False])
def test_full_size_tree_equals_reference(kron):
    """qwen3-4b at full size: the stacked (36, ...) leaves, their paths
    and bf16 dtypes equal ``jax.eval_shape`` of the reference's init."""
    jcfg = dataclasses.replace(jget("qwen3-4b"), kron_ffn=kron, kron_factors=2)
    tcfg = dataclasses.replace(tget("qwen3-4b"), kron_ffn=kron, kron_factors=2)
    want = jax.eval_shape(functools.partial(JM.init_params, jcfg), jax.random.PRNGKey(0))
    got = TM.init_params(tcfg, None, device="meta")
    assert _torch_paths(got) == _jax_paths(want)
    n = sum(l.numel() for l in tree.leaves(got))
    assert n == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(want))
    if kron:
        assert n == 1_723_039_872  # embed and lm_head 389 M each, attention 26.2 M a layer


@pytest.mark.parametrize("kron", [True, False])
def test_reduced_tree_and_init_equal_reference(kron):
    jcfg, tcfg = _cfgs(kron_ffn=kron)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _torch_paths(tp) == _jax_paths(jp)
    # the stacked layout: one (n_layers, ...) leaf per parameter of a layer
    assert tp["stack"]["pos0"]["mixer"]["q_norm"].shape == (tcfg.n_layers, tcfg.head_dim_)
    assert tp["prelude"] == []


@pytest.mark.parametrize("kron,remat,vocab", [
    (True, True, None), (False, True, None), (True, False, None), (False, False, 250),
])
def test_forward_logits_equal_reference(kron, remat, vocab):
    extra = {"vocab": vocab} if vocab else {}
    jcfg, tcfg = _cfgs(kron_ffn=kron, remat=remat, **extra)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    want, jaux = JM.forward(jcfg, jp, jnp.asarray(toks))
    got, aux = TM.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 16, tcfg.padded_vocab)
    assert_close(got, np.asarray(want), LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0
    if vocab:  # the padded rows never win the softmax
        assert float(got[..., tcfg.vocab:].max()) == -1e9


@pytest.mark.parametrize("kron", [True, False])
def test_forward_grads_equal_reference(kron):
    jcfg, tcfg = _cfgs(kron_ffn=kron)
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    ct = rng.standard_normal((2, 8, jcfg.padded_vocab)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(JM.forward(jcfg, p, jnp.asarray(toks))[0] * ct))(jp)
    leaves = [l.requires_grad_() for l in tree.leaves(tp)]
    logits, _ = TM.forward(tcfg, tp, torch.from_numpy(toks))
    grads = torch.autograd.grad(logits, leaves, torch.from_numpy(ct))
    for g, want in zip(grads, jax.tree.leaves(jg)):
        assert_close(g, np.asarray(want), GRAD_TOL)


def test_forward_bf16_follows_reference():
    """The default dtype (bf16 params, f32 logits) on the same params."""
    jcfg = dataclasses.replace(jreduced(jget("qwen3-4b")), kron_ffn=True)
    tcfg = dataclasses.replace(treduced(tget("qwen3-4b")), kron_ffn=True)
    jp, tp = _params(jcfg)
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    want, _ = JM.forward(jcfg, jp, jnp.asarray(toks))
    got, _ = TM.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    # bf16 layers: one rounding of a bf16 intermediate (2^-8) is the unit
    assert_close(got, np.asarray(want), 5e-2)


@pytest.mark.parametrize("arch", ["mamba2_130m", "deepseek_moe_16b", "mixtral_8x22b",
                                  "jamba_1_5_large_398b"])
def test_mamba_and_moe_forward_equal_reference(arch):
    """Mamba and MoE layers (and jamba's mix of both with attention): the
    parameter tree and the f32 logits and aux loss at 1e-4."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = model_params(tcfg)  # drawn once by the port, handed to both
    want_tree = jax.eval_shape(functools.partial(JM.init_params, jcfg), jax.random.PRNGKey(0))
    assert _torch_paths(tp) == _jax_paths(want_tree)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    want, jaux = jax.jit(JM.forward, static_argnums=0)(jcfg, jp, jnp.asarray(toks))
    got, aux = TM.forward(tcfg, tp, torch.from_numpy(toks))
    assert_close(got, np.asarray(want), LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=LOGIT_TOL)
    assert (float(aux) > 0) == (tcfg.moe is not None)
