"""Mamba2 in the port (``repro_torch.models.ssm``) against
``repro.models.ssm``: ``mamba_forward`` (chunked SSD, with the final conv
tail and state) and a chain of ``mamba_decode`` steps at 1e-5, one and two
groups, one and several chunks; the parameter init's tree and the cache
init equal; and Mamba models (mamba2-130m, jamba) through ``loss_fn``: the
loss and every parameter's gradient at 1e-4.  A block's parameters
are the reference's, carried across by ``convert.model_params_from_numpy``;
a model's are drawn once by the port's init and handed to both; inputs are
numpy from a seed; the JAX functions run jitted."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, model_params
from repro.configs import get_config as jget
from repro.models import ssm as JSSM
from repro.models.config import reduced as jreduced
from repro.train import steps as JS
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget
from repro_torch.models import ssm as TSSM
from repro_torch.models.config import reduced as treduced
from repro_torch.train import steps as TS

SSM_TOL, GRAD_TOL = 1e-5, 1e-4
_J_FWD = jax.jit(JSSM.mamba_forward, static_argnums=0, static_argnames=("return_state",))
_J_DECODE = jax.jit(JSSM.mamba_decode, static_argnums=0)


def _cfgs(**mamba_kw):
    jcfg = jreduced(jget("mamba2-130m"), dtype="float32")
    tcfg = treduced(tget("mamba2-130m"), dtype="float32")
    return (dataclasses.replace(jcfg, mamba=dataclasses.replace(jcfg.mamba, **mamba_kw)),
            dataclasses.replace(tcfg, mamba=dataclasses.replace(tcfg.mamba, **mamba_kw)))


def _params(jcfg, seed=0):
    jp = JSSM.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("groups,s", [(1, 16), (2, 16), (1, 12), (1, 5)],
                         ids=["g1-2chunks", "g2", "g1-gcd-chunk", "g1-one-chunk"])
def test_forward_and_decode_equal_reference(groups, s):
    jcfg, tcfg = _cfgs(n_groups=groups)
    jp, tp = _params(jcfg)
    assert tp["a_log"].dtype == tp["dt_bias"].dtype == torch.float32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jy, (jconv, jh) = _J_FWD(jcfg, jp, jnp.asarray(x), return_state=True)
    ty, (tconv, th) = TSSM.mamba_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    assert_close(ty, np.asarray(jy), SSM_TOL)
    assert_close(tconv, np.asarray(jconv), SSM_TOL)
    assert_close(th, np.asarray(jh), SSM_TOL)
    jc = JSSM.MambaCache(conv=jconv, h=jh)
    tc = TSSM.MambaCache(conv=tconv.contiguous(), h=th)
    for _ in range(3):
        xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = _J_DECODE(jcfg, jp, jnp.asarray(xd), jc)
        ty, tc = TSSM.mamba_decode(tcfg, tp, torch.from_numpy(xd), tc)
        assert_close(ty, np.asarray(jy), SSM_TOL)
        assert_close(tc.conv, np.asarray(jc.conv), SSM_TOL)
        assert_close(tc.h, np.asarray(jc.h), SSM_TOL)


def test_init_tree_and_cache_equal_reference():
    jcfg, tcfg = _cfgs()
    jp = JSSM.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = TSSM.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.float32, device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and str(tp[k].dtype)[6:] == str(jp[k].dtype)
    # dt lies in [1e-3, 1e-1] and A in [1, 16], as the reference draws them
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 1e-1 + 1e-7
    a = torch.exp(tp["a_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    jc = JSSM.mamba_cache_init(jcfg, 3, jnp.float32)
    tc = TSSM.mamba_cache_init(tcfg, 3, torch.float32, device="cpu")
    assert tuple(tc.conv.shape) == jc.conv.shape and tuple(tc.h.shape) == jc.h.shape
    assert tc.h.dtype == torch.float32 and not tc.h.any() and not tc.conv.any()


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_mamba_model_loss_and_grads_equal_reference(arch):
    jcfg = jreduced(jget(arch), dtype="float32")
    tcfg = treduced(tget(arch), dtype="float32")
    jp, tp = model_params(tcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(jcfg, p, jnp.asarray(toks), jnp.asarray(labels)), has_aux=True))(jp)
    leaves = [l.requires_grad_() for l in tree.leaves(tp)]
    loss, parts = TS.loss_fn(tcfg, tree.unflatten_like(tp, leaves), torch.from_numpy(toks),
                             torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(parts["aux"].detach()), float(jparts["aux"]), rtol=GRAD_TOL)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        assert_close(g, np.asarray(want), GRAD_TOL)
