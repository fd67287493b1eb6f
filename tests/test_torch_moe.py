"""MoE in the port (``repro_torch.models.moe``) against ``repro.models.moe``:
``moe_apply``'s output and aux loss at 1e-5 (routed experts alone, with a
shared expert, and the shared experts as a Kron FFN), the capacity formula,
and MoE models through ``loss_fn`` (loss and every parameter's gradient at
1e-4).  A block's parameters are the reference's, carried across by
``convert.model_params_from_numpy``; a model's are drawn once by the port's
init and handed to both; inputs are numpy from a seed; the JAX functions
run jitted.

Pinned as a kept difference: when a token overflows capacity, the
reference's index map redirects the dropped slot's write to (expert 0,
slot 0), an index in range, and overwrites the token kept there; the port
writes the map from kept slots only."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_gate, model_params
from repro.models import moe as JMoE
from repro.models.config import ModelConfig as JCfg
from repro.models.config import MoEConfig as JMoECfg
from repro.train import steps as JS
from repro_torch import convert, tree
from repro_torch.models import moe as TMoE
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.models.config import MoEConfig as TMoECfg
from repro_torch.train import steps as TS

MOE_TOL, GRAD_TOL = 1e-5, 1e-4
_J_MOE = jax.jit(JMoE.moe_apply, static_argnums=0)
_J_ROUTE = jax.jit(JMoE._route_one_seq, static_argnums=(2, 3))


def _cfgs(e=4, k=2, cf=2.0, n_shared=0, kron_ffn=False, d=16, ffn_act="silu"):
    def make(cfg_cls, moe_cls):
        return cfg_cls(
            name="t", family="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2,
            d_ff=0, vocab=32, ffn_act=ffn_act, kron_ffn=kron_ffn,
            moe=moe_cls(n_experts=e, top_k=k, d_expert=8, n_shared=n_shared,
                        capacity_factor=cf),
            dtype="float32",
        )
    return make(JCfg, JMoECfg), make(TCfg, TMoECfg)


def _params(jcfg, seed=0):
    jp = JMoE.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("kw", [{}, {"n_shared": 1}, {"n_shared": 2, "kron_ffn": True},
                                {"e": 8, "k": 3, "ffn_act": "gelu"}],
                         ids=["routed", "shared", "shared-kron", "top3-gelu"])
def test_moe_apply_equals_reference(kw):
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg)
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(0).standard_normal((2, 16, 16)).astype(np.float32)
    want, jaux = _J_MOE(jcfg, jp, jnp.asarray(x))
    got, aux = TMoE.moe_apply(tcfg, tp, torch.from_numpy(x))
    assert_close(got, np.asarray(want), MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_drops_without_a_kept_token_hit_equal_reference():
    """Tiny capacity, tokens dropped: wherever the reference's clobber hits
    no kept token (no token kept in expert 0's first slot is overwritten),
    the two agree; the routing maps agree on every kept slot."""
    jcfg, tcfg = _cfgs(cf=0.1)
    jp, tp = _params(jcfg, seed=1)
    x = np.random.default_rng(1).standard_normal((1, 64, 16)).astype(np.float32)
    cap = JMoE._capacity(64, jcfg.moe)
    assert cap == TMoE._capacity(64, tcfg.moe)
    logits = x[0] @ np.asarray(jp["router"])
    jsrc, (_, _, _, jkeep) = _J_ROUTE(jnp.asarray(x[0]), jnp.asarray(logits), jcfg.moe, cap)
    tsrc, (_, _, _, tkeep) = TMoE._route(torch.from_numpy(logits[None]), tcfg.moe, cap)
    np.testing.assert_array_equal(tkeep[0].numpy(), np.asarray(jkeep))
    jsrc, tsrc = np.asarray(jsrc), tsrc[0].numpy()
    assert (~np.asarray(jkeep)).any()            # tokens were dropped
    differs = jsrc != tsrc
    # the reference's only difference: expert 0, slot 0 set to -1
    assert not differs.any() or (differs.sum() == 1 and differs[0, 0] and jsrc[0, 0] == -1)


def test_dropped_token_does_not_clobber_a_kept_one():
    """16 tokens, capacity 8: token 0 alone goes to expert 0, the other 15
    to expert 1 (7 dropped).  The reference keeps token 0 (``keep[0]``) but
    its index map reads -1 at (expert 0, slot 0), so token 0 loses expert
    0's output; the port keeps token 0 in expert 0."""
    jcfg, tcfg = _cfgs(e=2, k=1, cf=0.5, d=2)
    cap = JMoE._capacity(16, jcfg.moe)
    assert cap == 8
    jp, tp = _params(jcfg, seed=2)
    router = np.array([[4.0, -4.0], [-4.0, 4.0]], np.float32)
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    x = np.zeros((1, 16, 2), np.float32)
    x[0, 0, 0] = 1.0
    x[0, 1:, 1] = 1.0
    logits = x[0] @ router
    jsrc, (_, _, _, jkeep) = _J_ROUTE(jnp.asarray(x[0]), jnp.asarray(logits), jcfg.moe, cap)
    assert bool(jkeep[0]) and int(jsrc[0, 0]) == -1        # the reference's clobber
    tsrc, (_, _, _, tkeep) = TMoE._route(torch.from_numpy(logits[None]), tcfg.moe, cap)
    assert bool(tkeep[0, 0]) and int(tsrc[0, 0, 0]) == 0      # the port keeps token 0
    np.testing.assert_array_equal(tsrc[0, 1].numpy(), np.asarray(jsrc[1]))
    want, _ = _J_MOE(jcfg, jp, jnp.asarray(x))
    got, _ = TMoE.moe_apply(tcfg, tp, torch.from_numpy(x))
    assert float(np.abs(np.asarray(want[0, 0])).max()) == 0.0
    # token 0 through expert 0 alone, with its full router weight
    xe = torch.from_numpy(x[0, :1])
    h = torch.nn.functional.silu(xe @ tp["ew1"][0]) * (xe @ tp["ew3"][0])
    assert_close(got[0, :1], (h @ tp["ew2"][0]).numpy(), MOE_TOL)
    assert_close(got[0, 1:], np.asarray(want[0, 1:]), MOE_TOL)  # the rest agree


def test_capacity_formula_equals_reference():
    for s, e, k, cf in ((1024, 8, 2, 1.25), (1, 8, 2, 1.25), (512, 64, 6, 1.25), (16, 4, 2, 2.0)):
        jm = JMoECfg(n_experts=e, top_k=k, d_expert=4, capacity_factor=cf)
        tm = TMoECfg(n_experts=e, top_k=k, d_expert=4, capacity_factor=cf)
        assert TMoE._capacity(s, tm) == JMoE._capacity(s, jm)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_moe_model_loss_and_grads_equal_reference(arch):
    from repro.configs import get_config as jget
    from repro.models.config import reduced as jreduced
    from repro_torch.configs import get_config as tget
    from repro_torch.models.config import reduced as treduced

    jcfg = jreduced(jget(arch), dtype="float32")
    tcfg = jax_gate(treduced(tget(arch), dtype="float32"))  # the reference renormalizes
    if arch == "deepseek-moe-16b":  # the prelude's FFN and the shared experts as Kron FFNs
        jcfg = dataclasses.replace(jcfg, kron_ffn=True)
        tcfg = dataclasses.replace(tcfg, kron_ffn=True)
    jp, tp = model_params(tcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(jcfg, p, jnp.asarray(toks), jnp.asarray(labels)), has_aux=True))(jp)
    leaves = [l.requires_grad_() for l in tree.leaves(tp)]
    loss, parts = TS.loss_fn(tcfg, tree.unflatten_like(tp, leaves), torch.from_numpy(toks),
                             torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(parts["aux"].detach()), float(jparts["aux"]), rtol=GRAD_TOL)
    assert float(parts["aux"].detach()) > 0
    for g, want in zip(grads, jax.tree.leaves(jg)):
        assert_close(g, np.asarray(want), GRAD_TOL)
