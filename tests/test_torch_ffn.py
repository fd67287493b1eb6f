"""Model configs and the FFN block in the port (repro_torch.configs,
repro_torch.models) against repro.configs and repro.models: every config
equal field by field, the shared components, and ``ffn_apply`` with
``kron_ffn`` on and off on parameters made by the reference's init and
carried across by ``convert.ffn_params_from_numpy`` (forward and gradients;
f64 1e-12, f32 1e-5, bf16 1e-2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_jax, to_torch
from repro import configs as JC
from repro.models import common as JM
from repro.models import ffn as JF
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import LayerSpec, ModelConfig, common as TM, ffn as TF

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_every_config_equals_reference(arch):
    """Every field equal but the MoE gate rule: the reference renormalizes
    the top-k gates of every model; the port keeps deepseek-moe-16b's
    published gate (``norm_topk=False``), a kept difference."""
    got, want = TC.get_config(arch), JC.get_config(arch)
    assert isinstance(got, ModelConfig)
    if got.moe is not None:
        assert got.moe.norm_topk == (arch != "deepseek_moe_16b")
        got_d = dataclasses.asdict(got)
        del got_d["moe"]["norm_topk"]
        assert got_d == dataclasses.asdict(want)
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [dataclasses.asdict(s) for s in got.layer_plan()] == [
        dataclasses.asdict(s) for s in want.layer_plan()]


def test_config_registry_equals_reference():
    assert TC.ARCHS == JC.ARCHS and TC.ALIASES == JC.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert TC.runnable_cells() == JC.runnable_cells()
    assert TC.skipped_cells() == JC.skipped_cells()
    assert TC.get_config("qwen3-4b") == TC.get_config("qwen3_4b")
    with pytest.raises(KeyError):
        TC.get_config("gpt-5")
    assert LayerSpec is not None


def _cfg(kron, act="silu", d=64, f=96):
    base = TC.get_config("qwen3-4b")
    return dataclasses.replace(base, d_model=d, d_ff=f, kron_ffn=kron, kron_factors=2,
                               ffn_act=act)


TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("kron", [True, False])
def test_ffn_apply_and_grads_equal_reference(kron, act, dtype):
    cfg = _cfg(kron, act)
    jcfg = dataclasses.replace(JC.get_config("qwen3-4b"), d_model=64, d_ff=96,
                               kron_ffn=kron, kron_factors=2, ffn_act=act)
    jp = JF.ffn_init(jax.random.PRNGKey(0), jcfg, dtype)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    tp = convert.ffn_params_from_numpy(npp, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64)).astype(dtype)
    ct = rng.standard_normal((2, 3, 64)).astype(dtype)

    def jloss(p, xx):
        return jnp.sum(JF.ffn_apply(jcfg, p, xx) * ct)

    want = JF.ffn_apply(jcfg, jp, to_jax(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, to_jax(x))
    leaves_t, _ = jax.tree_util.tree_flatten(
        tp, is_leaf=lambda a: isinstance(a, torch.Tensor))
    for t in leaves_t:
        t.requires_grad_()
    xt = to_torch(x).requires_grad_()
    y = TF.ffn_apply(cfg, tp, xt)
    assert_close(y.detach(), want, TOL[dtype])
    got = torch.autograd.grad(y, [xt, *leaves_t], to_torch(ct))
    assert_close(got[0], jgx, TOL[dtype])
    jleaves, _ = jax.tree_util.tree_flatten(jgp)
    assert len(jleaves) == len(leaves_t)
    for g, w in zip(got[1:], jleaves):
        assert_close(g, w, TOL[dtype])


def test_kron_ffn_bf16_equals_reference():
    """bf16 parameters and activations: the port keeps each stage's sums in
    f32 and rounds once; the reference's XLA path rounds per factor
    (ROADMAP queue 3 item 4), hence 1e-2."""
    jcfg = dataclasses.replace(JC.get_config("qwen3-4b"), d_model=64, d_ff=96,
                               kron_ffn=True, kron_factors=2)
    jp = JF.ffn_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    want = JF.ffn_apply(jcfg, jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp),
                        to_jax(x, jnp.bfloat16))
    tp = convert.ffn_params_from_numpy(npp, device="cpu", dtype=torch.bfloat16)
    got = TF.ffn_apply(_cfg(True), tp, to_torch(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-2)


def test_full_width_kron_ffn_shapes():
    """qwen3-4b with kron_ffn and two factors: w1 and w3 are (64, 40) x
    (128, 76), w2 the reverse; the port's init draws them on the caller's
    device (here the CPU), with the parameter count of the reference."""
    cfg = dataclasses.replace(TC.get_config("qwen3-4b"), kron_ffn=True, kron_factors=2)
    jcfg = dataclasses.replace(JC.get_config("qwen3-4b"), kron_ffn=True, kron_factors=2)
    gen = torch.Generator().manual_seed(0)
    p = TF.ffn_init(gen, cfg, torch.float32, device="cpu")
    shapes = {k: [tuple(f.shape) for f in v["factors"]] for k, v in p.items()}
    assert shapes == {"w1": [(64, 128), (40, 76)], "w3": [(64, 128), (40, 76)],
                      "w2": [(128, 64), (76, 40)]}
    jshapes = jax.eval_shape(lambda k: JF.ffn_init(k, jcfg, jnp.float32), jax.random.PRNGKey(0))
    assert {k: [tuple(f.shape) for f in v["factors"]] for k, v in jshapes.items()} == shapes
    dense = TF.ffn_init(gen, dataclasses.replace(cfg, kron_ffn=False, d_model=64, d_ff=96),
                        torch.float32, device="cpu")
    assert tuple(dense["w1"].shape) == (64, 96) and tuple(dense["w2"].shape) == (96, 64)
    # The truncated-normal fan-in init: within two standard deviations.
    assert float(dense["w1"].abs().max()) <= 2 * 64 ** -0.5 + 1e-6


def test_common_components_equal_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8))
    scale = rng.standard_normal(8)
    # Both reduce the variance in f32 whatever the input dtype: f32's 1e-5.
    assert_close(TM.rms_norm(to_torch(x), to_torch(scale)),
                 JM.rms_norm(to_jax(x), to_jax(scale)), 1e-5)
    pos = np.arange(5)
    assert_close(TM.apply_rope(to_torch(x), torch.arange(5), 10000.0),
                 JM.apply_rope(to_jax(x), jnp.asarray(pos), 10000.0), 1e-5)
    assert_close(TM.rope_freqs(8, 1e6), JM.rope_freqs(8, 1e6), 1e-6)
    for name in ("silu", "gelu"):
        assert_close(TM.act_fn(name)(to_torch(x)), JM.act_fn(name)(to_jax(x)), 1e-12)
    gen = torch.Generator().manual_seed(0)
    e = TM.embed_init(gen, 1000, 16, torch.float32, "cpu")
    assert e.shape == (1000, 16) and abs(float(e.std()) - 0.02) < 0.002
