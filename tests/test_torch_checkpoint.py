"""Checkpoints and the straggler monitor in the port
(repro_torch.checkpoint, repro_torch.runtime.fault) against the reference's
(repro.checkpoint, repro.runtime.fault): keep-k, ``.tmp`` ignored, async
save, a resumed run bit-exact, and checkpoints read across the packages:
every leaf bitwise, bf16 included, whole train states too."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as jget
from repro.models.config import reduced as jreduced
from repro.optim import ShampooConfig as JSh
from repro.train import steps as JS
from repro_torch import convert, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.data import SyntheticLM
from repro_torch.models.config import reduced as treduced
from repro_torch.optim import OptConfig, ShampooConfig
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.train import TrainState, make_train_step, train_state_init


def _tiny():
    cfg = treduced(tget("gemma_2b"), n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                   head_dim=16, d_ff=64, vocab=64, vocab_pad_multiple=32, dtype="float32")
    return cfg, OptConfig(lr=1e-3, warmup_steps=2, decay_steps=50)


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.tensor(1.5)}}
    for step in (1, 2, 3):
        mgr.save(step, tree.map(lambda x: x + step, t))
    assert mgr.all_steps() == [2, 3]  # keep-k pruned step 1
    got = mgr.restore(t, step=3)
    assert torch.equal(got["a"], torch.arange(6).reshape(2, 3) + 3)
    assert float(got["b"]["c"]) == 4.5


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.ones(3)})
    os.makedirs(tmp_path / "step_000000002.tmp")  # a crash mid-save
    assert mgr.latest_step() == 1
    mgr.save(3, {"x": torch.ones(3) * 3})  # gc removes the orphan
    assert not (tmp_path / "step_000000002.tmp").exists()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": torch.ones(3)})


def test_async_save_and_restore_checks(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(7, {"x": torch.arange(10)})
    mgr.wait()
    got = mgr.restore({"x": torch.zeros(10, dtype=torch.int32)})
    assert got["x"].dtype == torch.int32 and torch.equal(got["x"], torch.arange(10).int())
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"x": torch.zeros(11)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"y": torch.zeros(10)})


def test_training_resume_bitexact(tmp_path):
    """6 steps == 3 steps, checkpoint, restore, 3 more (Shampoo: the kron
    state and the host step counter ride along)."""
    cfg, _ = _tiny()
    opt_cfg = ShampooConfig(lr=1e-3, warmup_steps=2, decay_steps=50, precond_every=2)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, device="cpu")
    step_fn = make_train_step(cfg, opt_cfg)

    def run(state, a, b):
        for i in range(a, b):
            toks, labels = data.global_batch(i)
            state, _ = step_fn(state, {"tokens": toks, "labels": labels})
        return state

    def init():
        return train_state_init(cfg, opt_cfg, torch.Generator().manual_seed(0), device="cpu")

    s_full = run(init(), 0, 6)
    s_half = run(init(), 0, 3)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(3, s_half._asdict())
    s_resumed = run(TrainState(**mgr.restore(init()._asdict())), 3, 6)
    assert s_resumed.opt["step"].device.type == "cpu" and int(s_resumed.step) == 6
    for (p, a), (_, b) in zip(tree.leaves_with_path(s_full._asdict()),
                              tree.leaves_with_path(s_resumed._asdict())):
        assert torch.equal(a, b), p


def _mixed_np_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "h": np.asarray(jnp.asarray(rng.standard_normal((5, 2)), jnp.bfloat16)),
        "n": {"i": np.arange(4, dtype=np.int32), "ok": np.array([True, False]),
              "s": np.float32(2.5)},
        "factors": (rng.standard_normal((2, 2)).astype(np.float32),
                    np.asarray(jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16))),
        "layers": [np.zeros((1,), np.float32)],
    }


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    np_tree = _mixed_np_tree()
    JManager(str(tmp_path), keep=1).save(4, jax.tree.map(jnp.asarray, np_tree))
    target = convert.model_params_from_numpy(np_tree, device="cpu")
    zeros = tree.map(torch.zeros_like, target)
    got = CheckpointManager(str(tmp_path)).restore(zeros)
    assert got["h"].dtype == torch.bfloat16 and got["factors"][1].dtype == torch.bfloat16
    for (p, a), (_, b) in zip(tree.leaves_with_path(got), tree.leaves_with_path(target)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_port_checkpoint_restores_in_the_reference_and_matches_its_files(tmp_path):
    np_tree = _mixed_np_tree()
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(str(port_dir)).save(4, convert.model_params_from_numpy(np_tree,
                                                                          device="cpu"))
    JManager(str(ref_dir)).save(4, jax.tree.map(jnp.asarray, np_tree))
    step = "step_000000004"
    pm = json.loads((port_dir / step / "manifest.json").read_text())
    rm = json.loads((ref_dir / step / "manifest.json").read_text())
    assert pm["step"] == rm["step"] and pm["leaves"] == rm["leaves"]
    # every leaf file byte for byte, the bf16 ones ('<V2' words) included
    for leaf in rm["leaves"]:
        assert ((port_dir / step / leaf["file"]).read_bytes()
                == (ref_dir / step / leaf["file"]).read_bytes()), leaf["path"]
    # the reference restores the port's non-bf16 leaves
    plain = {k: v for k, v in np_tree.items() if k in ("w", "n", "layers")}
    CheckpointManager(str(tmp_path / "plain")).save(
        1, convert.model_params_from_numpy(plain, device="cpu"))
    got = JManager(str(tmp_path / "plain")).restore(jax.tree.map(jnp.asarray, plain))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(plain)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_states_cross_both_ways(tmp_path):
    """A reduced qwen3-4b Shampoo train state after one step: the port
    restores the reference's checkpoint, and the reference the port's."""
    jcfg = dataclasses.replace(jreduced(jget("qwen3-4b"), dtype="float32"), kron_ffn=True)
    tcfg = dataclasses.replace(treduced(tget("qwen3-4b"), dtype="float32"), kron_ffn=True)
    jo = JSh(precond_every=1)
    js = JS.train_state_init(jcfg, jo, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (2, 8)), jnp.int32)
    js, _ = JS.make_train_step(jcfg, jo)(js, {"tokens": toks, "labels": toks})
    JManager(str(tmp_path / "ref")).save(1, js._asdict())
    target = train_state_init(tcfg, ShampooConfig(precond_every=1),
                              torch.Generator().manual_seed(1), device="cpu")
    got = TrainState(**CheckpointManager(str(tmp_path / "ref")).restore(target._asdict()))
    want = jax.tree_util.tree_flatten_with_path(js._asdict())[0]
    mine = tree.leaves_with_path(got._asdict())
    assert [jax.tree_util.keystr(k, simple=True, separator="/") for k, _ in want] == [
        p for p, _ in mine]
    for (_, a), (_, b) in zip(want, mine):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    CheckpointManager(str(tmp_path / "port")).save(1, got._asdict())
    back = JManager(str(tmp_path / "port")).restore(js._asdict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js._asdict())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold_sigma=3.0, patience=1, warmup_steps=5)
    for i in range(20):
        mon.observe(i, 0.1 + 0.001 * (i % 3))
    assert not mon.flagged_steps
    assert mon.observe(20, 1.0)  # 10x outlier
    assert mon.flagged_steps and mon.flagged_steps[-1][0] == 20


def test_straggler_monitor_raises_after_patience():
    mon = StragglerMonitor(threshold_sigma=2.0, patience=2, warmup_steps=3, action="raise")
    for i in range(10):
        mon.observe(i, 0.1)
    mon.observe(10, 5.0)
    with pytest.raises(RuntimeError, match="straggler"):
        mon.observe(11, 5.0)


def test_straggler_monitor_rearms_after_firing():
    fired = []
    mon = StragglerMonitor(threshold_sigma=2.0, patience=2, warmup_steps=3,
                           action="callback", callback=lambda step, dt: fired.append(step))
    for i in range(10):
        mon.observe(i, 0.1)
    mon.observe(10, 5.0)          # slow 1/2: below patience
    mon.observe(11, 5.0)          # slow 2/2: fires, re-arms
    assert fired == [11]
    mon.observe(12, 5.0)          # slow 1/2 of the next window: no re-fire
    assert fired == [11]


def test_straggler_monitor_logs_on_the_ports_logger(capsys):
    mon = StragglerMonitor(threshold_sigma=2.0, patience=1, warmup_steps=3)
    for i in range(6):
        mon.observe(i, 0.1)
    mon.start()
    assert not mon.stop(6)  # a fast step
    assert mon.observe(7, 5.0)
    assert "[straggler-monitor] straggler: step 7" in capsys.readouterr().out
