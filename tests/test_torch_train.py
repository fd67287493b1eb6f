"""The train step in the port (repro_torch.train, .data, .launch.train)
against repro.train on the reduced qwen3-4b in f32: ``loss_fn``, then two
``make_train_step`` steps under AdamW and under Shampoo from the
reference's init (carried across by ``convert.model_params_from_numpy`` and
``opt_state_from_numpy``) on the same numpy tokens.  Tolerances: the loss
and grad norm 1e-5 relative (f32 sums of the same terms in another order);
the parameters 1e-5 of each leaf's largest (at least 1): Adam divides by
sqrt(v), so a last-bit difference in a small gradient moves its step by a
few ulps (about 2e-6 measured).  Also microbatch accumulation against the
full batch (the reference's own bounds), ``SyntheticLM`` and the launcher
in a subprocess."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.configs import get_config as jget
from repro.models.config import reduced as jreduced
from repro.optim import OptConfig as JOpt, ShampooConfig as JSh
from repro.train import steps as JS
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.models.config import reduced as treduced
from repro_torch.optim import OptConfig as TOpt, ShampooConfig as TSh
from repro_torch.train import steps as TS

LOSS_TOL, PARAM_TOL = 1e-5, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(kron=True):
    return (dataclasses.replace(jreduced(jget("qwen3-4b"), dtype="float32"), kron_ffn=kron),
            dataclasses.replace(treduced(tget("qwen3-4b"), dtype="float32"), kron_ffn=kron))


def _carry(jstate):
    """The reference's TrainState as the port's."""
    return TS.TrainState(
        convert.model_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu"),
        convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate.opt), device="cpu"),
        torch.tensor(int(jstate.step), dtype=torch.int32))


def _tokens(seed, vocab, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


@pytest.mark.parametrize("kron", [True, False])
def test_loss_fn_equals_reference(kron):
    jcfg, tcfg = _cfgs(kron)
    jstate = JS.train_state_init(jcfg, JOpt(), jax.random.PRNGKey(0))
    tstate = _carry(jstate)
    toks, labels = _tokens(0, jcfg.vocab)
    want, wparts = JS.loss_fn(jcfg, jstate.params, jnp.asarray(toks), jnp.asarray(labels))
    got, parts = TS.loss_fn(tcfg, tstate.params, torch.from_numpy(toks),
                            torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    assert float(parts["nll"]) == pytest.approx(float(wparts["nll"]), rel=LOSS_TOL)
    assert float(parts["aux"]) == float(wparts["aux"]) == 0.0


@pytest.mark.parametrize("opt", ["adamw", "shampoo"])
def test_two_train_steps_equal_reference(opt):
    jcfg, tcfg = _cfgs()
    kw = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    if opt == "shampoo":  # a refresh on both steps
        jo, to = JSh(precond_every=1, **kw), TSh(precond_every=1, **kw)
    else:
        jo, to = JOpt(**kw), TOpt(**kw)
    jstate = JS.train_state_init(jcfg, jo, jax.random.PRNGKey(0))
    tstate = _carry(jstate)
    jstep, tstep = jax.jit(JS.make_train_step(jcfg, jo)), TS.make_train_step(tcfg, to)
    for i in range(2):
        toks, labels = _tokens(i, jcfg.vocab)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
        for k in ("loss", "grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_TOL), k
        for got, want in zip(tree.leaves(tstate.params), jax.tree.leaves(jstate.params)):
            assert_close(got, np.asarray(want), PARAM_TOL)
        assert int(tstate.step) == int(jstate.step) == i + 1
    if opt == "shampoo":
        assert set(tstate.opt["kron"]) == set(jstate.opt["kron"])
        assert float(tm["precond_ok_frac"]) == float(jm["precond_ok_frac"]) == 1.0


def test_microbatch_accumulation_matches_full_batch():
    _, tcfg = _cfgs()
    opt = TOpt(lr=1e-3, warmup_steps=1, decay_steps=10)
    state = TS.train_state_init(tcfg, opt, torch.Generator().manual_seed(0), device="cpu")
    toks, labels = SyntheticLM(vocab=tcfg.vocab, seq_len=16, batch=8, device="cpu").global_batch(0)
    batch = {"tokens": toks, "labels": labels}
    s1, m1 = TS.make_train_step(tcfg, opt, microbatches=1)(state, batch)
    s4, m4 = TS.make_train_step(tcfg, opt, microbatches=4)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-4)
    for a, b in zip(tree.leaves(s1.params), tree.leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)


class _StandInMesh:
    mesh_dim_names = ("data", "model")
    shape = (1, 2)


def test_prebuild_kron_ops_and_its_later_slices():
    _, tcfg = _cfgs()
    assert len(TS.prebuild_kron_ops(tcfg)) == 2  # up and down projections
    assert len(TS.prebuild_kron_ops(tcfg, batch=2, seq_len=16)) == 2
    with_opt = TS.prebuild_kron_ops(tcfg, opt_cfg=TSh())
    assert len(with_opt) > 2 and all(op.batch for op in with_opt[2:])
    mesh = _StandInMesh()  # a (1, 2) mesh: construction reads its dims' names and sizes
    with_mesh = TS.prebuild_kron_ops(tcfg, mesh=mesh)
    assert [op.mesh is mesh for op in with_mesh] == [False, True, False, True]
    assert all(op.rounds for op in with_mesh[1::2])
    # serving: one op per shape and projection, each plan resolved for its rows
    serve = TS.prebuild_kron_ops(tcfg, prefill_shapes=[(1, 8), (2, 8), (2, 8)], decode_batch=4)
    assert len(serve) == 2 * 3  # up and down x (1, 8), (2, 8), (4, 1)
    keys = [list(op._plans) for op in serve]  # each op's resolved plans: (mode, rows, bytes, _)
    assert [k[0][:3] for k in keys] == [("single", r, 4) for r in (8, 16, 4) * 2]
    assert all(len(k) == 1 for k in keys) and [op.batch for op in serve] == [1, 2, 4] * 2


def test_synthetic_lm_deterministic_and_shifted():
    data = SyntheticLM(vocab=97, seq_len=32, batch=4, seed=3, device="cpu")
    toks, labels = data.global_batch(5)
    again, _ = SyntheticLM(vocab=97, seq_len=32, batch=4, seed=3, device="cpu").global_batch(5)
    assert toks.shape == labels.shape == (4, 32) and toks.dtype == torch.int32
    assert torch.equal(toks, again)
    assert torch.equal(toks[:, 1:], labels[:, :-1])  # labels: the next token
    assert int(toks.min()) >= 0 and int(toks.max()) < 97
    assert not torch.equal(toks, data.global_batch(6)[0])
    other_seed = SyntheticLM(vocab=97, seq_len=32, batch=4, device="cpu")
    assert not torch.equal(toks, other_seed.global_batch(5)[0])
    # mostly the noiseless recurrence t' = (5t + 7) mod vocab
    hits = (labels == (5 * toks + 7) % 97).float().mean()
    assert 0.8 < float(hits) < 1.0
    half, _ = data.host_slice(5, 1, 2)
    assert torch.equal(half, toks[2:])
    t2, l2 = make_batch(torch.Generator().manual_seed(0), 2, 8, 11, device="cpu")
    assert t2.shape == (2, 8) and torch.equal(t2[:, 1:], l2[:, :-1])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise without a card")
def test_synthetic_lm_defaults_to_the_card():
    """The data's entry points put the batch on the card unless asked for
    the CPU, as the model's do; without a card they raise."""
    data = SyntheticLM(vocab=97, seq_len=8, batch=2)
    assert data.device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        data.global_batch(0)
    with pytest.raises((RuntimeError, AssertionError)):
        make_batch(torch.Generator().manual_seed(0), 2, 8, 11)


def test_launcher_reduced_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b", "--reduced",
         "--device", "cpu", "--steps", "6", "--optimizer", "shampoo", "--precond-every", "5",
         "--log-every", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.stdout.splitlines() if line.startswith("step ")]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert "optimizer state:" in out.stdout and "device: cpu" in out.stdout


def test_launcher_refuses_the_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train as launcher

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
