"""The port's serving engine (``repro_torch.launch.serve``) on reduced
gemma-2b (f32, CPU): greedy tokens equal to the JAX engine's
(``repro.launch.serve.ServeEngine``, one module-scoped run) on the same
trace and parameters; per request, co-batched equal to batch-of-one (also
at temperature 1: the sampler's generator depends only on (seed, rid,
index)); ``serve_admit`` chaos degrading to per-request prefills without
dropping a request; zero plan-memo misses while serving after ``prewarm``
and ``compile_shapes`` with ``kron_ffn``; padded prefill positions masked;
and the launcher, one-shot and continuous, with ``--device cpu`` (its mesh
flags raise; ``elastic_mesh`` needs an initialised process group)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import model_params
from repro.configs import get_config as jget
from repro.launch import serve as JServe
from repro.launch.scheduler import SchedulerConfig as JSchedCfg
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_config as tget
from repro_torch.core import engine as E
from repro_torch.launch import serve as TServe
from repro_torch.launch.scheduler import Request, SchedulerConfig, poisson_trace
from repro_torch.models import model as TM
from repro_torch.models.config import reduced as treduced
from repro_torch.runtime import chaos, guard, telemetry
from repro_torch.runtime.fault import elastic_mesh

SCFG = dict(buckets=(8, 16), max_slots=3, max_prefill=2, max_wait=3)


@pytest.fixture(autouse=True)
def _fresh_state():
    guard.reset_health()
    telemetry.reset()
    yield
    guard.reset_health()
    telemetry.reset()


@pytest.fixture(scope="module")
def small_model():
    # Dense reduced gemma-2b: no MoE capacity coupling across co-batched
    # rows, so per-request independence is exact.
    tcfg = treduced(tget("gemma-2b"), dtype="float32")
    jp, tp = model_params(tcfg)
    return tcfg, tp, jp


def _trace(n=6, seed=3):
    return poisson_trace(seed=seed, rate=0.8, n=n, prompt_lens=(2, 14), max_new=(1, 5))


@pytest.fixture(scope="module")
def jax_report(small_model):
    """The JAX engine's one run on the trace, from the same parameters."""
    _, _, jp = small_model
    jcfg = jreduced(jget("gemma-2b"), dtype="float32")
    from repro.launch.scheduler import poisson_trace as jtrace

    reqs = jtrace(seed=3, rate=0.8, n=6, prompt_lens=(2, 14), max_new=(1, 5))
    return JServe.ServeEngine(jcfg, jp, JSchedCfg(**SCFG), max_new=5).run(reqs)


def test_batch_buckets_equal_reference():
    for n in (1, 3, 4, 6):
        assert TServe.batch_buckets(n) == JServe.batch_buckets(n)
    assert [TServe._pad_batch(g, (1, 2, 4)) for g in (1, 2, 3, 4, 5)] == [1, 2, 4, 4, 4]


def test_tokens_equal_jax_engine(small_model, jax_report):
    cfg, params, _ = small_model
    rep = TServe.ServeEngine(cfg, params, SchedulerConfig(**SCFG), max_new=5).run(_trace())
    assert rep.tokens == jax_report.tokens
    assert rep.steps == jax_report.steps and rep.total_tokens == jax_report.total_tokens
    for rid, m in rep.metrics.items():
        want = jax_report.metrics[rid]
        for key in ("arrival_step", "first_token_step", "admit_step", "finish_step", "reason"):
            assert m.get(key) == want.get(key), (rid, key)
        assert m["arrival_wall"] <= m["first_token_wall"] <= m["finish_wall"]
    assert len(rep.ttft_s) == 6 and len(rep.tpot_s) == len(jax_report.tpot_s)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_cobatched_equals_batch_of_one(small_model, temperature):
    """A request's tokens while it shares decode slots equal its tokens
    served alone (one slot, prefill groups of one): the per-slot positions,
    pad masking and ``cache_take``/``cache_put``; at temperature 1 the
    sampler's generator too."""
    cfg, params, _ = small_model
    reqs = _trace()
    packed = TServe.ServeEngine(cfg, params, SchedulerConfig(**SCFG), max_new=5,
                                temperature=temperature).run(reqs)
    solo_cfg = SchedulerConfig(buckets=SCFG["buckets"], max_slots=1, max_prefill=1,
                               max_wait=SCFG["max_wait"])
    solo = TServe.ServeEngine(cfg, params, solo_cfg, max_new=5,
                              temperature=temperature).run(reqs)
    assert packed.tokens == solo.tokens


def test_sampling_generator_is_per_request():
    """Kept difference: temperature sampling draws from a ``torch.Generator``
    seeded from ``(sample_seed, rid, index)`` (the reference folds them into
    a ``jax.random`` key): one draw per (request, index), the same on every
    call."""
    cfg = treduced(tget("gemma-2b"), dtype="float32")
    eng = TServe.ServeEngine(cfg, {"embed": torch.zeros(1)}, SchedulerConfig(**SCFG),
                             max_new=4, temperature=1.0, sample_seed=7)
    lg = torch.from_numpy(np.random.default_rng(0).standard_normal(cfg.padded_vocab)
                          .astype(np.float32))
    seed = int(np.random.SeedSequence([7, 3, 2]).generate_state(1)[0])
    want = int(torch.multinomial(torch.softmax(lg[:cfg.vocab].double(), -1), 1,
                                 generator=torch.Generator().manual_seed(seed)))
    assert eng._sample(lg, 3, 2) == eng._sample(lg, 3, 2) == want
    draws = {eng._sample(lg, rid, i) for rid in range(4) for i in range(4)}
    assert len(draws) > 1
    assert TServe.ServeEngine(cfg, {"embed": torch.zeros(1)}, SchedulerConfig(**SCFG),
                              max_new=4)._sample(lg, 3, 2) == int(lg[:cfg.vocab].argmax())


def test_chaos_serve_admit_degrades_not_drops(small_model, tmp_path):
    """An injected VmemOverflowError on the grouped bucket prefill falls to
    per-request prefills: a ``rung_fallback`` event, every request served,
    the same tokens as without it."""
    cfg, params, _ = small_model
    reqs = [Request(0, 6, 3, 0.0), Request(1, 7, 3, 0.0)]  # one group of 2
    want = TServe.ServeEngine(cfg, params, SchedulerConfig(**SCFG), max_new=3).run(reqs).tokens
    guard.reset_health()
    jl = tmp_path / "serve_chaos.jsonl"
    telemetry.configure(jsonl=str(jl))
    with pytest.warns(guard.GuardWarning), chaos.inject("serve_admit:times=1") as specs:
        rep = TServe.ServeEngine(cfg, params, SchedulerConfig(**SCFG), max_new=3).run(reqs)
    assert specs[0].fired == 1
    assert rep.tokens == want
    assert all(m["reason"] in ("eos", "max_new") for m in rep.metrics.values())
    assert guard.health_report()["ops"]["'serve_admit:8'"]["degraded_calls"] == 1
    telemetry.shutdown()
    events = [json.loads(line) for line in open(jl)]
    fallbacks = [e for e in events
                 if e.get("name") == "rung_fallback" and "serve_admit" in e.get("key", "")]
    assert fallbacks and fallbacks[0]["rung_name"] == "bucket"
    assert any(e.get("name") == "chaos_injected" for e in events)


def test_zero_replans_during_steady_state_serving(small_model):
    """After ``prewarm`` (one op per projection and shape: the prefill
    buckets and the decode batch) and ``compile_shapes`` (every shape run
    once), a whole serving run adds no plan-memo miss."""
    cfg, _, _ = small_model
    cfg = dataclasses.replace(cfg, kron_ffn=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = TServe.ServeEngine(cfg, params, SchedulerConfig(**SCFG), max_new=5)
    ops = eng.prewarm()
    n_shapes = len(SCFG["buckets"]) * len(TServe.batch_buckets(SCFG["max_prefill"])) + 1
    assert len(ops) == 2 * n_shapes  # up and down per prefill shape and the decode shape
    assert eng.compile_shapes() == n_shapes
    misses = (E._resolve_plan.cache_info().misses, E._resolve_batched_plan.cache_info().misses)
    eng.prewarm()
    eng.compile_shapes()
    rep = eng.run(_trace())
    assert len(rep.metrics) == 6
    after = (E._resolve_plan.cache_info().misses, E._resolve_batched_plan.cache_info().misses)
    assert after == misses, f"steady-state serving re-planned: misses {misses} -> {after}"
    with pytest.raises(NotImplementedError, match="queue 1"):
        eng.prewarm(mesh=object())


def test_engine_masks_padded_prefill_positions(small_model):
    """A prompt shorter than its bucket must not attend to the pad keys the
    bucketed prefill wrote: against an unpadded batch-of-one prefill and
    scalar-pos decode of the same prompt."""
    cfg, params, _ = small_model
    eng = TServe.ServeEngine(cfg, params, SchedulerConfig(**SCFG), max_new=4)
    rep = eng.run([Request(0, 5, 4, 0.0)])  # len 5 -> bucket 8 (3 pads)
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(1, 5)).astype(np.int32))
    logits, cache = TM.prefill(cfg, params, tok, eng.max_len)
    ref = [int(logits[0, -1, :cfg.vocab].argmax())]
    for i in range(3):
        logits, cache = TM.decode_step(cfg, params, cache,
                                       torch.tensor([[ref[-1]]], dtype=torch.int32), 5 + i)
        ref.append(int(logits[0, -1, :cfg.vocab].argmax()))
    assert rep.tokens[0] == ref


def test_launcher_one_shot_and_continuous_on_cpu(capsys):
    TServe.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "generated shape: (2, 4)" in out and "decode:" in out
    TServe.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--kron-ffn",
                 "--arrival-rate", "0.8", "--requests", "5", "--gen", "4",
                 "--buckets", "8,16", "--slots", "3", "--max-prefill", "2"])
    out = capsys.readouterr().out
    assert out.count("kron-ffn KronOp") == 2 * (2 * 2 + 1)
    assert "served 5/5 requests" in out and "ttft_s" in out
    for flag in (["--distributed"], ["--want-model-parallel", "4"]):
        with pytest.raises(NotImplementedError, match="queue 1"):
            TServe.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", *flag])
    with pytest.raises(RuntimeError, match="world"):  # built over an initialised world
        elastic_mesh(4, want_model=2)
