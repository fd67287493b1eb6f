"""The port's continuous-batching scheduler (``repro_torch.launch.scheduler``,
its own copy of the reference's plain-Python module) against
``repro.launch.scheduler``: the same traces from ``poisson_trace``, the same
actions step by step under one event stream, and the same ``simulate``
results, over several seeds and configurations; and the module imports
neither framework."""
import ast
import dataclasses
import pathlib

import pytest

from repro.launch import scheduler as JS
from repro_torch.launch import scheduler as TS

CONFIGS = [
    dict(buckets=(16, 32, 64, 128), max_slots=8, max_prefill=4, max_wait=8),
    dict(buckets=(8, 16), max_slots=3, max_prefill=2, max_wait=3),
    dict(buckets=(128, 512, 1024), max_slots=8, max_prefill=4, max_wait=8),
    dict(buckets=(4,), max_slots=1, max_prefill=1, max_wait=0),
]


def _as_tuple(x):
    """Dataclasses (the two modules' own classes) as plain tuples."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(_as_tuple(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_as_tuple(v) for v in x)
    if isinstance(x, dict):
        return {k: _as_tuple(v) for k, v in x.items()}
    return x


def test_module_imports_no_framework():
    src = pathlib.Path(TS.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "torch", "numpy", "repro"}, names


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_poisson_trace_equals_reference(seed):
    kw = dict(seed=seed, rate=0.5, n=24, prompt_lens=(4, 200), max_new=(1, 9))
    assert _as_tuple(TS.poisson_trace(**kw)) == _as_tuple(JS.poisson_trace(**kw))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_step_actions_equal_reference(seed, ci):
    """One event stream through both state machines: the same actions at
    every step and the same state after it (``audit`` equal too)."""
    jcfg, tcfg = JS.SchedulerConfig(**CONFIGS[ci]), TS.SchedulerConfig(**CONFIGS[ci])
    reqs_kw = dict(seed=seed, rate=0.7, n=20, prompt_lens=(1, 150), max_new=(1, 6))
    jreqs, treqs = JS.poisson_trace(**reqs_kw), TS.poisson_trace(**reqs_kw)
    js, ts = JS.new_state(jcfg), TS.new_state(tcfg)
    i, n_steps = 0, 0
    eos = []
    while n_steps < 400:
        t = js.step_idx
        jev, tev = list(eos), list(eos)
        while i < len(jreqs) and int(jreqs[i].arrival) <= t:
            jev.append(("arrive", jreqs[i]))
            tev.append(("arrive", treqs[i]))
            i += 1
        js, jact = JS.step(js, jev)
        ts, tact = TS.step(ts, tev)
        assert _as_tuple(tact) == _as_tuple(jact)
        assert _as_tuple(ts) == _as_tuple(js)
        assert TS.audit(ts) == JS.audit(js)
        # an EOS for every third decoded request, one step later
        eos = [("eos", rid) for a in jact if a[0] == "decode" for rid in a[1] if rid % 3 == 0]
        n_steps += 1


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_simulate_equals_reference(seed, ci):
    reqs_kw = dict(seed=seed, rate=0.6, n=30, prompt_lens=(1, 140), max_new=(1, 12))
    want = JS.simulate(JS.SchedulerConfig(**CONFIGS[ci]), JS.poisson_trace(**reqs_kw), seed=seed)
    got = TS.simulate(TS.SchedulerConfig(**CONFIGS[ci]), TS.poisson_trace(**reqs_kw), seed=seed)
    assert _as_tuple(got) == _as_tuple(want)
    assert got.steps > 0 and len(got.metrics) == 30


def test_config_checks_and_sim_token_equal_reference():
    for bad in (dict(buckets=()), dict(buckets=(8, 4)), dict(max_slots=0), dict(max_wait=-1)):
        with pytest.raises(ValueError):
            JS.SchedulerConfig(**bad)
        with pytest.raises(ValueError):
            TS.SchedulerConfig(**bad)
    assert [TS.sim_token(r, i) for r in range(5) for i in range(5)] == \
        [JS.sim_token(r, i) for r in range(5) for i in range(5)]
    cfg = TS.SchedulerConfig(buckets=(8, 16))
    assert (cfg.bucket_for(1), cfg.bucket_for(9), cfg.bucket_for(17)) == (8, 16, None)
    assert TS.FINISH_REASONS == JS.FINISH_REASONS and TS.REQUEST_STATES == JS.REQUEST_STATES
