"""The decode step from graphs (repro_torch.models.decode_graph).

On the CPU the CUDA capture is stood in for by ``Emulated``: a piece
records the ATen ops its Python calls (a dispatch mode) and a replay runs
them again on the tensors they ran on, writing each fresh result into the
tensor the capture made, as a graph writes into its pool.  A capture pass
on the card runs nothing, so the stand-in undoes every write the pass made
(the cache, the route buffers) when it ends.  (Host reads are not refused
here: the CPU's ATen makes some of its own, as ``one_hot``'s range check,
which the card's does not.)  The tests then hold the mechanism to the eager
step: which calls take which path, the spans a replay re-enters, fresh
logits, route records, counters, and the logits and caches themselves, bit
for bit.

The card tests (marked ``cuda``, skipped without a card) hold real CUDA
graphs to the eager step over a whole cycle of steps."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import warnings

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import _launch
from repro_torch.models import decode_graph as DG
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import reduced
from repro_torch.runtime import chaos, guard, telemetry

def _writes(func) -> list[int]:
    return [i for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write]


def _arg(func, args, kwargs, i):
    a = func._schema.arguments[i]
    return kwargs[a.name] if a.name in kwargs else args[i] if i < len(args) else None


class _Recording(TorchDispatchMode):
    """One piece: each op with its arguments and outputs.  Every tensor an op
    writes is saved whole (its base) the first time, into ``saved``."""

    def __init__(self, saved: dict):
        super().__init__()
        self.ops: list = []
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        writes = _writes(func)
        for i in writes:
            t = _arg(func, args, kwargs, i)
            for leaf in tree_flatten(t)[0]:
                if isinstance(leaf, torch.Tensor):
                    base = leaf if leaf._base is None else leaf._base
                    self.saved.setdefault(id(base), (base, base.clone()))
        out = func(*args, **kwargs)
        if writes or not _views(func):
            self.ops.append((func, args, kwargs, out, bool(writes)))
        return out


def _views(func) -> bool:
    return not _writes(func) and any(r.alias_info is not None for r in func._schema.returns)


def _open_spans() -> tuple:
    """The spans open on this thread, outermost first, up to the first
    ``op`` (a replay re-enters none inside one)."""
    stack = tuple(telemetry._STATE.stack())
    return stack[:stack.index("op") + 1] if "op" in stack else stack


class _Piece:
    log: list | None = None  # (op, the spans open) of each op replayed

    def __init__(self, ops):
        self.ops = ops

    def replay(self) -> None:
        spans = _open_spans() if _Piece.log is not None else None
        for func, args, kwargs, out, writes in self.ops:
            if spans is not None:
                _Piece.log.append((func, spans))
            new = func(*args, **kwargs)
            if writes:
                continue
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if isinstance(o, torch.Tensor):
                    o.copy_(n)

    def reset(self) -> None:
        self.ops = []


class Emulated:
    """``decode_graph.CudaGraphs`` on the CPU (module docstring)."""

    def __init__(self, device):
        self.saved: dict = {}

    @staticmethod
    def busy(device) -> bool:
        return False

    @staticmethod
    def replaying():
        return contextlib.nullcontext()

    def capturing(self):
        outer = self

        class _Undo:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                for base, copy in outer.saved.values():
                    base.copy_(copy)
                outer.saved.clear()
                return False

        return _Undo()

    def begin(self):
        mode = _Recording(self.saved)
        mode.__enter__()
        return mode

    def end(self, mode):
        mode.__exit__(None, None, None)
        return _Piece(mode.ops) if mode.ops else None


@pytest.fixture
def emulated(monkeypatch):
    DG.clear()
    monkeypatch.setattr(DG, "DEVICES", ("cpu",))
    monkeypatch.setattr(DG, "GRAPHS", Emulated)
    yield
    DG.clear()
    telemetry.reset()


@pytest.fixture(autouse=True)
def _fresh():
    DG.clear()
    telemetry.configure(annotate=False)  # the path counters
    yield
    DG.clear()
    telemetry.reset()


def _cfg(name: str, device: str = "cpu", dtype: str = "float32"):
    """Reduced configs: deepseek-moe (dense first layer, routed and shared
    experts), qwen3-4b (GQA), jamba (Mamba and attention, MoE); each with
    the Kron FFN, whose ops give the step its ``op`` spans."""
    arch = {"deepseek": "deepseek-moe-16b", "qwen3": "qwen3-4b",
            "jamba": "jamba-1.5-large-398b"}[name]
    return dataclasses.replace(reduced(get_config(arch), dtype=dtype), kron_ffn=True,
                               kron_factors=2)


def _served(cfg, device="cpu", batch=2, prompt=8, max_len=24, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, g, device=device)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=g, device=device)
    logits, cache = M.prefill(cfg, params, tokens, max_len)
    first = logits[:, -1:, :cfg.vocab].argmax(-1)
    return params, cache, first, prompt


def _clone(cache):
    return tree.map(lambda l: l.clone(), cache)


def _greedy(cfg, params, cache, tok, pos0, n, vector_pos=False):
    """``n`` greedy steps; their logits (each kept as returned)."""
    out = []
    b = tok.shape[0]
    for j in range(n):
        pos = (torch.full((b,), pos0 + j, dtype=torch.int32) if vector_pos
               else torch.tensor(pos0 + j, dtype=torch.int32))
        logits, cache = M.decode_step(cfg, params, cache, tok, pos.to(tok.device))
        out.append(logits)
        tok = logits[:, :, :cfg.vocab].argmax(-1)
    return out


def _counts() -> dict:
    """The decode path counters since telemetry was last configured."""
    c = telemetry.snapshot().get("counters", {})
    return {n: c.get(f"decode.{n}", 0) for n in ("eager_steps", "graph_steps", "graph_captures")}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


# ---------------------------------------------------------------------------
# Which path a call takes
# ---------------------------------------------------------------------------


class _Noop(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _grad_leaf(params):
    params["final_norm"].requires_grad_(True)
    return torch.no_grad()


INELIGIBLE = {
    "cpu_tensors": lambda params: None,  # DEVICES left at ("cuda",)
    "grad": _grad_leaf,
    "chaos": lambda params: chaos.inject("plan_cache_save:p=0"),
    "numerics": lambda params: guard.numerics("warn"),
    "eager_block": lambda params: DG.eager(),
    "dispatch_mode": lambda params: _Noop(),
}


@pytest.mark.parametrize("why", sorted(INELIGIBLE))
def test_ineligible_calls_run_eager(monkeypatch, why):
    if why != "cpu_tensors":
        monkeypatch.setattr(DG, "DEVICES", ("cpu",))
        monkeypatch.setattr(DG, "GRAPHS", Emulated)
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    before = _counts()
    ctx = INELIGIBLE[why](params)
    with ctx if ctx is not None else torch.no_grad():
        _greedy(cfg, params, cache, tok, p, 3)
    assert _delta(before) == {"eager_steps": 3, "graph_steps": 0, "graph_captures": 0}


def test_a_key_runs_eager_first_then_captures_then_replays(emulated):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    before = _counts()
    _greedy(cfg, params, cache, tok, p, 1)
    assert _delta(before) == {"eager_steps": 1, "graph_steps": 0, "graph_captures": 0}
    _greedy(cfg, params, cache, tok, p + 1, 1)
    assert _delta(before) == {"eager_steps": 1, "graph_steps": 1, "graph_captures": 1}
    _greedy(cfg, params, cache, tok, p + 2, 3)
    assert _delta(before) == {"eager_steps": 1, "graph_steps": 4, "graph_captures": 1}


def test_a_new_cache_is_a_new_key(emulated):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    _greedy(cfg, params, cache, tok, p, 3)
    before = _counts()
    _greedy(cfg, params, _clone(cache), tok, p + 3, 3)
    assert _delta(before) == {"eager_steps": 1, "graph_steps": 2, "graph_captures": 1}


def test_a_changing_batch_never_captures(emulated):
    cfg = _cfg("deepseek")
    params, cache2, tok2, p = _served(cfg, batch=2)
    _, cache3, tok3, _ = _served(cfg, batch=3)
    before = _counts()
    for j in range(3):
        M.decode_step(cfg, params, cache2, tok2, p + j)
        M.decode_step(cfg, params, cache3, tok3, p + j)
    assert _delta(before) == {"eager_steps": 6, "graph_steps": 0, "graph_captures": 0}


def test_the_store_keeps_the_newest_key_and_drops_a_dead_cache(emulated):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    first, second = _clone(cache), _clone(cache)
    _greedy(cfg, params, first, tok, p, 2)
    held = DG._HELD[1]
    before = _counts()
    _greedy(cfg, params, first, tok, p + 2, 1)  # its key is held: a replay
    _greedy(cfg, params, second, tok, p, 1)  # another key: eager, the first held
    assert DG._HELD[1] is held
    _greedy(cfg, params, second, tok, p + 1, 1)  # captured in the first's place
    assert DG._HELD[1] is not held and held.pieces == []
    _greedy(cfg, params, first, tok, p + 3, 1)  # released: eager again
    assert _delta(before) == {"eager_steps": 2, "graph_steps": 2, "graph_captures": 1}
    for piece in DG._HELD[1].pieces:  # a graph holds no Python reference to
        piece.reset()                 # what it reads; the stand-in's ops do
    del second
    gc.collect()
    _greedy(cfg, params, _clone(cache), tok, p, 1)  # a miss releases the dead
    assert DG._HELD == [None, None]


# ---------------------------------------------------------------------------
# What a replay gives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,vector_pos", [("deepseek", False), ("qwen3", False),
                                             ("jamba", False), ("deepseek", True)])
def test_graph_steps_equal_eager_steps(emulated, name, vector_pos):
    cfg = _cfg(name)
    params, cache, tok, p = _served(cfg)
    if vector_pos:
        cache = M.cache_to_slots(cache)
    eager_cache = _clone(cache)
    with DG.eager():
        want = _greedy(cfg, params, eager_cache, tok, p, 6, vector_pos)
    got = _greedy(cfg, params, cache, tok, p, 6, vector_pos)
    assert _counts()["graph_steps"] == 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(cache), tree.leaves(eager_cache)):
        assert torch.equal(a, b)


def test_successive_replays_return_fresh_logits(emulated):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    _greedy(cfg, params, cache, tok, p, 2)
    a, _ = M.decode_step(cfg, params, cache, tok, p + 2)
    kept = a.clone()
    b, _ = M.decode_step(cfg, params, cache, tok, p + 3)
    assert _counts()["graph_steps"] == 3
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)


def test_route_record_receives_each_steps_router_logits(emulated):
    cfg = _cfg("jamba")
    params, cache, tok, p = _served(cfg)
    n_moe = sum(spec.moe for spec in cfg.layer_plan())
    eager_cache, steps = _clone(cache), 4

    def run(c, eager_only):
        ring = torch.full((steps, n_moe, tok.shape[0], 1, cfg.moe.n_experts), float("nan"))
        with DG.eager() if eager_only else torch.no_grad():
            for j in range(steps):
                with moe.route_record(list(ring[j])):
                    M.decode_step(cfg, params, c, tok, p + j)
        return ring

    want = run(eager_cache, True)
    got = run(cache, False)
    assert _counts()["graph_steps"] == steps - 1
    assert not torch.isnan(want).any()
    assert torch.equal(got, want)


def test_counters_read_per_step_what_eager_steps_read(emulated):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    telemetry.configure(annotate=False)

    def per_step(n):
        steps = []
        for j in range(n):
            before = dict(telemetry.snapshot()["counters"])
            M.decode_step(cfg, params, cache, tok, p + j)
            after = telemetry.snapshot()["counters"]
            steps.append({k: v - before.get(k, 0) for k, v in after.items()
                          if not k.startswith("decode.") and v != before.get(k, 0)})
        return steps

    with DG.eager():
        eager = per_step(1)[0]
    steps = per_step(4)  # eager, capture, replay, replay
    assert eager["moe.tokens"] == 2 and eager["moe.slots"] > 0
    assert all(s == eager for s in steps)
    assert _counts()["graph_steps"] == 3


def test_launches_count_where_the_wrappers_run_and_replays_add_none(emulated, monkeypatch):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    orig = moe._route

    def route(*args):  # one stand-in wrapper launch a MoE layer
        _launch.launches["chain_fwd"] += 1
        return orig(*args)

    monkeypatch.setattr(moe, "_route", route)
    n_moe = sum(spec.moe for spec in cfg.layer_plan())
    counted = []
    for j in range(4):  # eager, capture, replay, replay
        before = _launch.launches["chain_fwd"]
        M.decode_step(cfg, params, cache, tok, p + j)
        counted.append(_launch.launches["chain_fwd"] - before)
    assert counted == [n_moe, n_moe, 0, 0]
    assert _counts()["graph_steps"] == 3


def _spans(path) -> list[dict]:
    with open(path) as fh:
        return [r for r in map(json.loads, fh) if r.get("kind") == "span"]


def _outside_ops(spans: list[dict]) -> list[tuple]:
    """(name, depth) of each span, in the order they ended, leaving out those
    inside an ``op`` span."""
    ops = [s for s in spans if s["name"] == "op"]

    def inside(s):
        return any(o["depth"] < s["depth"] and o["ts"] <= s["ts"]
                   and s["ts"] + s["dur"] <= o["ts"] + o["dur"] for o in ops)

    return [(s["name"], s["depth"]) for s in spans if not inside(s)]


def test_a_replay_reenters_the_eager_steps_spans(emulated, tmp_path):
    cfg = _cfg("jamba")
    params, cache, tok, p = _served(cfg)
    eager_cache = _clone(cache)
    _greedy(cfg, params, cache, tok, p, 2)  # eager, then captured with telemetry off
    entry = DG._HELD[1]
    cut = {e[1] for e in entry.plan if type(e) is tuple}
    assert "op" in cut and cut.isdisjoint({"program", "stage", "launch", "plan"})

    telemetry.configure(jsonl=str(tmp_path / "eager.jsonl"), annotate=False)
    with DG.eager():
        M.decode_step(cfg, params, eager_cache, tok, p + 2)
    telemetry.configure(jsonl=str(tmp_path / "graph.jsonl"), annotate=False)
    M.decode_step(cfg, params, cache, tok, p + 2)
    assert _counts()["graph_steps"] == 1
    telemetry.disable()  # closes the sinks
    eager, replay = _spans(tmp_path / "eager.jsonl"), _spans(tmp_path / "graph.jsonl")
    assert {s["name"] for s in eager} >= {"attn", "moe", "moe_route", "moe_experts", "ffn",
                                           "op", "program", "stage"}
    assert [(s["name"], s["depth"]) for s in replay] == _outside_ops(eager)


class _Log(TorchDispatchMode):
    """(op, the spans open) of each op an eager step runs, as ``_Piece`` logs."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _views(func):
            self.log.append((func, _open_spans()))
        return func(*args, **(kwargs or {}))


def test_each_op_replays_inside_the_spans_it_ran_in_eager(emulated, monkeypatch):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    eager_cache = _clone(cache)
    _greedy(cfg, params, cache, tok, p, 2)  # eager, then captured
    telemetry.configure(annotate=False)
    with DG.eager(), _Log() as eager:
        M.decode_step(cfg, params, eager_cache, tok, p + 2)
    monkeypatch.setattr(_Piece, "log", [])
    M.decode_step(cfg, params, cache, tok, p + 2)
    assert _counts()["graph_steps"] == 1
    assert {spans for _, spans in eager.log} >= {("attn",), ("moe", "moe_experts"),
                                                 ("ffn", "op"), ("moe", "ffn", "op")}
    assert _Piece.log == eager.log


def test_a_failed_capture_leaves_spans_and_route_records_as_they_were(emulated, monkeypatch):
    cfg = _cfg("deepseek")
    params, cache, tok, p = _served(cfg)
    orig = moe._route

    seen = []

    def failing(router_logits, mc, capacity):
        seen.append(1)
        if len(seen) > n_moe:  # the capture pass: what a refused host read raises
            raise RuntimeError("operation not permitted when stream is capturing")
        return orig(router_logits, mc, capacity)

    n_moe = sum(spec.moe for spec in cfg.layer_plan())
    monkeypatch.setattr(moe, "_route", failing)
    ring = [torch.zeros(tok.shape[0], 1, cfg.moe.n_experts) for _ in range(n_moe)]
    with moe.route_record(ring):
        M.decode_step(cfg, params, cache, tok, p)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        with moe.route_record(ring):
            M.decode_step(cfg, params, cache, tok, p + 1)
    assert telemetry.span is telemetry._plain_span
    assert moe._RECORD is None and _counts()["graph_captures"] == 0


class _FakeGraph:
    """What ``CudaGraphs.end`` calls of a captured graph; ``capture_end``
    warns as torch's does."""

    def __init__(self, warns):
        self.warns, self.was_reset = warns, False

    def capture_end(self):
        for message in self.warns:
            warnings.warn(message, UserWarning)

    def reset(self):
        self.was_reset = True


@pytest.mark.parametrize("warns,kept", [
    ((), True),
    ((DG.EMPTY + ". This usually means that the graph was attempted to be captured on "
      "wrong device or stream.",), False),
    (("another warning",), True),
])
def test_capture_end_drops_an_empty_graph_and_passes_other_warnings_on(warns, kept):
    g = _FakeGraph(warns)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = DG.CudaGraphs.end(None, g)
    assert (out is g) == kept and g.was_reset == (not kept)
    assert [str(w.message) for w in caught] == [m for m in warns if not m.startswith(DG.EMPTY)]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    return "cuda"


def _close(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


CARD_CASES = {"deepseek": "bfloat16", "qwen3": "bfloat16", "jamba": "float32"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_card_graph_steps_follow_eager_steps_over_a_cycle(card, name):
    cfg = _cfg(name, dtype=CARD_CASES[name])
    params, cache, tok, p = _served(cfg, card, batch=4, prompt=16, max_len=16 + 64)
    eager_cache = _clone(cache)
    with DG.eager():
        want = _greedy(cfg, params, eager_cache, tok, p, 64)
    before = _counts()
    got = _greedy(cfg, params, cache, tok, p, 64)
    assert _delta(before) == {"eager_steps": 1, "graph_steps": 63, "graph_captures": 1}
    for j, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"step {j}: another token"
        assert torch.equal(a, b) or _close(a, b) <= 1e-3, f"step {j}: {_close(a, b):.3e}"


@pytest.mark.cuda
def test_card_a_new_cache_recaptures(card):
    cfg = _cfg("deepseek", dtype="bfloat16")
    params, cache, tok, p = _served(cfg, card)
    _greedy(cfg, params, cache, tok, p, 3)
    other = _clone(cache)
    with DG.eager():
        want = _greedy(cfg, params, _clone(cache), tok, p + 3, 3)
    before = _counts()
    got = _greedy(cfg, params, other, tok, p + 3, 3)
    assert _delta(before) == {"eager_steps": 1, "graph_steps": 2, "graph_captures": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b) or _close(a, b) <= 1e-3


def _engine_tokens(cfg, params, eager_only: bool) -> dict:
    """Every request's tokens from ``ServeEngine`` on a Poisson trace: slots
    fill and drain, so the live batch changes from step to step."""
    from repro_torch.launch.scheduler import SchedulerConfig, poisson_trace
    from repro_torch.launch.serve import ServeEngine

    trace = poisson_trace(seed=3, rate=0.6, n=8, prompt_lens=(3, 16), max_new=(2, 6))
    eng = ServeEngine(cfg, params, SchedulerConfig(max_slots=4, buckets=(8, 16)), max_new=6)
    with DG.eager() if eager_only else torch.no_grad():
        return eng.run(trace).tokens


def test_serving_engine_with_a_changing_batch(emulated):
    cfg = _cfg("qwen3")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = _engine_tokens(cfg, params, True)
    before = _counts()
    got = _engine_tokens(cfg, params, False)
    assert _delta(before)["graph_steps"] > 0
    assert got == want


@pytest.mark.cuda
def test_card_serving_engine_with_a_changing_batch(card):
    cfg = _cfg("qwen3")
    params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    want = _engine_tokens(cfg, params, True)
    before = _counts()
    got = _engine_tokens(cfg, params, False)
    assert _delta(before)["graph_steps"] > 0
    assert got == want


# ---------------------------------------------------------------------------
# telemetry.observed, which a capture pass cuts at
# ---------------------------------------------------------------------------


class _Hook:
    def __init__(self):
        self.events = []

    def enter(self, name, attrs):
        self.events.append(("enter", name, attrs))

    def exit(self, name):
        self.events.append(("exit", name))

    def counter(self, name, n):
        self.events.append(("counter", name, n))


@pytest.mark.parametrize("active", [False, True])
def test_observed_hands_spans_and_counters_to_the_hook_alone(active):
    import threading

    telemetry.configure(annotate=False) if active else telemetry.reset()
    hook, other = _Hook(), []
    with telemetry.observed(hook):
        with telemetry.span("a", k=1):
            telemetry.counter_inc("c", 3)
            with telemetry.span("b"):
                pass
        worker = threading.Thread(target=lambda: other.append(telemetry.span("t")))
        worker.start()
        worker.join()
        with pytest.raises(RuntimeError, match="do not nest"):
            with telemetry.observed(_Hook()):
                pass
    assert hook.events == [("enter", "a", {"k": 1}), ("counter", "c", 3), ("enter", "b", {}),
                           ("exit", "b"), ("exit", "a")]
    assert telemetry.span is telemetry._plain_span
    assert type(other[0]).__name__ == ("_Span" if active else "_NullSpan")
    if active:  # the block's spans and counter made no record of their own
        snap = telemetry.snapshot()
        assert snap["spans"] == 0 and "c" not in snap["counters"]
    else:
        assert telemetry.span("x") is telemetry.span("y")
