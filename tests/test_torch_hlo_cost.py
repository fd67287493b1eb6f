"""Cost counting in the port (repro_torch.runtime.hlo_cost) against
repro.runtime.hlo_cost.

* Dot FLOPs of the reduced qwen3-4b prefill, dense and with the Kron FFN,
  equal the reference's trip-weighted count of its compiled HLO exactly.
* A train step's dot FLOPs exceed the reference's by what the port
  recomputes and XLA does not: the attention scores of every query chunk
  once more (torch's nested checkpoint re-runs the chunk's forward in its
  own backward; XLA merges it with the layer's recompute), exactly in the
  dense model; with the Kron FFN, also less than one forward pass of its
  chains (test_train_step_dot_flops_against_reference).
* The kernels' launchers on fake CUDA tensors (a dry-run's trace, here on a
  CPU-only torch): no build, no occupancy query, no ctypes call, no launch
  counted; the output's shape and dtype; the FLOPs they report equal the
  dot FLOPs of their plain twins on real tensors of the same shapes.
* The counting conventions (elementwise, reductions, views, bytes) and the
  live-storage peak.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models.config import reduced as jreduced
from repro.optim.adamw import OptConfig as JOpt
from repro.optim.adamw import opt_init as jopt_init
from repro.runtime import hlo_cost as JH
from repro.train import steps as JT
from repro_torch.configs import get_config as tget
from repro_torch.core.engine import _lowered, kron_op_for
from repro_torch.core.layers import KronLinearSpec
from repro_torch.kernels import _build, emit, kron_sliced, kron_sliced_t
from repro_torch.models import model as TM
from repro_torch.models.config import reduced as treduced
from repro_torch.optim import OptConfig as TOpt
from repro_torch.optim.adamw import opt_init as topt_init
from repro_torch.runtime import hlo_cost as TH
from repro_torch.train import steps as TT

B, S = 2, 32


def _cfgs(kron: bool):
    kw = dict(kron_ffn=True) if kron else {}
    return (dataclasses.replace(jreduced(jget("qwen3-4b"), dtype="float32"), **kw),
            dataclasses.replace(treduced(tget("qwen3-4b"), dtype="float32"), **kw))


def _inputs(jcfg, tcfg):
    jp = jax.eval_shape(functools.partial(JM.init_params, jcfg), jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jp, tp, toks


@pytest.mark.parametrize("kron", [False, True], ids=["dense", "kron_ffn"])
def test_prefill_dot_flops_equal_reference(kron):
    jcfg, tcfg = _cfgs(kron)
    jp, tp, toks = _inputs(jcfg, tcfg)
    hlo = jax.jit(JT.make_prefill_step(jcfg, S)).lower(jp, jnp.asarray(toks)).compile().as_text()
    ref = JH.analyze(hlo)
    got = TH.analyze(TT.make_prefill_step(tcfg, S), tp, torch.from_numpy(toks))
    assert got.dot_flops == ref.dot_flops == {False: 12_582_912, True: 7_602_176}[kron]
    assert got.collective_counts == {} and got.trip_weighted
    assert got.flops > got.dot_flops and got.bytes_accessed > 0


def _score_recompute(cfg, rows: int, seq: int) -> float:
    """The attention scores once per layer and query chunk: (B, H, qb, S)
    by hd, one chunk here (seq <= q_chunk)."""
    return cfg.n_layers * 2.0 * rows * cfg.n_heads * seq * seq * cfg.head_dim


def _kron_pass(cfg, rows: int) -> float:
    """One forward pass of every KronLinear of the Kron FFN over ``rows``
    rows (w1 and w3 up, w2 down, each layer), from the plans' programs."""
    total = 0.0
    for d_in, d_out in ((cfg.d_model, cfg.d_ff),) * 2 + ((cfg.d_ff, cfg.d_model),):
        spec = KronLinearSpec.balanced(d_in, d_out, cfg.kron_factors)
        op = kron_op_for(spec.ps, spec.qs)
        prog = _lowered(op._single_plan(rows, 4), op.ps, op.qs)
        k = math.prod(spec.ps)
        for ins in prog.instrs:
            total += emit.chain_flops(1, rows, k, ins.ps, ins.qs)
            k = k // ins.pprod * ins.qprod
    return cfg.n_layers * total


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("kron", [False, True], ids=["dense", "kron_ffn"])
def test_train_step_dot_flops_against_reference(kron, microbatches):
    """Dense: the port's dot FLOPs are the reference's plus the attention
    scores recomputed once per layer and query chunk, exactly.  Kron FFN:
    plus, besides, less than one more forward pass of the Kron FFN: the
    port's backward re-forwards the chain of each stage up to its last
    factor and the stage inputs, and re-runs the whole layer in its remat
    recompute, where XLA keeps chain intermediates as residuals and drops
    recomputed products the backward does not read (reduced qwen3-4b, f32,
    2 x 32 tokens: 786,432 of the 1,310,720 a pass costs)."""
    jcfg, tcfg = _cfgs(kron)
    jp, tp, toks = _inputs(jcfg, tcfg)
    jstate = JT.TrainState(jp, jax.eval_shape(lambda p: jopt_init(p, JOpt()), jp),
                           jax.ShapeDtypeStruct((), jnp.int32))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    hlo = jax.jit(JT.make_train_step(jcfg, JOpt(), microbatches=microbatches)).lower(
        jstate, batch).compile().as_text()
    ref = JH.analyze(hlo)
    state = TT.TrainState(tp, topt_init(tp, TOpt()), torch.zeros((), dtype=torch.int32))
    t = torch.from_numpy(toks)
    got = TH.analyze(TT.make_train_step(tcfg, TOpt(), microbatches=microbatches), state,
                     {"tokens": t, "labels": t})
    scores = _score_recompute(tcfg, B, S)
    if not kron:
        assert got.dot_flops == ref.dot_flops + scores
        return
    excess = got.dot_flops - ref.dot_flops - scores
    assert 0 < excess < _kron_pass(tcfg, B * S)


# --------------------------------------------------------------------------
# The kernels' fake path
# --------------------------------------------------------------------------

def _refuse(*args, **kwargs):
    raise AssertionError("a fake tensor reached the build, an occupancy query or ctypes")


@pytest.fixture
def no_card(monkeypatch):
    """Every way to the card refuses; the launch counters start at 0."""
    monkeypatch.setattr(_build, "library", _refuse)
    monkeypatch.setattr(_build, "build_all", _refuse)
    for mod in (emit, kron_sliced, kron_sliced_t):
        monkeypatch.setattr(mod, "sm_count", _refuse)
    for name in ("grad_occupancy", "chain_occupancy", "occupancy", "kernel_fn"):
        monkeypatch.setattr(emit, name, _refuse)
    monkeypatch.setattr(kron_sliced, "sliced_occupancy", _refuse)
    monkeypatch.setattr(kron_sliced_t, "sliced_t_occupancy", _refuse)
    monkeypatch.setattr(kron_sliced, "kernel_fn", _refuse)
    monkeypatch.setattr(kron_sliced_t, "kernel_fn", _refuse)
    counters = [(emit, "chain_launches"), (emit, "chain_bwd_launches"), (emit, "grad_launches"),
                (emit, "grad_reduce_launches"), (kron_sliced, "sliced_launches"),
                (kron_sliced_t, "sliced_t_launches")]
    for mod, attr in counters:
        monkeypatch.setattr(mod, attr, 0)
    yield lambda: {attr: getattr(mod, attr) for mod, attr in counters}


# name -> (wrapper, twin, operand shapes (x or dy first, then factors), dtype)
PS, QS, M = (4, 6, 5), (3, 4, 2), 8
K = math.prod(PS)
K_OUT = math.prod(QS)
LAUNCHERS = {
    "chain_fwd": (lambda *t: emit.chain_cuda(*t), lambda *t: emit.chain_reference(*t),
                  [(2, M, K)] + [(2, p, q) for p, q in zip(PS, QS)], torch.float32),
    "chain_bwd": (lambda *t: emit.chain_bwd_cuda(*t), lambda *t: emit.chain_bwd_reference(*t),
                  [(1, M, K_OUT)] + [(1, p, q) for p, q in zip(PS, QS)], torch.bfloat16),
    "grad": (lambda *t: emit.grad_cuda(*t), lambda *t: emit.grad_reference(*t),
             [(2, M, K), (2, M, K_OUT)] + [(2, p, q) for p, q in zip(PS, QS)], torch.float32),
    "sliced": (lambda x, f: kron_sliced.sliced_multiply_cuda(x, f),
               kron_sliced.sliced_multiply_reference, [(M, 24), (4, 7)], torch.float32),
    "sliced_t": (lambda dy, f: kron_sliced_t.sliced_multiply_t_cuda(dy, f),
                 kron_sliced_t.sliced_multiply_t_reference, [(M, 42), (4, 7)], torch.float64),
}


def _shapes(out):
    return [tuple(t.shape) for t in TH._tensors(out)]


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_fake_launch_counts_the_twins_flops_and_launches_nothing(no_card, name):
    wrapper, twin, shapes, dtype = LAUNCHERS[name]
    gen = torch.Generator().manual_seed(0)
    real = [torch.randn(s, generator=gen, dtype=torch.float32).to(dtype) for s in shapes]
    with TH.CostMode() as plain:
        want = twin(*real)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]
        with TH.CostMode() as mode:
            got = wrapper(*fake)
    assert all(isinstance(t, FakeTensor) and t.is_cuda for t in TH._tensors(got))
    assert _shapes(got) == _shapes(want)
    assert [t.dtype for t in TH._tensors(got)] == [t.dtype for t in TH._tensors(want)]
    assert no_card() == dict.fromkeys(no_card(), 0)
    assert mode.cost.kernel_flops == {name: plain.cost.dot_flops}
    assert mode.cost.dot_flops == mode.cost.flops == plain.cost.dot_flops > 0
    nbytes = sum(TH.shape_bytes(t) for t in TH._tensors((fake, got)))
    assert mode.cost.bytes_accessed == nbytes


def test_real_cpu_tensors_still_refuse_the_launchers():
    with pytest.raises(ValueError, match="CUDA"):
        emit.chain_cuda(torch.zeros(1, 4, 4), torch.zeros(1, 4, 4))


# --------------------------------------------------------------------------
# Conventions
# --------------------------------------------------------------------------

def test_elementwise_reduction_view_and_bytes():
    x, y = torch.randn(6, 5), torch.randn(6, 5)
    n, b = 30, 30 * 4
    assert TH.analyze(torch.add, x, y).flops == n
    assert TH.analyze(torch.add, x, y).bytes_accessed == 3 * b
    assert TH.analyze(lambda: x.sum(dim=1)).flops == n
    assert TH.analyze(lambda: torch.softmax(x, -1)).flops == 5 * n
    copy = TH.analyze(lambda: x.t().clone(memory_format=torch.contiguous_format))
    assert (copy.flops, copy.bytes_accessed) == (0, 2 * b)
    view = TH.analyze(lambda: x.view(5, 6).transpose(0, 1))
    assert (view.flops, view.bytes_accessed) == (0, 0)
    mm = TH.analyze(torch.mm, x, y.T.contiguous())
    assert mm.dot_flops == mm.flops == 2 * 6 * 5 * 6


def test_live_storage_peak():
    with TH.CostMode(memory="cpu") as mode:
        a = torch.empty(1000)            # 4000 bytes live
        b = torch.empty(500)             # 6000
        del a                            # 2000
        c = torch.empty(250)             # 3000
        c.add_(1)                        # in place: no new storage
        d = c.view(25, 10)               # a view: none either
    assert mode.peak_bytes == 6000
    assert mode.live_bytes == 3000
    del b, c, d
    assert mode.live_bytes == 0


def test_plan_cache_device_tag_asks_no_device_in_a_fake_trace():
    from repro_torch.core import autotune

    with FakeTensorMode():
        assert autotune.device_tag("cuda") == "fake"
    assert autotune.device_tag("cpu") == "cpu"
