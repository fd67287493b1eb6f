"""The port's training step against the benchmark's plain float32 training
reference (``perfbench/reference_lm_train.py``), on the CPU at a small
qwen3 shape; the ``lm_train`` step kind's check, which must pass the
program and fail the e4m3 control and every planted fault; the training
step's cost against hand counts; the train step's spans and counters; and
the new readers on a synthetic trace."""
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import cost, cost_lm_train, harness, reference_lm, reference_lm_train, trace  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.train import TrainState, make_train_step, train_state_init  # noqa: E402

PKG = harness.PKG
STEP = harness.load_module(PKG / "steps" / "lm_train.py", "step")
CONFIG = json.loads((PKG / "configs" / "qwen3-4b-kron-bf16.json").read_text())
SEED = 2**33 + 41
B, S = 2, 16
# f32 program against the f32 reference: the order of summation alone
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _cfg(**kw):
    return dataclasses.replace(
        reduced(get_config("qwen3-4b"), tie_embeddings=True, kron_ffn=True), dtype="float32",
        **kw)


def _lm(cfg) -> reference_lm_train.LMConfig:
    return reference_lm_train.LMConfig(
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_, d_ff=cfg.d_ff, vocab=cfg.vocab,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)


def _state(cfg, opt, seed=0):
    state = train_state_init(cfg, opt, torch.Generator().manual_seed(seed), device="cpu")
    # non-zero norm scales, so the (1 + w) form and qk-norm's scales are exercised
    g = torch.Generator().manual_seed(seed + 1)
    layer = state.params["stack"]["pos0"]
    for leaf in (layer["ln1"], layer["ln2"], layer["mixer"]["q_norm"], layer["mixer"]["k_norm"],
                 state.params["final_norm"]):
        leaf.copy_(0.1 * torch.randn(leaf.shape, generator=g))
    return state


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("n_kv_heads", [1, 2, 4], ids=["mqa", "gqa", "mha"])
def test_train_step_loss_and_gradients_equal_plain_reference(remat, n_kv_heads):
    """One ``make_train_step`` step (``backend="torch"``) from the initial
    state: its loss, and each leaf's gradient as AdamW's first moment holds
    it (``(1 - b1) g clip_scale`` after the first step), against the
    reference at the same parameters and tokens."""
    cfg = _cfg(remat=remat, n_kv_heads=n_kv_heads)
    opt = OptConfig(clip_norm=1e9)
    state = _state(cfg, opt)
    toks, labels = SyntheticLM(vocab=cfg.vocab, seq_len=S, batch=B, seed=3,
                               device="cpu").global_batch(0)
    new, m = make_train_step(cfg, opt, backend="torch")(state, {"tokens": toks, "labels": labels})
    weights = STEP.reference_weights(state.params)
    ref_loss, ref_grads = reference_lm_train.loss_and_grads(_lm(cfg), weights, toks, labels)
    assert abs(float(m["loss"]) - float(ref_loss)) <= LOSS_TOL
    got = reference_lm_train._tree_map(lambda t: t / (1 - opt.b1),
                                       STEP.reference_weights(new.opt["m"]))
    rels = STEP.leaf_rels(got, ref_grads)
    assert max(rels.values()) <= GRAD_TOL, rels
    # every leaf has a gradient worth the name, the table's both parts
    assert all(float(g.abs().max()) > 0 for g in reference_lm_train._leaves(ref_grads))


@pytest.mark.parametrize("precision", ["float32", "e4m3"])
def test_reference_tied_table_sums_lookup_and_head(precision):
    """The table's gradient is the lookup's part plus the head's: the same
    loss with the two uses split over two copies of the table gives the two
    parts, which add up to the tied gradient."""
    cfg = _cfg(n_layers=1)
    lm = _lm(cfg)
    weights = STEP.reference_weights(_state(cfg, OptConfig()).params)
    toks, labels = SyntheticLM(vocab=cfg.vocab, seq_len=8, batch=2, seed=5,
                               device="cpu").global_batch(0)
    _, grads = reference_lm_train.loss_and_grads(lm, weights, toks, labels, precision=precision)
    table = weights["embed"].detach().float()
    rnd = reference_lm_train._rounding(precision)
    # the lookup's part: the gradient of the loss with respect to the lookup's rows
    leaves = reference_lm_train._tree_map(lambda t: t.detach().float(), weights)
    x = rnd(table)[toks.long()].requires_grad_()
    h = x
    for i in range(lm.n_layers):
        w = {k: reference_lm_train._tree_map(lambda t: t[i], leaves[k])
             for k in reference_lm_train.LAYER_LEAVES}
        h = reference_lm_train.layer(lm, w, h, rnd)
    head = table.clone().requires_grad_()
    out = reference_lm.rms_norm(h, rnd(leaves["final_norm"]), lm.norm_eps) @ rnd(head).T
    loss = torch.nn.functional.cross_entropy(out.reshape(-1, lm.vocab), labels.reshape(-1).long())
    dx, dhead = torch.autograd.grad(loss, (x, head))
    want = dhead.index_put((toks.long(),), dx, accumulate=True)
    torch.testing.assert_close(grads["embed"], want, rtol=1e-5, atol=1e-8)


# -- the step kind on the CPU -------------------------------------------------

TINY = dict(name="tiny-qwen", num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=128, vocab_size=256,
            dtype="float32")
TRAFFIC = dict(batch=2, seq=16, warmup_steps=2, traced_steps=2, host_steps=0, sample_range=2)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark with a tiny qwen3 configuration and a tiny
    cell that has the real cell's step kind and limits."""
    tmp = tmp_path_factory.mktemp("lmtrain")
    shutil.copytree(PKG, tmp / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    pkg = tmp / "perfbench"
    (pkg / "configs" / "tiny-qwen.json").write_text(json.dumps({**CONFIG, **TINY}))
    w = json.loads((PKG / "workloads" / "kronffn-train.json").read_text())
    w.update(config="tiny-qwen", traffic=TRAFFIC)
    (pkg / "workloads" / "tiny-train.json").write_text(json.dumps(w))
    return pkg


def _run(pkg, impl="program", seconds=1.5, trace_on=False):
    return harness.run_cell("tiny-train", SEED, seconds, trace_on, device="cpu", impl=impl,
                            pkg=pkg)


def test_program_reads_correct(bench):
    ok = _run(bench, seconds=2.0, trace_on=True)
    assert ok["correct"] and ok["failed"] == 0, ok["checks"]
    for c in ok["checks"].values():
        assert c["value"] < c["limit"] / 100


@pytest.mark.parametrize("impl", ["control"] + [f"fault:{f}" for f in STEP.FAULTS])
def test_control_and_faults_read_not_correct(bench, impl):
    bad = _run(bench, impl)
    assert not bad["correct"] and bad["failed"] > 0, bad["checks"]
    # failed on what it compared, not for want of the drawn step
    assert all(c["value"] is not None for c in bad["checks"].values()), bad["checks"]


def test_faults_are_removed_after_the_run(bench):
    from repro_torch.kernels import emit
    from repro_torch.models import attention
    from repro_torch.optim import adamw

    def patched():
        return (emit.grad_cuda, emit.grad_reference, attention._project_qkv, M._embed,
                adamw._apply, adamw.global_norm)

    before = patched()
    for fault in STEP.FAULTS:
        _run(bench, f"fault:{fault}", seconds=0.1)
    assert patched() == before


def test_window_without_the_drawn_step_reads_not_correct(bench):
    """A window too short to reach the drawn step has no gradient to
    compare: the check fails rather than passing on nothing."""
    step = STEP.Step({**CONFIG, **TINY}, TRAFFIC, SEED, "cpu")
    step.drawn = 10**6
    step.start_window()
    step.run()
    step.finish()
    checks = step.check()
    assert checks["grad_rel"][0] == float("inf")
    assert len(checks["grad_rel"]) == 2 and len(checks["param_miss"]) == 1


def test_prepared_and_later_batches_are_the_data_streams():
    """Each step's batch is the data stream's at its index: the set-up's
    from the first, the window's from where the set-up stopped, made before
    the window, as many as ``MARGIN`` windows of ``run_seconds`` at the
    timed step's pace, and taken again from the first past the last."""
    step = STEP.Step({**CONFIG, **TINY}, TRAFFIC, SEED, "cpu")
    data = SyntheticLM(vocab=256, seq_len=TRAFFIC["seq"], batch=TRAFFIC["batch"], seed=SEED,
                       device="cpu")

    def ran(i):
        toks, labels = data.global_batch(i)
        return torch.equal(step.last.tokens, toks) and torch.equal(step.last.labels, labels)

    setup = len(step.pool)
    assert setup == TRAFFIC["warmup_steps"] + TRAFFIC["traced_steps"] + 2
    for i in range(setup + 1):
        step.run()
        assert ran(i % setup)
    step.start_window()
    start = step.i
    assert len(step.pool) >= STEP.MARGIN * STEP._run_seconds() / 60 and step.base == start
    step.run()
    assert ran(start) and step.last.count == start + 1
    step.pool = step.pool[:2]
    step.run()
    step.run()
    assert ran(start)


def test_config_is_the_published_model():
    cfg = STEP.program_config(CONFIG)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff,
            cfg.vocab) == (36, 2560, 32, 8, 128, 9728, 151936)
    assert cfg.qk_norm and not cfg.qkv_bias and cfg.tie_embeddings and cfg.remat
    assert cfg.kron_ffn and cfg.kron_factors == 2 and cfg.dtype == "bfloat16"
    assert cfg.rope_theta == 1e6 and cfg.norm_eps == 1e-6 and cfg.padded_vocab == cfg.vocab
    assert cfg.param_count() == 4_022_272_000  # dense FFNs, tied, as published
    params = M.init_params(cfg, None, device="meta")
    assert sum(p.numel() for p in tree.leaves(params)) == 1_334_083_712
    up, down = ((64, 40), (128, 76)), ((128, 76), (64, 40))
    assert STEP.kron_shapes(params) == [up, up, down] * 36
    assert reference_lm_train.LMConfig.from_config(CONFIG).head_dim == 128


# -- the cost ---------------------------------------------------------------------


def test_train_cost_by_hand_at_a_small_size():
    lm = reference_lm_train.LMConfig.from_config({**CONFIG, **TINY})
    up, down = ((8, 8), (16, 8)), ((16, 8), (8, 8))
    c = cost_lm_train.train_step(lm, 2, 16, [up, up, down] * 2, dtype="float32")
    t = 32
    # wq, wk, wv, wo: 64 x 64, 64 x 32 twice, 64 x 64; the tied head 256 x 64
    matrices = 2 * (64 * 64 * 2 + 64 * 32 * 2) + 256 * 64
    attn = 2 * 2 * 2 * 2 * 4 * 16 * (16 * 17 // 2)  # layers, two products, 2 FLOPs, B, H, hd
    # one up projection at M = 32: Y (8*8*16 + 16*8*8 multiply-adds a row: the
    # last factor first), dX (16*8*8 + 8*16*8... through the transposed factors), dF
    fwd_up = 2 * t * (8 * 8 * 8 + 8 * 8 * 16)
    fwd_down = 2 * t * (16 * 8 * 8 + 8 * 16 * 8)
    kron = 2 * (2 * (fwd_up + fwd_down + fwd_up) + (fwd_down + fwd_up + fwd_down))
    assert c.kron.flops == kron
    assert c.flops == 6 * t * matrices + 3 * attn + kron
    n = 256 * 64 + 64 + 2 * (64 * 64 * 2 + 64 * 32 * 2 + 2 * 16 + 2 * 64 + 3 * (8 * 16 + 8 * 8))
    assert c.params == n
    assert c.bytes == c.optim.bytes == n * (4 + 4 + 4 + 8 + 8 + 4)  # f32 p, g, p', m, v, m', v', g
    assert c.kron.bytes == 2 * 2 * (2 * t * 64 + 2 * t * 128 + 2 * 192) * 4 + \
        2 * (2 * t * 128 + 2 * t * 64 + 2 * 192) * 4


def test_train_cost_at_the_published_size():
    lm = reference_lm_train.LMConfig.from_config(CONFIG)
    shapes = [((64, 40), (128, 76))] * 2 + [((128, 76), (64, 40))]
    c = cost_lm_train.train_step(lm, 4, 1024, shapes * 36)
    assert c.params == 1_334_083_712
    assert c.optim.bytes == 24 * 1_334_083_712 and round(c.optim.memory_s * 1e3, 2) == 9.56
    matrices = 36 * 2560 * (4096 * 2 + 1024 * 2) + 151936 * 2560
    assert round(6 * 4096 * matrices / 1e13, 3) == 3.275
    assert round(c.flops / 1e13, 2) == 3.85 and c.dtype == "bfloat16"
    assert round(c.compute_s * 1e3, 1) == 38.9 and c.bound == "compute"
    assert c.kron.bound == "memory"


# -- tracing ---------------------------------------------------------------------


def test_train_step_spans_and_counters():
    cfg = _cfg()
    opt = OptConfig()
    state = _state(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=S, batch=B, seed=6, device="cpu")
    step = make_train_step(cfg, opt, backend="torch")
    n_params = sum(p.numel() for p in tree.leaves(state.params))

    def run(state, steps):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in range(steps):
                toks, labels = data.global_batch(i)
                state, _ = step(state, {"tokens": toks, "labels": labels})
        keys = {e.key: e.count for e in prof.key_averages() if e.key.startswith("kronscope.")}
        return state, keys

    state, keys = run(state, 1)
    assert "kronscope.loss" not in keys and "kronscope.optim" not in keys
    assert telemetry.snapshot() == {}
    telemetry.configure()
    try:
        state, keys = run(state, 3)
        assert keys["kronscope.loss"] == keys["kronscope.optim"] == 3
        snap = telemetry.snapshot()
        assert snap["counters"]["train.tokens"] == 3 * B * S
        assert snap["counters"]["optim.elements"] == 3 * n_params
        assert snap["histograms"]["span.loss"]["count"] == 3
        assert snap["histograms"]["span.optim"]["count"] == 3
    finally:
        telemetry.reset()
    assert isinstance(state, TrainState) and int(state.step) == 4


HOST, STREAM, BWD = 100, 7, 200


def _x(name, cat, ts, dur, tid=HOST, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _train_trace(with_optim: bool):
    """Two 100 us steps.  Each: a Kron kernel launched in ``kronscope.op``
    and ``.stage`` (20 us); in ``kronscope.op_bwd`` on the backward's thread,
    a remat kernel outside the executor's ranges (7 us) and a Kron kernel
    in ``.stage_grad`` (10 us); an elementwise kernel outside all (5 us);
    with ``with_optim``, an optimizer kernel in ``kronscope.optim`` (8 us)."""
    ev = [_x("perfbench.window", "user_annotation", 0, 200)]
    corr = 0

    def launch(at, dur, tid):
        nonlocal corr
        corr += 1
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", at, 1, tid=tid, corr=corr))
        ev.append(_x(f"k{corr}", "kernel", at + 2, dur, tid=STREAM, corr=corr))

    for s in (0, 100):
        ev.append(_x("perfbench.step", "user_annotation", s + 1, 98))
        ev += [_x("kronscope.op", "user_annotation", s + 1, 5),
               _x("kronscope.stage", "user_annotation", s + 1.5, 3)]
        launch(s + 2, 20, HOST)
        ev += [_x("kronscope.op_bwd", "user_annotation", s + 25, 20, tid=BWD),
               _x("kronscope.stage_grad", "user_annotation", s + 29, 4, tid=BWD)]
        launch(s + 26, 7, BWD)
        launch(s + 30, 10, BWD)
        launch(s + 50, 5, HOST)
        if with_optim:
            ev.append(_x("kronscope.optim", "user_annotation", s + 59, 4))
            launch(s + 60, 8, HOST)
    return trace.Trace.from_chrome({"traceEvents": ev})


def _reader(name):
    return harness.load_module(PKG / "metrics" / f"{name}.py", "metric").read


def test_train_readers_on_a_synthetic_trace():
    lm = reference_lm_train.LMConfig.from_config(CONFIG)
    c = cost_lm_train.train_step(lm, 4, 1024, [((64, 40), (128, 76))] * 108)
    run = harness.Run(0.0, None, None, c, _train_trace(True))
    assert _reader("optim.device_ms")(run) == pytest.approx(8e-3)
    assert _reader("optim.roofline")(run) == pytest.approx(c.optim.memory_s / 8e-6 * 100)
    assert _reader("kronffn.train_roofline")(run) == pytest.approx(
        c.kron.roofline_s / 30e-6 * 100)
    # a program without the optimizer's span (the parent's): no reading
    bare = harness.Run(0.0, None, None, c, _train_trace(False))
    assert _reader("optim.device_ms")(bare) is None and _reader("optim.roofline")(bare) is None
    assert _reader("kronffn.train_roofline")(bare) is not None
    # another cell's cost: no Kron training roofline
    other = harness.Run(0.0, None, None, cost.Cost(1, 1, "float32"), _train_trace(True))
    assert _reader("kronffn.train_roofline")(other) is None
    assert _reader("optim.roofline")(other) is None
