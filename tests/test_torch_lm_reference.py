"""The port's MoE language model against the benchmark's plain float32
reference (``perfbench/reference_lm.py``), on the CPU at a small size:
``prefill`` then ``decode_step`` logits against the reference's full
forward pass that replays the program's recorded expert picks, for dense
and Kron FFNs and both gate rules; the route record (``moe.route_record``);
the model stack's spans and counters; and the gate rules themselves
(``norm_topk=False`` is DeepSeekMoE's g_i = s_i, ``True`` the JAX
package's renormalized gate)."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import reference_lm  # noqa: E402
from perfbench.harness import load_module  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.config import MoEConfig as JMoECfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import MoEConfig, reduced  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402

STEP = load_module(ROOT / "perfbench" / "steps" / "lm_decode.py", "step")
# f32 program against the f32 reference: summation order alone
LOGIT_TOL = 1e-4
B, S, FED = 2, 8, 3


def _cfg(kron: bool, norm_topk: bool):
    """Reduced deepseek-moe-16b (f32): a dense layer and two MoE layers of
    8 experts, top-3, 2 shared; capacity E/k, so no token drops."""
    cfg = reduced(get_config("deepseek-moe-16b"), dtype="float32", n_layers=3,
                  n_kv_heads=4, kron_ffn=kron)
    mc = dataclasses.replace(cfg.moe, n_experts=8, top_k=3, n_shared=2, norm_topk=norm_topk)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=mc.n_experts / mc.top_k))


def _lm(cfg) -> reference_lm.LMConfig:
    mc = cfg.moe
    return reference_lm.LMConfig(
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_, vocab=cfg.vocab,
        first_dense=cfg.moe_skip_first, n_experts=mc.n_experts, top_k=mc.top_k,
        d_expert=mc.d_expert, norm_topk=mc.norm_topk, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps)


def _params(cfg, seed=0):
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    # non-zero norm scales, so the (1 + w) form is exercised
    g = torch.Generator().manual_seed(seed + 1)
    for layer in [*params["prelude"], *params["stack"].values()]:
        for k in ("ln1", "ln2"):
            layer[k].copy_(0.1 * torch.randn(layer[k].shape, generator=g))
    return params


def _n_moe(cfg) -> int:
    return sum(s.moe for s in cfg.layer_plan())


def _served(cfg, params, toks):
    """Prefill of ``toks[:, :S]``, then a decode step for each of the other
    tokens; the last row of each call's logits and each call's recorded
    router logits, one ``(B, positions, E)`` tensor per MoE layer."""
    n, e = _n_moe(cfg), cfg.moe.n_experts
    rec = torch.zeros(n, B, S, e)
    with moe.route_record(list(rec)):
        logits, cache = M.prefill(cfg, params, toks[:, :S], S + FED)
    rows, routes = [logits[:, -1, :cfg.vocab]], [rec]
    for j in range(toks.shape[1] - S):
        rec = torch.zeros(n, B, 1, e)
        with moe.route_record(list(rec)):
            logits, cache = M.decode_step(cfg, params, cache, toks[:, S + j:S + j + 1], S + j)
        rows.append(logits[:, -1, :cfg.vocab])
        routes.append(rec)
    return rows, list(torch.cat(routes, dim=2))


@pytest.mark.parametrize("kron", [False, True], ids=["dense", "kron"])
@pytest.mark.parametrize("norm_topk", [False, True], ids=["paper-gate", "renormalized"])
def test_prefill_and_decode_equal_plain_reference(kron, norm_topk):
    cfg = _cfg(kron, norm_topk)
    params = _params(cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (B, S + FED)))
    rows, routes = _served(cfg, params, toks)
    weights = STEP.ProgramWeights(cfg, params)
    at = torch.arange(S - 1, S + FED)
    ref, ref_routes = reference_lm.forward(_lm(cfg), weights, toks, routes, logits_at=at)
    for k, row in enumerate(rows):
        assert float((row - ref[:, k]).abs().max()) <= LOGIT_TOL * float(ref[:, k].abs().max())
    for got, want in zip(routes, ref_routes):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # The reference's own picks agree with the replayed ones in f32.
    own, _ = reference_lm.forward(_lm(cfg), weights, toks, logits_at=at)
    torch.testing.assert_close(own, ref, rtol=1e-5, atol=1e-5)


def test_the_gate_rule_moves_the_output():
    """Same weights, the other gate: the reference told the other rule
    reads far off, so the comparison above sees the gate."""
    cfg = _cfg(True, False)
    params = _params(cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (B, S + FED)))
    rows, routes = _served(cfg, params, toks)
    lm = dataclasses.replace(_lm(cfg), norm_topk=True)
    ref, _ = reference_lm.forward(lm, STEP.ProgramWeights(cfg, params), toks, routes,
                                  logits_at=torch.tensor([S + FED - 1]))
    assert float((rows[-1] - ref[:, 0]).abs().max()) > 100 * LOGIT_TOL * float(ref.abs().max())


def _moe_block(norm_topk=False, seed=0):
    cfg = _cfg(False, norm_topk)
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg, torch.float32, device="cpu")
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1))
    return cfg, p, x


def test_route_record_off_changes_nothing_and_costs_nothing():
    cfg, p, x = _moe_block()
    buf = torch.full((B, S, cfg.moe.n_experts), float("nan"))

    def ops(record: bool):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            if record:
                with moe.route_record([buf]):
                    y, aux = moe.moe_apply(cfg, p, x)
            else:
                y, aux = moe.moe_apply(cfg, p, x)
        counts = {}
        for e in prof.events():
            counts[e.name] = counts.get(e.name, 0) + 1
        return y, aux, counts

    y_off, aux_off, off = ops(False)
    assert moe._RECORD is None and bool(buf.isnan().all())
    ptr = buf.data_ptr()
    y_on, aux_on, on = ops(True)
    assert torch.equal(y_on, y_off) and torch.equal(aux_on, aux_off)
    # the router's matmul writes the caller's buffer in place: the same
    # mm, no copy, no allocation; only views of the buffer are added
    assert buf.data_ptr() == ptr and buf.shape == (B, S, cfg.moe.n_experts)
    assert torch.equal(buf, x.float() @ p["router"])
    added = {k for k in on if on[k] > off.get(k, 0)}
    assert added <= {"aten::view", "aten::reshape"}, added
    assert on["aten::mm"] == off["aten::mm"] and on.get("aten::copy_", 0) == off.get("aten::copy_", 0)
    assert moe._RECORD is None


def test_route_record_holds_routes_input(monkeypatch):
    cfg, p, x = _moe_block()
    seen = []
    route = moe._route

    def spy(router_logits, mc, capacity):
        seen.append(router_logits.clone())
        return route(router_logits, mc, capacity)

    monkeypatch.setattr(moe, "_route", spy)
    bufs = [torch.zeros(B, S, cfg.moe.n_experts) for _ in range(2)]
    with moe.route_record(bufs):
        moe.moe_apply(cfg, p, x)
        moe.moe_apply(cfg, p, 2 * x)
        with pytest.raises(IndexError):
            moe.moe_apply(cfg, p, x)
        with pytest.raises(RuntimeError):
            with moe.route_record(bufs):
                pass
    assert len(seen) == 2  # the third call raised before routing
    assert torch.equal(bufs[0], seen[0]) and torch.equal(bufs[1], seen[1])
    assert not torch.equal(bufs[0], bufs[1])


SPANS = {"kronscope.attn", "kronscope.ffn", "kronscope.moe", "kronscope.moe_route",
         "kronscope.moe_experts"}


def _model_ranges(fn) -> set:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages() if e.key.startswith("kronscope.")}


def test_model_spans_and_counters():
    cfg = _cfg(True, False)
    params = _params(cfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (B, S + 1)))
    logits, cache = M.prefill(cfg, params, toks[:, :S], S + 1)

    def decode():
        M.decode_step(cfg, params, cache, toks[:, S:], S)

    def prefill():
        M.prefill(cfg, params, toks[:, :S], S + 1)

    assert _model_ranges(decode) & SPANS == set()
    assert telemetry.snapshot() == {}
    n_moe, e, k = _n_moe(cfg), cfg.moe.n_experts, cfg.moe.top_k
    telemetry.configure()
    try:
        assert SPANS <= _model_ranges(decode)
        counters = telemetry.snapshot()["counters"]
        # decode: one token a row; capacity min(8, S*k) = k
        assert counters["moe.tokens"] == n_moe * B
        assert counters["moe.slots"] == n_moe * B * e * k
        telemetry.configure()
        assert SPANS <= _model_ranges(prefill)
        counters = telemetry.snapshot()["counters"]
        cap = moe._capacity(S, cfg.moe)
        assert cap >= S and counters["moe.tokens"] == n_moe * B * S
        assert counters["moe.slots"] == n_moe * B * e * cap
        hists = telemetry.snapshot()["histograms"]
        # ffn: the dense layer's and each MoE layer's shared experts
        assert hists["span.attn"]["count"] == cfg.n_layers
        assert hists["span.ffn"]["count"] == cfg.n_layers
        assert hists["span.moe"]["count"] == hists["span.moe_route"]["count"] == n_moe
        assert hists["span.moe_experts"]["count"] == n_moe
    finally:
        telemetry.reset()
    assert _model_ranges(decode) & SPANS == set()


def test_gate_rules_paper_and_reference():
    """``norm_topk=False``: each kept slot's gate is its expert's softmax
    score (DeepSeekMoE's g_i = s_i, summing to under 1); ``True``: the
    scores renormalized over the top-k, the JAX package's weights."""
    rng = np.random.default_rng(8)
    s, e, k = 16, 8, 3
    logits = rng.standard_normal((s, e)).astype(np.float32)
    t = torch.from_numpy(logits)[None]
    probs = torch.softmax(t, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    cap = s * k
    for norm in (False, True):
        mc = MoEConfig(n_experts=e, top_k=k, d_expert=4, capacity_factor=e / k, norm_topk=norm)
        _, (slot_e, _, w, keep) = moe._route(t, mc, cap)
        assert bool(keep.all())
        assert torch.equal(slot_e.reshape(1, s, k), top_i)
        want = top_p / top_p.sum(-1, keepdim=True) if norm else top_p
        torch.testing.assert_close(w.reshape(1, s, k), want, rtol=0, atol=0)
        if not norm:
            assert float(w.reshape(s, k).sum(-1).max()) < 1.0
    jmc = JMoECfg(n_experts=e, top_k=k, d_expert=4, capacity_factor=e / k)
    x = np.zeros((s, 4), np.float32)
    _, (_, _, jw, _) = jax.jit(JMoE._route_one_seq, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(logits), jmc, cap)
    mc = MoEConfig(n_experts=e, top_k=k, d_expert=4, capacity_factor=e / k)
    _, (_, _, w, _) = moe._route(t, mc, cap)
    np.testing.assert_allclose(w[0].numpy(), np.asarray(jw), rtol=1e-6)
