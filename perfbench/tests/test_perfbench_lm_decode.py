"""The ``lm_decode`` step kind on the CPU at a small size: the program reads
correct, the control and each planted fault read not correct; the decode
step's cost against hand counts at the published widths; and the
configuration against the registry's model."""
import json
import shutil

import pytest

from perfbench import cost_lm, harness, reference_lm

PKG = harness.PKG
SEED = 2**33 + 27
STEP = harness.load_module(PKG / "steps" / "lm_decode.py", "step")
CONFIG = json.loads((PKG / "configs" / "deepseek-moe-16b-kron-bf16.json").read_text())
# reduced widths, float32: three layers (one dense), 8 experts top-3, 2 shared
TINY = dict(name="tiny-lm", num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, intermediate_size=128, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=3, vocab_size=256, dtype="float32")
TRAFFIC = dict(batch=2, prompt=8, cache=10, cycle=2, warmup_steps=2, traced_steps=3,
               host_steps=2, sampled=3, sample_range=10)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark with a tiny configuration and a tiny cell that
    has the real cell's step kind and limits."""
    tmp = tmp_path_factory.mktemp("lm")
    shutil.copytree(PKG, tmp / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    pkg = tmp / "perfbench"
    (pkg / "configs" / "tiny-lm.json").write_text(json.dumps({**CONFIG, **TINY}))
    w = json.loads((PKG / "workloads" / "kronffn-decode.json").read_text())
    w.update(config="tiny-lm", traffic=TRAFFIC)
    (pkg / "workloads" / "tiny-decode.json").write_text(json.dumps(w))
    return pkg


def _run(pkg, impl="program", seconds=0.5):
    return harness.run_cell("tiny-decode", SEED, seconds, False, device="cpu", impl=impl, pkg=pkg)


def test_program_reads_correct_over_cycles(bench):
    ok = _run(bench, seconds=2.0)
    assert ok["correct"] and ok["failed"] == 0, ok["checks"]
    assert ok["attempted"] > 2 * TRAFFIC["cycle"]  # the window wraps the cycle
    for c in ok["checks"].values():
        assert c["value"] < c["limit"] / 100


@pytest.mark.parametrize("impl", ["control"] + [f"fault:{f}" for f in STEP.FAULTS])
def test_control_and_faults_read_not_correct(bench, impl):
    bad = _run(bench, impl)
    assert not bad["correct"] and bad["failed"] > 0, bad["checks"]


def test_decode_cost_by_hand():
    """deepseek-moe-16b, B = 8, positions 1,024-1,087, bf16."""
    lm = reference_lm.LMConfig.from_config(CONFIG)
    up, up_s = ((64, 32), (144, 76)), ((64, 32), (64, 44))
    shapes = [up, up, up[::-1]] + [up_s, up_s, up_s[::-1]] * 27
    c = cost_lm.decode_step(lm, 8, 1024, 64, shapes)
    hit = 64 * (1 - (58 / 64) ** 8)
    assert c.experts_hit == pytest.approx(hit) and round(hit, 1) == 34.9
    attn_w = 28 * 4 * 2048 * 2048
    experts = 27 * hit * 3 * 2048 * 1408
    head = 2048 * 102400
    mean_kv = 1024 + 65 / 2  # entries a query reads, the cycle's mean
    kv_bytes = 28 * 2 * 8 * 2048 * 2 * mean_kv
    big = 2 * (attn_w + experts + head) + kv_bytes
    assert round(big / 1e9, 2) == 19.59
    small = (2 * 28 * 2 * 8 * 2048          # the new K/V
             + 27 * 2048 * 64 * 4           # routers, f32
             + 2 * (57 * 2048 + 8 * 2048)   # norms, embedding rows
             + 8 * 102400 * 4)              # f32 logits
    kron = [(8 * 2048 + 8 * 10944 + 64 * 144 + 32 * 76) * 2] * 2 + [
        (8 * 10944 + 8 * 2048 + 144 * 64 + 76 * 32) * 2] + [
        (8 * 2048 + 8 * 2816 + 64 * 64 + 32 * 44) * 2] * 54 + [
        (8 * 2816 + 8 * 2048 + 64 * 64 + 44 * 32) * 2] * 27
    assert c.kron.bytes == sum(kron)
    assert c.bytes == pytest.approx(big + small + sum(kron), abs=1)
    flops = 2 * 8 * (attn_w + 27 * 6 * 3 * 2048 * 1408 + 27 * 2048 * 64 + head)
    flops += 4 * 8 * 28 * 2048 * mean_kv
    assert round(flops / 1e9, 1) == 35.3
    assert c.flops == int(flops + c.kron.flops)
    # the last factor first: 2 M P1 P2 Q2, then 2 M Q2 P1 Q1
    assert c.kron.flops == sum(2 * 8 * p1 * q2 * (p2 + q1) for (p1, p2), (q1, q2) in shapes)
    assert c.bound == "memory" and c.roofline_s == pytest.approx(c.bytes / 3.35e12)


def test_config_is_the_registry_model():
    """The cell runs ``get_config("deepseek-moe-16b")`` unchanged but for
    the Kron FFNs and the dropless capacity factor."""
    import dataclasses

    from repro_torch.configs import get_config

    reg = get_config("deepseek-moe-16b")
    cfg = STEP.program_config(CONFIG)
    assert cfg == dataclasses.replace(
        reg, kron_ffn=True, kron_factors=2,
        moe=dataclasses.replace(reg.moe, capacity_factor=64 / 6))
    assert reg.moe.norm_topk is False and round(reg.param_count() / 1e9, 2) == 16.38
    # as run, the Kron FFNs hold 0.53 B fewer: 15.84 B, 31.7 GB in bf16
    from repro_torch import tree
    from repro_torch.models import model as M

    held = sum(t.numel() for t in tree.leaves(M.init_params(cfg, None, device="meta")))
    assert round(held / 1e9, 2) == 15.84
    assert CONFIG["reduced"] == ["kron_ffn"] and CONFIG["norm_topk_prob"] is False
