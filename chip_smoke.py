#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --alone    # phases 1 and 4 only (A/B of two trees)
    python3 chip_smoke.py --mesh     # phases 1 and 12 only
    python3 chip_smoke.py --shard    # phases 1 and 13 only
    python3 chip_smoke.py --dryrun   # phases 1 and 14 only

It refuses to run (exit 1) with ``FASTKRON_CHAOS``, ``FASTKRON_NUMERICS`` or
``FASTKRON_PLAN_CACHE`` set: the first injects faults into the kernels'
path, the second adds host checks to every call, the third would point the
measured planner at a cache the smoke does not own (it writes its plans
into a temporary directory, never into ``~/.cache``).

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch twin on the card, then drives the
port's main path — ``KronOp(ps, qs)(x, factors)`` on CUDA tensors and
``torch.autograd.grad`` through it — at full size and checks that every call
went through the kernels.  Phases, one line each:

  1. build / device: nvcc time and libraries, each kernel's ptxas registers
     and spills (no kernel may spill); the card's name and power limit.
  2. check: each of the five kernels against its plain twin at stated
     tolerances (relative to max|ref|: 1e-5 f32, 1e-2 bf16, 1e-12 f64; the
     stage backward's dF against its twin run in f64 at 1e-4 f32, 2e-2
     bf16), and one small f32 KronOp, value and gradients, against
     ``x @ kron_matrix(factors)``.  Every kernel also runs cases that reach
     each branch of its code (many tiles per block, walks crossing samples
     and Q-tile digits, tensor cores, odd slices, copies too short for 16
     bytes, misaligned bases); every sliced multiply, transposed chain and
     stage backward runs twice and is asserted bitwise equal.
  3. main: five full-size KronOp calls (fig9, gp16, ffn, compress,
     fig9-unfused) and five full-size backward passes (fig9-grad, fig9-dx,
     gp16-grad, ffn-grad, fig9-unfused-grad); the per-sample batched path
     (gp16-batched and gp16-batched-grad: B=4 GP tasks at gp16's shape;
     precond-64x128 and precond-40x76: ``kron_precond_op`` over 36 layers)
     and ``torch.func.vmap`` (gp16-vmap over x and factors, bitwise equal
     to the per-sample call; fig9-vmap-x over x alone, B=2 folded into
     rows, bitwise equal to the flat call): launches per call (asserted),
     error against the plain twins, the backward run twice and asserted
     bitwise equal, the peak device memory (``kernel_peak_mem_gib``: inputs,
     forward and first backward; ``peak_mem_gib``: with the checks against
     the twins too), and CUDA-event times of the call, of its plain twins and
     of one PyTorch yardstick (``torch.einsum``, or ``torch.autograd.grad``
     through it), beside the card's bound for the same function.  Phases
     2-4 also assert that ``guard.health_report()`` records no rung
     fallback and no ``bwd_per_factor`` event.
  4. alone: one launch of every kernel at its main cases' shapes, timed by
     itself (chain_fwd: each stage of fig9, gp16 and ffn; chain_bwd:
     fig9-dx; grad: fig9-grad and ffn-grad; sliced: one fig9-unfused launch
     and ffn's two stages through plan=None in bf16; sliced_t: one
     fig9-unfused-grad launch), beside its per-launch bound, the blocks per
     SM from the occupancy query (at least two, or the run fails) and one
     PyTorch call computing the same function.  CUDA events around each
     call; the sliced rows add the device time alone (torch.profiler),
     which leaves out the host time between launches.
  5. ladder: the forward degradation ladder under ``chaos.inject``, at
     fig9 and gp16-batched: ``stage_execute`` puts a call on rung 1 (the
     per-factor kernels: ``sliced`` for fig9, chain-of-one ``chain_fwd``
     launches for gp16-batched, held bitwise to the planned result since
     the same kernel computes both); with ``per_factor`` injected too the
     call raises the per-factor rung's error, since on the card the ladder
     ends at the kernels (the plain twins never stand in for them), and so
     does a float16 call, a dtype the kernels do not take; the launch
     counters show which kernels ran, one GuardWarning per key,
     ``DEFAULT_PATIENCE`` degraded calls pin the key.
  6. measure: ``KronOp(..., tune="measure", cache_path=<temporary dir>)``
     on fig9, gp16, ffn (bf16) and gp16-batched: each distinct candidate's
     time, the winner, the analytic plan's time in the same run, the cache
     key (with the card's name); a second construction hits the cache
     (``plan_cache.hit``, no launch); the winner's forward and backward
     against the plain twins; then the pre-kronization pair
     (``enable_prekron`` True and False) on gp16 and gp16-batched.
  7. profile: ``KronOp.profile`` on fig9, gp16 and ffn: per stage the
     measured ms, the measured and predicted shares, the drift, the flags.
  8. ffn-block: qwen3-4b's FFN with ``kron_ffn=True, kron_factors=2`` (w1,
     w3 (64,40)->(128,76), w2 the reverse; three ``KronLinear`` modules) on
     4096 bf16 tokens: one module's forward (chain_fwd 2), the block's
     forward (chain_fwd 6) and backward into the parameters (grad 6,
     chain_fwd 3), against ``backend="torch"`` at 1e-2 / 2e-2; the dense
     SwiGLU block as a yardstick.
  9. gp-epoch: ``gp_train_epoch`` on six 16-point RBF factors (K=16^6,
     M=16, 10 CG iterations, f32; chain_fwd 3 per MVM, 11 MVMs) against
     ``backend="shuffle"`` at 1e-4, and ``gp_train_epoch_batched`` at B=4,
     every sample against its own shuffle epoch.
     Phases 6-9 assert an empty guard report after them.
  10. train: qwen3-4b at full width and depth (36 layers, ``kron_ffn=True,
      kron_factors=2``, bf16, remat) through ``make_train_step`` on
      ``SyntheticLM`` batches of 4 x 1024 tokens: one step through the
      kernels against the same step through ``backend="torch"`` (loss 1e-2,
      every leaf's gradient as AdamW's f32 first moment holds it 1e-1,
      updated Kron factors 2e-2), and the gradient check shown to fail a
      planted fault (factor gradients less an eighth of the rows); 6
      Shampoo steps (``precond_every=5``) and
      3 AdamW steps, each step's launches asserted against the plans'
      prediction (model: chain_fwd 540 with the remat re-forwards, grad and
      grad_reduce 216; Shampoo's 5 precondition calls: chain_fwd 10),
      finite losses and grad norms, the last Shampoo loss below the first;
      ms per step (CUDA events), tokens/s, the refresh steps' excess, peak
      memory, the profiled step's device time and idle share
      (``torch.profiler``: 1 - device ms / that step's event ms); Shampoo's
      batched ``precondition`` on the run's roots bitwise equal to
      ``looped=True`` and, per shape group, against its twins at 1e-5 (f32),
      a limit that a planted fault (the left roots dropped) must fail; an
      empty guard report after it.
  11. serve: (a) qwen3-4b at full width and depth with the Kron FFN (bf16,
      4 SyntheticLM prompts of 1024 tokens, a cache of 1088, 64 greedy
      decode steps through ``model.prefill``/``decode_step``): launches per
      prefill and per decode step asserted against the plans (chain_fwd
      216 each); every chain_fwd launch of one prefill and one decode step
      against its twin on the same inputs (1e-2); the prefill's last rows
      and 4 teacher-forced decode steps against ``backend="torch"``, and
      decode steps 15 and 63 against the last row of a prefill of the
      tokens so far (1e-1 of max|ref|: bf16 rounding through 36 random-init
      layers reads 2-3e-2); the same decode check in an f32 copy of the
      model (1e-3); a planted fault that moves each new K/V one slot late
      fails both; the int8 cache (``kv_quant``, f32 copy) against the exact
      one within the reference's envelope (rtol 0.1, atol 0.15), with the
      same argmax on every row, at under 0.55 of the bf16 cache's bytes; prefill ms, decode-step ms, one
      profiled step's device ms, ops and idle share, KV and peak GiB.  (b)
      ``ServeEngine`` (buckets 128/512/1024, 8 slots, groups of 4) on a
      32-request Poisson trace: every request finishes, no plan-memo miss
      after ``prewarm`` and ``compile_shapes``, launches as the plans of the
      calls made predict, each request's prefill row and first token
      against a batch-of-one engine (1e-1); every chain_fwd launch of
      ``compile_shapes`` (each prefill bucket and the 8-slot decode)
      against its twin (1e-2); in an f32 copy, the engine's per-slot
      decode of three requests admitted over stale slots against
      batch-of-one scalar-position decodes (1e-3), which a planted late
      K/V in the per-slot scatter fails; tokens/s, TTFT and TPOT p50/p99,
      decode-step ms, peak GiB.  (c) deepseek-moe-16b, all 28 layers (the
      dense prelude's FFN and the shared experts as Kron FFNs: chain_fwd
      168 per call), 4 x 512 prefill and 16 decode steps: the prefill and
      every decode step against ``backend="torch"`` (1e-1), every chain_fwd
      launch of a prefill and a decode step against its twin (1e-2), decode
      steps 3 and 15 against prefill at capacity E/k (bf16 1e-1; f32 copy
      of the first 4 layers 1e-3); the second run of each pair replays
      the first's router top-6 picks, and the rows whose own picks flipped
      are counted and printed.  (d)
      mamba2-130m, 24 layers, 4 x 1024 prefill and 64 decode steps against
      prefill (bf16 1e-1, f32 copy 1e-3); no Kron kernel on its path (d_ff
      = 0).  An empty guard report after it.
  12. mesh: the distributed Kron-Matmul on one card.  Four processes
      (``torch.multiprocessing``, ``spawn``), each ``torch.cuda.set_device(0)``,
      in a gloo process group (a ``file://`` store in a temporary directory);
      gloo stages the CUDA tensors' collectives through host memory.  First a
      CUDA ``all_to_all_single`` over gloo; then (a) Figure 11 (P=64, N=4,
      K=64^4, f32, M = 4 x 4 ranks) on (1, 4) and (2, 2): FastKron rounds
      serial, at n_slabs 2 and 4, and the per-iteration baseline, forward
      and ``torch.autograd.grad`` into x and the factors, each rank's shards
      against the local KronOp on the card (1e-5, gradients 1e-4), the
      slabbed runs bitwise equal to the serial one; (b) gp16 on (2, 2):
      ``BatchedKronKernel.matmul(v, mesh=)`` at B=4 and one
      ``gp_train_epoch_batched(..., mesh=)`` at B=1 (cut from B=4: its 11
      MVMs each move their rounds through the host), against the calls
      without a mesh (1e-4); (c) qwen3-4b's Kron FFN block, 4096 bf16
      tokens, forward and backward inside ``kron_distributed(mesh)`` against
      the block without it (1e-2 / 2e-2), with the round counters and comm
      gauges moving; (d) the mesh ladder under ``chaos.inject``
      (``collective``: the local rung, bitwise the local op;
      ``slab_collective``: the serial rounds, bitwise; ``round_chain``:
      ``sliced`` launches inside the rounds, one all-to-all per round and
      slab still); (e) ``tune="measure"`` on the mesh at gp16, B=2 (cut
      from 4: four ranks' per-sample backwards do not fit one card): each
      n_slabs candidate's time, the winner, the ``;dev=<card>;gk=2`` key,
      a cache hit on the second construction, and each rank's peak memory
      over the winner's forward and backward.  Every call's launches per
      rank (asserted equal on every rank, and to the rounds' plan) and its
      all-to-all calls and elements per device (against
      ``comm_elems_per_device``).  Times are wall times of the slowest rank:
      four ranks share one card and a host-staged collective, so they are
      not a scaling number.  A rank's failure prints its traceback and
      fails the run.
  13. shard: the model stack sharded over a (data, model) = (2, 2) mesh
      (``runtime/sharding.py``, the SPMD train step), four gloo ranks on the
      card as in phase 12, moving tensors only by direct ``all_reduce`` and
      ``all_gather_into_tensor`` calls, which a probe checks first on CUDA
      tensors, over the world and over each mesh dim's group.  (a) qwen3-4b
      with its Kron FFN, an f32 copy at full width cut to 4 layers: one
      AdamW step and one Shampoo refresh step sharded against the
      single-rank step from the same parameters (loss 1e-5; every gathered
      gradient, as AdamW's first moment holds it, and updated parameter
      1e-4 of max|ref|; every rank's shard shapes those of its
      placements); (b) the same model in bf16, ``SHARD_BF16["layers"]``
      deep: a step's launches per rank against the plans' prediction, then
      a timed step (the slowest rank's wall time) and each rank's peak
      memory; (c) ``launch.train --want-model-parallel 2`` on the same f32
      copy cut to 4 layers, with a checkpoint, then ``--resume``: restored
      shards bitwise equal to the saved ones, each save within one whole
      leaf of the card's memory over the rank's state;
      (d) ``launch.serve --distributed --kron-ffn`` one-shot on an f32 copy
      cut to 4 layers against the local run: greedy tokens equal, prefill
      logits 1e-3, ``prewarm(mesh=)`` builds the mesh ops.  Every
      ``chain_fwd`` and ``grad`` launch (and any ``chain_bwd``, ``sliced``,
      ``sliced_t``) of (a)-(d) is held against its plain twin
      (``held_tolerance``).  Times are gloo host staging, not a scaling
      number.
  14. dryrun: the dry-run tooling (``launch/dryrun.py``: ``specs``,
      ``hlo_cost``) held against the card, each job in a process of its own,
      all at once (a fake world must not meet phase 12/13's gloo worlds).
      (a) qwen3-4b's train_4k, prefill_32k and decode_32k cells and train_4k
      with phase 10's Kron FFN, on fake CUDA tensors in a fake world of 256
      ranks (the (16, 16) mesh): each record's row and JSON; no launch
      counter moves, the card keeps at most 64 MiB more allocated, and the
      Kron cell's counted kernel FLOPs equal its KronOps' planned programs'.
      (b) phase 10's AdamW step (4 x 1024 tokens, 36 layers) on the card
      under ``hlo_cost.CostMode``, through the kernels and through
      ``backend="torch"``, against the same step dry-run in a one-rank
      world: FLOPs and dot FLOPs equal (relative 1e-9), collectives equal
      (none), the twins' dot FLOPs equal the kernels'; the dry-run's peak
      against ``torch.cuda.max_memory_allocated`` of the card's step (0.8 to
      1.25); phase 10's AdamW step ms against the roofline's largest term.
  15. a ``{"kernels": [...]}`` JSON line (launches of phases 3 and 6-13,
      phases 12 and 13 summed over their ranks and also given as
      ``mesh_launches`` and ``shard_launches``), then the card's name and
      power limit.
  16. last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# The card's published peaks (NVIDIA data sheets, SXM parts, dense rates).
# f32 is the CUDA-core rate (the kernels do not use TF32); bf16 is the
# tensor-core rate, the fastest the card could do the same operations.
PEAKS = {
    "H100": {"bw": 3.35e12, torch.float32: 67e12, torch.bfloat16: 989e12},
    "H200": {"bw": 4.8e12, torch.float32: 67e12, torch.bfloat16: 989e12},
}
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}
# Gradients, relative to max|ref|: dx against the same-dtype twins, dF
# against the twins run in f64 (an f32 dF sums up to 3.4e7 terms at fig9).
GRAD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float64: 1e-12}
WARMUP, ITERS = 2, 10

CSRC = "src/repro_torch/kernels/csrc/"
# name -> (source, the TPU kernel it replaces, the main-path case it is timed in)
KERNELS = {
    "chain_fwd": (CSRC + "chain_fwd.cu", "src/repro/kernels/emit.py:575", "fig9"),
    "chain_bwd": (CSRC + "chain_bwd.cu", "src/repro/kernels/emit.py:603", "fig9-dx"),
    "grad": (CSRC + "grad.cu", "src/repro/kernels/emit.py:759", "fig9-grad"),
    "sliced": (CSRC + "sliced.cu", "src/repro/kernels/kron_sliced.py:83", "fig9-unfused"),
    "sliced_t": (CSRC + "sliced_t.cu", "src/repro/kernels/kron_sliced_t.py:78",
                 "fig9-unfused-grad"),
}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return PEAKS["H100"]


def time_ms(fn) -> float:
    """Median CUDA-event time of ``fn`` over ITERS runs after WARMUP."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn) -> float:
    """Device time of one ``fn`` call: the time of every kernel, memset and
    copy it launches, from ``torch.profiler`` over ITERS calls after WARMUP;
    host time between launches is left out."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages())
    return total / ITERS / 1e3


# The port's kernels, by the names torch.profiler gives their launches.
PORT_KERNEL_NAMES = ("chain_fwd_kernel", "chain_bwd_kernel", "grad_kernel", "grad_mma_kernel",
                     "grad_reduce_kernel", "sliced_kernel", "sliced_t_kernel")


def device_split(fn) -> tuple[float, float]:
    """(device ms, ms of the port's kernels) per ``fn`` call, from
    ``torch.profiler`` over ITERS calls after WARMUP: every kernel, memset
    and copy the call launches, and those of PORT_KERNEL_NAMES."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    total = ours = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        total += t
        if any(name in e.key for name in PORT_KERNEL_NAMES):
            ours += t
    return total / ITERS / 1e3, ours / ITERS / 1e3


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def compare(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|); non-finite output fails."""
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values in the kernel's output")
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err, err / scale if scale else err


def flat(grads):
    """(dx, (dF_0, ...)) -> (dx, dF_0, ...)."""
    return (grads[0], *grads[1])


def ptxas_entries(log: str) -> list[dict]:
    """Each kernel entry of a ``ptxas -v`` log: its name, registers and
    spill bytes (stores plus loads)."""
    entries = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entries.append({"entry": m.group(1), "registers": None, "spill_bytes": 0})
            continue
        if not entries:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entries[-1]["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def stage_tiles(m: int, k: int, ps, qs, t_qs, budget: int, kind: str = "fwd"):
    """(t_m, t_k) for a direct chain_cuda / chain_bwd_cuda / grad_cuda call:
    the widest t_k, then the most rows, whose per-row live set (the
    kernel's growth model times t_k) fits the planner's per-block budget."""
    from repro_torch.kernels import emit

    pprod = math.prod(ps)

    def per_row(t_k):
        if kind == "grad":
            return emit.grad_live_elems(t_k, ps, qs)
        growth = emit.fused_growth if kind == "fwd" else emit.transposed_growth
        return t_k * growth(ps, qs, t_qs)

    per = k // pprod
    d = max(d for d in range(1, per + 1) if per % d == 0 and per_row(pprod * d) <= budget)
    t_k = pprod * d
    t_m = max(t for t in range(1, m + 1) if m % t == 0 and t * per_row(t_k) <= budget)
    return t_m, t_k


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain twin
# ---------------------------------------------------------------------------

# (name, application-order ps, qs, rows, slices, dtype, t_qs, batch)
CHAIN_CASES = [
    ("fused (32,32)", (32, 32), (32, 32), 64, 64, torch.float32, None, 1),
    ("fused (16,16)", (16, 16), (16, 16), 64, 256, torch.float32, None, 1),
    ("fused (8,8,8)", (8, 8, 8), (8, 8, 8), 64, 128, torch.float32, None, 1),
    ("fused (32,32) bf16", (32, 32), (32, 32), 64, 64, torch.bfloat16, None, 1),
    ("mixed (8,16,32)", (32, 16, 8), (32, 16, 8), 16, 8, torch.float32, None, 1),
    ("P!=Q (64,40)->(128,76)", (40, 64), (76, 128), 64, 4, torch.float32, None, 1),
    ("P!=Q (64,40)->(128,76) bf16", (40, 64), (76, 128), 64, 4, torch.bfloat16, None, 1),
    ("odd (52,65)x(50,20) M=10", (65, 52), (20, 50), 10, 3, torch.float32, None, 1),
    ("t_qs (16,16)->(64,64) @ (16,32)", (16, 16), (64, 64), 32, 16, torch.float32, (16, 32), 1),
    ("B=3 per-sample (8,8)", (8, 8), (8, 8), 16, 32, torch.float32, None, 3),
    ("f64 (16,8)", (16, 8), (16, 8), 8, 16, torch.float64, None, 1),
    # The persistent walk's branches: blocks that walk many tiles each;
    # walks that cross samples (B=3) or Q-tile digits, so the panels change
    # inside a block's walk; bf16 rows and dY runs too short for 16-byte
    # copies (element by element).
    ("fused (32,32) many tiles per block", (32, 32), (32, 32), 1024, 16, torch.float32, None, 1),
    ("B=3 per-sample (16,16) crossing samples", (16, 16), (16, 16), 64, 64, torch.float32,
     None, 3),
    ("t_qs (16,16)->(64,64) @ (16,32) crossing digits", (16, 16), (64, 64), 64, 16,
     torch.float32, (16, 32), 1),
    ("bf16 odd runs (5,7)->(3,2)", (7, 5), (2, 3), 16, 3, torch.bfloat16, None, 1),
]
# (name, M, P, Q, S, dtype, element offset of x's base).  Beside the plain
# cases, the sliced kernel's own branches: blocks that walk many tiles each;
# a Q-tiled panel (256 x 256) whose walk crosses Q-tiles; bf16 on the tensor
# cores ("mma") with P and Q not multiples of 16; a bf16 factor too large for
# them; odd S (bf16 runs too short for 4-byte copies and stores); an x base
# that is not 16-byte aligned.  Each sliced launch runs twice, asserted
# bitwise equal.
SLICED_CASES = [
    ("f32 32x32", 64, 32, 32, 2048, torch.float32, 0),
    ("mma bf16 64x128", 64, 64, 128, 76, torch.bfloat16, 0),
    ("f64 40x76", 32, 40, 76, 64, torch.float64, 0),
    ("f32 odd 65x20 M=10", 10, 65, 20, 52, torch.float32, 0),
    ("f32 32x32 many tiles per block", 2048, 32, 32, 256, torch.float32, 0),
    ("f32 Q-tiled 256x256 crossing Q-tiles", 64, 256, 256, 64, torch.float32, 0),
    ("mma bf16 40->76", 64, 40, 76, 64, torch.bfloat16, 0),
    ("mma bf16 65->20", 10, 65, 20, 52, torch.bfloat16, 0),
    ("bf16 256x256 on the CUDA cores", 16, 256, 256, 16, torch.bfloat16, 0),
    ("mma bf16 odd S 40->76", 6, 40, 76, 39, torch.bfloat16, 0),
    ("mma bf16 odd S odd P 65->20", 6, 65, 20, 39, torch.bfloat16, 0),
    ("f32 x at an element offset", 16, 32, 32, 128, torch.float32, 1),
    ("mma bf16 x at an element offset", 16, 40, 76, 64, torch.bfloat16, 1),
]
# ops.sliced_multiply(_t)'s tiles= limit, (name, M, P, Q, S, dtype, tiles):
# a Q-tile limit below Q keeps a bf16 factor that fits the tensor cores on
# the CUDA cores; an f32 limit below the free choice on every axis.
SLICED_LIMIT_CASES = [
    ("bf16 40->76 tiles=(4,16,38) on the CUDA cores", 64, 40, 76, 64, torch.bfloat16,
     (4, 16, 38)),
    ("f32 32x32 tiles=(2,32,16)", 64, 32, 32, 256, torch.float32, (2, 32, 16)),
]
# The transposed sliced multiply's own branches: Q tiled (a 256 x 256 panel
# does not stay whole), slices not a multiple of 4, bf16 runs too short for
# asynchronous copies (odd S: element-wise loads).
SLICED_T_CASES = [
    ("f32 Q-tiled 256x256", 16, 256, 256, 64, torch.float32),
    ("f32 t_s=39", 6, 32, 32, 39, torch.float32),
    ("bf16 odd S 40x76", 6, 40, 76, 39, torch.bfloat16),
]
# The stage backward's own branches, (name, application-order ps, qs, rows,
# slices, dtype, batch, t_m, t_k): bf16 single-factor stages on the tensor
# cores with P and Q not multiples of 16 (padding masked), odd slices and
# B=2, warps sharing an output tile; a bf16 factor too large for the tensor
# core path and f32 single-factor stages on the CUDA cores; a grid whose
# blocks walk many tiles each (the small cases give samples fewer tiles
# than blocks); a mixed chain.
GRAD_CASES = [
    ("mma bf16 40->76", (40,), (76,), 64, 64, torch.bfloat16, 1, 2, 1280),
    ("mma bf16 64->128", (64,), (128,), 64, 38, torch.bfloat16, 1, 2, 1216),
    ("mma bf16 65->20", (65,), (20,), 6, 52, torch.bfloat16, 1, 2, 3380),
    ("mma bf16 odd s 40->76 B=2", (40,), (76,), 3, 7, torch.bfloat16, 2, 3, 280),
    ("f32 65->20", (65,), (20,), 4, 13, torch.float32, 1, 2, None),
    ("f32 (32,32) many tiles per block", (32, 32), (32, 32), 64, 64, torch.float32, 1, 1, 8192),
    ("f32 mixed (32,16,8)", (32, 16, 8), (32, 16, 8), 2, 2, torch.float32, 1, 1, None),
    ("mma bf16 16->16 warps share tiles", (16,), (16,), 8, 64, torch.bfloat16, 1, 2, None),
    ("bf16 128->128 on the CUDA cores", (128,), (128,), 4, 16, torch.bfloat16, 1, 1, None),
]


def check_kernels(gen) -> dict:
    from repro_torch.core import KronOp, kron_matrix
    from repro_torch.kernels import emit, kron_sliced, kron_sliced_t, ops

    passed = {name: 0 for name in KERNELS}
    failures = []
    budget = emit.SMEM_BUDGET_ELEMS

    def record(kernel, name, got, ref, tol):
        err, rel = compare(got, ref)
        ok = rel <= tol
        print(
            f"check {kernel} {name}: max_abs_err={err:.3e} rel={rel:.3e} "
            f"tol={tol:g} {'ok' if ok else 'FAIL'}", flush=True,
        )
        if ok:
            passed[kernel] += 1
        else:
            failures.append(f"{kernel} {name}")

    def repeat(kernel, name, first, second):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            print(f"check {kernel} {name}: a second run differs FAIL", flush=True)
            failures.append(f"{kernel} {name} repeat")

    for name, ps, qs, m, s, dtype, t_qs, b in CHAIN_CASES:
        k = math.prod(ps) * s
        x = randn(gen, (b, m, k), dtype)
        fs = [randn(gen, (b, p, q), dtype) for p, q in zip(ps, qs)]
        t_m, t_k = stage_tiles(m, k, ps, qs, t_qs or qs, budget)
        got = emit.chain_cuda(x, *fs, t_b=1, t_m=t_m, t_k=t_k, t_qs=t_qs)
        ref = emit.chain_reference(x, *fs)
        torch.cuda.synchronize()
        record("chain_fwd", f"{name} tiles=({t_m},{t_k})", got, ref, TOLERANCE[dtype])

        dy = randn(gen, (b, m, math.prod(qs) * s), dtype)
        t_m, t_k = stage_tiles(m, k, ps, qs, t_qs or qs, budget, kind="bwd")
        got = emit.chain_bwd_cuda(dy, *fs, t_b=1, t_m=t_m, t_k=t_k, t_qs=t_qs)
        ref = emit.chain_bwd_reference(dy, *fs)
        torch.cuda.synchronize()
        record("chain_bwd", f"{name} tiles=({t_m},{t_k})", got, ref, TOLERANCE[dtype])
        repeat("chain_bwd", name, (got,),
               (emit.chain_bwd_cuda(dy, *fs, t_b=1, t_m=t_m, t_k=t_k, t_qs=t_qs),))

        # The stage backward takes Q whole.
        t_m, t_k = stage_tiles(m, k, ps, qs, qs, budget, kind="grad")
        dx, dfs = emit.grad_cuda(x, dy, *fs, t_b=1, t_m=t_m, t_k=t_k)
        rdx, _ = emit.grad_reference(x, dy, *fs)
        _, rdfs = emit.grad_reference(x.double(), dy.double(), *(f.double() for f in fs))
        torch.cuda.synchronize()
        record("grad", f"{name} dx tiles=({t_m},{t_k})", dx, rdx, TOLERANCE[dtype])
        for i, (d, r) in enumerate(zip(dfs, rdfs)):
            record("grad", f"{name} dF{i} (vs f64)", d, r, GRAD_TOLERANCE[dtype])
        repeat("grad", name, (dx, *dfs), flat(emit.grad_cuda(x, dy, *fs, t_b=1, t_m=t_m, t_k=t_k)))

    for name, ps, qs, m, s, dtype, b, t_m, t_k in GRAD_CASES:
        k = math.prod(ps) * s
        x = randn(gen, (b, m, k), dtype)
        dy = randn(gen, (b, m, math.prod(qs) * s), dtype)
        fs = [randn(gen, (b, p, q), dtype) for p, q in zip(ps, qs)]
        dx, dfs = emit.grad_cuda(x, dy, *fs, t_m=t_m, t_k=t_k)
        rdx, _ = emit.grad_reference(x, dy, *fs)
        _, rdfs = emit.grad_reference(x.double(), dy.double(), *(f.double() for f in fs))
        torch.cuda.synchronize()
        record("grad", f"{name} dx", dx, rdx, TOLERANCE[dtype])
        for i, (d, r) in enumerate(zip(dfs, rdfs)):
            record("grad", f"{name} dF{i} (vs f64)", d, r, GRAD_TOLERANCE[dtype])
        repeat("grad", name, (dx, *dfs), flat(emit.grad_cuda(x, dy, *fs, t_m=t_m, t_k=t_k)))

    for name, m, p, q, s, dtype, offset in SLICED_CASES:
        # A contiguous view at `offset` elements into its buffer.
        x = randn(gen, (m * s * p + offset,), dtype)[offset:].view(m, s * p)
        f = randn(gen, (p, q), dtype)
        acc_bytes = emit.acc_dtype_for(dtype).itemsize
        got = kron_sliced.sliced_multiply_cuda(x, f)
        ref = kron_sliced.sliced_multiply_reference(x, f)
        torch.cuda.synchronize()
        tiles = kron_sliced.sliced_tiles(m, s, p, q, acc_bytes, in_bytes=x.element_size())
        record("sliced", f"{name} tiles={tiles}", got, ref, TOLERANCE[dtype])
        repeat("sliced", name, (got,), (kron_sliced.sliced_multiply_cuda(x, f),))
        dy = randn(gen, (m, q * s), dtype)
        got = kron_sliced_t.sliced_multiply_t_cuda(dy, f)
        ref = kron_sliced_t.sliced_multiply_t_reference(dy, f)
        torch.cuda.synchronize()
        tiles = kron_sliced.sliced_tiles(
            m, s, p, q, acc_bytes, kind="sliced_t", in_bytes=dy.element_size())
        record("sliced_t", f"{name} tiles={tiles}", got, ref, TOLERANCE[dtype])

    for name, m, p, q, s, dtype in SLICED_T_CASES:
        dy = randn(gen, (m, q * s), dtype)
        f = randn(gen, (p, q), dtype)
        got = kron_sliced_t.sliced_multiply_t_cuda(dy, f)
        ref = kron_sliced_t.sliced_multiply_t_reference(dy, f)
        torch.cuda.synchronize()
        tiles = kron_sliced.sliced_tiles(
            m, s, p, q, emit.acc_dtype_for(dtype).itemsize, kind="sliced_t",
            in_bytes=dy.element_size())
        record("sliced_t", f"{name} tiles={tiles}", got, ref, TOLERANCE[dtype])

    for name, m, p, q, s, dtype, tiles in SLICED_LIMIT_CASES:
        x = randn(gen, (m, s * p), dtype)
        f = randn(gen, (p, q), dtype)
        dy = randn(gen, (m, q * s), dtype)
        acc_bytes = emit.acc_dtype_for(dtype).itemsize
        for kernel, kind, call, ref in (
            ("sliced", "fwd", lambda: ops.sliced_multiply(x, f, tiles=tiles),
             lambda: kron_sliced.sliced_multiply_reference(x, f)),
            ("sliced_t", "sliced_t", lambda: ops.sliced_multiply_t(dy, f, tiles=tiles),
             lambda: kron_sliced_t.sliced_multiply_t_reference(dy, f)),
        ):
            got = call()
            torch.cuda.synchronize()
            used = kron_sliced.sliced_tiles(m, s, p, q, acc_bytes, kind=kind,
                                            in_bytes=x.element_size(), limit=tiles)
            mma = kernel == "sliced" and kron_sliced.sliced_mma(p, q, used[2], x.element_size())
            record(kernel, f"{name} tiles={used} mma={mma}", got, ref(), TOLERANCE[dtype])

    # One small KronOp against the dense oracle x @ (F^1 (x) ... (x) F^N):
    # its value, and its x and factor gradients against torch.autograd.
    ps, qs = (4, 8, 4), (8, 4, 8)
    x = randn(gen, (16, math.prod(ps)), torch.float32).requires_grad_()
    fs = [randn(gen, (p, q), torch.float32).requires_grad_() for p, q in zip(ps, qs)]
    op = KronOp(ps, qs)
    y = op(x, fs)
    want = x @ kron_matrix(fs)
    record("chain_fwd", "KronOp vs x @ kron_matrix", y.detach(), want.detach(),
           TOLERANCE[torch.float32])
    ct = randn(gen, tuple(y.shape), torch.float32)
    got = torch.autograd.grad(y, [x, *fs], ct)
    ref = torch.autograd.grad(want, [x, *fs], ct)
    for i, (a, r) in enumerate(zip(got, ref)):
        record("grad", "KronOp " + ("dx" if i == 0 else f"dF{i - 1}") + " vs autograd",
               a, r, GRAD_TOLERANCE[torch.float32])

    if failures:
        raise AssertionError(f"kernels disagree with their plain twins: {failures}")
    return passed


# ---------------------------------------------------------------------------
# Phase 3: the main path at full size
# ---------------------------------------------------------------------------

def _counter_sites():
    """(counter name, module, attribute) of every launch counter."""
    from repro_torch.core import engine
    from repro_torch.kernels import emit, kron_sliced, kron_sliced_t

    return (
        ("chain_fwd", emit, "chain_launches"),
        ("chain_bwd", emit, "chain_bwd_launches"),
        ("grad", emit, "grad_launches"),
        ("grad_reduce", emit, "grad_reduce_launches"),
        ("sliced", kron_sliced, "sliced_launches"),
        ("sliced_t", kron_sliced_t, "sliced_t_launches"),
        ("bwd_per_factor_fallbacks", engine, "bwd_per_factor_fallbacks"),
    )


def reset_counters() -> None:
    for _, mod, attr in _counter_sites():
        setattr(mod, attr, 0)


def read_counters() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in _counter_sites()}


def expect(**counts) -> dict:
    """The full counter dict: the given counts, every other counter 0."""
    return {name: counts.get(name, 0) for name, _, _ in _counter_sites()}


def assert_clean(phase: str) -> None:
    """No call of the phase left the kernels: the guard records no rung
    fallback and no ``bwd_per_factor`` event (the launch counters hold the
    per-factor fallbacks at 0 case by case)."""
    from repro_torch.core import engine
    from repro_torch.runtime import guard

    report = guard.health_report()
    bad = {k: h for k, h in report["ops"].items() if h["degraded_calls"] or h["errors"]}
    events = {k: n for k, n in report["events"].items() if k.startswith("bwd_per_factor")}
    if bad or events or engine.bwd_per_factor_fallbacks:
        raise AssertionError(
            f"{phase}: fallbacks {bad}, events {events}, "
            f"bwd_per_factor_fallbacks {engine.bwd_per_factor_fallbacks}")
    print(f"{phase}: no rung fallback, no bwd_per_factor event", flush=True)


# (name, M, ps, qs, dtype, plan) -- plan "auto" or None (unfused baseline)
MAIN_CASES = [
    # Paper Figure 9 shape (benchmarks/fig9.py): x and y are 4 GiB each.
    ("fig9", 1024, (32,) * 4, (32,) * 4, torch.float32, "auto"),
    # Paper Table 4 row 26, GP (benchmarks/fig10.py): x and y 1 GiB each.
    ("gp16", 16, (16,) * 6, (16,) * 6, torch.float32, "auto"),
    # qwen3-4b kron_ffn up projection, d_model 2560 -> d_ff 9728 with
    # balanced_factorization: 4096 token rows in bf16.
    ("ffn", 4096, (64, 40), (128, 76), torch.bfloat16, "auto"),
    # Paper Table 4 row 6 (compression).
    ("compress", 10, (52, 65), (50, 20), torch.float32, "auto"),
    # Figure 9 through the paper-faithful unfused loop: 4 sliced launches.
    ("fig9-unfused", 1024, (32,) * 4, (32,) * 4, torch.float32, None),
]


def plain_twin(op, x, fs):
    """The op's forward through the kernels' plain twins on the card; x
    ``(B, M, K)`` with per-sample factors runs the batched twins."""
    from repro_torch.core.engine import _lowered
    from repro_torch.kernels import emit, kron_sliced

    if op.plan is None:
        y = x
        for f in reversed(fs):
            y = kron_sliced.sliced_multiply_reference(y, f)
        return y
    batched = fs[0].ndim == 3
    rev = tuple(reversed(fs))
    y = x if batched else x[None]
    for ins in _lowered(op.plan, op.ps, op.qs, batched).instrs:
        sf = tuple(rev[i] if batched else rev[i][None] for i in ins.factor_ids)
        if ins.kind == emit.PREKRON:
            sf = (emit.prekron_product(sf),)
        y = emit.chain_reference(y, *sf, acc_dtype=ins.acc_dtype)
    return y if batched else y[0]


def einsum_call(x, fs):
    """One torch.einsum computing x @ (F^1 (x) ... (x) F^N); per sample
    for x ``(B, M, K)`` and ``(B, P_i, Q_i)`` factors."""
    n = len(fs)
    letters = "abcdefghijklmnop"
    ins, outs = letters[:n], letters[n:2 * n]
    lead = "yz" if fs[0].ndim == 3 else "z"
    fb = lead[:-1]
    spec = (lead + ins + "," + ",".join(fb + i + o for i, o in zip(ins, outs))
            + "->" + lead + outs)
    xv = x.reshape(*x.shape[:-1], *(int(f.shape[-2]) for f in fs))
    return torch.einsum(spec, xv, *fs).reshape(*x.shape[:-1], -1)


def run_main(gen, peaks) -> list[dict]:
    from repro_torch.core import KronOp, KronProblem, kron_matmul_shuffle
    from repro_torch.core.engine import _lowered

    rows = []
    for name, m, ps, qs, dtype, plan in MAIN_CASES:
        k = math.prod(ps)
        x = randn(gen, (m, k), dtype)
        fs = [randn(gen, (p, q), dtype) for p, q in zip(ps, qs)]
        op = KronOp(ps, qs, plan=plan)
        # The main path's run: counts set to 0 just before, read just after.
        reset_counters()
        y = op(x, fs)
        torch.cuda.synchronize()
        launches = read_counters()
        plan_used = op.plan
        if plan_used is None:
            n_stages = len(ps)
            want = expect(sliced=n_stages)
        else:
            n_stages = len(_lowered(plan_used, op.ps, op.qs).instrs)
            want = expect(chain_fwd=n_stages)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        if tuple(y.shape) != op.out_shape(x.shape):
            raise AssertionError(f"{name}: output shape {tuple(y.shape)}")
        ref = plain_twin(op, x, fs)
        torch.cuda.synchronize()
        err, rel = compare(y, ref)
        tol = TOLERANCE[dtype]
        del y, ref
        torch.cuda.empty_cache()
        ms = time_ms(lambda: op(x, fs))
        plain_ms = time_ms(lambda: plain_twin(op, x, fs))
        shuffle_ms = time_ms(lambda: kron_matmul_shuffle(x, fs))
        library_ms = time_ms(lambda: einsum_call(x, fs))
        nbytes = (m * k + m * op.k_out + sum(p * q for p, q in zip(ps, qs))) * x.element_size()
        flops = KronProblem(m, ps, qs).flops
        t_bytes = nbytes / peaks["bw"] * 1e3
        t_ops = flops / peaks[dtype] * 1e3
        row = {
            "case": name, "describe": op.describe(), "dtype": str(dtype).replace("torch.", ""),
            "m": m, "ps": list(ps), "qs": list(qs), "stages": n_stages,
            "launches": launches, "max_abs_err": err, "rel_err": rel, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "shuffle_ms": shuffle_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
        }
        print("main " + json.dumps(row), flush=True)
        if rel > tol:
            raise AssertionError(f"{name}: rel err {rel:.3e} > {tol:g}")
        rows.append(row)
        del x, fs, op
        torch.cuda.empty_cache()
    return rows


# (name, M, ps, qs, dtype, plan, factor grads) -- every backward runs with a
# runtime cotangent: a .sum() loss would make the x-gradient constant.
BWD_CASES = [
    ("fig9-grad", 1024, (32,) * 4, (32,) * 4, torch.float32, "auto", True),
    ("fig9-dx", 1024, (32,) * 4, (32,) * 4, torch.float32, "auto", False),
    ("gp16-grad", 16, (16,) * 6, (16,) * 6, torch.float32, "auto", True),
    # The qwen3-4b kron_ffn up projection, as in the forward's ffn case.
    ("ffn-grad", 4096, (64, 40), (128, 76), torch.bfloat16, "auto", True),
    ("fig9-unfused-grad", 1024, (32,) * 4, (32,) * 4, torch.float32, None, True),
]


def plain_bwd(op, x, fs, g, factors: bool):
    """The op's backward through the kernels' plain twins on the card, in
    the tensors' dtype: (dx, [dF^1 .. dF^N] in the accumulator dtype, or
    None).  The same program as ``engine._program_bwd`` / ``_per_factor_bwd``."""
    from repro_torch.core.engine import _lowered
    from repro_torch.kernels import emit, kron_sliced, kron_sliced_t

    rev = tuple(reversed(fs))
    n = len(fs)
    if op.plan is None:
        inputs = [x]
        if factors:
            for f in rev[:-1]:
                inputs.append(kron_sliced.sliced_multiply_reference(inputs[-1], f))
        dfs = []
        for i in reversed(range(n)):
            if factors:
                dfs.append(emit.sliced_vjp_factor(inputs[i], g, *rev[i].shape))
            g = kron_sliced_t.sliced_multiply_t_reference(g, rev[i])
        return g, (dfs if factors else None)
    prog = _lowered(op.plan, op.ps, op.qs)
    if any(ins.kind == emit.PREKRON for ins in prog.instrs):
        raise AssertionError("the smoke's cases plan no prekron stage")
    sfs = [tuple(rev[i][None] for i in ins.factor_ids) for ins in prog.instrs]
    inputs = [x]
    if factors:
        for ins, sf in zip(prog.instrs[:-1], sfs):
            inputs.append(emit.chain_reference(inputs[-1][None], *sf, acc_dtype=ins.acc_dtype)[0])
    by_id = {}
    for idx in reversed(range(len(prog.instrs))):
        ins, sf = prog.instrs[idx], sfs[idx]
        if factors:
            g3, dfs = emit.grad_reference(inputs[idx][None], g[None], *sf, acc_dtype=ins.acc_dtype)
            by_id.update({fid: d[0] for fid, d in zip(ins.factor_ids, dfs)})
        else:
            g3 = emit.chain_bwd_reference(g[None], *sf, acc_dtype=ins.acc_dtype)
        g = g3[0]
    return g, ([by_id[n - 1 - j] for j in range(n)] if factors else None)


def plain_dfs_f64(op, x, fs, g) -> list:
    """The factor gradients through the plain twins in f64, summed over row
    chunks of at most 2^26 elements of x (every row's chain is independent;
    dF is a sum over rows)."""
    m, k = x.shape
    rows = max(d for d in range(1, m + 1) if m % d == 0 and d * k <= max(k, 2 ** 26))
    fs64 = [f.double() for f in fs]
    total = None
    for r0 in range(0, m, rows):
        _, dfs = plain_bwd(op, x[r0:r0 + rows].double(), fs64, g[r0:r0 + rows].double(), True)
        total = dfs if total is None else [a + b for a, b in zip(total, dfs)]
    return total


def hold_backward(op, x, fs, grads, ct, batched: bool):
    """(max abs err, [dx rel err], [dF rel errs]) of ``grads`` (dx, dF...)
    against the plain twins: dx in the same dtype, every dF in f64; per
    sample for a per-sample op."""
    samples = range(x.shape[0]) if batched else [None]
    errs, dx_rels, df_rels = [], [], []
    with torch.no_grad():
        for i in samples:
            pick = (lambda t: t) if i is None else (lambda t, i=i: t[i])
            xi, gi = pick(x), pick(ct)
            fi = [pick(f) for f in fs]
            rdx, _ = plain_bwd(op, xi, fi, gi, False)
            err, rel = compare(pick(grads[0]), rdx)
            del rdx
            errs.append(err)
            dx_rels.append(rel)
            for d, r in zip(grads[1:], plain_dfs_f64(op, xi, fi, gi)):
                err, rel = compare(pick(d), r)
                errs.append(err)
                df_rels.append(rel)
    return max(errs), dx_rels, df_rels


def run_backward(gen, peaks) -> list[dict]:
    from repro_torch.core import KronOp, KronProblem
    from repro_torch.core.engine import _lowered

    rows = []
    for name, m, ps, qs, dtype, plan, factors in BWD_CASES:
        torch.cuda.reset_peak_memory_stats()
        k = math.prod(ps)
        x = randn(gen, (m, k), dtype).requires_grad_()
        fs = [randn(gen, (p, q), dtype).requires_grad_(factors) for p, q in zip(ps, qs)]
        ct = randn(gen, (m, math.prod(qs)), dtype)
        op = KronOp(ps, qs, plan=plan)
        y = op(x, fs)
        wrt = [x, *fs] if factors else [x]

        def backward():
            return torch.autograd.grad(y, wrt, ct, retain_graph=True)

        # The main path's run: counts set to 0 just before, read just after.
        reset_counters()
        grads = backward()
        torch.cuda.synchronize()
        launches = read_counters()
        kernel_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        n = len(ps)
        if op.plan is None:
            n_stages = n
            want = expect(sliced=n - 1, sliced_t=n) if factors else expect(sliced_t=n)
        else:
            n_stages = len(_lowered(op.plan, op.ps, op.qs).instrs)
            want = (expect(chain_fwd=n_stages - 1, grad=n_stages, grad_reduce=n_stages)
                    if factors else expect(chain_bwd=n_stages))
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        again = backward()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
        del again
        if not bitwise:
            raise AssertionError(f"{name}: two backward runs differ")

        xd, fd = x.detach(), [f.detach() for f in fs]
        with torch.no_grad():
            rdx, _ = plain_bwd(op, xd, fd, ct, False)
            dx_err, dx_rel = compare(grads[0], rdx)
            del rdx
            errs, rels = [dx_err], [dx_rel]
            if factors:
                for d, r in zip(grads[1:], plain_dfs_f64(op, xd, fd, ct)):
                    err, rel = compare(d, r)
                    errs.append(err)
                    rels.append(rel)
        del grads
        torch.cuda.empty_cache()
        tol = GRAD_TOLERANCE[dtype]
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        ms = time_ms(backward)
        with torch.no_grad():
            plain_ms = time_ms(lambda: plain_bwd(op, xd, fd, ct, factors))
        y_lib = einsum_call(x, fs)
        library_ms = time_ms(
            lambda: torch.autograd.grad(y_lib, wrt, ct, retain_graph=True))
        del y_lib
        torch.cuda.empty_cache()

        # Each operand the function needs moved once: dY, dX, the factors,
        # and with factor grads x and the dFs; FLOPs 1x the forward's for dX,
        # 2x with the factor grads.
        size = x.element_size()
        fsize = sum(p * q for p, q in zip(ps, qs))
        nbytes = (m * op.k_out + m * k + fsize + (m * k + fsize if factors else 0)) * size
        flops = (2 if factors else 1) * KronProblem(m, ps, qs).flops
        t_bytes = nbytes / peaks["bw"] * 1e3
        t_ops = flops / peaks[dtype] * 1e3
        row = {
            "case": name, "describe": op.describe(), "dtype": str(dtype).replace("torch.", ""),
            "m": m, "ps": list(ps), "qs": list(qs), "stages": n_stages,
            "grads": "x and factors" if factors else "x", "launches": launches,
            "max_abs_err": max(errs), "dx_rel_err": rels[0], "df_rel_err": max(rels[1:], default=0.0),
            "tol": tol, "bitwise_repeat": bitwise, "peak_mem_gib": peak_gib,
            "kernel_peak_mem_gib": kernel_peak_gib,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes,
        }
        print("main " + json.dumps(row), flush=True)
        if max(rels) > tol:
            raise AssertionError(f"{name}: rel err {max(rels):.3e} > {tol:g}")
        rows.append(row)
        del x, fs, ct, y, op, xd, fd
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 3, continued: the per-sample batched path and torch.func.vmap
# ---------------------------------------------------------------------------

# (name, B, M, ps, qs): per-sample factors, f32, at the sources' full widths.
BATCHED_CASES = [
    # BatchedKronKernel.op's MVM (GP hyperparameter learning) over B=4
    # independent GP tasks at gp16's shape (paper Table 4 row 26): x is
    # (4, 16, 16^6), 4.3 GB in and 4.3 GB out.
    ("gp16-batched", 4, 16, (16,) * 6, (16,) * 6),
    # Shampoo's precondition (kron_precond_op) for the factor parameters of
    # qwen3-4b's kron_ffn up projection, (64, 128) and (40, 76), stacked over
    # its 36 layers: x (36, 1, p*q), factors (36, p, p) and (36, q, q).
    ("precond-64x128", 36, 1, (64, 128), (64, 128)),
    ("precond-40x76", 36, 1, (40, 76), (40, 76)),
]
# The backward of gp16-batched: x and factor gradients.
BATCHED_GRAD_CASE = ("gp16-batched-grad", 4, 16, (16,) * 6, (16,) * 6)
# (B, M, ps, qs) of the vmap cases: over x and factors at gp16-batched's
# shape; over x alone at fig9's shape, B=2 folded into 2048 rows.
VMAP_CASES = {
    "gp16-vmap": (4, 16, (16,) * 6, (16,) * 6),
    "fig9-vmap-x": (2, 1024, (32,) * 4, (32,) * 4),
}


def n_stages(op, batched: bool) -> int:
    from repro_torch.core.engine import _lowered

    return len(_lowered(op.plan, op.ps, op.qs, batched).instrs)


def timed_row(name, describe, call, plain, library, want, check, nbytes, flops, dtype,
              peaks) -> dict:
    """One forward row: ``call`` once between counter resets (launches
    against ``want()``, ``check(y)`` for shapes and bitwise comparisons, its
    extra columns; ``describe()`` the plan it ran), the error against
    ``plain()`` (in y's shape), then CUDA-event times of the call, the plain
    twins and the one-call yardstick ``library``."""
    reset_counters()
    y = call()
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != want():
        raise AssertionError(f"{name}: launches {launches}, expected {want()}")
    extra = check(y)
    ref = plain()
    torch.cuda.synchronize()
    err, rel = compare(y, ref)
    del y, ref
    torch.cuda.empty_cache()
    tol = TOLERANCE[dtype]
    ms = time_ms(call)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    torch.cuda.empty_cache()
    b_ms, b_by = bound(nbytes, flops, peaks, dtype)
    row = {
        "case": name, "describe": describe(), "dtype": str(dtype).replace("torch.", ""),
        "launches": launches, "max_abs_err": err, "rel_err": rel, "tol": tol, **extra,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
        "bound_by": b_by, "flops": flops, "bytes": nbytes,
    }
    print("main " + json.dumps(row), flush=True)
    if rel > tol:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {tol:g}")
    return row


def run_batched(gen, peaks) -> list[dict]:
    """The per-sample batched forward: ``KronOp(ps, qs, batch=B,
    shared_factors=False)`` and ``kron_precond_op``."""
    from repro_torch.core import KronOp, KronProblem
    from repro_torch.core.engine import kron_precond_op

    rows = []
    for name, b, m, ps, qs in BATCHED_CASES:
        dtype = torch.float32
        x = randn(gen, (b, m, math.prod(ps)), dtype)
        fs = [randn(gen, (b, p, q), dtype) for p, q in zip(ps, qs)]
        if name.startswith("precond"):
            op = kron_precond_op(ps[0], ps[1], b)
        else:
            op = KronOp(ps, qs, batch=b, shared_factors=False)

        def check(y, op=op, x=x):
            if tuple(y.shape) != op.out_shape(x.shape):
                raise AssertionError(f"{name}: output shape {tuple(y.shape)}")
            return {"b": b, "m": m, "ps": list(ps), "qs": list(qs), "t_b": op.plan.t_b}

        fsize = b * sum(p * q for p, q in zip(ps, qs))
        rows.append(timed_row(
            name, op.describe, lambda op=op, x=x, fs=fs: op(x, fs),
            lambda op=op, x=x, fs=fs: plain_twin(op, x, fs),
            lambda x=x, fs=fs: einsum_call(x, fs),
            lambda op=op: expect(chain_fwd=n_stages(op, True)), check,
            (b * m * (math.prod(ps) + math.prod(qs)) + fsize) * 4,
            b * KronProblem(m, ps, qs).flops, dtype, peaks,
        ))
        del x, fs, op
        torch.cuda.empty_cache()
    return rows


def run_batched_backward(gen, peaks) -> list[dict]:
    """gp16-batched-grad: ``torch.autograd.grad`` through the per-sample
    call, x and factor gradients, with a runtime cotangent."""
    from repro_torch.core import KronOp, KronProblem

    name, b, m, ps, qs = BATCHED_GRAD_CASE
    dtype = torch.float32
    torch.cuda.reset_peak_memory_stats()
    k, k_out = math.prod(ps), math.prod(qs)
    x = randn(gen, (b, m, k), dtype).requires_grad_()
    fs = [randn(gen, (b, p, q), dtype).requires_grad_() for p, q in zip(ps, qs)]
    ct = randn(gen, (b, m, k_out), dtype)
    op = KronOp(ps, qs, batch=b, shared_factors=False)
    y = op(x, fs)
    wrt = [x, *fs]

    def backward():
        return torch.autograd.grad(y, wrt, ct, retain_graph=True)

    # The main path's run: counts set to 0 just before, read just after.
    reset_counters()
    grads = backward()
    torch.cuda.synchronize()
    launches = read_counters()
    kernel_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n = n_stages(op, True)
    want = expect(chain_fwd=n - 1, grad=n, grad_reduce=n)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    again = backward()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, c) for a, c in zip(grads, again))
    del again
    if not bitwise:
        raise AssertionError(f"{name}: two backward runs differ")
    xd, fd = x.detach(), [f.detach() for f in fs]
    max_err, dx_rels, df_rels = hold_backward(op, xd, fd, grads, ct, True)
    del grads
    torch.cuda.empty_cache()
    tol = GRAD_TOLERANCE[dtype]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = time_ms(backward)
    with torch.no_grad():
        plain_ms = time_ms(lambda: [plain_bwd(op, xd[i], [f[i] for f in fd], ct[i], True)
                                    for i in range(b)])
    y_lib = einsum_call(x, fs)
    library_ms = time_ms(lambda: torch.autograd.grad(y_lib, wrt, ct, retain_graph=True))
    del y_lib
    torch.cuda.empty_cache()
    fsize = b * sum(p * q for p, q in zip(ps, qs))
    nbytes = (b * m * k_out + 2 * b * m * k + 2 * fsize) * 4
    flops = 2 * b * KronProblem(m, ps, qs).flops
    b_ms, b_by = bound(nbytes, flops, peaks, dtype)
    row = {
        "case": name, "describe": op.describe(), "dtype": "float32", "b": b, "m": m,
        "ps": list(ps), "qs": list(qs), "stages": n, "t_b": op.plan.t_b,
        "grads": "x and factors", "launches": launches, "max_abs_err": max_err,
        "dx_rel_err": max(dx_rels), "df_rel_err": max(df_rels), "tol": tol,
        "bitwise_repeat": bitwise, "peak_mem_gib": peak_gib,
        "kernel_peak_mem_gib": kernel_peak_gib, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
        "bytes": nbytes,
    }
    print("main " + json.dumps(row), flush=True)
    if max(dx_rels + df_rels) > tol:
        raise AssertionError(f"{name}: rel err {max(dx_rels + df_rels):.3e} > {tol:g}")
    del x, fs, ct, y, op, xd, fd
    torch.cuda.empty_cache()
    return [row]


def run_vmap(gen, peaks) -> list[dict]:
    """``torch.func.vmap`` through the autograd.Function's vmap rules:
    gp16-vmap maps x and the factors (the per-sample plan, bitwise equal to
    the per-sample op's call); fig9-vmap-x maps x alone, B=2 folded into
    2048 rows (bitwise equal to the flat call, planned for 2048 rows)."""
    from repro_torch.core import KronOp, KronProblem
    from repro_torch.core.engine import _lowered, _resolve_plan

    rows = []
    dtype = torch.float32
    b, m, ps, qs = VMAP_CASES["gp16-vmap"]
    k = math.prod(ps)
    x = randn(gen, (b, m, k), dtype)
    fs = [randn(gen, (b, p, q), dtype) for p, q in zip(ps, qs)]
    per = KronOp(ps, qs, batch=b, shared_factors=False)
    fn = torch.func.vmap(KronOp(ps, qs))

    def check_per(y):
        if not torch.equal(y, per(x, fs)):
            raise AssertionError("gp16-vmap: differs from the per-sample call")
        return {"b": b, "m": m, "ps": list(ps), "qs": list(qs), "bitwise_vs_direct": True}

    fsize = b * sum(p * q for p, q in zip(ps, qs))
    rows.append(timed_row(
        "gp16-vmap", lambda: "vmap(KronOp) over x and factors :: " + per.describe(),
        lambda: fn(x, fs), lambda: plain_twin(per, x, fs), lambda: einsum_call(x, fs),
        lambda: expect(chain_fwd=n_stages(per, True)), check_per,
        (2 * b * m * k + fsize) * 4, b * KronProblem(m, ps, qs).flops, dtype, peaks,
    ))
    del x, fs, per, fn
    torch.cuda.empty_cache()

    b, m, ps, qs = VMAP_CASES["fig9-vmap-x"]
    k = math.prod(ps)
    x = randn(gen, (b, m, k), dtype)
    fs = [randn(gen, (p, q), dtype) for p, q in zip(ps, qs)]
    op, flat = KronOp(ps, qs), KronOp(ps, qs)
    fn = torch.func.vmap(lambda xi: op(xi, fs))
    xf = x.view(b * m, k)

    def check_flat(y):
        if not torch.equal(y.view(b * m, -1), flat(xf, fs)):
            raise AssertionError("fig9-vmap-x: differs from the flat call")
        return {"b": b, "m": m, "ps": list(ps), "qs": list(qs), "bitwise_vs_direct": True}

    folded = _lowered(_resolve_plan(b * m, ps, qs, 4, False), ps, qs)
    rows.append(timed_row(
        "fig9-vmap-x", lambda: "vmap(KronOp) over x, B folded into rows :: " + folded.describe(),
        lambda: fn(x), lambda: plain_twin(flat, xf, fs).view(b, m, -1),
        lambda: einsum_call(xf, fs),
        lambda: expect(chain_fwd=len(folded.instrs)), check_flat,
        (2 * b * m * k + sum(p * q for p, q in zip(ps, qs))) * 4,
        KronProblem(b * m, ps, qs).flops, dtype, peaks,
    ))
    del x, fs, op, flat, fn, xf
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 4: every kernel of the main path alone
# ---------------------------------------------------------------------------

def main_program(m, ps, qs, dtype):
    """The StageProgram of ``KronOp(ps, qs)``'s default plan for m rows of
    ``dtype``: the one the main path's calls and backward passes run."""
    from repro_torch.core import KronOp
    from repro_torch.core.engine import _lowered

    op = KronOp(ps, qs, m=m, dtype_bytes=torch.tensor([], dtype=dtype).element_size())
    return _lowered(op.plan, op.ps, op.qs)


def stage_einsum(x, fs, m, s_rest):
    """One torch.einsum computing a stage: x (M, S * prod(P)) viewed as
    (M, S, p_{n-1}, .., p_0) against factors (p_i, q_i) in application order,
    out (M, q_{n-1}, .., q_0, S) flattened, the chain's final-index layout."""
    n = len(fs)
    ps_l, qs_l = "abcdefgh"[:n], "ijklmnop"[:n]
    spec = ("zy" + ps_l[::-1] + "," + ",".join(p + q for p, q in zip(ps_l, qs_l))
            + "->z" + qs_l[::-1] + "y")
    xv = x.reshape(m, s_rest, *(int(f.shape[0]) for f in reversed(fs)))
    return torch.einsum(spec, xv, *fs).reshape(m, -1)


def stage_einsum_t(dy, fs, m, s_rest):
    """One torch.einsum computing a stage's transpose: dY (M, q_{n-1}, ..,
    q_0, S) against the transposed factors, out dX (M, S, p_{n-1}, .., p_0)
    flattened."""
    n = len(fs)
    ps_l, qs_l = "abcdefgh"[:n], "ijklmnop"[:n]
    spec = ("z" + qs_l[::-1] + "y," + ",".join(p + q for p, q in zip(ps_l, qs_l))
            + "->zy" + ps_l[::-1])
    dyv = dy.reshape(m, *(int(f.shape[1]) for f in reversed(fs)), s_rest)
    return torch.einsum(spec, dyv, *fs).reshape(m, -1)


def stage_flops(m, k, ps, qs):
    """Multiply-adds x 2 of one stage's chain over m rows of k columns."""
    cols, flops = k, 0
    for p, q in zip(ps, qs):
        flops += 2 * m * cols * q
        cols = cols // p * q
    return flops


def bound(nbytes, flops, peaks, dtype):
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = flops / peaks[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def distinct_stages(prog, k):
    """(index, instruction, input columns, output columns) of each stage of
    ``prog`` whose shapes and tiles no earlier stage had."""
    seen = set()
    for idx, ins in enumerate(prog.instrs):
        k_out = k // ins.pprod * ins.qprod
        key = (ins.ps, ins.qs, k, ins.t_m, ins.t_k, ins.transpose().t_m)
        if key not in seen:
            seen.add(key)
            yield idx, ins, k, k_out
        k = k_out


# Kernels whose blocks must share an SM two at a time (occupancy query).
TWO_BLOCK_KERNELS = ("chain_fwd", "chain_bwd", "grad", "sliced", "sliced_t")


def run_alone(gen, peaks) -> dict:
    """One launch of each kernel at its main cases' shapes: CUDA-event time
    (median of ITERS after WARMUP), the per-launch bound (each input read
    once, each output written once; the stage's FLOPs), the blocks per SM
    from the occupancy query, and one PyTorch call computing the same
    function.  Fails when a kernel of TWO_BLOCK_KERNELS fits fewer than two
    blocks per SM."""
    from repro_torch.kernels import emit, kron_sliced, kron_sliced_t

    out = {"chain_fwd": [], "chain_bwd": [], "grad": [], "sliced": [], "sliced_t": []}

    def report(kernel, row):
        print(f"alone {kernel} " + json.dumps(row), flush=True)
        out[kernel].append(row)
        torch.cuda.empty_cache()

    # chain_fwd: each distinct stage of fig9, gp16 and ffn (bf16).
    for case, m, ps, qs, dtype in (
        ("fig9", 1024, (32,) * 4, (32,) * 4, torch.float32),
        ("gp16", 16, (16,) * 6, (16,) * 6, torch.float32),
        ("ffn", 4096, (64, 40), (128, 76), torch.bfloat16),
    ):
        acc = emit.acc_dtype_for(dtype)
        for idx, ins, k, k_out in distinct_stages(main_program(m, ps, qs, dtype), math.prod(ps)):
            x = randn(gen, (1, m, k), dtype)
            fs = [randn(gen, (1, p, q), dtype) for p, q in zip(ins.ps, ins.qs)]
            tiles = dict(t_m=ins.t_m, t_k=ins.t_k, t_qs=ins.t_qs)
            geo = emit.chain_geometry(x.shape, [f.shape for f in fs], acc_bytes=acc.itemsize,
                                      in_bytes=x.element_size(), **tiles)
            per_sm, smem = emit.chain_occupancy(geo, emit.kernel_dtype_code(x, fs, acc),
                                                x.device)
            ms = time_ms(lambda: emit.chain_cuda(x, *fs, **tiles))
            xl, fl = x[0], [f[0] for f in fs]
            library_ms = time_ms(lambda: stage_einsum(xl, fl, m, k // ins.pprod))
            fsize = sum(p * q for p, q in zip(ins.ps, ins.qs))
            b_ms, b_by = bound((m * k + m * k_out + fsize) * x.element_size(),
                               stage_flops(m, k, ins.ps, ins.qs), peaks, dtype)
            report("chain_fwd", {
                "case": case, "stage": idx, "ps": list(ins.ps), "qs": list(ins.qs),
                "block_tile": [geo.block_m, geo.block_k], "smem_bytes": smem,
                "blocks_per_sm": per_sm, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
            })
            del x, fs, xl, fl

    # chain_bwd: each distinct stage of fig9-dx (the transposed program).
    m, ps, qs, dtype = 1024, (32,) * 4, (32,) * 4, torch.float32
    for idx, ins, k, k_out in distinct_stages(main_program(m, ps, qs, dtype), math.prod(ps)):
        t_ins = ins.transpose()
        dy = randn(gen, (1, m, k_out), dtype)
        fs = [randn(gen, (1, p, q), dtype) for p, q in zip(ins.ps, ins.qs)]
        tiles = dict(t_m=t_ins.t_m, t_k=t_ins.t_k, t_qs=t_ins.t_qs)
        geo = emit.chain_geometry(dy.shape, [f.shape for f in fs], direction="bwd", **tiles)
        per_sm, smem = emit.chain_occupancy(geo, emit.kernel_dtype_code(dy, fs, torch.float32),
                                            dy.device)
        ms = time_ms(lambda: emit.chain_bwd_cuda(dy, *fs, **tiles))
        dyl, fl = dy[0], [f[0] for f in fs]
        library_ms = time_ms(lambda: stage_einsum_t(dyl, fl, m, k // ins.pprod))
        fsize = sum(p * q for p, q in zip(ins.ps, ins.qs))
        b_ms, b_by = bound((m * k + m * k_out + fsize) * 4, stage_flops(m, k, ins.ps, ins.qs),
                           peaks, dtype)
        report("chain_bwd", {
            "case": "fig9-dx", "stage": idx, "ps": list(ins.ps), "qs": list(ins.qs),
            "block_tile": [geo.block_m, geo.block_k], "smem_bytes": smem,
            "blocks_per_sm": per_sm, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
        })
        del dy, fs, dyl, fl

    # grad: each distinct stage of fig9-grad and ffn-grad.
    for case, m, ps, qs, dtype in (
        ("fig9-grad", 1024, (32,) * 4, (32,) * 4, torch.float32),
        ("ffn-grad", 4096, (64, 40), (128, 76), torch.bfloat16),
    ):
        acc = emit.acc_dtype_for(dtype)
        for idx, ins, k, k_out in distinct_stages(main_program(m, ps, qs, dtype), math.prod(ps)):
            t_m, t_k = ins.transpose().t_m, ins.t_k
            x = randn(gen, (1, m, k), dtype)
            dy = randn(gen, (1, m, k_out), dtype)
            fs = [randn(gen, (1, p, q), dtype) for p, q in zip(ins.ps, ins.qs)]
            geo = emit.grad_geometry(
                x.shape, dy.shape, [f.shape for f in fs], t_m=t_m, t_k=t_k,
                acc_bytes=acc.itemsize, in_bytes=x.element_size())
            per_sm, smem = emit.grad_occupancy(x, dy, geo, emit.kernel_dtype_code(x, fs, acc))
            ms = time_ms(lambda: emit.grad_cuda(x, dy, *fs, t_m=t_m, t_k=t_k))
            xl = x[0].detach().clone().requires_grad_()
            fl = [f[0].detach().clone().requires_grad_() for f in fs]
            yl = stage_einsum(xl, fl, m, k // ins.pprod)
            library_ms = time_ms(lambda: torch.autograd.grad(yl, [xl, *fl], dy[0], retain_graph=True))
            fsize = sum(p * q for p, q in zip(ins.ps, ins.qs))
            nbytes = (2 * m * k + m * k_out + fsize) * x.element_size() + fsize * acc.itemsize
            b_ms, b_by = bound(nbytes, 2 * stage_flops(m, k, ins.ps, ins.qs), peaks, dtype)
            report("grad", {
                "case": case, "stage": idx, "ps": list(ins.ps), "qs": list(ins.qs),
                "block_tile": [geo.block_m, geo.block_k], "smem_bytes": smem,
                "blocks_per_sm": per_sm, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
            })
            del x, dy, fs, xl, fl, yl

    # sliced: one fig9-unfused launch, (1024, 32 * 32768) x (32, 32) in f32
    # (each of the 7 on the main path), and ffn's two stages through the
    # plan=None path in bf16, (4096, 40 * 64) x (40, 76) and (4096, 64 * 76)
    # x (64, 128), on the tensor cores.
    for case, m, p, q, s_, dtype in (
        ("fig9-unfused", 1024, 32, 32, 32768, torch.float32),
        ("ffn plan=None stage 0", 4096, 40, 76, 64, torch.bfloat16),
        ("ffn plan=None stage 1", 4096, 64, 128, 76, torch.bfloat16),
    ):
        x = randn(gen, (m, s_ * p), dtype)
        f = randn(gen, (p, q), dtype)
        acc = emit.acc_dtype_for(dtype)
        code = emit.kernel_dtype_code(x, (f,), acc)
        t_m, t_s, t_q = kron_sliced.sliced_tiles(m, s_, p, q, acc.itemsize,
                                                 in_bytes=x.element_size())
        per_sm, smem = kron_sliced.sliced_occupancy(code, m, s_, p, q, t_m, t_s, t_q, x.device)
        call = lambda: kron_sliced.sliced_multiply_cuda(x, f)  # noqa: E731
        ms, dev_ms = time_ms(call), device_ms(call)
        xv = x.view(m, s_, p)
        lib = lambda: torch.einsum("msp,pq->mqs", xv, f)  # noqa: E731
        library_ms, library_dev_ms = time_ms(lib), device_ms(lib)
        b_ms, b_by = bound((m * s_ * p + m * q * s_ + p * q) * x.element_size(),
                           2 * m * s_ * p * q, peaks, dtype)
        report("sliced", {
            "case": case, "dtype": str(dtype).replace("torch.", ""), "p": p, "q": q,
            "mma": kron_sliced.sliced_uses_mma(p, q, x.element_size()),
            "tiles": [t_m, t_s, t_q], "smem_bytes": smem, "blocks_per_sm": per_sm, "ms": ms,
            "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library_device_ms": library_dev_ms,
        })
        del x, xv, f
    # sliced_t (fig9-unfused-grad): each launch is (1024, 32 * 32768) x (32, 32).
    m, p, q, s_ = 1024, 32, 32, 32768
    f = randn(gen, (p, q), torch.float32)
    b_ms, b_by = bound((2 * m * q * s_ + p * q) * 4, 2 * m * s_ * p * q, peaks, torch.float32)
    dy = randn(gen, (m, q * s_), torch.float32)
    t_m, t_s, t_q = kron_sliced.sliced_tiles(m, s_, p, q, 4, kind="sliced_t", in_bytes=4)
    per_sm, smem = kron_sliced_t.sliced_t_occupancy(
        0, dy.data_ptr() % 16, m, s_, p, q, t_m, t_s, t_q, dy.device)
    ms = time_ms(lambda: kron_sliced_t.sliced_multiply_t_cuda(dy, f))
    dyv = dy.view(m, q, s_)
    library_ms = time_ms(lambda: torch.einsum("mqs,pq->msp", dyv, f))
    report("sliced_t", {
        "case": "fig9-unfused-grad", "tiles": [t_m, t_s, t_q], "smem_bytes": smem,
        "blocks_per_sm": per_sm, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
    })
    del dy, dyv, f
    torch.cuda.empty_cache()
    few = [(name, r) for name in TWO_BLOCK_KERNELS for r in out[name] if r["blocks_per_sm"] < 2]
    if few:
        raise AssertionError(f"fewer than two blocks per SM: {few}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: the forward degradation ladder under chaos
# ---------------------------------------------------------------------------

# (name, B or None, M, ps, qs, rung-1 launches): the per-factor rung runs
# the sliced kernel for 2-D factors and chain-of-one chain_fwd launches for
# per-sample ones.
LADDER_CASES = [
    ("fig9", None, 1024, (32,) * 4, (32,) * 4, {"sliced": 4}),
    ("gp16-batched", 4, 16, (16,) * 6, (16,) * 6, {"chain_fwd": 6}),
]


def run_ladder(gen) -> list[dict]:
    """Each case planned, then under ``chaos.inject("stage_execute:times=1")``
    (rung 1, per-factor kernels), held against the planned result (bitwise
    where the same kernel computes both); with ``per_factor`` injected too
    the call raises ``VmemOverflowError`` with no launch: the ladder on the
    card has no rung below the kernels.  ``DEFAULT_PATIENCE`` degraded
    calls pin the key to rung 1, which the next call (no chaos) starts at.
    One GuardWarning per key; a float16 call raises ``LoweringError``, also
    with no launch.  ``reset_health()`` and an empty chaos layer end the
    phase."""
    import warnings

    from repro_torch.core import KronOp
    from repro_torch.runtime import chaos, guard

    guard.reset_health()
    rows = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, b, m, ps, qs, rung1 in LADDER_CASES:
            lead = () if b is None else (b,)
            x = randn(gen, (*lead, m, math.prod(ps)), torch.float32)
            fs = [randn(gen, (*lead, p, q), torch.float32) for p, q in zip(ps, qs)]
            op = KronOp(ps, qs) if b is None else KronOp(ps, qs, batch=b, shared_factors=False)
            planned_n = n_stages(op, b is not None)
            runs = {}
            for rung, spec, want in (
                ("planned", None, expect(chain_fwd=planned_n)),
                ("per-factor", "stage_execute:times=1", expect(**rung1)),
            ):
                reset_counters()
                if spec is None:
                    y = op(x, fs)
                else:
                    with chaos.inject(spec):
                        y = op(x, fs)
                torch.cuda.synchronize()
                launches = read_counters()
                if launches != want:
                    raise AssertionError(f"ladder {name} {rung}: launches {launches}, want {want}")
                runs[rung] = (y, launches)
            ref = runs["planned"][0]
            row = {"case": name, "describe": op.describe()}
            y, launches = runs["per-factor"]
            err, rel = compare(y, ref)
            bitwise = torch.equal(y, ref)
            row["per-factor"] = {"launches": {k: v for k, v in launches.items() if v},
                                 "max_abs_err": err, "rel_err": rel, "bitwise": bitwise}
            if rel > TOLERANCE[torch.float32]:
                raise AssertionError(f"ladder {name} per-factor: rel err {rel:.3e}")
            if b is not None and not bitwise:
                raise AssertionError(f"ladder {name}: chain_fwd rungs differ bitwise")
            # Both rungs fail: the call raises; no plain twin runs on the card.
            reset_counters()
            try:
                with chaos.inject("stage_execute:times=1,per_factor"):
                    op(x, fs)
            except guard.VmemOverflowError as e:
                row["both-rungs-fail"] = f"raised {type(e).__name__}"
            else:
                raise AssertionError(f"ladder {name}: both rungs failed but the call returned")
            torch.cuda.synchronize()
            if read_counters() != expect():
                raise AssertionError(f"ladder {name}: launches after both rungs failed")
            key = ("kron", op.ps, op.qs, "cuda", b is not None)
            h = guard.health(key)
            for _ in range(guard.DEFAULT_PATIENCE - 1):
                with chaos.inject("stage_execute:times=1"):
                    op(x, fs)
            if not (h.pinned and h.rung == 1):
                raise AssertionError(f"ladder {name}: not pinned after patience: {h.summary()}")
            reset_counters()
            y = op(x, fs)  # pinned: starts at rung 1, no chaos active
            torch.cuda.synchronize()
            launches = read_counters()
            if launches != expect(**rung1) or not torch.equal(y, runs["per-factor"][0]):
                raise AssertionError(f"ladder {name}: pinned call {launches}")
            row["pinned"] = {"rung": h.rung, "calls": h.calls, "degraded_calls": h.degraded_calls,
                             "errors": dict(h.errors), "per_factor_ms": time_ms(lambda: op(x, fs))}
            row["health"] = guard.health_report()["ops"][repr(key)]
            print("ladder " + json.dumps(row), flush=True)
            rows.append(row)
            del x, fs, op, runs, ref, y
            torch.cuda.empty_cache()
        # A dtype the kernels do not take raises on the card, every time.
        op = KronOp((16, 16), (16, 16))
        x = randn(gen, (64, 256), torch.float32).half()
        fs = [randn(gen, (16, 16), torch.float32).half() for _ in range(2)]
        reset_counters()
        for _ in range(guard.DEFAULT_PATIENCE + 1):
            try:
                op(x, fs)
            except guard.LoweringError:
                pass
            else:
                raise AssertionError("ladder float16: the call returned")
        torch.cuda.synchronize()
        h = guard.health(("kron", op.ps, op.qs, "cuda", False))
        if read_counters() != expect() or h.pinned or h.degraded_calls:
            raise AssertionError(f"ladder float16: {read_counters()} {h.summary()}")
        rows.append({"case": "float16", "raised": "LoweringError", "health": h.summary()})
        print("ladder " + json.dumps(rows[-1]), flush=True)
    per_key = {}
    for w in caught:
        if issubclass(w.category, guard.GuardWarning):
            msg = str(w.message)
            tag = "pinned" if "pinned" in msg else msg.split(" — ")[-1].split(" (")[0]
            per_key.setdefault(msg.split(" failed")[0].split(" degraded")[0], []).append(tag)
    print("ladder warnings " + json.dumps(per_key), flush=True)
    # One warning per key: each case degrades, then pins; float16 only fails.
    want = [["degrading to rung 1", "pinned"]] * len(LADDER_CASES) + [["degrading to rung 1"]]
    if sorted(sorted(tags) for tags in per_key.values()) != sorted(want):
        raise AssertionError(f"ladder: GuardWarnings {per_key}")
    guard.reset_health()
    if chaos.active() or guard.health_report()["ops"]:
        raise AssertionError("ladder: chaos or health state left behind")
    return rows


# ---------------------------------------------------------------------------
# Phases 6-9: the consumers (measured plans, profile, the FFN block, the GP)
# ---------------------------------------------------------------------------

# (name, B or None, M, ps, qs, dtype): the measured planner's cases.
MEASURE_CASES = [
    ("fig9", None, 1024, (32,) * 4, (32,) * 4, torch.float32),
    ("gp16", None, 16, (16,) * 6, (16,) * 6, torch.float32),
    ("ffn", None, 4096, (64, 40), (128, 76), torch.bfloat16),
    ("gp16-batched", 4, 16, (16,) * 6, (16,) * 6, torch.float32),
]
# The pre-kronization pair: the only smoke shapes the gate can touch
# (prekron_max_p=16 leaves fig9's 32 x 32 factors alone).
PREKRON_CASES = [c for c in MEASURE_CASES if c[0] in ("gp16", "gp16-batched")]
PROFILE_CASES = [c for c in MEASURE_CASES if c[0] in ("fig9", "gp16", "ffn")]


def _telemetry_counter(name: str) -> int:
    from repro_torch.runtime import telemetry

    return telemetry.snapshot()["counters"].get(name, 0)


def run_measure(gen, cache_dir: str) -> tuple[list[dict], dict]:
    """``KronOp(..., tune="measure", cache_path=...)`` on each case: the
    candidates and their times from the cache entry, the winner, the
    analytic plan's time in the same run, the key (the card's name in its
    ``;dev=``); a second construction hits the cache (``plan_cache.hit``
    up, no launch); the winner's forward and backward against the plain
    twins.  Then the pre-kronization pair.  Returns the rows and the
    launches of the measured ops' calls."""
    from repro_torch.core import KronOp, KronProblem, autotune
    from repro_torch.core.engine import _lowered
    from repro_torch.runtime import telemetry

    path = os.path.join(cache_dir, "plans.json")
    telemetry.configure(annotate=False)
    rows, launches_total = [], expect()
    try:
        for name, b, m, ps, qs, dtype in MEASURE_CASES:
            dbytes = torch.tensor([], dtype=dtype).element_size()
            kw = {} if b is None else {"batch": b, "shared_factors": False}
            hits, misses = _telemetry_counter("plan_cache.hit"), _telemetry_counter(
                "plan_cache.miss")
            t0 = time.perf_counter()
            op = KronOp(ps, qs, m=m, tune="measure", cache_path=path, dtype_bytes=dbytes,
                        device="cuda", **kw)
            torch.cuda.synchronize()
            measure_s = time.perf_counter() - t0
            if _telemetry_counter("plan_cache.miss") != misses + 1:
                raise AssertionError(f"measure {name}: the first construction did not measure")
            prob = KronProblem(m, ps, qs)
            key = autotune.plan_cache_key(
                prob, dbytes, "auto", enable_prekron=False, device="cuda",
                **({} if b is None else {"batch": b, "shared_factors": False}))
            entry = autotune.load_plan_cache(path)[key]
            if torch.cuda.get_device_name(0) not in key:
                raise AssertionError(f"measure {name}: key {key!r} lacks the card's name")
            analytic = (autotune.make_plan(prob, dtype_bytes=dbytes, enable_prekron=False)
                        if b is None else autotune.make_batched_plan(
                            prob, b, shared_factors=False, dtype_bytes=dbytes))
            if entry["candidates"][0] != analytic.describe():
                raise AssertionError(f"measure {name}: the analytic plan was not timed first")
            # A second construction reads the plan back: no measurement, no launch.
            reset_counters()
            again = KronOp(ps, qs, m=m, tune="measure", cache_path=path, dtype_bytes=dbytes,
                           device="cuda", **kw)
            torch.cuda.synchronize()
            if (_telemetry_counter("plan_cache.hit") != hits + 1
                    or read_counters() != expect() or again.plan != op.plan):
                raise AssertionError(f"measure {name}: the second construction did not hit")
            # The winner's forward and backward against the plain twins.
            lead = () if b is None else (b,)
            x = randn(gen, (*lead, m, math.prod(ps)), dtype).requires_grad_()
            fs = [randn(gen, (*lead, p, q), dtype).requires_grad_() for p, q in zip(ps, qs)]
            ct = randn(gen, (*lead, m, math.prod(qs)), dtype)
            n = len(_lowered(op.plan, op.ps, op.qs, b is not None).instrs)
            reset_counters()
            y = op(x, fs)
            grads = torch.autograd.grad(y, [x, *fs], ct)
            torch.cuda.synchronize()
            launches = read_counters()
            want = expect(chain_fwd=2 * n - 1, grad=n, grad_reduce=n)
            if launches != want:
                raise AssertionError(f"measure {name}: launches {launches}, expected {want}")
            launches_total = {k: launches_total[k] + v for k, v in launches.items()}
            xd, fd = x.detach(), [f.detach() for f in fs]
            with torch.no_grad():
                err, rel = compare(y.detach(), plain_twin(op, xd, fd))
            del y
            g_err, dx_rels, df_rels = hold_backward(op, xd, fd, grads, ct, b is not None)
            del grads
            torch.cuda.empty_cache()
            cands = [{"plan": d, "ms": s * 1e3}
                     for d, s in zip(entry["candidates"], entry["candidate_seconds"])]
            # The measurement's 1 warm-up and 3 runs per candidate, checked:
            # the winner's and the analytic plan's forward plus backward in
            # turns (analytic, winner, winner, analytic), median of ITERS.
            ab = {}
            if len(cands) > 1:
                ab_ops = {"analytic": KronOp(ps, qs, plan=analytic, **kw), "winner": op}
                for which in ("analytic", "winner", "winner", "analytic"):
                    ab.setdefault(which + "_ms", []).append(time_ms(
                        lambda o=ab_ops[which]: torch.autograd.grad(
                            o(x, fs).float().sum(), [x, *fs])))
                del ab_ops
            del x, fs, ct, xd, fd
            torch.cuda.empty_cache()
            row = {
                "case": name, "dtype": str(dtype).replace("torch.", ""), "key": key,
                "candidates": cands, "distinct_launch_configurations": len(cands),
                "winner": op.plan.describe(), "winner_ms": entry["seconds"] * 1e3,
                "analytic": analytic.describe(), "analytic_ms": cands[0]["ms"],
                "ab_fwd_bwd": ab, "measure_s": measure_s,
                "second_construction": "plan_cache.hit",
                "launches": launches, "fwd_rel_err": rel, "max_abs_err": max(err, g_err),
                "dx_rel_err": max(dx_rels), "df_rel_err": max(df_rels),
                "tol": TOLERANCE[dtype], "grad_tol": GRAD_TOLERANCE[dtype],
            }
            print("measure " + json.dumps(row), flush=True)
            if rel > TOLERANCE[dtype] or max(dx_rels + df_rels) > GRAD_TOLERANCE[dtype]:
                raise AssertionError(f"measure {name}: errors {rel}, {dx_rels}, {df_rels}")
            rows.append(row)
            del op, again
            torch.cuda.empty_cache()
    finally:
        telemetry.disable()
    prekron_rows, prekron_launches = run_prekron_pair(gen)
    rows.extend(prekron_rows)
    return rows, {k: launches_total[k] + v for k, v in prekron_launches.items()}


def run_prekron_pair(gen) -> tuple[list[dict], dict]:
    """``enable_prekron=True`` against ``False`` on gp16 and gp16-batched:
    the forward timed in turns (off, on, on, off) by CUDA events, prekron's
    result held against the plain twins.  ``prekron_wins`` is true only
    where every prekron time is below every time without it (a win by more
    than the runs' spread)."""
    from repro_torch.core import KronOp

    rows, launches_total = [], expect()
    for name, b, m, ps, qs, dtype in PREKRON_CASES:
        lead = () if b is None else (b,)
        kw = {} if b is None else {"batch": b, "shared_factors": False}
        x = randn(gen, (*lead, m, math.prod(ps)), dtype)
        fs = [randn(gen, (*lead, p, q), dtype) for p, q in zip(ps, qs)]
        ops = {pk: KronOp(ps, qs, enable_prekron=pk, **kw) for pk in (False, True)}
        reset_counters()
        y = ops[True](x, fs)
        torch.cuda.synchronize()
        launches = read_counters()
        if launches != expect(chain_fwd=len(ps) // 2):
            raise AssertionError(f"{name} prekron: launches {launches}")
        launches_total = {k: launches_total[k] + v for k, v in launches.items()}
        err, rel = compare(y, plain_twin(ops[False], x, fs))
        del y
        torch.cuda.empty_cache()

        def fwd(pk):
            with torch.no_grad():
                return ops[pk](x, fs)

        # The forward only: a 256 x 256 prekron stage's backward does not fit
        # one block of the stage backward and would take the per-factor
        # fallback.
        times = {pk: [] for pk in (False, True)}
        for pk in (False, True, True, False):
            times[pk].append(time_ms(lambda: fwd(pk)))
        row = {"case": name + " prekron", "plans": {str(pk): op.plan.describe()
                                                    for pk, op in ops.items()},
               "prekron_rel_err": rel, "tol": TOLERANCE[dtype],
               "off_ms": times[False], "on_ms": times[True],
               "prekron_wins": max(times[True]) < min(times[False])}
        print("measure " + json.dumps(row), flush=True)
        if rel > TOLERANCE[dtype]:
            raise AssertionError(f"{name} prekron: rel err {rel:.3e}")
        rows.append(row)
        del x, fs, ops
        torch.cuda.empty_cache()
    return rows, launches_total


def run_profile(gen) -> tuple[list[dict], dict]:
    """``KronOp.profile`` on fig9, gp16 and ffn: each stage's measured ms,
    its measured and predicted shares, the drift and the flagged stages."""
    from repro_torch.core import KronOp

    rows, launches_total = [], expect()
    for name, _, m, ps, qs, dtype in PROFILE_CASES:
        x = randn(gen, (m, math.prod(ps)), dtype)
        fs = [randn(gen, (p, q), dtype) for p, q in zip(ps, qs)]
        op = KronOp(ps, qs)
        reset_counters()
        report = op.profile(x, fs, warmup=1, iters=3)
        torch.cuda.synchronize()
        launches = read_counters()
        n = len(report["stages"])
        if launches != expect(chain_fwd=4 * n):  # warmup 1 + iters 3 per stage
            raise AssertionError(f"profile {name}: launches {launches}")
        launches_total = {k: launches_total[k] + v for k, v in launches.items()}
        row = {
            "case": name, "plan": report["plan"], "launches": launches,
            "stages": [{
                "instr": s["instr"], "measured_ms": s["measured_s"] * 1e3,
                "predicted_ms": s["predicted_s"] * 1e3, "share_measured": s["share_measured"],
                "share_predicted": s["share_predicted"], "drift": s["drift"],
                "flagged": s["drift_flagged"], "kernel": s["kernel"],
                "peak_flops": s["peak_flops"]} for s in report["stages"]],
            "measured_ms": report["measured_s"] * 1e3,
            "predicted_ms": report["predicted_s"] * 1e3,
            "measured_over_predicted": report["measured_s"] / report["predicted_s"],
            "drift_flagged": report["drift_flagged"], "drift_threshold": report["drift_threshold"],
        }
        print("profile " + json.dumps(row), flush=True)
        rows.append(row)
        del x, fs, op
        torch.cuda.empty_cache()
    return rows, launches_total


# qwen3-4b's FFN block with each projection a KronLinear (configs/qwen3_4b.py
# with kron_ffn=True, kron_factors=2): a serving batch of 4096 tokens.
FFN_BLOCK = {"arch": "qwen3-4b", "batch": 4, "seq": 1024, "dtype": torch.bfloat16}
FFN_TOLERANCE, FFN_GRAD_TOLERANCE = 1e-2, 2e-2


def run_ffn_block(gen) -> tuple[dict, dict]:
    """``ffn_apply`` on the KronLinear FFN at full width in bf16, its
    projections three ``KronLinear`` modules: one module's own forward
    (chain_fwd 2), then the block's forward (chain_fwd 6) and backward into
    the modules' parameters (grad and its reduce 6 each, chain_fwd 3
    remats), held against the same block through ``backend="torch"`` on
    the card; the dense SwiGLU block at the same width is timed as a
    yardstick."""
    from repro_torch.configs import get_config
    from repro_torch.convert import load_kron_linear_
    from repro_torch.core.layers import KronLinear, KronLinearSpec, kron_linear_apply
    from repro_torch.models.ffn import ffn_apply, ffn_init

    cfg = dataclasses.replace(get_config(FFN_BLOCK["arch"]), kron_ffn=True, kron_factors=2)
    dtype = FFN_BLOCK["dtype"]
    shape = (FFN_BLOCK["batch"], FFN_BLOCK["seq"], cfg.d_model)
    tokens = shape[0] * shape[1]
    # The projections as a model holds them: KronLinear modules, filled
    # with the block's init.
    mods = {}
    for k, v in ffn_init(gen, cfg, dtype, device="cuda").items():
        spec = KronLinearSpec(tuple(f.shape[0] for f in v["factors"]),
                              tuple(f.shape[1] for f in v["factors"]))
        mods[k] = load_kron_linear_(KronLinear(gen, spec, dtype, device="cuda", m=tokens), v)
    params = {k: mod.params for k, mod in mods.items()}
    leaves = [f for mod in mods.values() for f in mod.parameters()]
    x = randn(gen, shape, dtype).requires_grad_()
    ct = randn(gen, shape, dtype)
    # One module's own forward (its op resolved at construction).
    reset_counters()
    with torch.no_grad():
        y1 = mods["w1"](x)
    torch.cuda.synchronize()
    mod_launches = read_counters()
    if mod_launches != expect(chain_fwd=2):
        raise AssertionError(f"ffn-block KronLinear forward launches {mod_launches}")
    _, mod_rel = compare(y1, kron_linear_apply(params["w1"], x.detach(), backend="torch"))
    del y1
    reset_counters()
    y = ffn_apply(cfg, params, x)
    torch.cuda.synchronize()
    fwd_launches = read_counters()
    reset_counters()
    y.backward(ct)
    torch.cuda.synchronize()
    bwd_launches = read_counters()
    if fwd_launches != expect(chain_fwd=6):
        raise AssertionError(f"ffn-block forward launches {fwd_launches}")
    if bwd_launches != expect(chain_fwd=3, grad=6, grad_reduce=6):
        raise AssertionError(f"ffn-block backward launches {bwd_launches}")
    grads = [x.grad] + [f.grad for f in leaves]
    ref_params = {k: {"factors": tuple(f.detach().requires_grad_() for f in v["factors"])}
                  for k, v in params.items()}
    ref_leaves = [f for v in ref_params.values() for f in v["factors"]]
    xr = x.detach().requires_grad_()
    y_ref = ffn_apply(cfg, ref_params, xr, backend="torch")
    ref_grads = torch.autograd.grad(y_ref, [xr, *ref_leaves], ct)
    err, rel = compare(y.detach(), y_ref.detach())
    g_errs = [compare(g, r) for g, r in zip(grads, ref_grads)]
    del y, y_ref, ref_grads
    torch.cuda.empty_cache()

    def fwd():
        with torch.no_grad():
            return ffn_apply(cfg, params, x)

    def fwd_bwd():
        return torch.autograd.grad(ffn_apply(cfg, params, x), [x, *leaves], ct)

    ms, fb_ms = time_ms(fwd), time_ms(fwd_bwd)
    dev_ms, kern_ms = device_split(fwd)
    fb_dev_ms, fb_kern_ms = device_split(fwd_bwd)
    plain_ms = time_ms(lambda: ffn_apply(cfg, params, x.detach(), backend="torch"))
    d, f = cfg.d_model, cfg.d_ff
    dense = {k: randn(gen, s, dtype).mul_(s[0] ** -0.5).requires_grad_()
             for k, s in (("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d)))}
    dcfg = dataclasses.replace(cfg, kron_ffn=False)
    with torch.no_grad():
        dense_ms = time_ms(lambda: ffn_apply(dcfg, dense, x))
    dense_fb_ms = time_ms(lambda: torch.autograd.grad(
        ffn_apply(dcfg, dense, x), [x, *dense.values()], ct))
    kron_params = sum(t.numel() for t in leaves)
    row = {
        "case": "ffn-block", "arch": FFN_BLOCK["arch"], "d_model": d, "d_ff": f,
        "tokens": shape[0] * shape[1], "dtype": "bfloat16",
        "projections": {k: [list(t.shape) for t in v["factors"]] for k, v in params.items()},
        "fwd_launches": {k: v for k, v in fwd_launches.items() if v},
        "bwd_launches": {k: v for k, v in bwd_launches.items() if v},
        "module_w1_launches": {k: v for k, v in mod_launches.items() if v},
        "module_w1_rel_err": mod_rel,
        "max_abs_err": max([err] + [e for e, _ in g_errs]), "fwd_rel_err": rel,
        "grad_rel_err": max(r for _, r in g_errs), "tol": FFN_TOLERANCE,
        "grad_tol": FFN_GRAD_TOLERANCE, "ms": ms, "fwd_bwd_ms": fb_ms,
        "device_ms": dev_ms, "kernels_device_ms": kern_ms, "idle_share": 1 - dev_ms / ms,
        "fwd_bwd_device_ms": fb_dev_ms, "fwd_bwd_kernels_device_ms": fb_kern_ms,
        "fwd_bwd_idle_share": 1 - fb_dev_ms / fb_ms,
        "plain_ms": plain_ms, "dense_ms": dense_ms, "dense_fwd_bwd_ms": dense_fb_ms,
        "kron_params": kron_params, "dense_params": 3 * d * f,
    }
    print("ffn-block " + json.dumps(row), flush=True)
    if max(rel, mod_rel) > FFN_TOLERANCE or row["grad_rel_err"] > FFN_GRAD_TOLERANCE:
        raise AssertionError(f"ffn-block: errors {rel}, {mod_rel}, {g_errs}")
    launches = {k: mod_launches[k] + fwd_launches[k] + bwd_launches[k] for k in fwd_launches}
    del mods, params, leaves, x, ct, grads, dense
    torch.cuda.empty_cache()
    return row, launches


# The paper's GP epoch (§6.4; Table 4 row 26): six 16-point RBF factors,
# the M=16 CG block, 10 CG iterations in f32; and B=4 such kernels at once.
GP_EPOCH = {"dims": 6, "points": 16, "m": 16, "cg_iters": 10, "batch": 4}
GP_TOLERANCE = 1e-4


def _gp_factors(dims, points, lengthscales):
    from repro_torch.gp import rbf_kernel_1d

    grid = torch.linspace(0, 1, points, device="cuda", dtype=torch.float32)
    return tuple(rbf_kernel_1d(grid, ls) for ls in lengthscales[:dims])


def run_gp_epoch(gen) -> tuple[list[dict], dict]:
    """``gp_train_epoch`` through the kernels (chain_fwd 3 per MVM, 11
    MVMs), held against the same epoch through ``backend="shuffle"`` on the
    card at 1e-4 relative; then ``gp_train_epoch_batched`` at B=4, each
    sample's solution and residuals held against its own shuffle epoch
    (``compare`` fails on a non-finite value)."""
    from repro_torch.gp import BatchedKronKernel, KronKernel, gp_train_epoch, gp_train_epoch_batched

    e = GP_EPOCH
    k = e["points"] ** e["dims"]
    mvms = e["cg_iters"] + 1
    lengthscales = [0.15, 0.2, 0.25, 0.3, 0.35, 0.4]
    kernel = KronKernel(_gp_factors(e["dims"], e["points"], lengthscales))
    v = randn(gen, (e["m"], k), torch.float32)
    stages = len(kernel.op.plan.stages)
    reset_counters()
    x, res = gp_train_epoch(kernel, v, cg_iters=e["cg_iters"])
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != expect(chain_fwd=stages * mvms):
        raise AssertionError(f"gp-epoch launches {launches}")
    xs, res_s = gp_train_epoch(kernel, v, cg_iters=e["cg_iters"], backend="shuffle")
    _, x_rel = compare(x, xs)
    _, r_rel = compare(res, res_s)
    del xs
    ms = time_ms(lambda: gp_train_epoch(kernel, v, cg_iters=e["cg_iters"]))
    dev_ms, kern_ms = device_split(lambda: gp_train_epoch(kernel, v, cg_iters=e["cg_iters"]))
    shuffle_ms = time_ms(lambda: gp_train_epoch(kernel, v, cg_iters=e["cg_iters"],
                                                backend="shuffle"))
    row = {
        "case": "gp-epoch", "m": e["m"], "k": k, "factors": [e["points"]] * e["dims"],
        "cg_iters": e["cg_iters"], "mvms": mvms, "plan": kernel.op.plan.describe(),
        "launches": {n: c for n, c in launches.items() if c}, "x_rel_err": x_rel,
        "residual_rel_err": r_rel, "tol": GP_TOLERANCE,
        "residual_norms": [float(r) for r in res], "rhs_norms_max": float(v.norm(dim=-1).max()),
        "ms": ms, "device_ms": dev_ms, "kernels_device_ms": kern_ms,
        "idle_share": 1 - dev_ms / ms, "shuffle_ms": shuffle_ms,
    }
    print("gp-epoch " + json.dumps(row), flush=True)
    if max(x_rel, r_rel) > GP_TOLERANCE:
        raise AssertionError(f"gp-epoch: rel errs {x_rel}, {r_rel}")
    del x, res, v, res_s
    torch.cuda.empty_cache()
    rows, total = [row], dict(launches)

    # B kernels at once, each with its own lengthscales: the CG state is
    # about 6 x 4.3 GB.
    b = e["batch"]
    kernels = [KronKernel(_gp_factors(e["dims"], e["points"],
                                      [ls * (1 + 0.25 * i) for ls in lengthscales]))
               for i in range(b)]
    bk = BatchedKronKernel.stack(kernels)
    vb = randn(gen, (b, e["m"], k), torch.float32)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    xb, resb = gp_train_epoch_batched(bk, vb, cg_iters=e["cg_iters"])
    torch.cuda.synchronize()
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bstages = len(bk.op.plan.stages)
    if launches != expect(chain_fwd=bstages * mvms):
        raise AssertionError(f"gp-epoch-batched launches {launches}")
    # Every sample against its own epoch through the shuffle algorithm.
    x_rels, r_rels = [], []
    for i in range(b):
        xi, ri = gp_train_epoch(kernels[i], vb[i], cg_iters=e["cg_iters"], backend="shuffle")
        x_rels.append(compare(xb[i], xi)[1])
        r_rels.append(compare(resb[i], ri)[1])
        del xi, ri
    res_norms = [[float(r) for r in rs] for rs in resb]
    del xb, resb
    torch.cuda.empty_cache()
    ms = time_ms(lambda: gp_train_epoch_batched(bk, vb, cg_iters=e["cg_iters"]))
    row = {
        "case": "gp-epoch-batched", "b": b, "m": e["m"], "k": k, "mvms": mvms,
        "plan": bk.op.plan.describe(), "launches": {n: c for n, c in launches.items() if c},
        "x_rel_err": x_rels, "residual_rel_err": r_rels, "tol": GP_TOLERANCE,
        "residual_norms_max": [max(r) for r in res_norms],
        "peak_mem_gib": peak, "ms": ms,
    }
    print("gp-epoch " + json.dumps(row), flush=True)
    if max(x_rels + r_rels) > GP_TOLERANCE:
        raise AssertionError(f"gp-epoch-batched: rel errs {x_rels}, {r_rels}")
    rows.append(row)
    total = {n: total[n] + c for n, c in launches.items()}
    del bk, vb, kernels
    torch.cuda.empty_cache()
    return rows, total


# qwen3-4b at full width and depth with the Kron FFN (configs/qwen3_4b.py,
# kron_ffn=True, kron_factors=2; bf16, remat), trained on SyntheticLM: 6
# Shampoo steps (refreshes at optimizer steps 1 and 5), then 3 AdamW steps
# from the same init.
TRAIN = {"arch": "qwen3-4b", "batch": 4, "seq": 1024, "seed": 0,
         "shampoo_steps": 6, "adamw_steps": 3, "precond_every": 5, "lr": 1e-3,
         "warmup_steps": 2}
# One Shampoo step through the kernels against the same step through the
# plain twins (backend="torch") from the same params and tokens, relative to
# max|ref|: the loss; the step's gradients, as AdamW's first moment holds
# them (f32, (1 - b1) g, every leaf: bf16 rounding that the two orders of
# summation leave grows through the 36 layers of the backward, to a few
# 1e-2 at the first layer, so the limit lies between that and a planted
# fault's reading); each updated Kron factor (bf16: at step 1 the update
# stays under one ulp of the larger elements, so this reading sees little
# of the step).  Shampoo's precondition through the kernels against its
# twin on the run's roots, f32, every leaf.  The gradient and precondition
# limits must also fail a planted fault (run_train).
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_FACTOR_TOL, TRAIN_PRECOND_TOL = 1e-2, 1e-1, 2e-2, 1e-5


def train_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN["arch"]), kron_ffn=True, kron_factors=2)


def train_expected(cfg, groups, batch: int = TRAIN["batch"],
                   seq: int = TRAIN["seq"]) -> tuple[dict, dict]:
    """The launches of one train step as the plans predict them: (model,
    optimizer).  Per KronLinear of n stages (the plan of the batch's rows):
    n chain_fwd forward, n more in the remat re-forward, n-1 stage inputs
    rematerialized for the factor gradients, n grad and n grad_reduce; three
    KronLinears per layer (w1 and w3 up, w2 down).  Per Shampoo shape group,
    one per-sample batched op: its stages' chain_fwd.  ``batch``: the rows
    of the batch one rank runs (all of them off the mesh)."""
    from repro_torch.core.engine import kron_op_for, kron_precond_op
    from repro_torch.core.layers import KronLinearSpec

    b = batch
    up = KronLinearSpec.balanced(cfg.d_model, cfg.d_ff, cfg.kron_factors)
    down = KronLinearSpec.balanced(cfg.d_ff, cfg.d_model, cfg.kron_factors)
    fwd = grad = 0
    for spec in (up, up, down):
        op = kron_op_for(spec.ps, spec.qs, batch=b, shared_factors=True,
                         backend="auto", plan="auto")
        op._single_plan(b * seq, getattr(torch, cfg.dtype).itemsize)
        n = n_stages(op, False)
        fwd += (2 if cfg.remat else 1) * n + n - 1
        grad += n
    model = expect(chain_fwd=cfg.n_layers * fwd, grad=cfg.n_layers * grad,
                   grad_reduce=cfg.n_layers * grad)
    opt = expect(chain_fwd=sum(
        n_stages(kron_precond_op(p, q, sum(s for _, s in members)), True)
        for (p, q), members in groups.items()))
    return model, opt


GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
F32_GEMM_NAMES = ("f32f32", "sgemm", "ffma")


def device_kinds(by_name: dict) -> dict:
    """Device ms of a profile by kind of kernel: the port's kernels, f32
    GEMMs (the CUDA cores: attention's scores, TF32 off), other GEMMs (the
    tensor cores), and everything else (elementwise ops, reductions,
    softmax, copies)."""
    out = {"port_kernels": 0.0, "gemm_f32": 0.0, "gemm_tensor_core": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if any(n in name for n in PORT_KERNEL_NAMES):
            out["port_kernels"] += ms
        elif any(n in low for n in GEMM_NAMES):
            out["gemm_f32" if any(n in low for n in F32_GEMM_NAMES)
                else "gemm_tensor_core"] += ms
        else:
            out["other"] += ms
    return out


def _factor_leaves(params) -> dict:
    from repro_torch import tree

    return {p: t for p, t in tree.leaves_with_path(params) if "/factors/" in p}


def run_train(gen, smi: str) -> tuple[dict, dict]:
    """The port's training path at qwen3-4b's full width and depth: init,
    ``make_train_step`` (the model forward with the Kron FFN, remat, the
    loss, ``torch.autograd.grad`` into every parameter, the optimizer),
    ``SyntheticLM`` batches.  First one step through the kernels and the
    same step through ``backend="torch"`` from the same state and tokens
    (loss, every leaf's gradient, updated Kron factors), and the step with a
    planted gradient fault; then the main path: 6 Shampoo steps and 3
    AdamW steps, each step's launches against the plans' prediction (model
    and optimizer apart: the optimizer's are the launches inside
    ``shampoo.precondition``), the losses and grad norms finite and the
    last Shampoo loss below the first; CUDA-event ms per step, the device
    time of a plain step (``torch.profiler``), peak memory; last, Shampoo's
    batched ``precondition`` on the run's roots against ``looped=True``,
    bitwise, and against its twins per shape group, with a planted fault."""
    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import emit
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, ShampooConfig, shampoo
    from repro_torch.train import TrainState, make_train_step

    t = TRAIN
    cfg = train_cfg()
    tokens = t["batch"] * t["seq"]
    data = SyntheticLM(vocab=cfg.vocab, seq_len=t["seq"], batch=t["batch"], seed=t["seed"],
                       device="cuda")
    kw = dict(lr=t["lr"], warmup_steps=t["warmup_steps"])
    sh_cfg = ShampooConfig(precond_every=t["precond_every"], **kw)
    ad_cfg = OptConfig(**kw)
    params0 = M.init_params(cfg, gen, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params0))
    groups = shampoo.shape_groups(params0, sh_cfg)

    def fresh(opt_cfg):
        init_fn, _ = shampoo.opt_for(opt_cfg)
        return TrainState(params0, init_fn(params0, opt_cfg), torch.zeros((), dtype=torch.int32))

    def batch(i):
        toks, labels = data.global_batch(i)
        return {"tokens": toks, "labels": labels}

    # One step through the kernels against the same step through the twins,
    # and the same step with a planted fault in the factor gradients: the
    # kernel's, less the last eighth of the rows (a reduction that drops one
    # of eight partial sums).
    grad_cuda = emit.grad_cuda

    def dropped_partial(x, dy, *fs, **kw):
        dx, dfs = grad_cuda(x, dy, *fs, **kw)
        rows = max(x.shape[1] // 8, 1)
        _, tail = emit.grad_reference(x[:, -rows:], dy[:, -rows:], *fs,
                                      acc_dtype=kw.get("acc_dtype"))
        return dx, tuple(d - t.to(d.dtype) for d, t in zip(dfs, tail))

    def twin_step(backend):
        state, m = make_train_step(cfg, sh_cfg, backend=backend)(fresh(sh_cfg), batch(0))
        return (float(m["loss"]), dict(tree.leaves_with_path(state.opt["m"])),
                {p: f.clone() for p, f in _factor_leaves(state.params).items()})

    loss_t, moment_t, fac_t = twin_step("torch")
    torch.cuda.empty_cache()
    twin_row = {"loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL,
                "factor_tol": TRAIN_FACTOR_TOL, "factor_leaves": len(fac_t)}
    for label in ("kernels", "planted"):
        emit.grad_cuda = dropped_partial if label == "planted" else grad_cuda
        try:
            loss_k, moment_k, fac_k = twin_step("auto")
        finally:
            emit.grad_cuda = grad_cuda
        grad_errs = {p: compare(moment_k[p], moment_t[p])[1] for p in moment_t}
        worst = max(grad_errs, key=grad_errs.get)
        twin_row[label] = {
            "loss": loss_k, "loss_rel_err": abs(loss_k - loss_t) / abs(loss_t),
            "grad_rel_err": grad_errs[worst], "grad_worst_leaf": worst,
            "grad_worst_leaf_by_layer": ([compare(moment_k[worst][i], moment_t[worst][i])[1]
                                          for i in range(moment_t[worst].shape[0])]
                                         if worst.startswith("stack/") else None),
            "factor_rel_err": max(compare(fac_k[p], fac_t[p])[1] for p in fac_t),
        }
        del moment_k, fac_k
        torch.cuda.empty_cache()
    twin_row["loss_twins"] = loss_t
    print("train twin " + json.dumps(twin_row), flush=True)
    sound, planted = twin_row["kernels"], twin_row["planted"]
    if (sound["loss_rel_err"] > TRAIN_LOSS_TOL or sound["grad_rel_err"] > TRAIN_GRAD_TOL
            or sound["factor_rel_err"] > TRAIN_FACTOR_TOL):
        raise AssertionError(f"train: kernels against twins {twin_row}")
    if not planted["grad_rel_err"] > TRAIN_GRAD_TOL:
        raise AssertionError(f"train: the gradient check passes a planted fault {twin_row}")
    del moment_t, fac_t

    want_model, want_opt = train_expected(cfg, groups)
    opt_launches = {}
    precondition = shampoo.precondition

    def counted_precondition(*args, **kwargs):
        before = read_counters()
        out = precondition(*args, **kwargs)
        for name, n in read_counters().items():
            opt_launches[name] = opt_launches.get(name, 0) + n - before[name]
        return out

    def run(opt_cfg, steps, profile_step=None):
        """``steps`` steps from the init: per step ms, loss, grad norm,
        launches (model, optimizer); the device time of ``profile_step``."""
        step_fn = make_train_step(cfg, opt_cfg)
        state = fresh(opt_cfg)
        rows, device_ms, by_name = [], None, {}
        for i in range(steps):
            opt_launches.clear()
            reset_counters()
            b = batch(i)
            profiled = i == profile_step
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext()) as prof:
                start.record()
                state, m = step_fn(state, b)
                end.record()
                end.synchronize()
            if profiled:
                by_name = {e.key: getattr(e, "device_time_total", 0) / 1e3
                           for e in prof.key_averages()}
                device_ms = sum(by_name.values())
            launches = read_counters()
            opt = {name: opt_launches.get(name, 0) for name in launches}
            model = {name: launches[name] - opt[name] for name in launches}
            if model != want_model or opt != (want_opt if opt_cfg is sh_cfg else expect()):
                raise AssertionError(f"train step {i + 1}: launches {model} + {opt}, expected "
                                     f"{want_model} + {want_opt}")
            rows.append({
                "opt_step": int(state.opt["step"]), "ms": start.elapsed_time(end),
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "model_launches": {k: v for k, v in model.items() if v},
                "opt_launches": {k: v for k, v in opt.items() if v},
                "profiled": profiled,
            })
        return state, rows, (device_ms, by_name)

    shampoo.precondition = counted_precondition
    try:
        torch.cuda.reset_peak_memory_stats()
        profile_step = t["shampoo_steps"] - 1
        state, sh_rows, (device_ms, by_name) = run(sh_cfg, t["shampoo_steps"], profile_step)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        opt_bytes = shampoo.state_memory_report(state.opt)["total_bytes"]
        kron = state.opt["kron"]
        del state
        torch.cuda.empty_cache()
        ad_state, ad_rows, _ = run(ad_cfg, t["adamw_steps"])
        del ad_state
        torch.cuda.empty_cache()
    finally:
        shampoo.precondition = precondition
    launches = {name: sum(r["model_launches"].get(name, 0) + r["opt_launches"].get(name, 0)
                          for r in sh_rows + ad_rows) for name in read_counters()}

    # Precondition on the run's roots: batched against one call per layer
    # (bitwise), and against its twins, per shape group; the planted fault
    # runs the kernels without the left roots (a chain that skips a stage).
    ups = {p: randn(gen, (e["ok"].shape[0], e["lroot"].shape[-1], e["rroot"].shape[-1]),
                    torch.float32) for p, e in kron.items()}
    yb = shampoo.precondition(ups, kron)
    yl = shampoo.precondition(ups, kron, looped=True)
    bitwise = all(torch.equal(yb[p], yl[p]) for p in yl) and set(yb) == set(yl)
    yt = shampoo.precondition(ups, kron, backend="torch")
    no_left = {p: {**e, "lroot": torch.eye(e["lroot"].shape[-1], device="cuda").expand_as(
        e["lroot"]).contiguous()} for p, e in kron.items()}
    yp = shampoo.precondition(ups, no_left)
    precond = {}
    for (p, q), members in groups.items():
        paths = [path for path, _ in members]
        precond[f"{p}x{q}"] = {
            "rel_err": max(compare(yb[path], yt[path])[1] for path in paths),
            "planted_rel_err": min(compare(yp[path], yt[path])[1] for path in paths)}
    del ups, yb, yl, yt, yp, no_left, kron, params0
    torch.cuda.empty_cache()

    refresh = [r for r in sh_rows
               if r["opt_step"] == 1 or r["opt_step"] % t["precond_every"] == 0]
    plain = [r for r in sh_rows
             if r not in refresh and not r["profiled"] and r["opt_step"] > 1]
    plain_ms = statistics.median(r["ms"] for r in plain)
    dense = dataclasses.replace(cfg, kron_ffn=False)
    row = {
        "case": "train", "device": smi, "arch": t["arch"], "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype, "remat": cfg.remat,
        "batch": t["batch"], "seq": t["seq"], "tokens": tokens,
        "params": n_params, "dense_params": dense.param_count(),
        "shape_groups": {f"{p}x{q}": sum(s for _, s in m) for (p, q), m in groups.items()},
        "expected_model_launches": {k: v for k, v in want_model.items() if v},
        "expected_opt_launches": {k: v for k, v in want_opt.items() if v},
        "shampoo": sh_rows, "adamw": ad_rows,
        "plain_step_ms": plain_ms, "plain_steps": [r["opt_step"] for r in plain],
        "refresh_excess_ms": {r["opt_step"]: r["ms"] - plain_ms for r in refresh},
        "tokens_per_s": tokens / (plain_ms / 1e3),
        "adamw_step_ms": statistics.median(r["ms"] for r in ad_rows[1:]),
        "profiled_step_device_ms": device_ms,
        "device_ms_by_kind": device_kinds(by_name),
        "top_device_ms": {k[:80]: v for k, v in sorted(by_name.items(),
                                                        key=lambda kv: -kv[1])[:12]},
        "profiled_step_ms": sh_rows[profile_step]["ms"],
        "idle_share": 1 - device_ms / sh_rows[profile_step]["ms"],
        "peak_mem_gib": peak, "opt_state_gib": opt_bytes / 2 ** 30,
        "precondition_batched_bitwise_looped": bitwise,
        "precondition_against_twins": precond, "precondition_tol": TRAIN_PRECOND_TOL,
    }
    print("train " + json.dumps(row), flush=True)
    for r in sh_rows + ad_rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"train: non-finite loss or grad norm {r}")
    if not sh_rows[-1]["loss"] < sh_rows[0]["loss"]:
        raise AssertionError(f"train: Shampoo loss did not fall: "
                             f"{[r['loss'] for r in sh_rows]}")
    if not bitwise:
        raise AssertionError("train: batched precondition differs from looped")
    for shape, r in precond.items():
        if not r["rel_err"] <= TRAIN_PRECOND_TOL < r["planted_rel_err"]:
            raise AssertionError(f"train: precondition {shape} against twins {r} "
                                 f"(limit {TRAIN_PRECOND_TOL}; the planted fault must fail it)")
    return row, launches


# ---------------------------------------------------------------------------
# Phase 11: serving
# ---------------------------------------------------------------------------

# (a) qwen3-4b one-shot with the Kron FFN at full width and depth: 4
# SyntheticLM prompts of 1024 tokens, a cache of 1088, 64 greedy decode
# steps.  Decode steps 0-3 are held against the twins (backend="torch",
# teacher-forced from a copy of the prefill's cache); steps 15 and 63
# against the last row of a prefill of the tokens so far; the planted fault
# is read at step 15, in bf16 and in an f32 copy of the model, where the
# int8 cache is held against the exact one as the reference's test holds
# it (in f32).
SERVE_ONE_SHOT = {"arch": "qwen3-4b", "batch": 4, "prompt": 1024, "gen": 64, "seed": 0,
                  "twin_steps": 4, "check_steps": (15, 63), "fault_step": 15,
                  "profile_step": 32}
# (b) continuous batching on a Poisson trace (launch/serve.py's engine).
SERVE_CONTINUOUS = {"buckets": (128, 512, 1024), "max_slots": 8, "max_prefill": 4,
                    "max_wait": 8, "trace": {"seed": 0, "rate": 0.5, "n": 32,
                                             "prompt_lens": (64, 1024), "max_new": (16, 64)}}
# The per-slot decode check of (b), in an f32 copy: stale requests in every
# slot, live ones of several lengths in two buckets admitted over them into
# scattered slots, decode steps teacher-forced on random tokens.
SLOT_CHECK = {"seed": 3, "stale": (1000,) * 4, "live": ((512, (300, 450)), (128, (100,))),
              "slots": (5, 2, 7), "steps": 3}
# (c) deepseek-moe-16b (dense prelude FFN and shared experts as Kron FFNs)
# and (d) mamba2-130m (no FFN: no Kron kernel), at full width and depth.
SERVE_MOE = {"arch": "deepseek-moe-16b", "batch": 4, "prompt": 512, "gen": 16, "seed": 1,
             "check_steps": (3, 15), "f32_layers": 4}
SERVE_SSM = {"arch": "mamba2-130m", "batch": 4, "prompt": 1024, "gen": 64, "seed": 2,
             "check_steps": (15, 63), "f32_layers": None}
# Logits relative to max|ref|.  bf16 (the main path): kernels against
# twins and decode against prefill.  bf16 rounding flips that differ
# between two orders of summation (the twins', a prefill's GEMM shapes)
# grow through 36 random-init layers to 2-3e-2 of max|ref| on an H100,
# while the planted late K/V reads 0.30-0.46: the limit lies between.  f32
# (the same model cast): decode against prefill, where rounding stays near
# 1e-6, so the limit sees the cache logic alone.  The int8 cache against
# the exact one in f32 within the reference's envelope
# (tests/test_kv_quant.py: rtol 0.1, atol 0.15, f32), at under 0.55 of the
# bf16 cache's bytes.
SERVE_TOL, SERVE_F32_TOL = 1e-1, 1e-3
QUANT_RTOL, QUANT_ATOL, QUANT_BYTES = 0.1, 0.15, 0.55


def serve_cfg(arch: str, **kw):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.d_ff or (cfg.moe is not None and cfg.moe.n_shared):
        kw = {"kron_ffn": True, "kron_factors": 2, **kw}
    return dataclasses.replace(cfg, **kw)


def serve_expected(cfg, b: int, s: int) -> dict:
    """The launches of one prefill of (b, s) tokens, or one decode step of
    b slots (s = 1), as the plans of their rows predict them: per Kron FFN
    (the dense layers' FFN, the MoE layers' shared experts) its three
    KronLinears' stages, one ``chain_fwd`` each."""
    from repro_torch.core.engine import kron_op_for
    from repro_torch.core.layers import KronLinearSpec

    if not cfg.kron_ffn:
        return expect()
    plan = cfg.layer_plan()
    blocks = []
    if cfg.d_ff:
        blocks += [cfg.d_ff] * sum(not spec.moe for spec in plan)
    if cfg.moe is not None and cfg.moe.n_shared:
        blocks += [cfg.moe.n_shared * cfg.moe.d_expert] * sum(spec.moe for spec in plan)
    total = 0
    for f in blocks:
        up = KronLinearSpec.balanced(cfg.d_model, f, cfg.kron_factors)
        down = KronLinearSpec.balanced(f, cfg.d_model, cfg.kron_factors)
        for spec in (up, up, down):
            op = kron_op_for(spec.ps, spec.qs, batch=b, shared_factors=True,
                             backend="auto", plan="auto")
            op._single_plan(b * s, getattr(torch, cfg.dtype).itemsize)
            total += n_stages(op, False)
    return expect(chain_fwd=total)


def tree_bytes(t) -> int:
    from repro_torch import tree

    return sum(l.numel() * l.element_size() for l in tree.leaves(t))


def last_rows(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The last position's logits over the real vocabulary (the padded
    rows hold -1e9, which would set max|ref|), copied: a view would keep
    the whole logits tensor alive."""
    return logits[:, -1, :vocab].float().clone()


def serve_prompts(cfg, spec) -> torch.Tensor:
    from repro_torch.data import SyntheticLM

    return SyntheticLM(vocab=cfg.vocab, seq_len=spec["prompt"], batch=spec["batch"],
                       seed=spec["seed"], device="cuda").global_batch(0)[0]


def greedy(logits, vocab: int) -> torch.Tensor:
    return logits[:, -1, :vocab].argmax(dim=-1).to(torch.int32)[:, None]


def event_ms(fn):
    """``fn()`` between two CUDA events: (its result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def rel_err(got: torch.Tensor, ref: torch.Tensor, chunk: int = 1 << 24) -> float:
    """``compare``'s relative error, taken over slices of at most ``chunk``
    elements so that no double copy of a whole operand is held (a mesh
    round's operand is 256-512 MiB a rank, and four ranks share the card)."""
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
    g, r = got.reshape(-1), ref.reshape(-1)
    err = torch.zeros((), dtype=torch.float64, device=got.device)
    scale, finite = err.clone(), torch.ones((), dtype=torch.bool, device=got.device)
    for i in range(0, g.numel(), chunk):
        a, b = g[i:i + chunk].double(), r[i:i + chunk].double()
        finite &= torch.isfinite(a).all()
        err = torch.maximum(err, (a - b).abs().max())
        scale = torch.maximum(scale, b.abs().max())
    if not bool(finite):
        raise AssertionError("non-finite values in the kernel's output")
    err, scale = float(err), float(scale)
    return err / scale if scale else err


# kernel -> (module, wrapper, plain twin): the wrappers held_launches wraps.
HELD_WRAPPERS = {
    "chain_fwd": ("emit", "chain_cuda", "chain_reference"),
    "chain_bwd": ("emit", "chain_bwd_cuda", "chain_bwd_reference"),
    "sliced": ("kron_sliced", "sliced_multiply_cuda", "sliced_multiply_reference"),
    "sliced_t": ("kron_sliced_t", "sliced_multiply_t_cuda", "sliced_multiply_t_reference"),
    "grad": ("emit", "grad_cuda", "grad_reference"),
}


def held_tolerance(h) -> float:
    """A held launch's limit: ``TOLERANCE`` of its dtype; the stage backward
    (dx and every dF, summed over the rows in another order than its twin)
    ``GRAD_TOLERANCE``, at most 1e-2."""
    if h.kernel == "grad":
        return min(GRAD_TOLERANCE[h.dtype], 1e-2)
    return TOLERANCE[h.dtype]


# One kernel launch held against its plain twin on the same inputs.
Held = collections.namedtuple("Held", "kernel rows dtype rel_err")


@contextlib.contextmanager
def held_launches(kernels=("chain_fwd",)):
    """Inside the block every launch of ``kernels`` (names of
    ``HELD_WRAPPERS``) is also computed by its plain twin on the same
    inputs; yields the list of ``Held`` it fills, one per launch.  The twins
    launch no kernel, so the launch counters are untouched."""
    saved, out = [], []

    def wrap(name, cuda, twin):
        def held(x, *fs, **kw):
            y = cuda(x, *fs, **kw)
            acc = ({"acc_dtype": kw.get("acc_dtype")}
                   if name.startswith("chain") or name == "grad" else {})
            ref = twin(x, *fs, **acc)
            if name == "grad":  # (dx, (dF_0, ...)): the worst of them
                err = max(rel_err(a, b) for a, b in zip(flat(y), flat(ref)))
            else:
                err = rel_err(y, ref)
            out.append(Held(name, int(x.shape[-2]), x.dtype, err))
            return y
        return held

    for name in kernels:
        mod_name, wrapper, twin = HELD_WRAPPERS[name]
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        cuda = getattr(mod, wrapper)
        saved.append((mod, wrapper, cuda))
        setattr(mod, wrapper, wrap(name, cuda, getattr(mod, twin)))
    try:
        yield out
    finally:
        for mod, wrapper, cuda in saved:
            setattr(mod, wrapper, cuda)


def held_summary(held: list) -> dict:
    """Per kernel: launches held, their rows and the worst relative error."""
    out = {}
    for h in held:
        n, rows, worst = out.get(h.kernel, (0, set(), 0.0))
        out[h.kernel] = (n + 1, rows | {h.rows}, max(worst, h.rel_err))
    return {k: {"launches": n, "rows": sorted(rows), "rel_err": e}
            for k, (n, rows, e) in out.items()}


def held_stages(cfg, params, prompts, max_len: int) -> dict:
    """One prefill and one greedy decode step from its cache with every
    ``chain_fwd`` launch held against its twin on the same inputs:
    launches, rows per launch and the worst relative error of each call."""
    from repro_torch.models import model as M

    out = {}
    with held_launches() as errs:
        logits, cache = M.prefill(cfg, params, prompts, max_len)
        out["prefill"] = (len(errs), sorted({h.rows for h in errs}),
                          max(h.rel_err for h in errs))
        errs.clear()
        M.decode_step(cfg, params, cache, greedy(logits, cfg.vocab), prompts.shape[1])
        out["decode_step"] = (len(errs), sorted({h.rows for h in errs}),
                              max(h.rel_err for h in errs))
    del logits, cache
    torch.cuda.empty_cache()
    return {k: {"launches": n, "rows": rows, "rel_err": e} for k, (n, rows, e) in out.items()}


def decode_run(cfg, params, cache, first, prompt_len: int, steps: int, want: dict,
               profile_step=None):
    """The main path's ``steps`` greedy decode steps from ``cache`` (in
    place), fed ``first`` at the first.  Returns the tokens fed, each
    step's CUDA-event ms, the launches summed over the steps (each step's
    asserted against ``want``) and the profiled step's (device ms, event
    ms, {kernel name: (device ms, count)})."""
    from repro_torch.models import model as M

    pos = torch.tensor(prompt_len, dtype=torch.int32, device="cuda")
    tok, fed, ms, total, prof_row = first, [], [], {}, None
    for j in range(steps):
        fed.append(tok)
        reset_counters()
        profiled = j == profile_step
        with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            (logits, cache), t = event_ms(lambda: M.decode_step(cfg, params, cache, tok, pos))
        launches = read_counters()
        if launches != want:
            raise AssertionError(f"serve {cfg.name}: decode step {j} launches {launches}, "
                                 f"expected {want}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        if profiled:
            by_name = {e.key: (getattr(e, "device_time_total", 0) / 1e3, e.count)
                       for e in prof.key_averages()}
            prof_row = (sum(ms for ms, _ in by_name.values()), t, by_name)
        else:
            ms.append(t)
        tok = greedy(logits, cfg.vocab)
        pos += 1
    return fed, ms, total, prof_row


def late_kv(orig):
    """A planted fault for the decode checks: each new token's K/V moved one
    slot late after it is written, in each row's own slot under per-slot
    positions (every later step reads a zero where the token should be,
    and the token sits in a slot still marked empty)."""

    def decode(cfg, p, x, cache, pos):
        y, cache = orig(cfg, p, x, cache, pos)
        l = cache.k.shape[1]
        rows = torch.arange(x.shape[0], device=x.device)
        s = (torch.as_tensor(pos, device=x.device).long() % l).expand(x.shape[0])
        for buf in (cache.k, cache.v):
            buf[rows, (s + 1) % l] = buf[rows, s]
            buf[rows, s] = 0
        return y, cache

    return decode


def planted_late_kv(cfg, params, prompts, fed, j: int, max_len: int) -> float:
    """``routed_against_prefill`` at decode step ``j`` under ``late_kv``:
    the reading a sound cache keeps under the limit."""
    from repro_torch.models import attention

    orig = attention.attn_decode
    attention.attn_decode = late_kv(orig)
    try:
        return routed_against_prefill(cfg, params, prompts, fed, (j,), max_len)["max_rel_err"]
    finally:
        attention.attn_decode = orig


def run_serve_one_shot(gen, smi: str, peaks) -> tuple[dict, dict, dict]:
    """(a): returns the row, the main path's launches and the model
    (cfg, params) for (b)."""
    from repro_torch import tree
    from repro_torch.models import model as M

    spec = SERVE_ONE_SHOT
    cfg = serve_cfg(spec["arch"])
    b, s, steps = spec["batch"], spec["prompt"], spec["gen"]
    max_len = s + steps
    params = M.init_params(cfg, gen, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params))
    prompts = serve_prompts(cfg, spec)
    want_prefill, want_decode = serve_expected(cfg, b, s), serve_expected(cfg, b, 1)

    # The main path: one prefill and the greedy decode steps, launches per call.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    (logits, cache), prefill_event_ms = event_ms(lambda: M.prefill(cfg, params, prompts, max_len))
    prefill_launches = read_counters()
    if prefill_launches != want_prefill:
        raise AssertionError(f"serve one-shot: prefill launches {prefill_launches}, "
                             f"expected {want_prefill}")
    first = greedy(logits, cfg.vocab)
    del logits
    cache_bytes = tree_bytes(cache)
    fed, step_ms, decode_launches, (prof_dev, prof_ms, by_name) = decode_run(
        cfg, params, cache, first, s, steps, want_decode, profile_step=spec["profile_step"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache
    launches = {k: prefill_launches[k] + decode_launches[k] for k in prefill_launches}

    # Teacher-forced on the main path's tokens: kernels against the twins,
    # decode against prefill (bf16), the planted fault; then in f32 the
    # same check, its planted fault and the int8 cache.
    twin = against_twins(cfg, params, prompts, fed, spec["twin_steps"], max_len)
    stages = held_stages(cfg, params, prompts, max_len)
    against = routed_against_prefill(cfg, params, prompts, fed, spec["check_steps"], max_len)
    j = spec["fault_step"]
    planted = {"bfloat16": planted_late_kv(cfg, params, prompts, fed, j, max_len)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree.map(lambda l: l.float(), params)
    against32 = routed_against_prefill(cfg32, params32, prompts, fed, (j,), max_len)
    planted["float32"] = planted_late_kv(cfg32, params32, prompts, fed, j, max_len)
    qcfg = dataclasses.replace(cfg32, kv_quant=True)
    quant_bytes = tree_bytes(M.init_cache(qcfg, b, max_len, device="meta"))
    exact = routed_run(cfg32, params32, prompts, fed, j + 1, max_len)[0][j + 1]
    quant = routed_run(qcfg, params32, prompts, fed, j + 1, max_len)[0][j + 1]
    del params32
    excess = float(((quant - exact).abs() - QUANT_RTOL * exact.abs()).max())
    quant_argmax = int((quant.argmax(-1) == exact.argmax(-1)).sum())
    torch.cuda.empty_cache()

    prefill_ms = time_ms(lambda: M.prefill(cfg, params, prompts, max_len))
    torch.cuda.empty_cache()
    weight_bytes = sum(l.numel() * l.element_size() for p, l in tree.leaves_with_path(params)
                       if p != "embed")
    decode_bytes = weight_bytes + cache_bytes
    b_ms, b_by = bound(decode_bytes, 0, peaks, torch.bfloat16)
    row = {
        "case": "serve-one-shot", "device": smi, "arch": cfg.name, "n_layers": cfg.n_layers,
        "kron_ffn": cfg.kron_ffn, "dtype": cfg.dtype, "params": n_params, "batch": b,
        "prompt": s, "max_len": max_len, "decode_steps": steps,
        "launches_per_prefill": {k: v for k, v in prefill_launches.items() if v},
        "launches_per_decode_step": {k: v for k, v in want_decode.items() if v},
        "prefill_event_ms": prefill_event_ms, "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": b * s / (prefill_ms / 1e3),
        "decode_step_ms": statistics.median(step_ms),
        "decode_step_ms_min_max": [min(step_ms), max(step_ms)],
        "decode_tokens_per_s": b / (statistics.median(step_ms) / 1e3),
        "profiled_step_device_ms": prof_dev, "profiled_step_ms": prof_ms,
        "idle_share": 1 - prof_dev / prof_ms,
        "profiled_step_device_ops": sum(n for _, n in by_name.values()),
        "device_ms_by_kind": device_kinds({k: ms for k, (ms, _) in by_name.items()}),
        "top_device_ms": {k[:80]: v for k, v in sorted(by_name.items(),
                                                        key=lambda kv: -kv[1][0])[:8]},
        "decode_bound_ms": b_ms, "decode_bound_by": b_by, "decode_bytes": decode_bytes,
        "weight_bytes_outside_embedding": weight_bytes,
        "kv_cache_gib": cache_bytes / 2 ** 30, "peak_mem_gib": peak,
        "twins": twin, "launches_against_twins": stages,
        "launch_tol": TOLERANCE[torch.bfloat16], "decode_vs_prefill": against,
        "f32_decode_vs_prefill": against32, "planted_late_kv_rel_err": planted,
        "tol": SERVE_TOL, "f32_tol": SERVE_F32_TOL,
        "kv_quant_f32": {"cache_bytes_ratio": quant_bytes / cache_bytes,
                         "max_excess_over_rtol": excess, "rtol": QUANT_RTOL, "atol": QUANT_ATOL,
                         "argmax_agree": f"{quant_argmax}/{b}"},
    }
    print("serve " + json.dumps(row), flush=True)
    worst = max(twin["max_rel_err"], against["max_rel_err"])
    if max(v["rel_err"] for v in stages.values()) > TOLERANCE[torch.bfloat16]:
        raise AssertionError(f"serve one-shot: chain_fwd against its twin {stages}")
    if worst > SERVE_TOL or against32["max_rel_err"] > SERVE_F32_TOL:
        raise AssertionError(f"serve one-shot: rel err {worst:.3e} > {SERVE_TOL} or f32 "
                             f"{against32} > {SERVE_F32_TOL}")
    if not (planted["bfloat16"] > SERVE_TOL and planted["float32"] > SERVE_F32_TOL):
        raise AssertionError(f"serve one-shot: the decode check passes a planted fault {planted}")
    if excess > QUANT_ATOL or quant_argmax != b or quant_bytes / cache_bytes >= QUANT_BYTES:
        raise AssertionError(f"serve one-shot: int8 cache {row['kv_quant_f32']}")
    return row, launches, (cfg, params)


def slot_decode(cfg, params, scfg, max_new: int, fault: bool = False) -> dict:
    """The engine's per-slot decode against batch-of-one runs, in an f32
    copy of the model (``SLOT_CHECK``): stale requests fill every slot,
    then the live ones are prefilled in their buckets (padded) and
    admitted over them, and a few decode steps are teacher-forced through
    ``ServeEngine._decode`` with the per-slot positions of the live slots
    (the others decode at position 0, as idle slots do).  Each live slot's
    prefill row and decode logits are held against a batch-of-one prefill
    of its prompt alone and scalar-position ``decode_step`` calls.
    ``fault``: the engine's decode runs under ``late_kv``.  Returns the
    worst relative error of the prefill rows and of each step."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import attention
    from repro_torch.models import model as M

    spec = SLOT_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree.map(lambda l: l.float(), params)
    eng = ServeEngine(cfg32, params32, scfg, max_new=max_new)
    rng = np.random.RandomState(spec["seed"])
    stale = [rng.randint(0, cfg.vocab, n).astype(np.int32) for n in spec["stale"]]
    live = [(bucket, [rng.randint(0, cfg.vocab, n).astype(np.int32) for n in lens])
            for bucket, lens in spec["live"]]
    slots, steps = spec["slots"], spec["steps"]
    feed = rng.randint(0, cfg.vocab, (steps, len(slots))).astype(np.int32)

    cache = eng._new_cache()
    outs = eng._prefill_group(max(scfg.buckets), stale)
    for si in range(scfg.max_slots):
        cache = eng._move(cache, *outs[si % len(outs)][1], si)
    prompts, rows = [], []
    for bucket, group in live:
        for p, (lg, (src, i)) in zip(group, eng._prefill_group(bucket, group)):
            cache = eng._move(cache, src, i, slots[len(prompts)])
            prompts.append(p)
            rows.append(lg[: cfg.vocab].float())
    tok = np.zeros((scfg.max_slots, 1), np.int32)
    pos = np.zeros(scfg.max_slots, np.int32)
    pos[list(slots)] = [len(p) for p in prompts]
    orig = attention.attn_decode
    if fault:
        attention.attn_decode = late_kv(orig)
    try:
        got = []
        for j in range(steps):
            tok[list(slots), 0] = feed[j]
            logits, cache = eng._decode(params32, cache, torch.as_tensor(tok, device="cuda"),
                                        torch.as_tensor(pos, device="cuda"))
            got.append(last_rows(logits, cfg.vocab)[list(slots)])
            pos[list(slots)] += 1
    finally:
        attention.attn_decode = orig
    del cache, outs
    errs = {"prefill": 0.0, "steps": [0.0] * steps}
    for n, p in enumerate(prompts):
        logits, c = M.prefill(cfg32, params32, torch.as_tensor(p[None], device="cuda"),
                              eng.max_len)
        errs["prefill"] = max(errs["prefill"], compare(torch.as_tensor(rows[n], device="cuda"),
                                                       last_rows(logits, cfg.vocab)[0])[1])
        for j in range(steps):
            logits, c = M.decode_step(cfg32, params32, c,
                                      torch.tensor([[feed[j, n]]], device="cuda"), len(p) + j)
            errs["steps"][j] = max(errs["steps"][j],
                                   compare(got[j][n], last_rows(logits, cfg.vocab)[0])[1])
        del logits, c
    del params32, eng
    torch.cuda.empty_cache()
    return errs


def run_serve_continuous(cfg, params, smi: str) -> tuple[dict, dict]:
    """(b): ``ServeEngine`` on a Poisson trace: every request finishes, no
    plan-memo miss after ``prewarm`` and ``compile_shapes``, launches as
    the plans of the calls made predict; each request's prefill row and
    first token against a batch-of-one engine (one slot, groups of one);
    every launch of ``compile_shapes`` against its twin; the per-slot
    decode in f32 (``slot_decode``), sound and under a planted fault."""
    from repro_torch.core import engine as E
    from repro_torch.launch.scheduler import SchedulerConfig, poisson_trace
    from repro_torch.launch.serve import ServeEngine, _pcts

    spec = SERVE_CONTINUOUS
    reqs = poisson_trace(**spec["trace"])
    max_new = spec["trace"]["max_new"][1]

    def engine(slots, group):
        """An engine that records each request's prefill row, each call's
        shape and each decode step's host time (to the synchronize after
        it)."""
        eng = ServeEngine(cfg, params, SchedulerConfig(
            buckets=spec["buckets"], max_slots=slots, max_prefill=group,
            max_wait=spec["max_wait"]), max_new=max_new)
        eng.rows, eng.calls, eng.decode_ms = {}, [], []
        sample, pf, decode = eng._sample, eng._pf, eng._decode

        def record_sample(lg, rid, index):
            if index == 0:
                eng.rows[rid] = lg[: cfg.vocab].float()
            return sample(lg, rid, index)

        def record_pf(p, tokens):
            eng.calls.append(tuple(tokens.shape))
            return pf(p, tokens)

        def timed_decode(*args):
            t0 = time.perf_counter()
            out = decode(*args)
            torch.cuda.synchronize()
            eng.decode_ms.append((time.perf_counter() - t0) * 1e3)
            eng.calls.append((slots, 1))
            return out

        eng._sample, eng._pf, eng._decode = record_sample, record_pf, timed_decode
        return eng

    eng = engine(spec["max_slots"], spec["max_prefill"])
    n_ops = len(eng.prewarm())
    # Every serving shape's chain_fwd launches held against their twins.
    with held_launches() as errs:
        n_shapes = eng.compile_shapes()
    warm_want = sum(serve_expected(cfg, *shape)["chain_fwd"] for shape in eng.calls)
    held = {}
    for h in errs:
        n, worst = held.get(h.rows, (0, 0.0))
        held[h.rows] = (n + 1, max(worst, h.rel_err))
    misses = (E._resolve_plan.cache_info().misses, E._resolve_batched_plan.cache_info().misses)
    eng.rows, eng.calls, eng.decode_ms = {}, [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    rep = eng.run(reqs)
    torch.cuda.synchronize()
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = (E._resolve_plan.cache_info().misses, E._resolve_batched_plan.cache_info().misses)
    want = {}
    for shape in eng.calls:
        for name, n in serve_expected(cfg, *shape).items():
            want[name] = want.get(name, 0) + n

    # Batch-of-one: the same engine's prefill of each request alone (one
    # slot, groups of one; max_new 1 ends each request at its admission).
    solo = engine(1, 1)
    solo_rep = solo.run([dataclasses.replace(r, max_new=1) for r in reqs])
    row_err = {rid: compare(eng.rows[rid], solo.rows[rid])[1] for rid in solo.rows}
    slot = {"sound": slot_decode(cfg, params, eng.scfg, max_new),
            "planted_late_kv": slot_decode(cfg, params, eng.scfg, max_new, fault=True)}
    agree = sum(rep.tokens[rid][0] == solo_rep.tokens[rid][0] for rid in rep.tokens)
    done = [m for m in rep.metrics.values() if m.get("reason") in ("eos", "max_new")]
    row = {
        "case": "serve-continuous", "device": smi, "arch": cfg.name,
        "scheduler": {k: spec[k] for k in ("buckets", "max_slots", "max_prefill", "max_wait")},
        "trace": spec["trace"], "max_len": eng.max_len, "prewarmed_ops": n_ops,
        "warmed_shapes": n_shapes, "plan_misses_while_serving": [a - m for a, m in
                                                                 zip(after, misses)],
        "finished": len(done), "requests": len(reqs), "steps": rep.steps,
        "prefill_calls": sum(1 for c in eng.calls if c[1] != 1),
        "decode_steps": len(eng.decode_ms),
        "launches": {k: v for k, v in launches.items() if v},
        "expected_launches": {k: v for k, v in want.items() if v},
        "total_tokens": rep.total_tokens, "duration_s": rep.duration_s,
        "tokens_per_s": rep.tokens_per_s, "ttft_s": _pcts(rep.ttft_s), "tpot_s": _pcts(rep.tpot_s),
        "decode_step_ms": statistics.median(eng.decode_ms),
        "decode_step_ms_p99": _pcts(eng.decode_ms)["p99"], "peak_mem_gib": peak,
        "prefill_row_vs_batch_of_one_rel_err": max(row_err.values()), "tol": SERVE_TOL,
        "first_tokens_equal_batch_of_one": f"{agree}/{len(reqs)}",
        "warm_up_launches_against_twins": {r: {"launches": n, "rel_err": e}
                                           for r, (n, e) in sorted(held.items())},
        "launch_tol": TOLERANCE[torch.bfloat16],
        "f32_slot_decode_vs_batch_of_one": slot, "f32_tol": SERVE_F32_TOL,
    }
    print("serve " + json.dumps(row), flush=True)
    if len(done) != len(reqs):
        raise AssertionError(f"serve continuous: {len(done)} of {len(reqs)} requests finished")
    if after != misses:
        raise AssertionError(f"serve continuous: re-planned while serving: {misses} -> {after}")
    if launches != want:
        raise AssertionError(f"serve continuous: launches {launches}, expected {want}")
    if max(row_err.values()) > SERVE_TOL:
        raise AssertionError(f"serve continuous: prefill rows against batch-of-one {row_err}")
    if len(errs) != warm_want or max(e for _, e in held.values()) > TOLERANCE[torch.bfloat16]:
        raise AssertionError(f"serve continuous: warm-up launches against their twins {held}, "
                             f"{len(errs)} of {warm_want} held")
    if max(slot["sound"]["prefill"], *slot["sound"]["steps"]) > SERVE_F32_TOL:
        raise AssertionError(f"serve continuous: per-slot decode {slot['sound']}")
    if not slot["planted_late_kv"]["steps"][-1] > SERVE_F32_TOL:
        raise AssertionError(f"serve continuous: per-slot check passes a planted fault {slot}")
    return row, launches


@contextlib.contextmanager
def recorded_routes(replay=None):
    """Inside the block each MoE layer's routing records the top-k experts
    its router picks for each token (sorted), one ``(B, S, k)`` tensor per
    layer call in the order the layers run; yields the list it fills.
    ``replay``: such tensors, one per layer call, whose experts each call
    takes in place of its router's pick (the router's logits masked to
    them, so their weights are the ones the router gives them)."""
    from repro_torch.models import moe

    route, calls = moe._route, []

    def recorded(router_logits, mc, capacity):
        top = torch.topk(torch.softmax(router_logits, dim=-1), mc.top_k, dim=-1).indices
        calls.append(top.sort(dim=-1).values)
        if replay is not None:
            forced = torch.zeros_like(router_logits, dtype=torch.bool).scatter_(
                -1, replay[len(calls) - 1], True)
            router_logits = router_logits.masked_fill(~forced, float("-inf"))
        return route(router_logits, mc, capacity)

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def routed_run(cfg, params, prompts, fed, steps: int, max_len: int, backend="auto",
               replay=None):
    """A prefill of ``prompts``, then ``steps`` decode steps teacher-forced
    on ``fed``: per call (the prefill first) the last rows of its logits
    and the routes its MoE layers' routers picked.  ``replay``: another
    run's routes, per call, taken in place of this run's picks."""
    from repro_torch.models import model as M

    rows, routes = [], []
    flat = None if replay is None else [t for call in replay for t in call]
    with recorded_routes(flat) as calls:
        logits, cache = M.prefill(cfg, params, prompts, max_len, backend=backend)
        pos = torch.tensor(prompts.shape[1], dtype=torch.int32, device="cuda")
        for j in range(steps + 1):
            if j:
                logits, cache = M.decode_step(cfg, params, cache, fed[j - 1], pos,
                                              backend=backend)
                pos += 1
            rows.append(last_rows(logits, cfg.vocab))
            routes.append(calls[sum(map(len, routes)):])
    del logits, cache
    torch.cuda.empty_cache()
    return rows, routes


def route_history(routes, i: int) -> list:
    """Each MoE layer's routes at every position through call ``i`` of a
    ``routed_run``: one ``(B, positions, k)`` tensor per layer."""
    return [torch.cat([call[l] for call in routes[:i + 1]], dim=1)
            for l in range(len(routes[0]))]


def flipped_rows(a: list, b: list) -> int:
    """The rows in which some token's router picked other experts in some
    layer under ``b`` than under ``a`` (0 without MoE)."""
    if not a:
        return 0
    differ = torch.stack([(x != y).flatten(1).any(dim=1) for x, y in zip(a, b)])
    return int(differ.any(dim=0).sum())


def held_rows(errs, flips) -> dict:
    """Per-row readings of several calls: the worst, each call's worst and,
    per call, the rows whose routers picked other experts than the run
    they replay."""
    e = torch.stack(errs)
    return {"max_rel_err": float(e.max()), "by_step": [float(x) for x in e.amax(dim=1)],
            "rows_with_route_flips": flips}


def rel_rows(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B,): each row's max |got - ref| over its own max |ref|."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    ref = ref.double()
    return (got.double() - ref).abs().amax(-1) / ref.abs().amax(-1)


def against_twins(cfg, params, prompts, fed, steps: int, max_len: int) -> dict:
    """A prefill's last rows and ``steps`` decode steps (teacher-forced on
    ``fed``) against the twins (``backend="torch"``), which replay the
    kernels' routes."""
    got, got_routes = routed_run(cfg, params, prompts, fed, steps, max_len)
    ref, ref_routes = routed_run(cfg, params, prompts, fed, steps, max_len, backend="torch",
                                 replay=got_routes)
    return held_rows([rel_rows(g, r) for g, r in zip(got, ref)],
                     [flipped_rows(a, b) for a, b in zip(got_routes, ref_routes)])


def routed_against_prefill(cfg, params, prompts, fed, steps, max_len: int) -> dict:
    """Decode steps ``steps`` (teacher-forced on ``fed``) against the last
    row of a prefill of the tokens so far that replays the decode run's
    routes at every position."""
    rows, routes = routed_run(cfg, params, prompts, fed, max(steps) + 1, max_len)
    errs, flips = [], []
    for j in steps:
        history = route_history(routes, j + 1)
        ref, ref_routes = routed_run(cfg, params, torch.cat([prompts] + fed[:j + 1], dim=1),
                                     [], 0, max_len, replay=[history])
        errs.append(rel_rows(rows[j + 1], ref[0]))
        flips.append(flipped_rows(history, ref_routes[0]))
    return held_rows(errs, flips)


def run_serve_model(gen, smi: str, spec: dict) -> tuple[dict, dict]:
    """(c) and (d): prefill and greedy decode at full width and depth,
    launches per call asserted; then the checks, each teacher-forced on
    the greedy run's tokens.  With a Kron FFN: the prefill's last rows and
    every decode step against the twins (``backend="torch"``), and each
    ``chain_fwd`` launch of a prefill and a decode step against its twin
    on the same inputs.  Every model: decode steps ``spec["check_steps"]``
    against the last row of a prefill of the tokens so far, in bf16 and in
    an f32 copy of the first ``spec["f32_layers"]`` layers (all if None).
    In an MoE model the second run of each pair replays the first's routes
    (``recorded_routes``): a top-k pick that flips between two orders of
    summation moves a row by a whole expert's share, so the readings hold
    everything but the pick, and the rows whose picks flipped are counted.
    Its decode is held against prefill at capacity E/k, where no token
    drops: at the configured capacity a prefill of t + 1 tokens may drop
    the last one, which a decode step never does."""
    import gc

    from repro_torch import tree
    from repro_torch.models import model as M

    cfg = serve_cfg(spec["arch"])
    b, s, steps = spec["batch"], spec["prompt"], spec["gen"]
    max_len = s + steps
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated() / 2 ** 30
    params = M.init_params(cfg, gen, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params))
    prompts = serve_prompts(cfg, spec)
    want_prefill, want_decode = serve_expected(cfg, b, s), serve_expected(cfg, b, 1)
    reset_counters()
    (logits, cache), prefill_ms = event_ms(lambda: M.prefill(cfg, params, prompts, max_len))
    prefill_launches = read_counters()
    if prefill_launches != want_prefill:
        raise AssertionError(f"serve {cfg.name}: prefill launches {prefill_launches}, "
                             f"expected {want_prefill}")
    first = greedy(logits, cfg.vocab)
    del logits
    fed, step_ms, decode_launches, _ = decode_run(cfg, params, cache, first, s, steps,
                                                  want_decode)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cache_bytes = tree_bytes(cache)
    del cache
    launches = {k: prefill_launches[k] + decode_launches[k] for k in prefill_launches}

    checks, gates = {}, []
    if cfg.kron_ffn:
        checks["twins"] = against_twins(cfg, params, prompts, fed, steps, max_len)
        checks["launches_against_twins"] = held_stages(cfg, params, prompts, max_len)
        gates += [(checks["twins"]["max_rel_err"], SERVE_TOL),
                  (max(v["rel_err"] for v in checks["launches_against_twins"].values()),
                   TOLERANCE[torch.bfloat16])]
    chk = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    checks["decode_vs_prefill"] = routed_against_prefill(chk, params, prompts, fed,
                                                         spec["check_steps"], max_len)
    gates.append((checks["decode_vs_prefill"]["max_rel_err"], SERVE_TOL))
    n32 = spec["f32_layers"] or cfg.n_layers
    cut = (n32 - cfg.prelude_len) // cfg.period
    cfg32 = dataclasses.replace(chk, dtype="float32", n_layers=n32)
    params32 = tree.map(lambda l: l.float(), {**params, "stack": tree.map(lambda l: l[:cut],
                                                                          params["stack"])})
    del params
    checks["f32_decode_vs_prefill"] = routed_against_prefill(
        cfg32, params32, prompts, fed, spec["check_steps"], max_len)
    checks["f32_layers"] = n32
    del params32
    torch.cuda.empty_cache()
    gates.append((checks["f32_decode_vs_prefill"]["max_rel_err"], SERVE_F32_TOL))
    # In f32 the routers' own picks must agree too: the replay would hide a
    # decode that picks the wrong experts.
    gates.append((max(checks["f32_decode_vs_prefill"]["rows_with_route_flips"]), 0))
    row = {
        "case": f"serve-{cfg.name}", "device": smi, "arch": cfg.name, "n_layers": cfg.n_layers,
        "kron_ffn": cfg.kron_ffn, "dtype": cfg.dtype, "params": n_params, "batch": b,
        "prompt": s, "decode_steps": steps,
        "launches_per_prefill": {k: v for k, v in prefill_launches.items() if v},
        "launches_per_decode_step": {k: v for k, v in want_decode.items() if v},
        "prefill_event_ms": prefill_ms, "decode_step_ms": statistics.median(step_ms),
        "cache_gib": cache_bytes / 2 ** 30, "allocated_at_start_gib": at_start,
        "peak_mem_gib": peak, "tol": SERVE_TOL,
        "f32_tol": SERVE_F32_TOL, "launch_tol": TOLERANCE[torch.bfloat16], **checks,
    }
    if not cfg.kron_ffn:
        row["note"] = "no Kron kernel on this path: d_ff = 0 and no MoE, so no Kron FFN"
    print("serve " + json.dumps(row), flush=True)
    for err, tol in gates:
        if err > tol:
            raise AssertionError(f"serve {cfg.name}: reading {err:.3e} > {tol}")
    return row, launches


def run_serve(gen, smi: str, peaks) -> tuple[list, dict]:
    """Phase 11: (a)-(d); the launches of their main-path runs, summed.
    Peak memory is read over what earlier phases left allocated, printed
    first (collected garbage excluded)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated at the "
          f"phase's start", flush=True)
    one_shot, la, (cfg, params) = run_serve_one_shot(gen, smi, peaks)
    continuous, lb = run_serve_continuous(cfg, params, smi)
    del cfg, params
    torch.cuda.empty_cache()
    moe, lc = run_serve_model(gen, smi, SERVE_MOE)
    ssm, ld = run_serve_model(gen, smi, SERVE_SSM)
    if ld != expect():
        raise AssertionError(f"serve mamba2-130m: launched {ld}")
    launches = {k: la[k] + lb[k] + lc[k] + ld[k] for k in la}
    return [one_shot, continuous, moe, ssm], launches


# One injects faults into the kernels' path, one adds host checks, and one
# would point the measured planner at a cache the smoke does not own.
# ---------------------------------------------------------------------------
# Phase 12: the mesh (MESH_RANKS ranks share the one card over gloo)
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# Figure 11 (benchmarks/fig11.py): P=64, N=4, K=64^4=16,777,216, f32, weak
# scaling M = 4 * G: FastKron rounds serial and at each of MESH_SLABS, and
# the per-iteration baseline, on each mesh.
MESH_FIG11 = {"p": 64, "n": 4, "rows_per_rank": 4, "meshes": ((1, 4), (2, 2)), "iters": 2}
MESH_SLABS = (2, 4)
# gp16 (Table 4 row 26) on (2, 2): the batched MVM at B=4, and one epoch
# cut to B=1 (its 11 MVMs each move their rounds through the host).
MESH_GP = {"dims": 6, "points": 16, "m": 16, "batch": 4, "epoch_batch": 1, "cg_iters": 10,
           "mesh": (2, 2)}
# qwen3-4b's Kron FFN block in bf16 (FFN_BLOCK's 4096 tokens) on (2, 2).
MESH_FFN = {"mesh": (2, 2)}
MESH_LADDER = {"ps": (16,) * 4, "m": 32, "mesh": (2, 2), "n_slabs": 2}
# The measured slab count at gp16, cut from B=4 to B=2: each rank's
# per-sample backward holds a round's inputs and cotangents for every
# factor (over 16 GiB a rank at B=4), and the four ranks share one card.
MESH_MEASURE = {"ps": (16,) * 6, "m": 16, "batch": 2, "mesh": (2, 2)}
MESH_TOL, MESH_GRAD_TOL = TOLERANCE[torch.float32], GRAD_TOLERANCE[torch.float32]
MESH_TIMEOUT_S = 600
MESH_NOTE = "ranks share one card: not a scaling number"


def _mesh_counters() -> dict:
    from repro_torch.core import distributed as TD

    out = read_counters()
    out["a2a_calls"], out["a2a_elems"] = TD.all_to_all_calls, TD.all_to_all_elems
    return out


def _mesh_reset() -> None:
    from repro_torch.core import distributed as TD

    reset_counters()
    TD.all_to_all_calls = TD.all_to_all_elems = 0


def _mesh_expect(a2a_calls: int = 0, a2a_elems: int = 0, **counts) -> dict:
    out = expect(**counts)
    out["a2a_calls"], out["a2a_elems"] = a2a_calls, a2a_elems
    return out


MESH_HELD = ("chain_fwd", "chain_bwd", "sliced", "sliced_t")


def _mesh_counted(fn, want: dict | None, what: str, kernels=MESH_HELD):
    """``fn()`` with every counter from 0 just before it, read just after
    and asserted equal to ``want`` (None: returned unchecked).  Every launch
    of ``kernels`` (phase 12: ``chain_fwd``, ``chain_bwd``, ``sliced`` and
    ``sliced_t``) in it is held against its plain twin on the same inputs,
    at the shapes the mesh path gives it, within ``held_tolerance``.
    Returns ``fn()``'s result, the counts, and the held launches per
    kernel."""
    _mesh_reset()
    with held_launches(kernels) as held:
        out = fn()
    torch.cuda.synchronize()
    got = _mesh_counters()
    if want is not None and got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    summary = held_summary(held)
    if any(summary.get(k, {}).get("launches", 0) != got[k] for k in kernels):
        raise AssertionError(f"{what}: held {summary}, launched {got}")
    bad = [h for h in held if h.rel_err > held_tolerance(h)]
    if bad:
        raise AssertionError(f"{what}: launches disagree with their twins: {bad[:8]}")
    return out, got, summary


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _mesh_ms(fn, iters: int) -> float:
    """Median wall time of ``fn`` on this rank, the ranks starting together
    (a barrier after the card is idle)."""
    import torch.distributed as dist

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return compare(got, ref)[1]


def _only(placements, dim: int) -> tuple:
    """``placements`` with every Shard other than of tensor dim ``dim``
    replaced by Replicate (a rank's rows with every column, or the
    reverse)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim == dim else Replicate()
                 for p in placements)


def _round_launches(op, m_slab: int, dtype, batched: bool) -> list[int]:
    """Chain launches per round of a mesh op: the sub-chains one block
    holds (``distributed._round_instrs``)."""
    from repro_torch.core import distributed as TD
    from repro_torch.kernels import emit

    ps, qs = op.ps[::-1], op.qs[::-1]
    acc = emit.acc_dtype_for(dtype).itemsize
    size = torch.empty((), dtype=dtype).element_size()
    out, i, k = [], 0, op.k // op.g_k
    for r in op.rounds:
        out.append(len(TD._round_instrs(m_slab, k, ps[i:i + r], qs[i:i + r], batched, acc, size)))
        k = k // math.prod(ps[i:i + r]) * math.prod(qs[i:i + r])
        i += r
    return out


def _rounds_want(op, m_loc: int, n_slabs: int, dtype, *, grad: bool, batch: int = 1) -> dict:
    """A mesh call's launches and collectives on each rank: the forward, or
    the backward into x and the factors (the rounds but the last
    re-materialised, ``sliced`` for the in-round inputs, ``sliced_t`` per
    factor; per-sample factors run the chain kernels' chain-of-one for
    both)."""
    from repro_torch.core import distributed as TD

    per_sample = batch > 1 or op._per_sample
    per_round = _round_launches(op, m_loc // n_slabs, dtype, per_sample)
    n_r = len(op.rounds)
    ps, qs, k_loc = op.ps[::-1], op.qs[::-1], op.k // op.g_k

    def comm(rounds):
        return TD.comm_elems_per_device(m_loc, k_loc, ps, qs, op.g_k, rounds, batch=batch)

    if not grad:
        return _mesh_expect(chain_fwd=n_slabs * sum(per_round), a2a_calls=n_r * n_slabs,
                            a2a_elems=comm(op.rounds))
    within = n_slabs * (op.n - n_r)  # in-round inputs: every factor of a round but its last
    transposed = n_slabs * op.n
    counts = dict(chain_fwd=n_slabs * sum(per_round[:-1]))
    if per_sample:
        counts["chain_fwd"] += within
        counts["chain_bwd"] = transposed
    else:
        counts.update(sliced=within, sliced_t=transposed)
    remat = comm(op.rounds[:-1]) if n_r > 1 else 0
    return _mesh_expect(a2a_calls=(2 * n_r - 1) * n_slabs, a2a_elems=remat + comm(op.rounds),
                        **counts)


def _mesh_fig11(shape) -> list[dict]:
    """Figure 11 on one mesh: FastKron rounds serial and slabbed, and the
    per-iteration baseline, forward and ``torch.autograd.grad`` into x and
    the factors, each rank's shards against the local KronOp on the whole
    problem; every slabbed schedule bitwise equal to the serial one."""
    from repro_torch.core import KronOp
    from repro_torch.core import distributed as TD
    from repro_torch.launch.mesh import make_debug_mesh

    g_m, g_k = shape
    cfg = MESH_FIG11
    ps = (cfg["p"],) * cfg["n"]
    m = cfg["rows_per_rank"] * g_m * g_k
    k = math.prod(ps)
    mesh = make_debug_mesh(g_m, g_k)
    pl = TD.mesh_placements(mesh)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)  # the same x, factors and cotangent on every rank
    x = randn(gen, (m, k), torch.float32)
    fs = [randn(gen, (cfg["p"], cfg["p"]), torch.float32) for _ in ps]
    ct = randn(gen, (m, k), torch.float32)
    xr = x.clone().requires_grad_()
    fr = [f.clone().requires_grad_() for f in fs]
    y_ref = KronOp(ps, ps)(xr, fr)
    g_ref = torch.autograd.grad(y_ref, (xr, *fr), ct)
    y_ref = TD._slice_local(y_ref.detach(), mesh, pl).contiguous()
    dx_ref = TD._slice_local(g_ref[0], mesh, pl).contiguous()
    df_ref = g_ref[1:]
    xs = TD.sharded_input(x, mesh).requires_grad_()
    cts = TD.sharded_input(ct, mesh)
    del x, ct, xr, fr, g_ref
    torch.cuda.empty_cache()
    fl = [f.clone().requires_grad_() for f in fs]
    m_loc = m // g_m
    rows, serial = [], None
    for per_it, n_slabs in [(False, 1)] + [(False, n) for n in MESH_SLABS] + [(True, 1)]:
        op = KronOp(ps, ps, mesh=mesh, n_slabs=n_slabs, per_iteration=per_it)
        name = f"fig11-{g_m}x{g_k}-" + ("periter" if per_it else f"slabs{n_slabs}")
        y, fwd, fwd_held = _mesh_counted(lambda: op(xs, fl), _rounds_want(
            op, m_loc, n_slabs, torch.float32, grad=False), f"{name} forward")
        g, bwd, bwd_held = _mesh_counted(lambda: torch.autograd.grad(y, (xs, *fl), cts),
                                         _rounds_want(op, m_loc, n_slabs, torch.float32,
                                                      grad=True), f"{name} backward")
        outs = (y.to_local().detach(), g[0].to_local(), *g[1:])
        errs = {"fwd": _rel(outs[0], y_ref), "dx": _rel(outs[1], dx_ref),
                "df": max(_rel(a, b) for a, b in zip(g[1:], df_ref))}
        if errs["fwd"] > MESH_TOL or max(errs["dx"], errs["df"]) > MESH_GRAD_TOL:
            raise AssertionError(f"{name}: errors {errs}")
        row = {"case": name, "mesh": [g_m, g_k], "m": m, "k": k, "rounds": list(op.rounds),
               "n_slabs": n_slabs, "fwd_launches": _nonzero(fwd), "bwd_launches": _nonzero(bwd),
               "fwd_held": fwd_held, "bwd_held": bwd_held, "rel_err": errs}
        if not per_it:
            if serial is None:
                serial = outs
            else:
                row["bitwise_serial"] = all(torch.equal(a, b) for a, b in zip(outs, serial))
                if not row["bitwise_serial"]:
                    raise AssertionError(f"{name}: slabbed differs from serial")
        del y, g, outs
        with torch.no_grad():
            row["fwd_ms"] = _mesh_ms(lambda: op(xs, fs), cfg["iters"])
        rows.append(row)
    del xs, cts, fl, serial, y_ref, dx_ref, df_ref
    torch.cuda.empty_cache()
    return rows


def _mesh_gp() -> list[dict]:
    """gp16 on (2, 2): ``BatchedKronKernel.matmul(v, mesh=)`` at B=4, and one
    ``gp_train_epoch_batched(..., mesh=)`` at B=1 (10 CG iterations, 11
    MVMs), each rank's shards against the same calls without a mesh on
    the rank's rows (rows are independent in both)."""
    from repro_torch.core import distributed as TD
    from repro_torch.gp import BatchedKronKernel, KronKernel, gp_train_epoch_batched
    from repro_torch.launch.mesh import make_debug_mesh

    e = MESH_GP
    g_m, g_k = e["mesh"]
    mesh = make_debug_mesh(g_m, g_k)
    pl = TD.mesh_placements(mesh, ndim=3)
    k = e["points"] ** e["dims"]
    m_loc = e["m"] // g_m
    lengthscales = [0.15, 0.2, 0.25, 0.3, 0.35, 0.4]
    kernels = [KronKernel(_gp_factors(e["dims"], e["points"],
                                      [ls * (1 + 0.25 * i) for ls in lengthscales]))
               for i in range(e["batch"])]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rows = []
    for case, b in (("gp16-mesh-matmul", e["batch"]), ("gp16-mesh-epoch", e["epoch_batch"])):
        bk = BatchedKronKernel.stack(kernels[:b])
        v = randn(gen, (b, e["m"], k), torch.float32)
        vs = TD.sharded_input_batched(v, mesh)
        v_rows = TD._slice_local(v, mesh, _only(pl, 1)).contiguous()
        del v
        op = bk.op.with_mesh(mesh)
        n_slabs = op._resolve_n_slabs(m_loc, 4, op._mesh_batched_plan(b, m_loc, 4, None))
        mvm = _rounds_want(op, m_loc, n_slabs, torch.float32, grad=False, batch=b)
        if case.endswith("matmul"):
            ref = TD._slice_local(bk.matmul(v_rows), mesh, _only(pl, 2))
            y, got, held = _mesh_counted(lambda: bk.matmul(vs, mesh=mesh), mvm, case)
            errs = {"fwd": _rel(y.to_local(), ref)}
            call = lambda: bk.matmul(vs, mesh=mesh)  # noqa: E731
        else:
            mvms = e["cg_iters"] + 1
            want = {n: c * mvms for n, c in mvm.items()}
            xr, rr = gp_train_epoch_batched(bk, v_rows, cg_iters=e["cg_iters"])
            (x, res), got, held = _mesh_counted(
                lambda: gp_train_epoch_batched(bk, vs, cg_iters=e["cg_iters"], mesh=mesh),
                want, case)
            errs = {"x": _rel(x.to_local(), TD._slice_local(xr, mesh, _only(pl, 2))),
                    "residual": _rel(res.to_local(), rr)}
            call = lambda: gp_train_epoch_batched(  # noqa: E731
                bk, vs, cg_iters=e["cg_iters"], mesh=mesh)
        if max(errs.values()) > GP_TOLERANCE:
            raise AssertionError(f"{case}: errors {errs}")
        row = {"case": case, "mesh": [g_m, g_k], "b": b, "m": e["m"], "k": k,
               "rounds": list(op.rounds), "n_slabs": n_slabs, "launches": _nonzero(got),
               "held": held, "rel_err": errs,
               "tol": GP_TOLERANCE, "ms": _mesh_ms(call, 1)}
        rows.append(row)
        del bk, vs, v_rows, op
        torch.cuda.empty_cache()
    return rows


def _mesh_ffn() -> list[dict]:
    """qwen3-4b's Kron FFN block on 4096 bf16 tokens, forward and backward
    inside ``kron_distributed(mesh)`` (every rank holds the activation;
    each projection is two one-factor rounds), against the block without
    the scope; the mesh op's round counters and comm gauges must move."""
    from repro_torch.configs import get_config
    from repro_torch.core.layers import kron_distributed
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.ffn import ffn_apply, ffn_init
    from repro_torch.runtime import telemetry

    mesh = make_debug_mesh(*MESH_FFN["mesh"])
    cfg = dataclasses.replace(get_config(FFN_BLOCK["arch"]), kron_ffn=True, kron_factors=2)
    dtype = FFN_BLOCK["dtype"]
    shape = (FFN_BLOCK["batch"], FFN_BLOCK["seq"], cfg.d_model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    params = ffn_init(gen, cfg, dtype, device="cuda")
    leaves = [f.requires_grad_() for v in params.values() for f in v["factors"]]
    x = randn(gen, shape, dtype).requires_grad_()
    ct = randn(gen, shape, dtype)
    y_ref = ffn_apply(cfg, params, x)
    g_ref = torch.autograd.grad(y_ref, [x, *leaves], ct)
    telemetry.configure(annotate=False)
    with kron_distributed(mesh):
        y, fwd, fwd_held = _mesh_counted(lambda: ffn_apply(cfg, params, x), None,
                                         "ffn-mesh forward")
    gauges = telemetry.comm_summary()
    telemetry.disable()
    g, bwd, bwd_held = _mesh_counted(lambda: torch.autograd.grad(y, [x, *leaves], ct), None,
                                     "ffn-mesh backward")
    errs = {"fwd": _rel(y.detach(), y_ref.detach()),
            "grad": max(_rel(a, b) for a, b in zip(g, g_ref))}
    want_fwd = fwd["a2a_calls"] == 6 and fwd["chain_fwd"] == 6
    want_bwd = bwd["a2a_calls"] == 9 and bwd["sliced_t"] == 6 and bwd["chain_fwd"] == 3
    if not (want_fwd and want_bwd and gauges):
        raise AssertionError(f"ffn-mesh: the mesh op did not run as planned: {fwd} {bwd} {gauges}")
    if errs["fwd"] > FFN_TOLERANCE or errs["grad"] > FFN_GRAD_TOLERANCE:
        raise AssertionError(f"ffn-mesh: errors {errs}")

    def fwd_bwd():
        with kron_distributed(mesh):
            return torch.autograd.grad(ffn_apply(cfg, params, x), [x, *leaves], ct)

    row = {"case": "ffn-mesh", "mesh": list(MESH_FFN["mesh"]), "tokens": shape[0] * shape[1],
           "dtype": "bfloat16", "fwd_launches": _nonzero(fwd), "bwd_launches": _nonzero(bwd),
           "fwd_held": fwd_held, "bwd_held": bwd_held, "comm_rounds_gauged": len(gauges), "rel_err": errs,
           "tol": [FFN_TOLERANCE, FFN_GRAD_TOLERANCE], "fwd_bwd_ms": _mesh_ms(fwd_bwd, 2)}
    del params, leaves, x, ct, y, g, y_ref, g_ref
    torch.cuda.empty_cache()
    return [row]


def _mesh_ladder() -> list[dict]:
    """The mesh ladder under ``chaos.inject`` (the same spec fires on every
    rank): ``collective`` ends on the local rung, bitwise equal to the
    local op; ``slab_collective`` on the serial rounds, bitwise equal to
    the planned serial call; ``round_chain`` runs each round's factors as
    ``sliced`` launches, still one all-to-all per round and slab (1e-5).
    One GuardWarning per key; the health report names the errors."""
    import warnings

    from repro_torch.core import KronOp
    from repro_torch.core import distributed as TD
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import chaos, guard

    c = MESH_LADDER
    mesh = make_debug_mesh(*c["mesh"])
    pl = TD.mesh_placements(mesh)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    x = randn(gen, (c["m"], math.prod(c["ps"])), torch.float32)
    fs = [randn(gen, (p, p), torch.float32) for p in c["ps"]]
    local = TD._slice_local(KronOp(c["ps"], c["ps"])(x, fs), mesh, pl)
    xs = TD.sharded_input(x, mesh)
    serial_op = KronOp(c["ps"], c["ps"], mesh=mesh, n_slabs=1)
    serial = serial_op(xs, fs).to_local()
    n, n_r = c["n_slabs"], len(serial_op.rounds)
    rows = []
    for spec, want_calls in (("collective", 0), ("slab_collective", n_r),
                             ("round_chain", n_r * n)):
        guard.reset_health()
        op = KronOp(c["ps"], c["ps"], mesh=mesh, n_slabs=n)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with chaos.inject(spec):
                y, got, held = _mesh_counted(lambda: op(xs, fs), None, f"mesh-ladder {spec}")
        y = y.to_local()
        warned = [str(w.message) for w in caught if issubclass(w.category, guard.GuardWarning)]
        report = guard.health_report()
        row = {"case": f"mesh-ladder-{spec}", "launches": _nonzero(got), "held": held,
               "warnings": len(warned),
               "health": report["ops"], "events": report["events"],
               "describe": op.describe()}
        if spec == "collective":
            row["bitwise_local"] = torch.equal(y, local)
            ok = row["bitwise_local"] and got["a2a_calls"] == 0 and len(warned) == 2
        elif spec == "slab_collective":
            row["bitwise_serial"] = torch.equal(y, serial)
            ok = row["bitwise_serial"] and got["a2a_calls"] == want_calls and len(warned) == 1
        else:
            row["rel_err"] = {"fwd": _rel(y, serial)}
            ok = (row["rel_err"]["fwd"] <= MESH_TOL and got["a2a_calls"] == want_calls
                  and got["sliced"] == n * len(c["ps"]) and got["chain_fwd"] == 0
                  and len(warned) == n_r)
        if not ok:
            raise AssertionError(f"mesh-ladder {spec}: {row} {warned}")
        rows.append(row)
    guard.reset_health()
    if chaos.active():
        raise AssertionError("mesh-ladder: chaos left active")
    return rows


def _mesh_measure(cache: str) -> list[dict]:
    """``KronOp(batch=B, shared_factors=False, mesh=..., tune="measure")`` at
    gp16 on (2, 2) (``MESH_MEASURE``): each candidate n_slabs with its time
    (the slowest rank's), the winner and the key; a second construction
    hits the cache."""
    from repro_torch.core import KronOp, autotune
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import telemetry

    c = MESH_MEASURE
    mesh = make_debug_mesh(*c["mesh"])
    torch.cuda.empty_cache()
    telemetry.configure(annotate=False)

    def make():
        return KronOp(c["ps"], c["ps"], m=None, batch=c["batch"], shared_factors=False,
                      mesh=mesh, tune="measure", cache_path=cache)

    t0 = time.perf_counter()
    plan = make().plan
    measure_s = time.perf_counter() - t0
    hits = _telemetry_counter("plan_cache.hit")
    again = make().plan
    hit = _telemetry_counter("plan_cache.hit") - hits
    telemetry.disable()
    entries = autotune.load_plan_cache(cache)
    (key, entry), = entries.items()
    card = torch.cuda.get_device_name(0)
    row = {"case": "mesh-measure", "mesh": list(c["mesh"]), "b": c["batch"], "m": c["m"],
           "candidates": dict(zip(entry["candidates"],
                                  [s * 1e3 for s in entry["candidate_seconds"]])),
           "winner": plan.describe(), "n_slabs": plan.n_slabs, "key": key,
           "second_construction_hit": hit, "measure_s": measure_s}
    if not (key.endswith(f";dev={card};gk={c['mesh'][1]}") and hit == 1 and again == plan):
        raise AssertionError(f"mesh-measure: {row}")
    row.update(_mesh_winner(make(), mesh))
    return [row]


def _mesh_winner(op, mesh) -> dict:
    """The measured plan once forward and backward (the per-sample mesh
    backward: chain-of-one ``chain_fwd`` and ``chain_bwd``), its launches
    counted and held against their twins, its results against the same
    mesh op on the plain path (``backend="torch"``, same slab count)."""
    from repro_torch.core import KronOp
    from repro_torch.core import distributed as TD

    c = MESH_MEASURE
    b, m, k = c["batch"], c["m"], math.prod(c["ps"])
    m_loc = m // c["mesh"][0]
    n_slabs = op._resolve_n_slabs(m_loc, 4, op.plan)
    pl = TD.mesh_placements(mesh, ndim=3)
    shape = (b, m, k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)  # the same factors on every rank
    fs = [randn(gen, (b, p, p), torch.float32) / 4 for p in c["ps"]]
    gen.manual_seed(150 + torch.distributed.get_rank())  # each rank's shard of x and ct
    local = (b, m_loc, k // c["mesh"][1])
    xs = TD._from_local(randn(gen, local, torch.float32), mesh, pl, shape).requires_grad_()
    cts = TD._from_local(randn(gen, local, torch.float32), mesh, pl, shape)

    def run(o, count: bool):
        fl = [f.clone().requires_grad_() for f in fs]
        if count:
            y, fwd, fwd_held = _mesh_counted(lambda: o(xs, fl), _rounds_want(
                o, m_loc, n_slabs, torch.float32, grad=False, batch=b), "mesh-measure forward")
            g, bwd, bwd_held = _mesh_counted(
                lambda: torch.autograd.grad(y, (xs, *fl), cts),
                _rounds_want(o, m_loc, n_slabs, torch.float32, grad=True, batch=b),
                "mesh-measure backward")
            counts.update(fwd_launches=_nonzero(fwd), bwd_launches=_nonzero(bwd),
                          fwd_held=fwd_held, bwd_held=bwd_held)
        else:
            y = o(xs, fl)
            g = torch.autograd.grad(y, (xs, *fl), cts)
        return (y.to_local().detach(), g[0].to_local(), *g[1:])

    counts: dict = {}
    torch.cuda.reset_peak_memory_stats()
    got = run(op, True)
    # This rank's peak over the per-sample mesh forward and backward,
    # against the reference's per-device buffers for the same call
    # (tools/reference_mesh_memory.py).
    counts["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    plain = run(KronOp(c["ps"], c["ps"], batch=b, shared_factors=False, mesh=mesh,
                       n_slabs=n_slabs, backend="torch"), False)
    errs = {"fwd": _rel(got[0], plain[0]), "dx": _rel(got[1], plain[1]),
            "df": max(_rel(a, r) for a, r in zip(got[2:], plain[2:]))}
    del got, plain, xs, cts
    torch.cuda.empty_cache()
    if errs["fwd"] > MESH_TOL or max(errs["dx"], errs["df"]) > MESH_GRAD_TOL:
        raise AssertionError(f"mesh-measure winner against backend='torch': {errs}")
    return {"winner_n_slabs": n_slabs, **counts, "rel_err": errs}


def _mesh_probe() -> list[dict]:
    """Phase 12's first call on the card: one all-to-all of CUDA tensors over
    gloo, and the time of one of 64 MiB."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    send = torch.arange(world * 2, device="cuda", dtype=torch.float32) + 100 * rank
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, async_op=True).wait()
    want = torch.tensor([100 * r + 2 * rank + j for r in range(world) for j in range(2)],
                        device="cuda", dtype=torch.float32)
    if not torch.equal(recv, want):
        raise AssertionError(f"gloo all_to_all_single of CUDA tensors: {recv.tolist()}")
    big = torch.empty(64 * 2 ** 20 // 4, device="cuda")
    t0 = time.perf_counter()
    dist.all_to_all_single(torch.empty_like(big), big)
    torch.cuda.synchronize()
    return [{"case": "gloo-probe", "a2a_cuda": "ok",
             "a2a_64mib_ms": (time.perf_counter() - t0) * 1e3}]


def _mesh_checks(out_dir: str) -> list:
    """Phase 12's checks, in order: (name, fn) with fn() -> rows."""
    cache = os.path.join(out_dir, "plans.json")
    return [("probe", _mesh_probe),
            *((f"fig11-{s[0]}x{s[1]}", lambda s=s: _mesh_fig11(s)) for s in MESH_FIG11["meshes"]),
            ("gp16", _mesh_gp), ("ffn", _mesh_ffn), ("ladder", _mesh_ladder),
            ("measure", lambda: _mesh_measure(cache))]


def _mesh_rank(rank: int, world: int, store: str, out_dir: str, phase: str = "mesh") -> None:
    """One rank of phase 12 (``phase="mesh"``) or 13 (``"shard"``): a gloo
    process group over a ``file://`` store, every check of the phase, its
    rows written to ``rank<r>.json``; a failure writes its traceback to
    ``rank<r>.err`` and exits 1."""
    import datetime
    import traceback

    import torch.distributed as dist

    out = Path(out_dir)
    # Four ranks share the card's memory: expandable segments keep each
    # rank's cache from holding it in fragments (set before CUDA starts).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        checks = _mesh_checks(out_dir) if phase == "mesh" else _shard_checks(out_dir)
        rows, timings = [], {}
        for name, fn in checks:
            t0 = time.perf_counter()
            rows += fn()
            timings[name] = time.perf_counter() - t0
            # Written after every check, so a later failure still shows these.
            (out / f"rank{rank}.json").write_text(json.dumps(rows))
        rows.append({"case": "timings", "seconds": timings})
        (out / f"rank{rank}.json").write_text(json.dumps(rows))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)


def _run_ranks(phase: str) -> list[list[dict]]:
    """MESH_RANKS processes on the one card (``spawn``, since this process
    holds a CUDA context), each ``torch.cuda.set_device(0)``, in a gloo
    process group, running ``_mesh_rank(..., phase)``; every rank's rows.  A
    rank's failure prints its traceback and fails the phase."""
    import gc

    import torch.multiprocessing as mp

    # The ranks share the card with this process: what earlier phases left
    # (collected garbage included) is freed first, and what stays is shown.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{phase}: this process holds {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
          f"({torch.cuda.memory_reserved() / 2 ** 30:.3f} reserved) as the ranks start",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _mesh_rank, args=(MESH_RANKS, os.path.join(tmp, "store"), tmp, phase),
            nprocs=MESH_RANKS, start_method="spawn", join=False)
        deadline = time.monotonic() + MESH_TIMEOUT_S
        failure = None
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    failure = f"timed out after {MESH_TIMEOUT_S} s"
                    break
        except Exception as e:  # a rank exited non-zero; the others are stopped
            failure = f"{type(e).__name__}: {e}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        errs = sorted(Path(tmp).glob("rank*.err"))
        if failure or errs:
            done = Path(tmp) / "rank0.json"
            for row in json.loads(done.read_text()) if done.exists() else []:
                print(f"{phase} (rank 0, before the failure) " + json.dumps(row), flush=True)
            for e in errs:
                print(f"{phase}: {e.stem} failed:\n{e.read_text()}", file=sys.stderr, flush=True)
            raise AssertionError(f"{phase} phase: {failure or 'a rank failed'}")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(MESH_RANKS)]


def _merge_ranks(phase: str, per_rank: list[list[dict]], smi: str) -> tuple[list[dict], dict]:
    """One line per check: rank 0's row, the launches of every rank asserted
    equal (and summed over the ranks), the slowest rank's times, the worst
    rank's errors, every rank's peak memory."""
    launches = {name: 0 for name, _, _ in _counter_sites()}
    rows = []
    for i, row in enumerate(per_rank[0]):
        others = [rr[i] for rr in per_rank]
        for key in ("launches", "fwd_launches", "bwd_launches"):
            if key in row:
                if any(o[key] != row[key] for o in others):
                    raise AssertionError(f"{phase} {row['case']}: ranks differ in {key}: "
                                         f"{[o[key] for o in others]}")
                for name, cnt in row[key].items():
                    if name in launches:
                        launches[name] += cnt * MESH_RANKS
        for key in ("held", "fwd_held", "bwd_held"):
            if key in row:
                if any({k: (v["launches"], v["rows"]) for k, v in o[key].items()}
                       != {k: (v["launches"], v["rows"]) for k, v in row[key].items()}
                       for o in others):
                    raise AssertionError(f"{phase} {row['case']}: ranks differ in {key}")
                for name, v in row[key].items():
                    v["rel_err"] = max(o[key][name]["rel_err"] for o in others)
        for key in ("ms", "fwd_ms", "fwd_bwd_ms", "a2a_64mib_ms", "step_ms",
                    "all_gather_64mib_ms"):
            if key in row:
                row[key] = max(o[key] for o in others)  # the slowest rank's
        if "rel_err" in row:
            row["rel_err"] = {k: max(o["rel_err"][k] for o in others) for k in row["rel_err"]}
        if "peak_gib" in row:
            row["peak_gib"] = [o["peak_gib"] for o in others]  # every rank's
        row.update(ranks=MESH_RANKS, ranks_share_one_card=True, times=MESH_NOTE, device=smi)
        print(f"{phase} " + json.dumps(row), flush=True)
        rows.append(row)
    return rows, launches


def run_mesh(smi: str) -> tuple[list[dict], dict]:
    """Phase 12: MESH_RANKS ranks on the one card in a gloo process group:
    fig11 on (1, 4) and (2, 2), gp16-mesh, ffn-mesh, mesh-ladder,
    mesh-measure.  Returns the rows and the launches of the mesh calls
    summed over the ranks."""
    t0 = time.perf_counter()
    rows, launches = _merge_ranks("mesh", _run_ranks("mesh"), smi)
    print(f"mesh: phase {time.perf_counter() - t0:.1f} s of command time ({MESH_RANKS} ranks, "
          f"gloo, {smi})", flush=True)
    return rows, launches


# ---------------------------------------------------------------------------
# Phase 13: the model stack sharded over the mesh (the ranks share the card)
# ---------------------------------------------------------------------------

SHARD_MESH = (2, 2)
# (a) qwen3-4b with its Kron FFN, an f32 copy at full width cut to 4 layers:
# one AdamW step and one Shampoo refresh step sharded, against the port's
# single-rank step on the card from the same parameters and tokens: the
# loss (1e-5), every gradient (as AdamW's first moment after step 1 holds
# it) and every updated parameter (1e-4 of max|ref|).  eps at 1e-3 keeps the
# first Adam step a smooth function of the gradient (at 1e-8 it is sign(g),
# which flips where g sits at the summation-order noise floor).
SHARD_PARITY = {"layers": 4, "batch": 4, "seq": 128, "seed": 21, "lr": 1e-3, "eps": 1e-3,
                "warmup_steps": 1, "precond_every": 2}
SHARD_LOSS_TOL, SHARD_TOL = 1e-5, 1e-4
# (b) the same model in bf16 at full width and depth (36 layers: a step at
# 12 took 5.6 s, so the phase stays near its 150 s): a counted step with
# every launch held against its twin, then a timed one.
SHARD_BF16 = {"layers": 36, "batch": 4, "seq": 1024, "seed": 22, "lr": 1e-3,
              "warmup_steps": 2}
# (c) the training launcher on qwen3-4b at its published widths, (a)'s f32
# copy cut to 4 layers: two steps and a checkpoint, then --resume.  Each
# save gathers one leaf at a time, in pieces that go to the host: a rank's
# card holds its state and less than SHARD_SAVE_LEAVES whole leaves.
SHARD_TRAIN_ARGV = ["--arch", "qwen3-4b", "--layers", "4", "--dtype", "float32",
                    "--kron-ffn", "--steps", "2", "--batch", "4", "--seq", "128",
                    "--want-model-parallel", "2", "--log-every", "1"]
SHARD_SAVE_LEAVES = 1.0
# (d) the serving launcher one-shot, an f32 copy of qwen3-4b cut to 4 layers,
# local and with --distributed: greedy tokens equal, prefill logits 1e-3.
SHARD_SERVE_ARGV = ["--arch", "qwen3-4b", "--layers", "4", "--dtype", "float32",
                    "--kron-ffn", "--batch", "4", "--prompt-len", "32", "--gen", "4"]
SHARD_SERVE_TOL = 1e-3
SHARD_HELD = tuple(HELD_WRAPPERS)


def _shard_checks(out_dir: str) -> list:
    """Phase 13's checks, in order: (name, fn) with fn() -> rows."""
    return [("probe", _shard_probe), ("parity", _shard_parity), ("bf16", _shard_bf16),
            ("train-launcher", lambda: _shard_train_launcher(out_dir)),
            ("serve-launcher", _shard_serve_launcher)]


def _shard_probe() -> list[dict]:
    """The collectives the sharded stack moves CUDA tensors with, probed
    first: ``all_reduce`` and ``all_gather_into_tensor`` over the world and
    over one mesh dim's group each, and the time of a 64 MiB all-gather."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import sharding as S

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_debug_mesh(*SHARD_MESH)
    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    if not bool((t == world * (world + 1) / 2).all()):
        raise AssertionError(f"gloo all_reduce of CUDA tensors: {t.tolist()}")
    src = torch.arange(3, device="cuda", dtype=torch.float32) + 10 * rank
    buf = torch.empty(3 * world, device="cuda")
    S._all_gather(buf, src)
    want = torch.cat([torch.arange(3, device="cuda", dtype=torch.float32) + 10 * r
                      for r in range(world)])
    if not torch.equal(buf, want):
        raise AssertionError(f"gloo all_gather_into_tensor of CUDA tensors: {buf.tolist()}")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for axis in mesh.mesh_dim_names:  # over each mesh dim's group
        n = S._dim_size(mesh, axis)
        v = torch.full((2,), float(coord[axis]), device="cuda")
        S._all_reduce(v, mesh, (axis,))
        g = S._join(torch.full((1, 2), float(coord[axis]), device="cuda"), mesh, [(0, (axis,))])
        if not (bool((v == n * (n - 1) / 2).all())
                and torch.equal(g[:, 0], torch.arange(n, device="cuda", dtype=torch.float32))):
            raise AssertionError(f"collectives over {axis}: {v.tolist()} {g.tolist()}")
    big = torch.empty(64 * 2 ** 20 // 4 // world, device="cuda")
    out = torch.empty(big.numel() * world, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    S._all_gather(out, big)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # what the collective itself allocates on the card, in outputs
    staged = (torch.cuda.max_memory_allocated() - base) / (out.numel() * out.element_size())
    return [{"case": "shard-probe", "all_reduce_cuda": "ok", "all_gather_cuda": "ok",
             "mesh_dim_groups": "ok", "all_gather_64mib_ms": ms,
             "all_gather_card_bytes_per_output_byte": staged}]


def _shard_cfg(layers: int, dtype: str):
    return dataclasses.replace(train_cfg(), n_layers=layers, dtype=dtype)


def _shard_tokens(cfg, c) -> dict:
    """The global batch (every rank the same, from the case's seed)."""
    g = torch.Generator().manual_seed(c["seed"])
    t = torch.randint(0, cfg.vocab, (2, c["batch"], c["seq"]), generator=g,
                      dtype=torch.int32).cuda()
    return {"tokens": t[0], "labels": t[1]}


def _shard_want(cfg, c, opt_cfg) -> dict:
    """One sharded step's launches per rank: the model's on this rank's rows
    of the batch, Shampoo's on the whole eligible leaves."""
    from repro_torch.models import model as TM
    from repro_torch.optim import ShampooConfig
    from repro_torch.optim.shampoo import shape_groups

    groups = (shape_groups(TM.init_params(cfg, None, device="meta"), opt_cfg)
              if isinstance(opt_cfg, ShampooConfig) else {})
    model, opt = train_expected(cfg, groups, batch=c["batch"] // SHARD_MESH[0], seq=c["seq"])
    return _mesh_expect(**{k: model[k] + opt[k] for k in model})


def _release() -> None:
    """Free what a case left: its reference cycles (an autograd graph held
    by a closure keeps a whole step's tensors), then the cached blocks. Four
    ranks share the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _all_ranks(ok: bool) -> bool:
    import torch.distributed as dist

    t = torch.tensor([int(ok)])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _shard_parity() -> list[dict]:
    """(a): the sharded AdamW step and Shampoo refresh step against the
    single-rank step on the card (rank 0 runs it first, alone), every launch
    counted and held against its twin."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as TM
    from repro_torch.optim import OptConfig, ShampooConfig
    from repro_torch.runtime import sharding as S
    from repro_torch.train import steps as TT

    c = SHARD_PARITY
    mesh = make_debug_mesh(*SHARD_MESH)
    cfg = _shard_cfg(c["layers"], "float32")
    rank = dist.get_rank()
    batch = _shard_tokens(cfg, c)
    p_sh = tree.leaves(TM.param_layout(cfg, mesh))
    rows = []
    for name in ("adamw", "shampoo"):
        kw = dict(lr=c["lr"], eps=c["eps"], warmup_steps=c["warmup_steps"])
        oc = (ShampooConfig(precond_every=c["precond_every"], **kw) if name == "shampoo"
              else OptConfig(**kw))

        def init(on_mesh):
            g = torch.Generator(device="cuda")
            g.manual_seed(c["seed"])
            return TT.train_state_init(cfg, oc, g, device="cuda", mesh=on_mesh)

        ref = None
        if rank == 0:  # the single-rank step, while the others wait; kept on the host
            state = init(None)
            new, metrics = TT.make_train_step(cfg, oc)(state, batch)
            ref = (float(metrics["loss"]), [t.cpu() for t in tree.leaves(new.params)],
                   [t.cpu() for t in tree.leaves(new.opt["m"])])
            del state, new, metrics
            _release()
        dist.barrier()
        state = init(mesh)
        torch.cuda.reset_peak_memory_stats()
        step = TT.make_train_step(cfg, oc, mesh=mesh)
        (new, metrics), got, held = _mesh_counted(
            lambda: step(state, batch), _shard_want(cfg, c, oc), f"shard-parity {name}",
            kernels=SHARD_HELD)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        shapes = all(tuple(p.shape) == tuple(m.shape) == sh.shard_shape()
                     for p, m, sh in zip(tree.leaves(new.params), tree.leaves(new.opt["m"]), p_sh))
        errs = torch.zeros(3, dtype=torch.float64)  # loss, gradients (m), parameters
        # (index in errs, this rank's leaves, index of the reference's in ref)
        pairs = ((1, tree.leaves(new.opt["m"]), 2), (2, tree.leaves(new.params), 1))
        for i, sh in enumerate(p_sh):  # one whole leaf on the card at a time
            for k, leaves, j in pairs:
                full = S.gather_shards(leaves[i], sh)
                if rank == 0:
                    errs[k] = max(float(errs[k]), _rel(full, ref[j][i].cuda()))
                del full
        if rank == 0:
            errs[0] = abs(float(metrics["loss"]) - ref[0]) / max(1.0, abs(ref[0]))
        dist.broadcast(errs, 0)
        del ref, state, new
        _release()
        row = {"case": f"shard-parity-{name}", "mesh": list(SHARD_MESH), "layers": c["layers"],
               "dtype": "float32", "batch": c["batch"], "seq": c["seq"],
               "loss": float(metrics["loss"]), "launches": _nonzero(got), "held": held,
               "rel_err": {"loss": float(errs[0]), "grad": float(errs[1]),
                           "param": float(errs[2])},
               "shard_shapes_ok": _all_ranks(shapes), "peak_gib": peak}
        if not (row["shard_shapes_ok"] and errs[0] <= SHARD_LOSS_TOL
                and errs[1] <= SHARD_TOL and errs[2] <= SHARD_TOL):
            raise AssertionError(f"shard-parity {name}: {row}")
        rows.append(row)
    return rows


def _shard_bf16() -> list[dict]:
    """(b): qwen3-4b in bf16 at full width, ``SHARD_BF16["layers"]`` deep:
    one AdamW step counted (launches per rank against the plans'
    prediction) with every launch held against its twin, then one timed."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps as TT

    c = SHARD_BF16
    mesh = make_debug_mesh(*SHARD_MESH)
    cfg = _shard_cfg(c["layers"], "bfloat16")
    oc = OptConfig(lr=c["lr"], warmup_steps=c["warmup_steps"])
    g = torch.Generator(device="cuda")
    g.manual_seed(c["seed"])
    _release()
    torch.cuda.reset_peak_memory_stats()
    state = TT.train_state_init(cfg, oc, g, device="cuda", mesh=mesh)
    batch = _shard_tokens(cfg, c)
    step = TT.make_train_step(cfg, oc, mesh=mesh)
    want = _shard_want(cfg, c, oc)
    (state, m1), got, held = _mesh_counted(lambda: step(state, batch), want,
                                           "shard-bf16 step 1", kernels=SHARD_HELD)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    state, m2 = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    losses = [float(m1["loss"]), float(m2["loss"])]
    row = {"case": "shard-bf16", "mesh": list(SHARD_MESH), "layers": c["layers"],
           "dtype": "bfloat16", "batch": c["batch"], "seq": c["seq"],
           "launches": _nonzero(got), "want": _nonzero(want), "held": held,
           "loss": losses, "step_ms": step_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state
    _release()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"shard-bf16: {row}")
    return [row]


def _shard_train_launcher(out_dir: str) -> list[dict]:
    """(c): ``launch.train --want-model-parallel 2`` on the world the phase
    runs in, two steps and a checkpoint (gathered, rank 0 writes), then
    ``--resume``: every rank's restored shards bitwise equal to the ones it
    saved, and every save within ``SHARD_SAVE_LEAVES`` whole leaves of the
    card's memory over the rank's state."""
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as TL

    saves = []
    orig = CheckpointManager.save

    def save(self, step, state, *, shardings=None):  # the launcher's saves, measured
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        orig(self, step, state, shardings=shardings)
        torch.cuda.synchronize()
        leaf = max(math.prod(sh.shape or t.shape) * t.element_size()
                   for t, sh in zip(tree.leaves(state), tree.leaves(shardings)))
        saves.append({"s": time.perf_counter() - t0, "largest_leaf_gib": leaf / 2 ** 30,
                      "state_gib": base / 2 ** 30,
                      "over_state_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30})

    argv = SHARD_TRAIN_ARGV + ["--ckpt-dir", os.path.join(out_dir, "train-ckpt")]
    CheckpointManager.save = save
    try:
        saved, got, held = _mesh_counted(lambda: TL.main(argv), None, "shard train launcher",
                                         kernels=SHARD_HELD)
        _release()
        back = TL.main(argv + ["--resume"])
    finally:
        CheckpointManager.save = orig
    same = [torch.equal(a, b) for a, b in zip(tree.leaves(back._asdict()),
                                              tree.leaves(saved._asdict()))]
    step = int(back.step)
    del saved, back
    _release()
    lean = all(v["over_state_gib"] <= SHARD_SAVE_LEAVES * v["largest_leaf_gib"] for v in saves)
    row = {"case": "shard-train-launcher", "argv": argv, "launches": _nonzero(got),
           "held": held, "step": step, "leaves": len(same),
           "restored_bitwise": _all_ranks(all(same)), "saves": saves,
           "save_within_leaves": _all_ranks(lean)}
    if not (row["restored_bitwise"] and row["save_within_leaves"] and step == 2
            and len(saves) == 2 and got["chain_fwd"] and got["grad"]):
        raise AssertionError(f"shard train launcher: {row}")
    return [row]


def _shard_serve_launcher() -> list[dict]:
    """(d): ``launch.serve --distributed --kron-ffn`` one-shot against the
    same launcher without it: greedy tokens equal, prefill logits within
    ``SHARD_SERVE_TOL``, every launch of the distributed run held against
    its twin; ``ServeEngine.prewarm(mesh=)`` builds the mesh ops."""
    from repro_torch.launch import serve as TServe
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.scheduler import SchedulerConfig
    from repro_torch.models import model as TM

    local = TServe.main(SHARD_SERVE_ARGV)
    argv = SHARD_SERVE_ARGV + ["--distributed", "--want-model-parallel", str(SHARD_MESH[1])]
    out, got, held = _mesh_counted(lambda: TServe.main(argv), None, "shard serve launcher",
                                   kernels=SHARD_HELD)
    same = torch.equal(out["tokens"], local["tokens"])
    err = _rel(out["prefill_logits"], local["prefill_logits"])
    cfg = dataclasses.replace(_shard_cfg(4, "float32"), kron_ffn=True)
    mesh = make_debug_mesh(*SHARD_MESH)
    eng = TServe.ServeEngine(cfg, TM.init_params(cfg, None, device="meta"),
                             SchedulerConfig(buckets=(32,), max_slots=4, max_prefill=2),
                             max_new=4)
    mesh_ops = sum(op.mesh == mesh for op in eng.prewarm(mesh=mesh))
    row = {"case": "shard-serve-launcher", "argv": argv, "launches": _nonzero(got),
           "held": held, "tokens_equal": same, "rel_err": {"prefill_logits": err},
           "prewarm_mesh_ops": mesh_ops}
    if not (same and err <= SHARD_SERVE_TOL and mesh_ops == 2 and got["a2a_calls"]
            and got["chain_fwd"]):
        raise AssertionError(f"shard serve launcher: {row}")
    return [row]


def run_shard(smi: str) -> tuple[list[dict], dict]:
    """Phase 13: the model stack sharded over a (2, 2) mesh of MESH_RANKS
    ranks on the one card (gloo): (a) parity, (b) bf16, (c) the training
    launcher, (d) the serving launcher.  Returns the rows and the launches
    of the phase summed over the ranks."""
    t0 = time.perf_counter()
    rows, launches = _merge_ranks("shard", _run_ranks("shard"), smi)
    print(f"shard: phase {time.perf_counter() - t0:.1f} s of command time ({MESH_RANKS} ranks, "
          f"gloo, {smi})", flush=True)
    return rows, launches


# ---------------------------------------------------------------------------
# Phase 14: the dry-run tooling held against the card
# ---------------------------------------------------------------------------

# (a) qwen3-4b's three published cells on the (16, 16) production mesh, and
# train_4k once more with phase 10's Kron FFN (train_cfg()): (shape, Kron FFN).
DRYRUN_CELLS = (("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
                ("train_4k", True))
DRYRUN_DEVICE = "cuda"  # the fake tensors' device
# A dry-run launches nothing and may leave at most this much allocated on
# the card (its process's CUDA context aside, which memory_allocated omits).
DRYRUN_CARD_BYTES = 64 * 2 ** 20
# (b) phase 10's AdamW step (train_cfg(), TRAIN's batch): counted FLOPs, dot
# FLOPs and HBM bytes of the card's step against the dry-run's, relative; the
# dry-run's peak against the card's peak of the same step.
DRYRUN_COUNT_RTOL = 1e-9
DRYRUN_PEAK_RATIO = (0.8, 1.25)
DRYRUN_TIMEOUT_S = 600


def planned_kron_flops(cfg, rows: int, passes: int) -> float:
    """FLOPs of the Kron FFN's kernels in ``passes`` forward-and-backward
    passes over ``rows`` rows each, from the plans' stage programs.  Per
    KronLinear (w1 and w3 up, w2 down; each layer) of n stages: the chain
    forward, again in the remat re-forward, the first n-1 stages once more
    for the stage inputs of the backward, and each stage's backward (dF and
    dx, twice the chain, plus its chain re-run up to the last factor)."""
    from repro_torch.core.engine import _lowered, kron_op_for
    from repro_torch.core.layers import KronLinearSpec
    from repro_torch.kernels.emit import chain_flops

    up = KronLinearSpec.balanced(cfg.d_model, cfg.d_ff, cfg.kron_factors)
    down = KronLinearSpec.balanced(cfg.d_ff, cfg.d_model, cfg.kron_factors)
    per_layer = 0
    for spec in (up, up, down):
        op = kron_op_for(spec.ps, spec.qs, backend="auto", plan="auto")
        prog = _lowered(op._single_plan(rows, getattr(torch, cfg.dtype).itemsize), op.ps, op.qs)
        k, fwd, bwd = math.prod(spec.ps), [], 0
        for ins in prog.instrs:
            fwd.append(chain_flops(1, rows, k, ins.ps, ins.qs))
            bwd += 2 * fwd[-1] + chain_flops(1, rows, k, ins.ps[:-1], ins.qs[:-1])
            k = k // ins.pprod * ins.qprod
        per_layer += (2 if cfg.remat else 1) * sum(fwd) + sum(fwd[:-1]) + bwd
    return float(passes * cfg.n_layers * per_layer)


def _cost_row(cost) -> dict:
    return {"flops": cost.flops, "dot_flops": cost.dot_flops, "bytes": cost.bytes_accessed,
            "collective_counts": cost.collective_counts, "kernel_flops": cost.kernel_flops}


def dryrun_job(job: str) -> dict:
    """One process's share of phase 14.  ``cell:<i>``: DRYRUN_CELLS[i] dry-run
    on the production mesh; ``step-fake``: phase 10's AdamW step dry-run in a
    one-rank world; ``step-card``: the same step on the card under
    ``hlo_cost.CostMode``, through the kernels and through their twins
    (``backend="torch"``), with the peak memory of the first."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.optim import OptConfig

    t = TRAIN
    ad_cfg = OptConfig(lr=t["lr"], warmup_steps=t["warmup_steps"])
    reset_counters()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if job.startswith("cell:"):
        shape, kron = DRYRUN_CELLS[int(job[5:])]
        cfg = train_cfg() if kron else get_config("qwen3-4b")
        out = dryrun.run_cell("qwen3-4b", shape, False, None, device=DRYRUN_DEVICE, cfg=cfg)
        out["fmt_row"] = dryrun.fmt_row(out)
        if kron:  # every microbatch of this rank's rows
            rows = dryrun.SHAPES[shape].global_batch // 16 // out["microbatches_per_rank"]
            out["planned_kron_flops"] = planned_kron_flops(
                cfg, rows * dryrun.SHAPES[shape].seq_len, out["microbatches_per_rank"])
    elif job == "step-fake":
        out = dryrun.run_cell(
            "qwen3-4b", "train_4k", False, None, device=DRYRUN_DEVICE, mesh_shape=(1, 1),
            cfg=train_cfg(), shape=ShapeSpec("phase10", t["seq"], t["batch"], "train"),
            opt_cfg=ad_cfg, microbatches=1)
        out["fmt_row"] = dryrun.fmt_row(out)
    elif job == "step-card":
        out = _dryrun_card_steps(ad_cfg)
    else:
        raise ValueError(f"unknown phase-14 job {job!r}")
    out["job_s"] = time.perf_counter() - t0
    out["launches_moved"] = {k: v for k, v in read_counters().items() if v}
    out["card_bytes_grown"] = torch.cuda.memory_allocated() - mem0
    return out


def _dryrun_card_steps(ad_cfg) -> dict:
    """Phase 10's AdamW step from a fresh state on the card, under
    ``CostMode``: through the kernels (peak memory with the stats reset just
    before it, launches) and through the twins."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import opt_init
    from repro_torch.runtime.hlo_cost import CostMode
    from repro_torch.train import TrainState, make_train_step

    t = TRAIN
    cfg = train_cfg()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(t["seed"])
    params = M.init_params(cfg, gen, device="cuda")
    state = TrainState(params, opt_init(params, ad_cfg), torch.zeros((), dtype=torch.int32))
    toks, labels = SyntheticLM(vocab=cfg.vocab, seq_len=t["seq"], batch=t["batch"],
                               seed=t["seed"], device="cuda").global_batch(0)
    batch = {"tokens": toks, "labels": labels}
    out = {}
    for backend in ("auto", "torch"):
        step = make_train_step(cfg, ad_cfg, backend=backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        with CostMode() as cm:
            new_state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out[backend] = {**_cost_row(cm.cost), "loss": float(metrics["loss"]),
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "launches": {k: v for k, v in read_counters().items() if v}}
        del new_state, metrics
        torch.cuda.empty_cache()
    reset_counters()
    del state, params
    torch.cuda.empty_cache()
    out["total_memory"] = torch.cuda.get_device_properties(0).total_memory
    return out


def _dryrun_jobs() -> list[str]:
    return [f"cell:{i}" for i in range(len(DRYRUN_CELLS))] + ["step-fake", "step-card"]


def _run_dryrun_jobs(out_dir: str) -> dict:
    """Every phase-14 job in its own process, all at once (no fake world
    meets another process's process group); their results by job."""
    procs = {}
    for job in _dryrun_jobs():
        out = os.path.join(out_dir, job.replace(":", "-"))
        log = open(out + ".log", "w")
        procs[job] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-job", job, out + ".json"],
            stdout=log, stderr=subprocess.STDOUT), log, out)
    failed = []
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    for job, (proc, log, out) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(job)
    if failed:
        for job in failed:
            with open(procs[job][2] + ".log") as f:
                print(f"dryrun: job {job} failed:\n{f.read()[-4000:]}", file=sys.stderr)
        raise AssertionError(f"dryrun: jobs {failed} failed")
    results = {}
    for job, (_, _, out) in procs.items():
        with open(out + ".json") as f:
            results[job] = json.load(f)
    return results


def _rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def run_dryrun(smi: str, step_ms: float | None) -> dict:
    """Phase 14: (a) the DRYRUN_CELLS on fake CUDA tensors in a fake world of
    256 ranks: each record, no launch, at most DRYRUN_CARD_BYTES left on the
    card, the Kron cell's kernel FLOPs those of its plans; (b) phase 10's
    AdamW step counted on the card against its dry-run in a one-rank world
    (FLOPs, dot FLOPs, HBM bytes, collectives), ``dryrun.HBM_PER_CHIP``
    against the card's memory, the twins' dot FLOPs against the kernels',
    the dry-run's peak against the card's, and ``step_ms`` (phase
    10's AdamW step ms; None when phase 10 did not run) against the
    roofline's largest term."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        res = _run_dryrun_jobs(out_dir)
    wall = time.perf_counter() - t0
    failures = []
    for i, (shape, kron) in enumerate(DRYRUN_CELLS):
        rec = res[f"cell:{i}"]
        print(f"dryrun: {rec['fmt_row']}{' (kron_ffn)' if kron else ''}", flush=True)
        print("dryrun cell " + json.dumps({"card": smi, **{k: v for k, v in rec.items()
                                                           if k != "fmt_row"}}), flush=True)
        if rec["launches_moved"] or rec["card_bytes_grown"] > DRYRUN_CARD_BYTES:
            failures.append(f"{shape}{'-kron' if kron else ''}: launches {rec['launches_moved']}, "
                            f"card bytes grown {rec['card_bytes_grown']}")
        if kron:
            got = sum(rec["per_device"]["kernel_flops"].values())
            if not got or _rel_diff(got, rec["planned_kron_flops"]) > DRYRUN_COUNT_RTOL:
                failures.append(f"kron cell: kernel FLOPs {got} against the plans' "
                                f"{rec['planned_kron_flops']}")
    fake, card = res["step-fake"], res["step-card"]
    kern, twin = card["auto"], card["torch"]
    pd = fake["per_device"]
    peak_ratio = fake["peak_bytes_per_device"] / kern["peak_bytes"]
    max_term = max(fake["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
    row = {
        "case": "dryrun", "device": smi, "wall_s": wall,
        "jobs_s": {job: r["job_s"] for job, r in res.items()},
        "step": {"card": kern, "twins": twin, "dryrun": {
            "flops": pd["hlo_flops"], "dot_flops": pd["hlo_dot_flops"], "bytes": pd["hlo_bytes"],
            "collective_counts": pd["collective_counts"], "kernel_flops": pd["kernel_flops"],
            "peak_bytes": fake["peak_bytes_per_device"], "roofline": fake["roofline"],
            "launches_moved": fake["launches_moved"],
            "card_bytes_grown": fake["card_bytes_grown"]}},
        "flops_rel_err": _rel_diff(pd["hlo_flops"], kern["flops"]),
        "dot_flops_rel_err": _rel_diff(pd["hlo_dot_flops"], kern["dot_flops"]),
        "bytes_rel_err": _rel_diff(pd["hlo_bytes"], kern["bytes"]),
        "twin_dot_flops_rel_err": _rel_diff(twin["dot_flops"], kern["dot_flops"]),
        "twin_flops_gap": twin["flops"] - kern["flops"],
        "peak_gib": {"dryrun": fake["peak_bytes_per_device"] / 2 ** 30,
                     "card": kern["peak_bytes"] / 2 ** 30, "ratio": peak_ratio},
        "card_total_memory": card["total_memory"], "hbm_per_chip": dryrun.HBM_PER_CHIP,
        "adamw_step_ms": step_ms, "roofline_max_term_ms": max_term * 1e3,
        "roofline_max_term_over_step": None if step_ms is None else max_term * 1e3 / step_ms,
    }
    print("dryrun step " + json.dumps(row), flush=True)
    print(f"dryrun: phase {wall:.1f} s ({smi})", flush=True)
    if fake["launches_moved"] or fake["card_bytes_grown"] > DRYRUN_CARD_BYTES:
        failures.append(f"step dry-run: launches {fake['launches_moved']}, card bytes grown "
                        f"{fake['card_bytes_grown']}")
    if (max(row["flops_rel_err"], row["dot_flops_rel_err"], row["bytes_rel_err"])
            > DRYRUN_COUNT_RTOL or pd["collective_counts"] != kern["collective_counts"]):
        failures.append(f"step: the dry-run's counts differ from the card's {row}")
    if dryrun.HBM_PER_CHIP != card["total_memory"]:
        failures.append(f"dryrun.HBM_PER_CHIP {dryrun.HBM_PER_CHIP} is not this card's "
                        f"total_memory {card['total_memory']}")
    if row["twin_dot_flops_rel_err"] > DRYRUN_COUNT_RTOL:
        failures.append(f"step: the twins' dot FLOPs differ from the kernels' {row}")
    if not kern["launches"].get("chain_fwd") or not kern["kernel_flops"]:
        failures.append(f"step: the card's step launched no kernel {kern['launches']}")
    lo, hi = DRYRUN_PEAK_RATIO
    if not lo <= peak_ratio <= hi:
        failures.append(f"step: dry-run peak / card peak {peak_ratio} outside {DRYRUN_PEAK_RATIO}")
    if failures:
        raise AssertionError("dryrun: " + "; ".join(failures))
    return row


REFUSED_ENV = ("FASTKRON_CHAOS", "FASTKRON_NUMERICS", "FASTKRON_PLAN_CACHE")


def main() -> int:
    set_env = [var for var in REFUSED_ENV if var in os.environ]
    if set_env:
        print(f"chip_smoke: refusing to run with {set_env} set", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if "--dryrun-job" in sys.argv[1:]:  # one process of phase 14, started by run_dryrun
        i = sys.argv.index("--dryrun-job")
        job, out = sys.argv[i + 1], sys.argv[i + 2]
        with open(out, "w") as f:
            json.dump(dryrun_job(job), f)
        return 0
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s nvcc -> "
          + ", ".join(str(p) for p in libs.values()), flush=True)
    spills = []
    for name in libs:
        log = (_build.build_dir() / f"{name}.log").read_text()
        for e in ptxas_entries(log):
            print(f"build: {name}.cu ptxas: {e['entry']}: {e['registers']} registers, "
                  f"{e['spill_bytes']} bytes spilled", flush=True)
            if name in TWO_BLOCK_KERNELS and e["spill_bytes"]:
                spills.append(e["entry"])
    if spills:
        print(f"chip_smoke: ptxas spills registers in {spills}", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} ({kind}, torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    peaks = peaks_for(kind)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if "--alone" in sys.argv[1:]:  # phase 4 only, for comparing two trees in one call
        run_alone(gen, peaks)
        return 0
    if "--mesh" in sys.argv[1:]:  # phase 12 only
        run_mesh(smi)
        return 0
    if "--shard" in sys.argv[1:]:  # phase 13 only
        run_shard(smi)
        return 0
    if "--dryrun" in sys.argv[1:]:  # phase 14 only (no phase 10 step time to hold)
        run_dryrun(smi, None)
        return 0
    assert_clean("start")
    passed = check_kernels(gen)
    assert_clean("check")
    rows = {r["case"]: r for r in (
        run_main(gen, peaks) + run_backward(gen, peaks) + run_batched(gen, peaks)
        + run_batched_backward(gen, peaks) + run_vmap(gen, peaks))}
    assert_clean("main")
    print("main: per-sample batched against B single calls in this run: " + json.dumps({
        "gp16-batched / (4 x gp16)": rows["gp16-batched"]["ms"] / (4 * rows["gp16"]["ms"]),
        "gp16-batched-grad / (4 x gp16-grad)":
            rows["gp16-batched-grad"]["ms"] / (4 * rows["gp16-grad"]["ms"]),
        "gp16-vmap / gp16-batched": rows["gp16-vmap"]["ms"] / rows["gp16-batched"]["ms"],
        "fig9-vmap-x / (2 x fig9)": rows["fig9-vmap-x"]["ms"] / (2 * rows["fig9"]["ms"]),
    }), flush=True)
    alone = run_alone(gen, peaks)
    assert_clean("alone")
    run_ladder(gen)
    # The consumers, each phase's launches counted from 0.
    with tempfile.TemporaryDirectory() as cache_dir:
        _, measure_launches = run_measure(gen, cache_dir)
    _, profile_launches = run_profile(gen)
    _, ffn_launches = run_ffn_block(gen)
    _, gp_launches = run_gp_epoch(gen)
    assert_clean("consumers")
    train_row, train_launches = run_train(gen, smi)
    assert_clean("train")
    _, serve_launches = run_serve(gen, smi, peaks)
    assert_clean("serve")
    _, mesh_launches = run_mesh(smi)
    _, shard_launches = run_shard(smi)
    run_dryrun(smi, train_row["adamw_step_ms"])
    consumers = (measure_launches, profile_launches, ffn_launches, gp_launches, train_launches,
                 serve_launches, mesh_launches, shard_launches)

    def kernel_row(name):
        source, replaces, case = KERNELS[name]
        r = rows[case]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (sum(row["launches"][name] for row in rows.values())
                         + sum(c[name] for c in consumers)),
            "cases_passed": passed[name], "main_case": case,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        row["mesh_launches"] = mesh_launches[name]  # phase 12, summed over its ranks
        row["shard_launches"] = shard_launches[name]  # phase 13, summed over its ranks
        if name == "grad":
            row["reduce_launches"] = (sum(row["launches"]["grad_reduce"] for row in rows.values())
                                      + sum(c["grad_reduce"] for c in consumers))
        if name in alone:
            row["alone"] = alone[name]
        return row

    kernels = [kernel_row(name) for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
