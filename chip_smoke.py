#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --alone    # phases 1 and 4 only (A/B of two trees)

It refuses to run (exit 1) with ``FASTKRON_CHAOS`` or ``FASTKRON_NUMERICS``
set: the first injects faults into the kernels' path, the second adds host
checks to every call.

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
  6. a ``{"kernels": [...]}`` JSON line, then the card's name and power limit.
  7. last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
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
    errs, dx_rels, df_rels = [], [], []
    with torch.no_grad():
        for i in range(b):  # each sample against the plain twins of its own problem
            fi = [f[i] for f in fd]
            rdx, _ = plain_bwd(op, xd[i], fi, ct[i], False)
            err, rel = compare(grads[0][i], rdx)
            del rdx
            errs.append(err)
            dx_rels.append(rel)
            for d, r in zip(grads[1:], plain_dfs_f64(op, xd[i], fi, ct[i])):
                err, rel = compare(d[i], r)
                errs.append(err)
                df_rels.append(rel)
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
        "grads": "x and factors", "launches": launches, "max_abs_err": max(errs),
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


# One injects faults into the kernels' path, the other adds host checks.
REFUSED_ENV = ("FASTKRON_CHAOS", "FASTKRON_NUMERICS")


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

    def kernel_row(name):
        source, replaces, case = KERNELS[name]
        r = rows[case]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(row["launches"][name] for row in rows.values()),
            "cases_passed": passed[name], "main_case": case,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        if name == "grad":
            row["reduce_launches"] = sum(row["launches"]["grad_reduce"] for row in rows.values())
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
