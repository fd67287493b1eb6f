#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch twin on the card, then drives the
port's main path — ``KronOp(ps, qs)(x, factors)`` on CUDA tensors — at full
size and checks that every call went through the kernels.  Phases, one line
each:

  1. build / device: nvcc time and libraries; the card's name and power limit.
  2. check: each kernel against its plain twin at stated tolerances (relative
     to max|ref|: 1e-5 f32, 1e-2 bf16, 1e-12 f64), and one small f32 KronOp
     against ``x @ kron_matrix(factors)``.
  3. main: five full-size KronOp calls (fig9, gp16, ffn, compress,
     fig9-unfused): launches per call (asserted), error against the plain
     twins, and CUDA-event times of the op, of its plain twins, of the
     shuffle algorithm and of one ``torch.einsum`` call, beside the card's
     bound for the same function.
  4. a ``{"kernels": [...]}`` JSON line, then the card's name and power limit.
  5. last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
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
WARMUP, ITERS = 2, 10

CHAIN_SOURCE = "src/repro_torch/kernels/csrc/chain_fwd.cu"
SLICED_SOURCE = "src/repro_torch/kernels/csrc/sliced.cu"
CHAIN_REPLACES = "src/repro/kernels/emit.py:575"
SLICED_REPLACES = "src/repro/kernels/kron_sliced.py:83"


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


def stage_tiles(m: int, k: int, ps, t_qs, budget: int) -> tuple[int, int]:
    """(t_m, t_k) for a direct chain_cuda call: the widest t_k, then the
    most rows, inside the planner's per-block budget."""
    from repro_torch.kernels.emit import fused_growth

    pprod = math.prod(ps)
    growth = fused_growth(ps, t_qs, t_qs)
    per = k // pprod
    d = max(d for d in range(1, per + 1) if per % d == 0 and pprod * d * growth <= budget)
    t_k = pprod * d
    t_m = max(t for t in range(1, m + 1) if m % t == 0 and t * t_k * growth <= budget)
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
]
# (name, M, P, Q, S, dtype)
SLICED_CASES = [
    ("f32 32x32", 64, 32, 32, 2048, torch.float32),
    ("bf16 64x128", 64, 64, 128, 76, torch.bfloat16),
    ("f64 40x76", 32, 40, 76, 64, torch.float64),
    ("f32 odd 65x20 M=10", 10, 65, 20, 52, torch.float32),
]


def check_kernels(gen) -> dict:
    from repro_torch.core import KronOp, kron_matrix
    from repro_torch.kernels import emit, kron_sliced

    passed = {"chain_fwd": 0, "sliced": 0}
    failures = []

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

    for name, ps, qs, m, s, dtype, t_qs, b in CHAIN_CASES:
        k = math.prod(ps) * s
        x = randn(gen, (b, m, k), dtype)
        fs = [randn(gen, (b, p, q), dtype) for p, q in zip(ps, qs)]
        t_m, t_k = stage_tiles(m, k, ps, t_qs or qs, emit.SMEM_BUDGET_ELEMS)
        got = emit.chain_cuda(x, *fs, t_b=1, t_m=t_m, t_k=t_k, t_qs=t_qs)
        ref = emit.chain_reference(x, *fs)
        torch.cuda.synchronize()
        record("chain_fwd", f"{name} tiles=({t_m},{t_k})", got, ref, TOLERANCE[dtype])

    for name, m, p, q, s, dtype in SLICED_CASES:
        x = randn(gen, (m, s * p), dtype)
        f = randn(gen, (p, q), dtype)
        got = kron_sliced.sliced_multiply_cuda(x, f)
        ref = kron_sliced.sliced_multiply_reference(x, f)
        torch.cuda.synchronize()
        tiles = kron_sliced.sliced_tiles(m, s, p, q, emit.acc_dtype_for(dtype).itemsize)
        record("sliced", f"{name} tiles={tiles}", got, ref, TOLERANCE[dtype])

    # One small KronOp against the dense oracle x @ (F^1 (x) ... (x) F^N).
    ps, qs = (4, 8, 4), (8, 4, 8)
    x = randn(gen, (16, math.prod(ps)), torch.float32)
    fs = [randn(gen, (p, q), torch.float32) for p, q in zip(ps, qs)]
    record("chain_fwd", "KronOp vs x @ kron_matrix", KronOp(ps, qs)(x, fs),
           x @ kron_matrix(fs), TOLERANCE[torch.float32])

    if failures:
        raise AssertionError(f"kernels disagree with their plain twins: {failures}")
    return passed


# ---------------------------------------------------------------------------
# Phase 3: the main path at full size
# ---------------------------------------------------------------------------

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
    """The op's forward through the kernels' plain twins on the card."""
    from repro_torch.core.engine import _lowered
    from repro_torch.kernels import emit, kron_sliced

    if op.plan is None:
        y = x
        for f in reversed(fs):
            y = kron_sliced.sliced_multiply_reference(y, f)
        return y
    rev = tuple(reversed(fs))
    y = x
    for ins in _lowered(op.plan, op.ps, op.qs).instrs:
        sf = tuple(rev[i] for i in ins.factor_ids)
        if ins.kind == emit.PREKRON:
            sf = (emit.prekron_product(sf),)
        y = emit.chain_reference(y[None], *(f[None] for f in sf), acc_dtype=ins.acc_dtype)[0]
    return y


def einsum_call(x, fs):
    """One torch.einsum computing x @ (F^1 (x) ... (x) F^N)."""
    n = len(fs)
    letters = "abcdefghijklmnop"
    ins, outs = letters[:n], letters[n:2 * n]
    spec = "z" + ins + "," + ",".join(i + o for i, o in zip(ins, outs)) + "->z" + outs
    xv = x.reshape(x.shape[0], *(int(f.shape[0]) for f in fs))
    return torch.einsum(spec, xv, *fs).reshape(x.shape[0], -1)


def run_main(gen, peaks) -> list[dict]:
    from repro_torch.core import KronOp, KronProblem, kron_matmul_shuffle
    from repro_torch.core.engine import _lowered
    from repro_torch.kernels import emit, kron_sliced

    rows = []
    for name, m, ps, qs, dtype, plan in MAIN_CASES:
        k = math.prod(ps)
        x = randn(gen, (m, k), dtype)
        fs = [randn(gen, (p, q), dtype) for p, q in zip(ps, qs)]
        op = KronOp(ps, qs, plan=plan)
        # The main path's run: counts set to 0 just before, read just after.
        emit.chain_launches = 0
        kron_sliced.sliced_launches = 0
        y = op(x, fs)
        torch.cuda.synchronize()
        launches = {"chain_fwd": emit.chain_launches, "sliced": kron_sliced.sliced_launches}
        plan_used = op.plan
        if plan_used is None:
            want = {"chain_fwd": 0, "sliced": len(ps)}
            n_stages = len(ps)
        else:
            n_stages = len(_lowered(plan_used, op.ps, op.qs).instrs)
            want = {"chain_fwd": n_stages, "sliced": 0}
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


def main() -> int:
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
    for name in libs:
        log = (_build.build_dir() / f"{name}.log").read_text()
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build: {name}.cu ptxas: " + " | ".join(usage), flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} ({kind}, torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    peaks = peaks_for(kind)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    passed = check_kernels(gen)
    rows = {r["case"]: r for r in run_main(gen, peaks)}

    def kernel_row(name, route, source, replaces, case):
        r = rows[case]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(row["launches"][name] for row in rows.values()),
            "cases_passed": passed[name], "main_case": case,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }

    kernels = [
        kernel_row("chain_fwd", "cuda", CHAIN_SOURCE, CHAIN_REPLACES, "fig9"),
        kernel_row("sliced", "cuda", SLICED_SOURCE, SLICED_REPLACES, "fig9-unfused"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
