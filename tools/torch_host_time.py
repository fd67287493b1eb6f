#!/usr/bin/env python
"""Host time of one ``repro_torch`` KronOp forward call, kernels left out.

    PYTHONPATH=src python tools/torch_host_time.py [--calls N] [--profile]

Every chain launch is replaced by a stand-in that returns a preallocated
output, so what is timed is the Python between the caller and the launches:
the op's checks, ``autograd.Function.apply``, the degradation ladder, the
emitter and its hooks.  The problem is the ``ffn`` case of ``chip_smoke.py``
(M=4096, (64, 40) -> (128, 76), bf16: two single-factor stages) on CPU
tensors, so it runs on any host.

Prints one JSON line of microseconds per call (the least of 7 blocks of N
calls): ``as_is``, and where the tree has them, ``torch_apply`` (the call
through ``torch.autograd.Function.apply``, which binds the arguments with
``inspect.signature`` in the ``setup_context`` form) and ``no_ladder`` (the
planned program run directly, without ``guard.run_ladder``).  The
differences attribute the host time to each piece.  ``--profile`` adds the
cProfile top entries of the as-is call.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time

import torch

from repro_torch.core import KronOp, engine
from repro_torch.kernels import emit

M, PS, QS = 4096, (64, 40), (128, 76)


def _stub_launches() -> None:
    outs: dict = {}

    def chain_cuda(x, *fs, **tiles):
        emit.chain_launches += 1
        shape = (x.shape[0], x.shape[1], x.shape[2] // fs[0].shape[-2] * fs[0].shape[-1])
        if shape not in outs:
            outs[shape] = torch.empty(shape, dtype=x.dtype)
        return outs[shape]

    emit.resolve_backend = lambda backend, x: "cuda"
    emit.chain_cuda = chain_cuda


def _per_call_us(call, n: int) -> float:
    for _ in range(200):
        call()
    best = float("inf")
    for _ in range(7):
        t = time.perf_counter()
        for _ in range(n):
            call()
        best = min(best, (time.perf_counter() - t) / n * 1e6)
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    _stub_launches()
    x = torch.zeros(M, PS[0] * PS[1], dtype=torch.bfloat16)
    fs = [torch.zeros(p, q, dtype=torch.bfloat16) for p, q in zip(PS, QS)]
    op = KronOp(PS, QS)
    call = lambda: op(x, fs)  # noqa: E731
    out = {"as_is": _per_call_us(call, args.calls)}
    fn = engine._KronFunction
    if "apply" in vars(fn):  # the tree skips torch's argument binding
        own = vars(fn)["apply"]
        fn.apply = classmethod(torch.autograd.Function.apply.__func__)
        out["torch_apply"] = _per_call_us(call, args.calls)
        fn.apply = own
    if hasattr(engine, "_fwd_ladder"):
        ladder = engine._fwd_ladder

        def planned(x, factors, plan, backend, batched):
            ps, qs = engine._signature(factors)
            prog = engine._lowered(plan, ps, qs, batched)
            return emit.run_program(x, factors, prog, backend=backend)

        engine._fwd_ladder = planned
        out["no_ladder"] = _per_call_us(call, args.calls)
        engine._fwd_ladder = ladder
    print(json.dumps({"host_us_per_call": out, "case": "ffn", "torch": torch.__version__}))
    if args.profile:
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.calls):
            call()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(20)
        print(text.getvalue())


if __name__ == "__main__":
    main()
