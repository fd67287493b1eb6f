#!/usr/bin/env python
"""Checks of the mesh path on the cards of one host that the benchmark does
not make.

    python tools/mesh_checks.py link [--ranks 4]
    python tools/mesh_checks.py bitwise [--ranks 4] [--seed 1] [--slabs 1 2 4] [--cpu]

Starts one process a card (``torch.multiprocessing``, NCCL over
``tcp://localhost``) and prints one JSON line per reading from rank 0.

* ``link``: ``all_to_all_single`` of float32 over every rank, timed by CUDA
  events: at 1 MiB a card (the per-call time; 200 calls) and at a 16 GiB
  stripe a card, Table 4 row 27's round payload (5 calls).  ``algbw`` is a
  card's buffer over the time, ``busbw`` nccl-tests' all-to-all bus
  bandwidth, the bytes a card sends to the others (the buffer times
  ``(n-1)/n``) over the time: the figures ``core/autotune.py``'s
  ``NVLINK_BW`` and ``A2A_LATENCY_S`` model.
* ``bitwise``: Table 4 row 27 (M = 16, six 32 x 32 RBF factors, float32)
  on a ``(1, ranks)`` mesh, each rank's stripe of ``x`` made on its card as
  the benchmark's ``kron_mesh`` step makes it: the op's output at each
  slab count against the serial schedule's, bitwise on every rank, with
  each count's time of a call and its peak memory per rank.
"""
from __future__ import annotations

import argparse
import datetime
import json
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _events_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def link(rank: int, world: int) -> list[dict]:
    out = []
    for label, elems, warm, iters in (("1MiB", 2**18, 20, 200), ("16GiB", 2**32, 1, 5)):
        send = torch.ones(elems, device="cuda")
        recv = torch.empty_like(send)
        call = lambda: dist.all_to_all_single(recv, send)  # noqa: E731
        for _ in range(warm):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        ms = _events_ms(call, iters)
        nbytes = elems * 4
        out.append({"payload": label, "bytes_per_card": nbytes, "ms_per_call": ms,
                    "algbw_GBps": nbytes / ms / 1e6,
                    "busbw_GBps": nbytes * (world - 1) / world / ms / 1e6})
        del send, recv
        torch.cuda.empty_cache()
    return out


def bitwise(rank: int, world: int, seed: int, slabs: list[int], points: int = 32) -> list[dict]:
    from perfbench import inputs, reference, reference_mesh
    from repro_torch.core import KronOp
    from repro_torch.core.distributed import sharded_input_from_local
    from repro_torch.launch.mesh import make_debug_mesh

    cuda = points == 32
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    mesh = make_debug_mesh(1, world, device_type=dev.type)
    m, k_loc = 16, points ** 6 // world
    chunk = min(2**20, k_loc)
    x = torch.empty((m, k_loc), device=dev)
    gen = inputs.generator(dev, seed * 256 + rank)
    for k0, part in reference_mesh.stripe_chunks(gen, m, k_loc, chunk, torch.float32, dev):
        x[:, k0:k0 + chunk].copy_(part)
    host = inputs.host_generator(seed)
    scales = 0.15 + 0.25 * torch.rand(6, generator=host)
    fs = [reference.rbf_factor(points, float(ls), device=dev) for ls in scales]
    xd = sharded_input_from_local(x, mesh)
    serial = None
    out = []
    for n in slabs:
        op = KronOp((points,) * 6, (points,) * 6, mesh=mesh, n_slabs=n)
        sync = torch.cuda.synchronize if cuda else (lambda d: None)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        with torch.no_grad():
            for _ in range(3):
                sync(dev)
                t0 = time.perf_counter()
                y = op(xd, fs).to_local()
                sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                if serial is None:
                    serial = y.cpu()
                    same = True
                elif len(times) == 1:
                    same = all(torch.equal(y[:, a:a + chunk * 16].cpu(), serial[:, a:a + chunk * 16])
                               for a in range(0, k_loc, chunk * 16))
                del y
        flag = torch.tensor([int(same)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if cuda else 0], device=dev,
                            dtype=torch.float64)
        peaks = [torch.zeros_like(peak) for _ in range(world)]
        dist.all_gather(peaks, peak)
        out.append({"n_slabs": n, "bitwise_equal_to_serial": bool(flag.item()),
                    "call_ms": times, "peak_gib": [float(p) / 2**30 for p in peaks]})
    return out


def _rank(rank: int, world: int, port: int, args) -> None:
    url, timeout = f"tcp://localhost:{port}", datetime.timedelta(seconds=120)
    if args.cpu:
        dist.init_process_group("gloo", init_method=url, world_size=world, rank=rank,
                                timeout=timeout)
    else:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=url, world_size=world, rank=rank,
                                timeout=timeout, device_id=torch.device("cuda", rank))
    try:
        rows = (link(rank, world) if args.what == "link" else
                bitwise(rank, world, args.seed, args.slabs, 4 if args.cpu else 32))
        if rank == 0:
            name = "cpu" if args.cpu else torch.cuda.get_device_name(0)
            for row in rows:
                print(json.dumps({"check": args.what, "card": name, **row}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("link", "bitwise"))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slabs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--cpu", action="store_true",
                    help="bitwise only: gloo ranks on the CPU at six 4 x 4 factors")
    args = ap.parse_args(argv)
    if not args.cpu and torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(args.ranks, _port(), args), nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
