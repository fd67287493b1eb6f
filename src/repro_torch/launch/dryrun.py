"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on fake
tensors in a fake world and read the roofline terms off the trace.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

The port of ``repro.launch.dryrun``.  The reference lowers and compiles one
global program on 512 placeholder host devices.  Here a cell is one rank of
an explicit-SPMD world: a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, collectives that move
nothing) under the production mesh (``launch/mesh.py``), and the cell's
step (``specs.build_cell``, backward included for a train cell) runs once
on rank 0's fake shards (``FakeTensorMode``: shapes and dtypes, no memory,
no kernel launch; ``--device cpu`` fakes CPU tensors, which run the
kernels' plain twins, on any host) under ``hlo_cost.CostMode``; fake CUDA
tensors need a CUDA build of torch.

Per cell this records (``--out``, one JSON file a cell):
  * the per-device FLOPs, dot FLOPs and HBM bytes, and the collective
    payloads by kind (``hlo_cost``'s conventions: eager ops, every loop
    iteration counted as it runs);
  * the peak bytes of live storages on the device over the step, the
    step's inputs included, and whether it fits the card's memory;
  * the three roofline terms on the H100 (``HW``) + the dominant one +
    MODEL_FLOPS / counted FLOPs; ``collective_predictive`` is false in a
    prefill or decode cell, whose serving layout gathers every layer's
    weights whole (``model.prefill_on_mesh``), so its collective term
    predicts no partitioned server.

The step runs with the numerics policy ``off`` (its guard would read a
flag on the host), and a Shampoo cell takes its refresh branch (the step
counter is 0: the reference's upper bound).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback

import torch.distributed as dist

from ..configs import LONG_OK, SHAPES, runnable_cells, skipped_cells
from ..core.autotune import HBM_BW, NVLINK_BW
from ..runtime import guard
from ..runtime.hlo_cost import CostMode

# hardware model: one NVIDIA H100 SXM (data sheet, dense rates).  The
# model's matmuls run in bf16 on the tensor cores; HBM3 and NVLink 4 (per
# direction) are ``core.autotune``'s.  HBM_PER_CHIP is
# torch.cuda.get_device_properties(0).total_memory, read on an
# "NVIDIA H100 80GB HBM3" at a 700 W power limit (chip_smoke.py phase 14).
PEAK_FLOPS = 989e12
HBM_PER_CHIP = 85_017_493_504
HW = (f"NVIDIA H100 SXM: {PEAK_FLOPS / 1e12:.0f} TF/s bf16, {HBM_BW / 1e12:.2f} TB/s HBM, "
      f"{NVLINK_BW / 1e9:.0f} GB/s NVLink, {HBM_PER_CHIP / 2 ** 30:.1f} GiB")


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def model_flops(cell, cfg) -> float:
    """6*N*D train / 2*N*D forward-only (global, per step)."""
    n_active = cfg.param_count(active_only=True)
    s, b = cell.shape.seq_len, cell.shape.global_batch
    if cell.shape.kind == "train":
        return 6.0 * n_active * s * b
    if cell.shape.kind == "prefill":
        return 2.0 * n_active * s * b
    return 2.0 * n_active * b  # decode: one token per sequence


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for the
    duration.  A process that already runs a world refuses: a dry-run's
    collectives must move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            f"a dry-run makes its own fake world; this process already runs a "
            f"{dist.get_backend()} world of {dist.get_world_size()}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape, device: str):
    from .mesh import _mesh as mesh_of, make_production_mesh

    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    return mesh_of(tuple(mesh_shape), names, device)


def _bytes(tensors, device: str) -> int:
    """Bytes of the distinct storages of ``tensors`` on ``device``."""
    seen, total = set(), 0
    for t in tensors:
        if t.device.type != device:
            continue
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None, *,
             device: str = "cuda", mesh_shape: tuple[int, ...] | None = None,
             sites: bool = False, **overrides):
    """Dry-run one cell; its record (also written to ``out_dir`` when
    given).  ``mesh_shape``: a ``(data, model)`` or ``(pod, data, model)``
    grid in place of the production mesh; ``overrides``: ``build_cell``'s
    ``cfg``/``shape``/``opt_cfg``/``microbatches``.  ``sites``: the record
    also lists every collective call (``collective_report``)."""
    from .. import tree
    from .specs import build_cell

    n_chips = (2 * 16 * 16 if multi_pod else 16 * 16) if mesh_shape is None \
        else math.prod(mesh_shape)
    tag = mesh_tag(multi_pod) if mesh_shape is None else "x".join(map(str, mesh_shape))
    with fake_world(n_chips), guard.numerics("off"):
        mesh = _mesh(multi_pod, mesh_shape, device)
        t0 = time.time()
        cell = build_cell(arch, shape_name, mesh, device=device, **overrides)
        t_lower = time.time() - t0
        inputs = tree.leaves(cell.in_specs)
        with cell.mode, CostMode(sites=sites, memory=device) as cm:
            cm.track(inputs)
            arg_bytes = cm.live_bytes
            t0 = time.time()
            out = cell.fn(*cell.in_specs)
            t_compile = time.time() - t0
            outputs = tree.leaves(out)
            out_bytes = _bytes(outputs, device)
            held = {i.untyped_storage()._cdata for i in inputs}
            alias_bytes = _bytes([t for t in outputs if t.untyped_storage()._cdata in held],
                                 device)
            del out, outputs
        cost = cm.cost

    flops_dev = cost.flops
    bytes_dev = cost.bytes_accessed
    coll_bytes_dev = cost.total_collective_bytes

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_bytes_dev / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    # A serving cell runs model.prefill_on_mesh / decode_step_on_mesh, which
    # gather every layer's weights (and, decoding, its cache) whole: its
    # collective term is that layout's, not a tensor-parallel server's.
    coll_predictive = cell.shape.kind == "train"

    mf = model_flops(cell, cell.cfg)
    mf_dev = mf / n_chips
    useful = mf_dev / flops_dev if flops_dev else 0.0
    peak_bytes = cm.peak_bytes

    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": tag,
        "chips": n_chips,
        "device": device,
        "meta": cell.meta,
        "microbatches_per_rank": cell.microbatches,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "per_device": {
            "hlo_flops": flops_dev,
            "hlo_dot_flops": cost.dot_flops,
            "hlo_bytes": bytes_dev,
            "collective_bytes": coll_bytes_dev,
            "collectives": cost.collective_bytes,
            "collective_counts": cost.collective_counts,
            "kernel_flops": cost.kernel_flops,
        },
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias_bytes,
            "temp_size_in_bytes": peak_bytes - arg_bytes,
        },
        "peak_bytes_per_device": peak_bytes,
        "fits_hbm": peak_bytes < HBM_PER_CHIP,
        "roofline": {
            **{k: float(v) for k, v in terms.items()},
            "dominant": dominant,
            "collective_predictive": coll_predictive,
            "model_flops_global": mf,
            "model_flops_per_device": mf_dev,
            "useful_flops_ratio": useful,
        },
    }
    if sites:
        record["sites"] = [dict(kind=s.kind, bytes=s.nbytes, shape=s.shape, dtype=s.dtype,
                                site=s.site) for s in cm.sites]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{tag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(record, f, indent=1)
    return record


def fmt_row(r) -> str:
    t = r["roofline"]
    return (
        f"{r['arch']:<24} {r['shape']:<12} {r['mesh']:<8} "
        f"comp={t['compute_s']*1e3:8.2f}ms mem={t['memory_s']*1e3:8.2f}ms "
        f"coll={t['collective_s']*1e3:8.2f}ms dom={t['dominant']:<13} "
        f"peak={r['peak_bytes_per_device']/1e9:5.2f}GB "
        f"fit={'Y' if r['fits_hbm'] else 'N'} useful={t['useful_flops_ratio']:.2f} "
        f"compile={r['compile_s']:.0f}s"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (cpu: the kernels' plain twins run)")
    args = ap.parse_args(argv)

    if args.all:
        cells = runnable_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        if args.shape == "long_500k" and args.arch.replace("-", "_").replace(".", "_") not in LONG_OK:
            print(f"SKIP {args.arch} long_500k (full attention)")
            return
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, mp, args.out, device=args.device)
                print(fmt_row(rec), flush=True)
            except Exception as e:
                failures.append((arch, shape, mp, repr(e)))
                print(f"FAIL {arch} {shape} {mesh_tag(mp)}: {e}", flush=True)
                if not args.continue_on_error:
                    traceback.print_exc()
                    sys.exit(1)
    for arch, shape, reason in skipped_cells():
        print(f"SKIP {arch:<24} {shape:<12} ({reason})")
    if failures:
        print(f"{len(failures)} FAILURES")
        sys.exit(1)
    print("DRY-RUN OK")


if __name__ == "__main__":
    main()
