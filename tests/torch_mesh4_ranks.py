"""Four gloo CPU ranks behind tests/test_torch_mesh_stripes.py: Table 4 row
27's small twin through the port's mesh path.

    python tests/torch_mesh4_ranks.py OUT.npz

The twin is M = 16 rows and six 4 x 4 RBF factors (K = 4,096), on a
``(data, model) = (1, 4)`` mesh: each rank holds a (16, 1,024) stripe and
the rounds are [5, 1], row 27's schedule.  Every rank makes the same ``x``
from the seed and places only its own stripe
(``distributed.sharded_input_from_local``); the ranks' outputs are
gathered to rank 0, which writes every output and check to ``OUT.npz``:
keys ``<case>/<quantity>``, the port's own checks 0/1 or counts under
``check/...``.  The planted faults are the ones ``PERF.md`` §2 holds
``y_rel``'s limit against: two ranks' chunks swapped in one relocation,
one factor left out of a round, and the previous factor set.  A rank's
failure prints its traceback and fails the run.
"""
from __future__ import annotations

import os
import sys
import tempfile
import traceback

import numpy as np

G_K = 4
M, POINTS, DIMS = 16, 4, 6
K = POINTS ** DIMS
SEED = 31
SETS = 2  # factor sets; the "previous set" fault runs set 0 against set 1's reference
CHECKED_PER_RANK = 8


def twin_inputs():
    """``x`` (M, K) float32 and ``SETS`` sets of six RBF factors, the same
    on every rank (the lengthscales as the benchmark's step draws them)."""
    import torch

    sys.path.insert(0, _root())
    from perfbench import reference

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((M, K), generator=gen)
    scales = 0.15 + 0.25 * torch.rand((SETS, DIMS), generator=gen)
    sets = [[reference.rbf_factor(POINTS, float(ls)) for ls in row] for row in scales]
    return x, sets


def _root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _rank(rank: int, world: int, store: str, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        torch.set_num_threads(1)
        out = _checks(rank)
        if rank == 0:
            np.savez(out_path, **out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _checks(rank: int) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.core import autotune as A
    from repro_torch.core import distributed as D
    from repro_torch.core import engine
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import chaos, guard, telemetry

    mesh = make_debug_mesh(1, G_K, device_type="cpu")
    x, sets = twin_inputs()
    k_loc = K // G_K
    xd = D.sharded_input_from_local(x[:, rank * k_loc:(rank + 1) * k_loc].contiguous(), mesh)
    ps = (POINTS,) * DIMS
    out: dict = {"x": x.numpy()}

    def full(y) -> torch.Tensor:
        """The whole output on every rank, from each rank's stripe."""
        parts = [torch.empty_like(y.to_local()) for _ in range(G_K)]
        dist.all_gather(parts, y.to_local().contiguous())
        return torch.cat(parts, dim=1)

    def all_ranks(flag: bool) -> int:
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t)

    for s, fs in enumerate(sets):
        out[f"set{s}/factors"] = torch.stack(fs).numpy()
    out["check/global_shape"] = np.asarray(list(xd.shape))
    out["check/no_full_x"] = all_ranks(xd.to_local().shape == (M, k_loc))

    # -- the op from per-rank stripes, at "auto" and each slab count --
    outs = {}
    with torch.no_grad():
        for n in ("auto", 1, 2, 4):
            outs[n] = full(engine.KronOp(ps, ps, mesh=mesh, n_slabs=n)(xd, sets[0]))
    out["mesh/y"] = outs["auto"].numpy()
    for n in ("auto", 2, 4):
        out[f"check/bitwise/{n}"] = all_ranks(torch.equal(outs[n], outs[1]))

    # -- spans and counters --
    telemetry.configure(annotate=False)
    try:
        with torch.no_grad():
            op = engine.KronOp(ps, ps, mesh=mesh, n_slabs=2)
            op(xd, sets[0])
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    hist = snap["histograms"]
    out["check/telemetry/relocate"] = hist["span.relocate"]["count"]
    out["check/telemetry/relocate_wait"] = hist["span.relocate_wait"]["count"]
    out["check/telemetry/a2a_calls"] = snap["counters"]["comm.a2a_calls"]
    out["check/telemetry/a2a_bytes"] = snap["counters"]["comm.a2a_bytes"]
    out["check/telemetry/n_slabs"] = snap["gauges"]["mesh.n_slabs"]
    out["check/telemetry/rounds"] = len(op.rounds)

    # -- the planted faults --
    with torch.no_grad():
        real_exchange = D.group_exchange

        def swapped(group):
            exchange, calls = real_exchange(group), []

            def first_swapped(send):
                recv, wait = exchange(send)
                calls.append(1)
                if len(calls) > 1:
                    return recv, wait

                def wait_and_swap():
                    wait()
                    recv[[0, 1]] = recv[[1, 0]].clone()

                return recv, wait_and_swap

            return first_swapped

        D.group_exchange = swapped
        try:
            out["fault/swap/y"] = full(engine.KronOp(ps, ps, mesh=mesh, n_slabs=1)(
                xd, sets[0])).numpy()
        finally:
            D.group_exchange = real_exchange

        real_round = D._local_multiply_round

        def dropped(y, fs, backend):
            return real_round(y, fs[1:] if len(fs) > 1 else fs, backend)

        D._local_multiply_round = dropped
        try:
            out["fault/drop/y"] = full(engine.KronOp(ps, ps, mesh=mesh, n_slabs=1)(
                xd, sets[0])).numpy()
        finally:
            D._local_multiply_round = real_round
        out["fault/previous_set/y"] = outs["auto"].numpy()  # set 0's, held to set 1's reference

    # -- a card's budget (a CPU rank has none: given here): slab choice and
    # the ladder's gather rung --
    ws = {n: D.round_working_set_bytes(M, k_loc, ps, ps, G_K, n_slabs=n) for n in (1, 2, 4)}
    out["check/ws"] = np.asarray([ws[1], ws[2], ws[4]])
    real_budget = A.device_memory_budget

    def budget_of(nbytes):
        A.device_memory_budget = lambda device: nbytes

    try:
        with torch.no_grad():
            budget_of(ws[4])
            telemetry.configure(annotate=False)
            try:
                y4 = full(engine.KronOp(ps, ps, mesh=mesh)(xd, sets[0]))
                out["check/budget/n_slabs"] = telemetry.snapshot()["gauges"]["mesh.n_slabs"]
            finally:
                telemetry.disable()
            out["check/budget/bitwise"] = all_ranks(torch.equal(y4, outs[1]))
            budget_of(ws[4] // 4)
            try:
                engine.KronOp(ps, ps, mesh=mesh)(xd, sets[0])
                out["check/budget/none_fits"] = ""
            except guard.PlanError as e:
                out["check/budget/none_fits"] = str(e)
            guard.reset_health()
            budget_of(ws[1])
            try:
                with chaos.inject("collective"):
                    engine.KronOp(ps, ps, mesh=mesh, n_slabs=1)(xd, sets[0])
                out["check/gather/refused"] = ""
            except guard.PlanError as e:
                out["check/gather/refused"] = str(e)
            guard.reset_health()
    finally:
        A.device_memory_budget = real_budget
    return out


def run(out_path: str) -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(G_K, os.path.join(tmp, "store"), out_path),
                           nprocs=G_K, start_method="spawn")
    print("ALL-OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(_root(), "src"))
    run(sys.argv[1])
