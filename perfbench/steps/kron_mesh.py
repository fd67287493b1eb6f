"""Step kind ``kron_mesh``: one distributed forward MVM on a mesh of cards.

One step is ``KronOp(ps, qs, mesh=mesh)(x, factors)`` under ``no_grad`` on
a ``(data, model)`` mesh of one rank a card, for ``x`` of ``(m,
points^dims)`` that no card holds: each rank makes its own stripe of
columns on its card from the seed (``reference_mesh.stripe_chunks``) and
places it with ``distributed.sharded_input_from_local``.  The factors
cycle through ``traffic.factor_sets`` sets of ``dims`` RBF kernels on
``points`` grid points (lengthscales from the seed), as ``gp_epoch``'s
do: one CG iteration's MVM of a SKI solve.  ``traffic.n_slabs`` is the
op's ``n_slabs``.

The ranks: this process (the harness's, on ``cuda:0``) is rank 0.  Once it
has built the kernels (one small call of the op on its card) it starts
ranks 1.. as processes of this file, one a card, with ``torchrun``'s
environment for ``launch.mesh.init_world``, and drives them over pipes, a
line a step, so that nothing of the benchmark's own runs on a card
between steps.  A failed rank ends every rank: rank 0 exits as soon as a
rank exits with an error, a rank exits when rank 0 is gone or its pipe
closes, and a collective that waits ``TIMEOUT_S`` for a lost peer fails.

The check: ``2 + G_K * checked_per_rank`` columns of ``Y`` (the first, the
last, and in each rank's stripe of the output ``checked_per_rank`` drawn
from the seed) of ``sampled`` window steps drawn from the seed among the
first ``sample_range`` and of the last step, each rank copying its own as
the step runs.  Each rank makes its share of those columns in float64 from
its stripe of ``x`` remade from the seed (``reference_mesh.stripe_partial``)
and rank 0 sums the shares.  ``y_rel`` is the worst row's max|got - ref| /
max|ref| over the columns.  ``impl="control"`` runs the program on ``x``
and factors rounded to TF32.

``cost()`` is one card's share (``cost_mesh.mesh_forward``), so that the
readers read per card.  Each rank's peak memory over the window is printed
to standard error.
"""
from __future__ import annotations

import atexit
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import cost_mesh, inputs, reference, reference_mesh  # noqa: E402

TIMEOUT_S = 90  # the process group's bound on one collective's wait
POLL_S = 0.5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def checked_columns(k: int, g_k: int, per: int, host: torch.Generator) -> list[int]:
    """The columns of ``Y`` the check reads: the first, the last, and
    ``per`` drawn from ``host`` in each of the ``g_k`` ranks' stripes."""
    stripe = k // g_k
    return [0, k - 1] + [int(j) for r in range(g_k)
                         for j in torch.randint(r * stripe, (r + 1) * stripe, (per,),
                                                generator=host)]


class _Rank:
    """One rank's share of the step: its stripe of ``x``, the op, and its
    part of the check."""

    def __init__(self, rank: int, config: dict, traffic: dict, seed: int, device, impl: str):
        from repro_torch.core import KronOp
        from repro_torch.core.distributed import sharded_input_from_local
        from repro_torch.launch.mesh import init_world, make_debug_mesh

        if impl not in ("program", "control"):
            raise ValueError(f"unknown impl {impl!r}")
        g_m, g_k = int(config["mesh"]["data"]), int(config["mesh"]["model"])
        if g_m != 1:
            raise ValueError("kron_mesh splits the columns only: data must be 1")
        points, dims = int(config["points"]), int(config["dims"])
        self.rank, self.device = rank, device
        self.m, self.k = int(config["m"]), points ** dims
        self.k_loc = self.k // g_k
        self.chunk = int(traffic["x_chunk"])
        self.dtype = inputs.DTYPES[config["dtype"]]
        init_world(device, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self.mesh = make_debug_mesh(g_m, g_k, device_type=device.type)

        host = inputs.host_generator(seed)
        lo, hi = config["lengthscale_range"]
        scales = lo + (hi - lo) * torch.rand((int(traffic["factor_sets"]), dims), generator=host)
        self.sets = [tuple(reference.rbf_factor(points, float(ls), dtype=self.dtype, device=device)
                           for ls in row) for row in scales]
        picks = torch.randperm(int(traffic["sample_range"]), generator=host)
        self.sample = {int(w) for w in picks[:int(traffic["sampled"])]}
        self.cols = checked_columns(self.k, g_k, int(traffic["checked_per_rank"]), host)
        lo_col = rank * self.k_loc
        self.own = [i for i, j in enumerate(self.cols) if lo_col <= j < lo_col + self.k_loc]
        self.own_idx = torch.tensor([self.cols[i] - lo_col for i in self.own], device=device)

        self.gen_seed = seed * 256 + rank
        rounded = impl == "control"
        self.x = torch.empty((self.m, self.k_loc), dtype=self.dtype, device=device)
        for k0, part in self._stripe():
            self.x[:, k0:k0 + self.chunk].copy_(reference.tf32(part) if rounded else part)
        self.run_sets = ([tuple(reference.tf32(f) for f in fs) for fs in self.sets]
                         if rounded else self.sets)
        self.xd = sharded_input_from_local(self.x, self.mesh)
        n_slabs = traffic["n_slabs"]
        self.op = KronOp((points,) * dims, (points,) * dims, mesh=self.mesh,
                         n_slabs=n_slabs if n_slabs == "auto" else int(n_slabs))
        self.i = self.w = 0
        self.recording = False
        self.kept: list = []
        self.last = None
        self.peak = 0

    def _stripe(self):
        gen = inputs.generator(self.device, self.gen_seed)
        return reference_mesh.stripe_chunks(gen, self.m, self.k_loc, self.chunk, self.dtype,
                                            self.device)

    def run(self) -> None:
        s = self.i % len(self.sets)
        self.last = None  # the previous output's memory is the next one's
        with torch.no_grad():
            y = self.op(self.xd, self.run_sets[s]).to_local()
        if self.recording:
            if self.w in self.sample:
                self.kept.append((s, y.index_select(1, self.own_idx)))
            self.w += 1
        self.last = (s, y)
        self.i += 1

    def start_window(self) -> None:
        self.recording, self.kept, self.w = True, [], 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak = torch.cuda.max_memory_allocated(self.device)
        self.op = None
        if self.last is not None:
            s, y = self.last
            self.last = (s, y.index_select(1, self.own_idx))

    def share(self) -> dict:
        """This rank's columns of the checked steps and its float64 share of
        the reference's columns for each factor set."""
        steps = self.kept + ([self.last] if self.last is not None else [])
        sets = sorted({s for s, _ in steps})
        parts = reference_mesh.stripe_partial(self._stripe(), [self.sets[s] for s in sets],
                                              self.cols, self.rank * self.k_loc, self.chunk)
        return {"rank": self.rank, "peak": self.peak, "own": self.own,
                "steps": [[s, y.double().cpu().tolist()] for s, y in steps],
                "ref": {str(s): p.cpu().tolist() for s, p in zip(sets, parts)}}

    def close(self) -> None:
        """Free the stripe and leave the world: every rank destroys its
        process group at once (rank 0 sends ``exit`` first), each waiting at
        most ``TIMEOUT_S`` for it."""
        import torch.distributed as dist

        self.x = self.xd = self.kept = self.last = None
        if dist.is_initialized():
            leave = threading.Thread(target=dist.destroy_process_group, daemon=True)
            leave.start()
            leave.join(TIMEOUT_S)


class Step:
    """Rank 0, in the harness's process, and the handles of the others."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        # The placement of a stripe no rank holds whole; a program without it
        # fails here, before any rank starts.
        from repro_torch.core import KronOp
        from repro_torch.core.distributed import sharded_input_from_local  # noqa: F401

        world = int(config["mesh"]["data"]) * int(config["mesh"]["model"])
        if device.type == "cuda" and torch.cuda.device_count() < world:
            raise RuntimeError(f"kron_mesh needs {world} CUDA devices, one a rank")
        self.points, self.dims = int(config["points"]), int(config["dims"])
        self.m, self.dtype = int(config["m"]), config["dtype"]
        self.g_k = int(config["mesh"]["model"])
        with torch.no_grad():  # builds the kernels once, before the other ranks load them
            KronOp((2,), (2,))(torch.ones((1, 2), device=device), [torch.eye(2, device=device)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world))
        spec = json.dumps({"config": config, "traffic": traffic, "seed": seed, "impl": impl,
                           "device": device.type})
        self.procs = [
            subprocess.Popen([sys.executable, str(Path(__file__).resolve()), spec],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(ROOT),
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for r in range(1, world)]
        atexit.register(self._kill)
        self._done = False
        threading.Thread(target=self._watch, daemon=True).start()
        os.environ.update(MASTER_ADDR=env["MASTER_ADDR"], MASTER_PORT=env["MASTER_PORT"],
                          WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
        self.me = _Rank(0, config, traffic, seed, device, impl)

    def _watch(self) -> None:
        """End this process as soon as another rank has failed."""
        while not self._done:
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is not None and code != 0 and not self._done:
                    print(f"kron_mesh: rank {r} exited with {code}; ending every rank",
                          file=sys.stderr, flush=True)
                    self._kill()
                    os._exit(1)
            time.sleep(POLL_S)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def _send(self, line: str) -> None:
        for p in self.procs:
            p.stdin.write(line + "\n")
            p.stdin.flush()

    def run(self) -> None:
        self._send("run")
        self.me.run()

    def start_window(self) -> None:
        self._send("start")
        self.me.start_window()

    def cost(self) -> cost_mesh.MeshCost:
        ps = (self.points,) * self.dims
        return cost_mesh.mesh_forward(self.m, ps, ps, 1, self.g_k, self.dtype)

    def finish(self) -> None:
        self._send("finish")
        self.me.finish()

    def check(self) -> dict[str, list[float]]:
        self._send("share")
        shares = [self.me.share()]
        for p in self.procs:
            line = p.stdout.readline()
            if not line:
                raise RuntimeError("a rank closed its pipe before its share of the check")
            shares.append(json.loads(line))
        self._done = True
        self._send("exit")
        self.me.close()
        for p in self.procs:
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                print("kron_mesh: a rank did not leave the world; killed", file=sys.stderr)
                p.kill()
        for sh in shares:
            print(f"kron_mesh: rank {sh['rank']} peak_mem_gib {sh['peak'] / 2**30!r}",
                  file=sys.stderr)
        return {"y_rel": combine(shares, len(self.me.cols))}


def combine(shares: list[dict], n_cols: int) -> list[float]:
    """``y_rel`` of each checked step: its columns gathered from every
    rank's share against the sum of the ranks' float64 shares of the
    reference's."""
    out = []
    for t in range(len(shares[0]["steps"])):
        s = shares[0]["steps"][t][0]
        got = torch.zeros((len(shares[0]["steps"][t][1]), n_cols), dtype=torch.float64)
        ref = torch.zeros_like(got)
        for sh in shares:
            cols = torch.tensor(sh["steps"][t][1], dtype=torch.float64)
            if sh["own"]:
                got[:, sh["own"]] = cols
            ref += torch.tensor(sh["ref"][str(s)], dtype=torch.float64)
        out.append(reference.row_rel(got, ref))
    return out


def _serve(spec: dict) -> int:
    """A rank other than 0: run what rank 0's lines say until ``exit``."""
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # the rank's own output goes to standard error
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(POLL_S)

    threading.Thread(target=orphaned, daemon=True).start()
    rank = int(os.environ["RANK"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"])) if spec["device"] == "cuda"
              else torch.device(spec["device"]))
    me = _Rank(rank, spec["config"], spec["traffic"], int(spec["seed"]), device, spec["impl"])
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "run":
            me.run()
        elif cmd == "start":
            me.start_window()
        elif cmd == "finish":
            me.finish()
        elif cmd == "share":
            proto.write(json.dumps(me.share()) + "\n")
            proto.flush()
        elif cmd == "exit":
            me.close()
            sys.stderr.flush()
            os._exit(0)
        else:
            raise ValueError(f"unknown command {cmd!r}")
    return 2  # rank 0 went away without an exit


if __name__ == "__main__":
    sys.exit(_serve(json.loads(sys.argv[1])))
