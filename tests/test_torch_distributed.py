"""The port's distributed Kron-Matmul (repro_torch.core.distributed, the
mesh KronOp and its consumers) against repro.core.distributed.

In this process: the round planning and comm arithmetic against the
reference's on a grid of shapes (fig11, gp16, qwen3-4b's Kron FFN, every
row of the paper's Table 4, and shapes with no legal round), the slab
clamp, the slab model, the relocation's layout with G ranks simulated by
threads, and the round chain's split into launches one block holds.

Across processes (``torch_mesh_driver.py``, once per module): eight gloo
CPU ranks as a ``(2, 4)`` DeviceMesh, and the reference on eight host
devices inside ``jax.set_mesh``, on the same numpy inputs: forward and
gradients of single and per-sample rounds at n_slabs 1 and 2 and
per-iteration (f64 1e-10; f32 1e-5 forward, 1e-4 gradients, relative to
max|ref|), the factor gradients summed over the mesh, slabbed bitwise equal
to serial, the all-to-all counts against ``comm_elems_per_device``, the
mesh ladder under ``chaos.inject``, ``kron_distributed`` around a
KronLinear, the GP epoch and MVM (1e-4), the measured plan, elastic meshes
and the shims.  Each side runs under its own timeout
(``SIDE_TIMEOUT_S``)."""
import math
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_mesh_driver as DRV
from _torch_parity import assert_close
from repro.core import distributed as JD
from repro.kernels import emit as JE
from repro_torch.core import autotune as TA
from repro_torch.core import distributed as TD
from repro_torch.core import engine
from repro_torch.core.kron import KronProblem
from repro_torch.kernels import emit as TE
from repro_torch.runtime import fault, guard

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDE_TIMEOUT_S = 420

# (id, M, [(P, Q), ...]): the paper's Table 4 (benchmarks/fig10.py).
TABLE4 = [
    (1, 20, [(128, 128)]), (2, 20, [(512, 512)]), (3, 50, [(512, 512)]),
    (4, 20, [(1024, 1024)]), (5, 1, [(2048, 2048)]), (6, 10, [(52, 50), (65, 20)]),
    (7, 50, [(32, 8), (64, 128)]), (8, 10, [(52, 65), (50, 20)]), (9, 4, [(512, 512)]),
    (10, 8, [(512, 512)]), (11, 16, [(512, 512)]), (12, 20, [(512, 512)]),
    (13, 4, [(8, 8)] * 3), (14, 8, [(8, 8)] * 3), (15, 16, [(8, 8)] * 3),
    (16, 20, [(8, 8)] * 3), (17, 1024, [(3, 3)] * 7), (18, 1024, [(4, 4)] * 7),
    (19, 1024, [(6, 6)] * 7), (20, 1, [(5, 5)] * 3 + [(2, 2)]),
    (21, 1, [(5, 5)] * 2 + [(2, 2), (25, 25)]), (22, 1526, [(4, 4)] * 6),
    (23, 156, [(8, 8)] * 3), (24, 2967, [(4, 4)] * 7), (25, 16, [(8, 8)] * 8),
    (26, 16, [(16, 16)] * 6), (27, 16, [(32, 32)] * 6), (28, 16, [(64, 64)] * 3),
]
# name -> (M, ps, qs): the configurations the smoke drives, and shapes with
# no legal round on some model axis.
NAMED = {
    "fig11": (16, (64,) * 4, (64,) * 4),
    "gp16": (16, (16,) * 6, (16,) * 6),
    "ffn-w1": (4096, (64, 40), (128, 76)),
    "ffn-w2": (4096, (128, 76), (64, 40)),
    "no-round-q3": (8, (4, 4), (3, 3)),
    "no-round-p3": (8, (3, 3, 3), (3, 3, 3)),
}
SHAPES = {f"table4-{i}": (m, tuple(p for p, _ in fs), tuple(q for _, q in fs))
          for i, m, fs in TABLE4}
SHAPES.update(NAMED)
GRID = [(name, g_k) for name, (_, ps, _) in SHAPES.items() for g_k in (2, 4)
        if math.prod(ps) % g_k == 0]


def _rounds_both(name, g_k, minimal):
    """(port, reference) round plans, or the name of the error each raised."""
    _, ps, qs = SHAPES[name]
    k = math.prod(ps)
    out = []
    for mod in (TD, JD):
        try:
            out.append(mod.plan_rounds(k // g_k, ps[::-1], qs[::-1], g_k, minimal=minimal))
        except ValueError as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("name,g_k", GRID)
def test_plan_rounds_matches_reference(name, g_k):
    for minimal in (False, True):
        got, want = _rounds_both(name, g_k, minimal)
        assert got == want, (minimal, got, want)


@pytest.mark.parametrize("name,g_k", GRID)
def test_comm_elems_match_reference(name, g_k):
    m, ps, qs = SHAPES[name]
    k = math.prod(ps)
    if isinstance(_rounds_both(name, g_k, False)[0], str):
        with pytest.raises(guard.PlanError):
            TD.comm_elems_per_device(m, k // g_k, ps[::-1], qs[::-1], g_k)
        return
    for batch in (1, 3):
        for n_slabs in (1, 2, 4):
            args = (max(1, m // 2), k // g_k, ps[::-1], qs[::-1], g_k)
            kw = dict(batch=batch, n_slabs=n_slabs)
            assert TD.comm_elems_per_device(*args, **kw) == JD.comm_elems_per_device(*args, **kw)
            assert TD.comm_hidden_elems(*args, **kw) == JD.comm_hidden_elems(*args, **kw)


@pytest.mark.parametrize("size", [0, 1, 2, 3, 6, 8, 12, 16, 17, 4096])
def test_effective_slabs_and_split_match_reference(size):
    for n in (0, 1, 2, 3, 4, 5, 8, 64):
        assert TE.effective_slabs(size, n) == JE.effective_slabs(size, n)
    y = torch.arange(max(size, 1) * 3.0).reshape(max(size, 1), 3)
    slabs = TE.split_slabs(y, TE.effective_slabs(int(y.shape[0]), 4))
    assert torch.equal(torch.cat(slabs), y) and len(slabs) == TE.effective_slabs(len(y), 4)
    assert all(s.data_ptr() >= y.data_ptr() for s in slabs)  # views of y
    with pytest.raises(ValueError, match="effective_slabs"):
        TE.split_slabs(torch.zeros(6, 2), 4)


@pytest.mark.parametrize("name", ["fig11", "gp16", "ffn-w1", "table4-18", "table4-22"])
@pytest.mark.parametrize("g_k", [2, 4])
def test_choose_n_slabs_is_monotone_in_rows(name, g_k):
    """More rows per rank never plan fewer slabs; tiny problems plan serial;
    the count always divides the rows."""
    _, ps, qs = SHAPES[name]
    prev = 1
    for m in (1, 2, 4, 16, 256, 4096, 65536):
        for b in (1, 4):
            n = TA.choose_n_slabs(KronProblem(m, ps, qs), g_k, batch=b)
            assert m % n == 0 and n in (1, 2, 4)
        n = TA.choose_n_slabs(KronProblem(m, ps, qs), g_k)
        assert n >= prev, (m, n, prev)
        prev = n
    assert TA.choose_n_slabs(KronProblem(1, ps, qs), g_k) == 1
    assert TA.choose_n_slabs(KronProblem(4096, ps, qs), 1) == 1


def test_distributed_plans():
    prob = KronProblem(8, (16,) * 6, (16,) * 6)
    with pytest.raises(ValueError, match="shared_factors=False"):
        TA.make_batched_plan(prob, 4, shared_factors=True, g_k=2)
    plan = TA.make_batched_plan(prob, 4, shared_factors=False, g_k=2)
    assert plan.t_b == 1 and plan.n_slabs in (1, 2, 4)
    assert TA.make_batched_plan(prob, 4, shared_factors=False, g_k=2, tune="measure") == plan
    big = TA.make_batched_plan(KronProblem(65536, (16,) * 6, (16,) * 6), 4,
                               shared_factors=False, g_k=4)
    assert big.n_slabs > 1 and f"[slabs={big.n_slabs}]" in big.describe()
    assert TA.plan_from_json(TA.plan_to_json(big)) == big
    legacy = TA.plan_to_json(big)
    del legacy["n_slabs"]
    assert TA.plan_from_json(legacy).n_slabs == 1
    cands = TA._dist_plan_candidates(KronProblem(6, (4, 4), (4, 4)), dtype_bytes=4,
                                     enable_fusion=True, vmem_budget_elems=TE.SMEM_BUDGET_ELEMS,
                                     acc_dtype=None)
    assert [c.n_slabs for c in cands] == [1, 2, 3]  # 4 slabs clamp to 3 on 6 rows
    assert TA._dist_round_payload_elems(KronProblem(8, (4, 4, 4), (4, 4, 4)), 4) == 8 * 16


@pytest.mark.parametrize("g_k,b,m,chunk,u", [(2, 1, 3, 1, 2), (4, 2, 2, 2, 3), (4, 1, 1, 1, 1),
                                             (3, 2, 4, 2, 1), (8, 1, 2, 1, 4)])
def test_relocation_layout(g_k, b, m, chunk, u):
    """G ranks as threads exchanging through a list: after the relocation
    rank d holds global columns [d*C, (d+1)*C) in order, where local column
    (q, s) of rank r was global column (q*G_K + r)*U + s; the transpose
    undoes it."""
    q_prod = g_k * chunk
    c = q_prod * u
    ys = []
    for r in range(g_k):
        q = torch.arange(q_prod).repeat_interleave(u)
        s = torch.arange(u).repeat(q_prod)
        cols = ((q * g_k + r) * u + s).double()
        rows = torch.arange(b * m).double().reshape(b, m, 1) * 1e4
        ys.append(rows + cols)
    bufs = [None] * g_k
    barrier = threading.Barrier(g_k)

    def exchange_of(r):
        def exchange(send):
            bufs[r] = send
            barrier.wait()
            recv = torch.stack([bufs[i][r] for i in range(g_k)])
            barrier.wait()
            return recv, lambda: None
        return exchange

    def run(fn, inputs):
        outs = [None] * g_k
        threads = [threading.Thread(target=lambda r=r: outs.__setitem__(
            r, fn(inputs[r], q_prod, g_k, exchange_of(r)))) for r in range(g_k)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return outs

    moved = run(TD._relocate_batched, ys)
    for d in range(g_k):
        want = torch.arange(d * c, (d + 1) * c).double() + torch.arange(b * m).double().reshape(
            b, m, 1) * 1e4
        assert torch.equal(moved[d], want)
    assert all(torch.equal(a, y) for a, y in zip(run(TD._relocate_batched_t, moved), ys))
    flat = run(TD._relocate_batched, [y[0] for y in ys])  # a 2-D operand
    assert all(torch.equal(a, w[0]) for a, w in zip(flat, moved))


def test_round_instrs_split_what_one_block_cannot_hold():
    # fig11's first round at (1, 4): three 64 x 64 factors, 262,144 columns
    # per contraction, more than one block holds: two launches.
    k = 64 ** 4 // 4
    instrs = TD._round_instrs(4, k, (64,) * 3, (64,) * 3, False, 4, 4)
    assert [ids for _, ids in instrs] == [(0, 1), (2,)]
    for ins, ids in instrs:
        TE.chain_geometry((1, 4, k), [(1, 64, 64)] * len(ids), t_m=ins.t_m, t_k=ins.t_k)
    one = TD._round_instrs(8, 256, (16, 16), (16, 16), True, 4, 4)
    assert len(one) == 1 and one[0][0].t_b == 1 and one[0][1] == (0, 1)
    with pytest.raises(guard.VmemOverflowError):
        TD._round_instrs(1, 2 ** 20, (2 ** 20,), (2 ** 20,), False, 4, 4)


def test_round_falls_back_per_factor_when_no_tile_fits(monkeypatch):
    guard.reset_health()
    x = torch.randn(4, 64, dtype=torch.float64)
    fs = tuple(torch.randn(4, 4, dtype=torch.float64) for _ in range(3))
    want = TD._local_multiply_round(x, fs, "torch")

    def no_fit(*a, **k):
        raise guard.VmemOverflowError("no block tile fits")

    monkeypatch.setattr(TD, "_round_instrs", no_fit)
    with pytest.warns(guard.GuardWarning, match="per-factor"):
        got = TD._local_multiply_round(x, fs, "torch")
    assert_close(got, want.numpy(), 1e-12)
    assert guard.health_report()["events"]["round_per_factor"] == 1
    guard.reset_health()


class _StandInMesh:
    """What a KronOp's construction reads of a mesh: dim names and sizes."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape


def test_mesh_kron_op_construction_and_cost():
    mesh = _StandInMesh((2, 4))
    op = engine.KronOp((4, 4, 4), (4, 4, 4), mesh=mesh, n_slabs=2)
    assert (op.g_m, op.g_k, op.rounds) == (2, 4, (2, 1)) and op.plan is None
    assert "mesh(2x4)" in op.describe() and "rounds[2, 1]" in op.describe()
    cost = op.cost(8)
    args = (4, 16, (4, 4, 4), (4, 4, 4), 4)
    assert cost.comm_elems_per_device == JD.comm_elems_per_device(*args)
    assert cost.comm_hidden_elems == JD.comm_hidden_elems(*args, n_slabs=2)
    assert (cost.rounds, cost.n_slabs) == (2, 2) and cost.critical_path_s > 0
    assert op.with_mesh(mesh, per_iteration=True).rounds == (1, 1, 1)
    assert op.with_batch(3).mesh is mesh and engine.KronOp((4,), (4,)).cost().rounds == 0
    assert engine.kron_op_for((4, 4, 4), (4, 4, 4), mesh=mesh) is engine.kron_op_for(
        (4, 4, 4), (4, 4, 4), mesh=mesh)
    with pytest.raises(ValueError, match="G_K"):
        engine.KronOp((3, 3), (3, 3), mesh=mesh)
    with pytest.raises(guard.PlanError, match="relocate"):
        engine.KronOp((4, 4), (3, 3), mesh=_StandInMesh((1, 2)))
    with pytest.raises(ValueError, match="n_slabs"):
        engine.KronOp((4,), (4,), n_slabs=0)
    per = engine.KronOp((16,) * 6, (16,) * 6, batch=4, shared_factors=False,
                        mesh=_StandInMesh((2, 2)))
    assert per.plan.n_slabs >= 1 and per.cost(16).comm_elems_per_device == JD.comm_elems_per_device(
        8, 16 ** 6 // 2, (16,) * 6, (16,) * 6, 2, batch=4)


def test_profile_reports_the_comm_block():
    """A mesh op profiles its local-equivalent program, with the round
    schedule's collective cost predicted under "comm"."""
    op = engine.KronOp((4, 4, 4), (4, 4, 4), mesh=_StandInMesh((2, 4)), n_slabs=2)
    x = torch.randn(8, 64, dtype=torch.float64)
    fs = [torch.randn(4, 4, dtype=torch.float64) for _ in range(3)]
    report = op.profile(x, fs, warmup=0, iters=1)
    cost = op.cost(8)
    assert report["signature"]["mesh"] == [2, 4] and len(report["stages"]) >= 1
    assert report["comm"]["elems_per_device"] == cost.comm_elems_per_device
    assert (report["comm"]["rounds"], report["comm"]["n_slabs"]) == (2, 2)
    assert report["comm"]["hidden_elems"] == cost.comm_hidden_elems
    assert report["comm"]["measured_s"] is None


def test_elastic_shape_and_mesh_need_a_world():
    assert [fault.elastic_shape(n, w) for n, w in [(8, 16), (8, 2), (6, 16), (1, 4), (12, 4)]] == [
        (1, 8), (4, 2), (3, 2), (1, 1), (3, 4)]
    with pytest.raises(ValueError, match="ranks given"):
        fault.elastic_mesh(4, devices=[0, 1], device_type="cpu")


# ---------------------------------------------------------------------------
# The two sides, once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the port's gloo side and the reference's in parallel; their
    outputs as dicts."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("FASTKRON_CHAOS", None)
    procs = {
        side: subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_driver.py"), side,
             str(tmp / f"{side}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side in ("torch", "jax")
    }
    out = {}
    for side, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=SIDE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        assert proc.returncode == 0 and "ALL-OK" in log, f"{side} side:\n{log[-6000:]}"
        out[side] = dict(np.load(tmp / f"{side}.npz"))
    return out


def _tol(dtype, qty):
    if dtype == "float64":
        return 1e-10
    return 1e-5 if qty == "y" else 1e-4


QTYS = ("y", "dx", "df0", "df1", "df2")
ROUND_CASES = ([(name, tag) for name in DRV.SINGLE for tag in ("slabs1", "slabs2", "periter")]
               + [(name, tag) for name in DRV.PER_SAMPLE for tag in ("slabs1", "slabs2")])


def _dtype(name):
    return (DRV.SINGLE.get(name) or DRV.PER_SAMPLE[name])[-1]


@pytest.mark.parametrize("name,tag", ROUND_CASES)
@pytest.mark.parametrize("qty", QTYS)
def test_mesh_rounds_match_reference(runs, name, tag, qty):
    key = f"{name}/{tag}/{qty}"
    assert_close(torch.from_numpy(runs["torch"][key]), runs["jax"][key], _tol(_dtype(name), qty))


@pytest.mark.parametrize("name", list(DRV.SINGLE))
@pytest.mark.parametrize("tag", ["slabs1", "slabs2", "periter"])
def test_factor_grads_are_summed_over_the_mesh(runs, name, tag):
    """Every rank holds the whole problem's dF: the local op's, not its own
    partial sum."""
    t = runs["torch"]
    for i in range(3):
        assert t[f"check/{name}/{tag}/df{i}_same_on_all_ranks"] == 1
        assert_close(torch.from_numpy(t[f"{name}/{tag}/df{i}"]), t[f"{name}/local/df{i}"],
                     _tol(_dtype(name), "df"))
    assert_close(torch.from_numpy(t[f"{name}/{tag}/dx"]), t[f"{name}/local/dx"],
                 _tol(_dtype(name), "dx"))


@pytest.mark.parametrize("qty", QTYS)
def test_replicated_mesh_dim_is_not_summed_twice(runs, qty):
    """On (pod, data, model) the ranks along ``pod`` hold the same partial
    dF: the sum runs over data and model only, as the reference's does."""
    got = torch.from_numpy(runs["torch"][f"pod/{qty}"])
    assert_close(got, runs["jax"][f"pod/{qty}"], 1e-10)
    assert_close(got, runs["torch"][f"{DRV.POD_CASE}/local/{qty}"], 1e-10)


@pytest.mark.parametrize("name", list(DRV.SINGLE) + list(DRV.PER_SAMPLE))
def test_slabbed_is_bitwise_serial_and_counts_match_comm(runs, name):
    t = runs["torch"]
    assert t[f"check/{name}/slabs2_bitwise"] == 1
    for tag in ("slabs1", "slabs2") + (("periter",) if name in DRV.SINGLE else ()):
        calls, want_calls = t[f"check/{name}/{tag}/a2a_calls"]
        elems, want_elems = t[f"check/{name}/{tag}/a2a_elems"]
        assert calls == want_calls and elems == want_elems, (tag, calls, elems)


def test_replicated_operands_come_back_replicated(runs):
    t = runs["torch"]
    for q in QTYS:
        assert_close(torch.from_numpy(t[f"replicated/{q}"]), t[f"sq444-f64/local/{q}"], 1e-10)


def test_mesh_ladder_under_chaos(runs):
    t = runs["torch"]
    # collective: slabbed, then serial rounds fail; the local rung's result
    # is the local op's, bitwise (the same op on the gathered x).
    assert torch.equal(torch.from_numpy(t["ladder/collective/y"]),
                       torch.from_numpy(t["ladder/local/y"]))
    assert t["check/ladder/collective/a2a_calls"] == 0
    assert t["check/ladder/collective/warnings"] == 2  # one per failed rung key
    assert t["check/ladder/collective/degraded"] == 2
    # slab_collective: serial rounds, bitwise equal to the planned serial call.
    assert t["check/ladder/slab/serial_bitwise"] == 1
    assert t["check/ladder/slab/warnings"] == 1 and t["check/ladder/slab/degraded"] == 2
    assert t["check/ladder/slab/a2a_calls"] == 2 * 2  # 2 calls x 2 serial rounds
    # round_chain: per-factor multiplies inside the rounds, the relocations
    # unchanged (one all-to-all per round and slab), one warning per key.
    assert t["check/ladder/round_chain/events"] == 2 * 2 * 2
    assert t["check/ladder/round_chain/a2a_calls"] == 2 * 2 * 2
    assert t["check/ladder/round_chain/warnings"] == 2  # the two rounds' signatures
    assert t["check/ladder/round_chain/degraded"] == 0
    assert_close(torch.from_numpy(t["ladder/round_chain/y"]), t["ladder/serial/y"], 1e-5)
    for tag in ("collective", "slab", "round_chain"):
        assert t[f"check/ladder/{tag}/repeat_bitwise"] == 1


def test_kron_distributed_linear_matches_local(runs):
    t = runs["torch"]
    assert t["check/linear/scope0/a2a_calls"] == 0 and t["check/linear/scope1/a2a_calls"] == 2
    for i in range(5):  # y, dx, and the three factor gradients
        assert_close(torch.from_numpy(t[f"linear/mesh/{i}"]), t[f"linear/local/{i}"], 1e-10)


@pytest.mark.parametrize("key", ["gp/x", "gp/res", "gp/mvm"])
def test_gp_on_the_mesh_matches_reference(runs, key):
    assert_close(torch.from_numpy(runs["torch"][key]), runs["jax"][key], 1e-4)


def test_gp_epoch_replicated_and_local_agree(runs):
    t = runs["torch"]
    for q in ("x", "res"):
        assert_close(torch.from_numpy(t[f"gp/{q}_replicated"]), t[f"gp/{q}_local"], 1e-4)
        assert_close(torch.from_numpy(t[f"gp/{q}"]), t[f"gp/{q}_local"], 1e-4)


def test_measured_dist_plan_agrees_across_ranks_and_hits(runs):
    t = runs["torch"]
    assert t["check/measure/misses"] == 1 and t["check/measure/hits"] == 1
    assert t["check/measure/same_plan"] == 1 and t["check/measure/key_suffix"] == 1
    assert t["check/measure/n_slabs_same_on_all_ranks"] == 1


@pytest.mark.parametrize("n,w", DRV.ELASTIC)
def test_elastic_mesh_matches_reference(runs, n, w):
    key = f"elastic/{n}/{w}"
    assert tuple(runs["torch"][key]) == tuple(runs["jax"][key])


def test_constructors_shims_and_cost(runs):
    t = runs["torch"]
    assert tuple(t["check/elastic_mesh_shape"]) == (2, 4)
    assert t["check/prebuild_mesh_ops"] == 2
    assert t["check/shim_deprecations"] == 2
    assert_close(torch.from_numpy(t["shim/y"]), t["sq444-f64/local/y"], 1e-10)
    assert_close(torch.from_numpy(t["shim/yb"]), runs["jax"]["ps444-f64/slabs1/y"], 1e-10)
    comm = JD.comm_elems_per_device(4, 16, (4, 4, 4), (4, 4, 4), 4)
    hidden = JD.comm_hidden_elems(4, 16, (4, 4, 4), (4, 4, 4), 4, n_slabs=2)
    assert tuple(t["check/cost"]) == (comm, 2, hidden, 2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_rank(rank, world, store, errs):
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        from repro_torch.launch.mesh import make_debug_mesh

        mesh = make_debug_mesh(1, 2)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(8, 4096, generator=gen, device="cuda")
        fs = [torch.randn(8, 8, generator=gen, device="cuda") for _ in range(4)]
        got = TD.gather(engine.KronOp((8,) * 4, (8,) * 4, mesh=mesh)(
            TD.sharded_input(x, mesh), fs))
        want = engine.KronOp((8,) * 4, (8,) * 4)(x, fs)
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, err
        dist.destroy_process_group()
    except BaseException as e:  # reported by the parent
        errs.put(f"rank {rank}: {type(e).__name__}: {e}")
        raise


@pytest.mark.cuda
def test_mesh_rounds_on_the_card(tmp_path):
    """Two gloo ranks on one card run the rounds through the kernels and
    match the local op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh rounds through the kernels")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    errs = ctx.Queue()
    mp.start_processes(_card_rank, args=(2, str(tmp_path / "store"), errs), nprocs=2,
                       start_method="spawn")
    assert errs.empty()
