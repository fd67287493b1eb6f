"""The mesh runs behind tests/test_torch_distributed.py: the same numpy
inputs through the port's mesh rounds and through the JAX reference's.

    python tests/torch_mesh_driver.py torch OUT.npz   # 8 gloo CPU ranks as (2, 4)
    python tests/torch_mesh_driver.py jax OUT.npz     # the reference on 8 host devices

``torch`` spawns eight ``torch.multiprocessing`` ranks in a gloo process
group (a ``file://`` store under a temporary directory) and a ``(2, 4)``
``DeviceMesh`` named ``("data", "model")`` on the CPU; rank 0 writes every
output and check to ``OUT.npz``.  ``jax`` sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before importing
jax and runs the reference's runners inside ``with jax.set_mesh(mesh):``
(its reshapes and ``jax.grad`` over explicitly sharded arrays need the
mesh context).  Keys are ``<case>/<quantity>``; the port's own checks are
0/1 or counts under ``check/...``.  Inputs are made with numpy from the
case's seed.  A rank's failure prints its traceback and fails the run.
"""
from __future__ import annotations

import math
import os
import sys
import tempfile
import traceback

import numpy as np

G_M, G_K = 2, 4

# name -> (seed, m, ps, qs, dtype): single-problem rounds with shared factors.
SINGLE = {
    "sq444-f64": (0, 8, (4, 4, 4), (4, 4, 4), "float64"),
    "rect-f64": (1, 8, (2, 4, 2), (4, 2, 4), "float64"),
    "sq444-f32": (2, 8, (4, 4, 4), (4, 4, 4), "float32"),
}
# name -> (seed, batch, m, ps, qs, dtype): per-sample factors.
PER_SAMPLE = {
    "ps444-f64": (3, 2, 8, (4, 4, 4), (4, 4, 4), "float64"),
    "ps444-f32": (4, 2, 8, (4, 4, 4), (4, 4, 4), "float32"),
}
SLABS = (1, 2)
GP = {"seed": 5, "batch": 2, "m": 8, "sizes": (4, 4, 4), "cg_iters": 3, "noise": 0.1}
LINEAR = {"seed": 6, "batch": 2, "seq": 4, "ps": (4, 4, 4), "qs": (4, 4, 4)}
ELASTIC = [(n, w) for n in (1, 2, 4, 6, 8) for w in (1, 2, 4, 16)]
# A third, replicated mesh dim ahead of (data, model), as the multi-pod
# production mesh has: the same eight ranks as (pod, data, model).
POD_MESH, POD_AXES, POD_CASE = (2, 2, 2), ("pod", "data", "model"), "sq444-f64"


def single_inputs(name):
    seed, m, ps, qs, dtype = SINGLE[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, math.prod(ps))).astype(dtype)
    fs = [rng.standard_normal((p, q)).astype(dtype) for p, q in zip(ps, qs)]
    ct = rng.standard_normal((m, math.prod(qs))).astype(dtype)
    return x, fs, ct


def per_sample_inputs(name):
    seed, b, m, ps, qs, dtype = PER_SAMPLE[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, m, math.prod(ps))).astype(dtype)
    fs = [rng.standard_normal((b, p, q)).astype(dtype) for p, q in zip(ps, qs)]
    ct = rng.standard_normal((b, m, math.prod(qs))).astype(dtype)
    return x, fs, ct


def gp_inputs():
    """Per-sample RBF kernels on jittered grids (B, P, P) and the probe
    block v (B, M, prod P), float64."""
    rng = np.random.default_rng(GP["seed"])
    b = GP["batch"]
    ks = []
    for p in GP["sizes"]:
        grids = np.sort(rng.uniform(0, 1, (b, p)), axis=-1)
        ls = rng.uniform(0.15, 0.4, b)
        d = grids[:, :, None] - grids[:, None, :]
        ks.append(np.exp(-0.5 * (d / ls[:, None, None]) ** 2) + 1e-4 * np.eye(p))
    v = rng.standard_normal((b, GP["m"], math.prod(GP["sizes"])))
    return ks, v


def linear_inputs():
    rng = np.random.default_rng(LINEAR["seed"])
    d_in = math.prod(LINEAR["ps"])
    x = rng.standard_normal((LINEAR["batch"], LINEAR["seq"], d_in))
    fs = [rng.standard_normal((p, q)) / 2 for p, q in zip(LINEAR["ps"], LINEAR["qs"])]
    ct = rng.standard_normal((LINEAR["batch"], LINEAR["seq"], math.prod(LINEAR["qs"])))
    return x, fs, ct


# ---------------------------------------------------------------------------
# The JAX reference
# ---------------------------------------------------------------------------


def run_jax(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.core import distributed as JD
    from repro.gp import ski as JS
    from repro.runtime import fault as JF

    mesh = jax.make_mesh((G_M, G_K), ("data", "model"))
    out = {}

    def grads(fn, x, fs, ct):
        y, vjp = jax.vjp(fn, x, tuple(fs))
        dx, dfs = vjp(ct)
        return y, dx, dfs

    with jax.set_mesh(mesh):
        for name in SINGLE:
            x, fs, ct = single_inputs(name)
            xs = JD.sharded_input(jnp.asarray(x), mesh)
            cts = JD.sharded_input(jnp.asarray(ct), mesh)
            fj = tuple(jnp.asarray(f) for f in fs)
            for tag, kw in [(f"slabs{n}", dict(n_slabs=n)) for n in SLABS] + [
                    ("periter", dict(per_iteration=True))]:
                y, dx, dfs = grads(lambda a, b, kw=kw: JD.run_distributed_rounds(
                    a, b, mesh, backend="xla", **kw), xs, fj, cts)
                out[f"{name}/{tag}/y"] = np.asarray(y)
                out[f"{name}/{tag}/dx"] = np.asarray(dx)
                for i, d in enumerate(dfs):
                    out[f"{name}/{tag}/df{i}"] = np.asarray(d)
        for name in PER_SAMPLE:
            x, fs, ct = per_sample_inputs(name)
            xs = JD.sharded_input_batched(jnp.asarray(x), mesh)
            cts = JD.sharded_input_batched(jnp.asarray(ct), mesh)
            fj = tuple(jnp.asarray(f) for f in fs)
            for n in SLABS:
                y, dx, dfs = grads(lambda a, b, n=n: JD.run_batched_distributed_rounds(
                    a, b, mesh, backend="xla", n_slabs=n), xs, fj, cts)
                out[f"{name}/slabs{n}/y"] = np.asarray(y)
                out[f"{name}/slabs{n}/dx"] = np.asarray(dx)
                for i, d in enumerate(dfs):
                    out[f"{name}/slabs{n}/df{i}"] = np.asarray(d)
        ks, v = gp_inputs()
        kernel = JS.BatchedKronKernel(tuple(jnp.asarray(k) for k in ks))
        xg, res = JS.gp_train_epoch_batched(
            kernel, JD.sharded_input_batched(jnp.asarray(v), mesh), noise=GP["noise"],
            cg_iters=GP["cg_iters"], mesh=mesh)
        out["gp/x"] = np.asarray(xg)
        out["gp/res"] = np.asarray(res)
        out["gp/mvm"] = np.asarray(kernel.matmul(
            JD.sharded_input_batched(jnp.asarray(v), mesh), mesh=mesh))
    pod = jax.make_mesh(POD_MESH, POD_AXES)
    with jax.set_mesh(pod):
        x, fs, ct = single_inputs(POD_CASE)
        y, dx, dfs = grads(lambda a, b: JD.run_distributed_rounds(a, b, pod, backend="xla"),
                           JD.sharded_input(jnp.asarray(x), pod),
                           tuple(jnp.asarray(f) for f in fs),
                           JD.sharded_input(jnp.asarray(ct), pod))
        out["pod/y"], out["pod/dx"] = np.asarray(y), np.asarray(dx)
        for i, d in enumerate(dfs):
            out[f"pod/df{i}"] = np.asarray(d)
    for n, w in ELASTIC:
        m = JF.elastic_mesh(n, want_model=w, devices=jax.devices()[:n])
        out[f"elastic/{n}/{w}"] = np.asarray([m.shape["data"], m.shape["model"]])
    np.savez(out_path, **out)
    print("ALL-OK", flush=True)


# ---------------------------------------------------------------------------
# The port, on 8 gloo ranks
# ---------------------------------------------------------------------------


def _torch_rank(rank: int, world: int, store: str, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        torch.set_num_threads(1)
        out = _torch_checks(rank)
        if rank == 0:
            np.savez(out_path, **out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _torch_checks(rank: int) -> dict:
    import warnings

    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.core import engine
    from repro_torch.core.layers import KronLinear, KronLinearSpec, kron_distributed
    from repro_torch.gp import ski as TS
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import chaos, fault, guard
    from repro_torch.train.steps import prebuild_kron_ops

    mesh = make_debug_mesh(G_M, G_K, device_type="cpu")
    out: dict = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def same_on_all_ranks(v: torch.Tensor) -> bool:
        ref = v.detach().clone()
        dist.broadcast(ref, src=0)
        ok = torch.tensor([int(torch.equal(ref, v.detach()))])
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return bool(ok.item())

    def mesh_call(op, x, fs, ct, sharded):
        """(y, dx, dfs) of one mesh call, x and ct as DTensors or full."""
        xin = (D.sharded_input_batched(t(x), mesh) if x.ndim == 3 else
               D.sharded_input(t(x), mesh)) if sharded else t(x)
        xin.requires_grad_()
        fin = [t(f).requires_grad_() for f in fs]
        c0 = (D.all_to_all_calls, D.all_to_all_elems)
        y = op(xin, fin)
        fwd = (D.all_to_all_calls - c0[0], D.all_to_all_elems - c0[1])
        cin = ((D.sharded_input_batched(t(ct), mesh) if ct.ndim == 3 else
                D.sharded_input(t(ct), mesh)) if sharded else t(ct))
        g = torch.autograd.grad(y, (xin, *fin), cin)
        full = D.gather if sharded else (lambda v: v)
        return full(y).detach(), full(g[0]).detach(), [d.detach() for d in g[1:]], fwd

    # -- single-problem rounds: slabs, per-iteration, bitwise, summed dF --
    for name, (_, m, ps, qs, _) in SINGLE.items():
        x, fs, ct = single_inputs(name)
        runs = {}
        for tag, kw in [(f"slabs{n}", dict(n_slabs=n)) for n in SLABS] + [
                ("periter", dict(per_iteration=True, n_slabs=1))]:
            op = engine.KronOp(ps, qs, mesh=mesh, **kw)
            y, dx, dfs, fwd = mesh_call(op, x, fs, ct, sharded=True)
            runs[tag] = (y, dx, dfs)
            out[f"{name}/{tag}/y"] = y.numpy()
            out[f"{name}/{tag}/dx"] = dx.numpy()
            for i, d in enumerate(dfs):
                out[f"{name}/{tag}/df{i}"] = d.numpy()
                out[f"check/{name}/{tag}/df{i}_same_on_all_ranks"] = int(same_on_all_ranks(d))
            n = op._resolve_n_slabs(m // G_M, x.itemsize)
            out[f"check/{name}/{tag}/a2a_calls"] = np.asarray([fwd[0], len(op.rounds) * n])
            out[f"check/{name}/{tag}/a2a_elems"] = np.asarray([fwd[1], op.cost(m).comm_elems_per_device])
        for n in SLABS[1:]:
            same = all(torch.equal(a, b) for a, b in zip(
                (runs[f"slabs{n}"][0], runs[f"slabs{n}"][1], *runs[f"slabs{n}"][2]),
                (runs["slabs1"][0], runs["slabs1"][1], *runs["slabs1"][2])))
            out[f"check/{name}/slabs{n}_bitwise"] = int(same)
        # The local op on one rank: the summed dF is the whole problem's.
        lop = engine.KronOp(ps, qs)
        xl = t(x).requires_grad_()
        fl = [t(f).requires_grad_() for f in fs]
        yl = lop(xl, fl)
        gl = torch.autograd.grad(yl, (xl, *fl), t(ct))
        out[f"{name}/local/y"] = yl.detach().numpy()
        out[f"{name}/local/dx"] = gl[0].numpy()
        for i, d in enumerate(gl[1:]):
            out[f"{name}/local/df{i}"] = d.numpy()

    # -- per-sample rounds --
    for name, (_, b, m, ps, qs, _) in PER_SAMPLE.items():
        x, fs, ct = per_sample_inputs(name)
        runs = {}
        for n in SLABS:
            op = engine.KronOp(ps, qs, batch=b, shared_factors=False, mesh=mesh, n_slabs=n)
            y, dx, dfs, fwd = mesh_call(op, x, fs, ct, sharded=True)
            runs[n] = (y, dx, *dfs)
            out[f"{name}/slabs{n}/y"] = y.numpy()
            out[f"{name}/slabs{n}/dx"] = dx.numpy()
            for i, d in enumerate(dfs):
                out[f"{name}/slabs{n}/df{i}"] = d.numpy()
            out[f"check/{name}/slabs{n}/a2a_calls"] = np.asarray([fwd[0], len(op.rounds) * n])
            out[f"check/{name}/slabs{n}/a2a_elems"] = np.asarray(
                [fwd[1], op.cost(m).comm_elems_per_device])
        out[f"check/{name}/slabs2_bitwise"] = int(all(
            torch.equal(a, b) for a, b in zip(runs[2], runs[1])))

    # -- full (replicated) operands: sliced locally, gathered back --
    x, fs, ct = single_inputs("sq444-f64")
    y, dx, dfs, _ = mesh_call(engine.KronOp((4, 4, 4), (4, 4, 4), mesh=mesh, n_slabs=2),
                              x, fs, ct, sharded=False)
    out["replicated/y"], out["replicated/dx"] = y.numpy(), dx.numpy()
    for i, d in enumerate(dfs):
        out[f"replicated/df{i}"] = d.numpy()

    # -- a (pod, data, model) mesh: dF summed over data and model only --
    from torch.distributed.device_mesh import init_device_mesh

    pod = init_device_mesh("cpu", POD_MESH, mesh_dim_names=POD_AXES)
    x, fs, ct = single_inputs(POD_CASE)
    xin = D.sharded_input(t(x), pod).requires_grad_()
    fin = [t(f).requires_grad_() for f in fs]
    y = engine.KronOp((4, 4, 4), (4, 4, 4), mesh=pod)(xin, fin)
    g = torch.autograd.grad(y, (xin, *fin), D.sharded_input(t(ct), pod))
    out["pod/y"], out["pod/dx"] = D.gather(y).detach().numpy(), D.gather(g[0]).numpy()
    for i, d in enumerate(g[1:]):
        out[f"pod/df{i}"] = d.numpy()

    # -- the mesh ladder under chaos.inject --
    x, fs, _ = single_inputs("sq444-f32")
    xs = D.sharded_input(t(x), mesh)
    ftt = [t(f) for f in fs]
    serial = D.gather(engine.KronOp((4, 4, 4), (4, 4, 4), mesh=mesh, n_slabs=1)(xs, ftt))
    local = engine.KronOp((4, 4, 4), (4, 4, 4))(t(x), ftt)
    for spec, tag in [("collective", "collective"), ("slab_collective", "slab"),
                      ("round_chain", "round_chain")]:
        guard.reset_health()
        op = engine.KronOp((4, 4, 4), (4, 4, 4), mesh=mesh, n_slabs=2)
        c0 = D.all_to_all_calls
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with chaos.inject(spec):
                y1 = D.gather(op(xs, ftt))
                y2 = D.gather(op(xs, ftt))
        report = guard.health_report()
        mesh_key = [h for k, h in report["ops"].items() if k.startswith("('mesh'")]
        out[f"check/ladder/{tag}/warnings"] = sum(
            issubclass(w.category, guard.GuardWarning) for w in caught)
        out[f"check/ladder/{tag}/rung"] = mesh_key[0]["rung"] if mesh_key else -1
        out[f"check/ladder/{tag}/degraded"] = mesh_key[0]["degraded_calls"] if mesh_key else 0
        out[f"check/ladder/{tag}/a2a_calls"] = D.all_to_all_calls - c0
        out[f"check/ladder/{tag}/events"] = report["events"].get("round_per_factor", 0)
        out[f"ladder/{tag}/y"] = y1.numpy()
        out[f"check/ladder/{tag}/repeat_bitwise"] = int(torch.equal(y1, y2))
        out[f"check/ladder/{tag}/serial_bitwise"] = int(torch.equal(y1, serial))
    out["ladder/local/y"] = local.numpy()
    out["ladder/serial/y"] = serial.numpy()
    guard.reset_health()

    # -- kron_distributed KronLinear against local --
    x, fs, ct = linear_inputs()
    spec = KronLinearSpec(LINEAR["ps"], LINEAR["qs"])
    layer = KronLinear(torch.Generator().manual_seed(0), spec, torch.float64, device="cpu")
    with torch.no_grad():
        for p, f in zip(layer.factors, fs):
            p.copy_(t(f))
    grads = {}
    for scope in (False, True):
        xin = t(x).requires_grad_()
        c0 = D.all_to_all_calls
        if scope:
            with kron_distributed(mesh):
                y = layer(xin)
        else:
            y = layer(xin)
        calls = D.all_to_all_calls - c0
        g = torch.autograd.grad(y, (xin, *layer.factors), t(ct))
        grads[scope] = (y.detach(), *g)
        out[f"check/linear/scope{int(scope)}/a2a_calls"] = calls
    out["linear/local/y"] = grads[False][0].numpy()
    for i, (a, b) in enumerate(zip(grads[True], grads[False])):
        out[f"linear/mesh/{i}"] = a.numpy()
        out[f"linear/local/{i}"] = b.numpy()

    # -- the GP epoch and the batched MVM on the mesh --
    ks, v = gp_inputs()
    from repro_torch import convert

    kernel = TS.BatchedKronKernel(convert.factors_from_numpy(ks, device="cpu"))
    vt = convert.factors_from_numpy([v], device="cpu")[0]
    xg, res = TS.gp_train_epoch_batched(kernel, D.sharded_input_batched(vt, mesh),
                                        noise=GP["noise"], cg_iters=GP["cg_iters"], mesh=mesh)
    out["gp/x"] = D.gather(xg).numpy()
    out["gp/res"] = (D.gather(res) if isinstance(res, torch.distributed.tensor.DTensor)
                     else res).numpy()
    xr, rr = TS.gp_train_epoch_batched(kernel, vt, noise=GP["noise"], cg_iters=GP["cg_iters"],
                                       mesh=mesh)
    out["gp/x_replicated"], out["gp/res_replicated"] = xr.numpy(), rr.numpy()
    out["gp/mvm"] = D.gather(kernel.matmul(D.sharded_input_batched(vt, mesh), mesh=mesh)).numpy()
    xl, rl = TS.gp_train_epoch_batched(kernel, vt, noise=GP["noise"], cg_iters=GP["cg_iters"])
    out["gp/x_local"], out["gp/res_local"] = xl.numpy(), rl.numpy()

    # -- measured distributed plan: the ranks agree, the cache hits --
    cache = os.path.join(tempfile.gettempdir(), f"mesh-plans-{os.getppid()}.json")
    if rank == 0 and os.path.exists(cache):
        os.unlink(cache)
    dist.barrier()
    from repro_torch.runtime import telemetry

    telemetry.configure()
    plans = []
    for _ in range(2):
        op = engine.KronOp((4, 4, 4), (4, 4, 4), batch=2, shared_factors=False, mesh=mesh,
                           tune="measure", cache_path=cache, device="cpu")
        plans.append(op.plan)
    snap = telemetry.snapshot()
    telemetry.disable()
    out["check/measure/hits"] = snap["counters"].get("plan_cache.hit", 0)
    out["check/measure/misses"] = snap["counters"].get("plan_cache.miss", 0)
    out["check/measure/same_plan"] = int(plans[0] == plans[1])
    slabs = torch.tensor([plans[0].n_slabs])
    out["check/measure/n_slabs_same_on_all_ranks"] = int(same_on_all_ranks(slabs))
    import json

    with open(cache) as f:
        keys = list(json.load(f)["entries"])
    out["check/measure/key_suffix"] = int(len(keys) == 1 and keys[0].endswith(";dev=cpu;gk=4"))

    # -- constructors: elastic meshes, prebuild_kron_ops, the shims, cost --
    for n, w in ELASTIC:
        out[f"elastic/{n}/{w}"] = np.asarray(fault.elastic_shape(n, w))
    em = fault.elastic_mesh(8, want_model=4, device_type="cpu")
    out["check/elastic_mesh_shape"] = np.asarray(tuple(em.shape))
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    cfg = reduced(get_config("qwen3-4b"), kron_ffn=True, kron_factors=2, d_model=64, d_ff=128)
    ops = prebuild_kron_ops(cfg, mesh=mesh)
    out["check/prebuild_mesh_ops"] = sum(op.mesh is mesh for op in ops)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x, fs, _ = single_inputs("sq444-f64")
        ys = D.kron_matmul_distributed(D.sharded_input(t(x), mesh), [t(f) for f in fs], mesh)
        xb, fb, _ = per_sample_inputs("ps444-f64")
        yb = D.kron_matmul_batched_distributed(D.sharded_input_batched(t(xb), mesh),
                                               [t(f) for f in fb], mesh, shared_factors=False)
    out["shim/y"] = D.gather(ys).numpy()
    out["shim/yb"] = D.gather(yb).numpy()
    out["check/shim_deprecations"] = sum(issubclass(w.category, DeprecationWarning)
                                         for w in caught)
    cost = engine.KronOp((4, 4, 4), (4, 4, 4), mesh=mesh, n_slabs=2).cost(8)
    out["check/cost"] = np.asarray([cost.comm_elems_per_device, cost.rounds,
                                    cost.comm_hidden_elems, cost.n_slabs])
    return out


def run_torch(out_path: str) -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_torch_rank, args=(G_M * G_K, os.path.join(tmp, "store"), out_path),
                           nprocs=G_M * G_K, start_method="spawn")
    print("ALL-OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    {"torch": run_torch, "jax": run_jax}[sys.argv[1]](sys.argv[2])
