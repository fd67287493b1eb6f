"""The mesh runs behind tests/test_torch_distributed.py: the same numpy
inputs through the port's mesh rounds and through the JAX reference's.

    python tests/torch_mesh_driver.py torch OUT.npz   # 8 gloo CPU ranks as (2, 4)
    python tests/torch_mesh_driver.py jax OUT.npz     # the reference on 8 host devices
    python tests/torch_mesh_driver.py serve-jax OUT.npz  # its serving on 4 host devices

``torch`` spawns eight ``torch.multiprocessing`` ranks in a gloo process
group (a ``file://`` store under a temporary directory) and a ``(2, 4)``
``DeviceMesh`` named ``("data", "model")`` on the CPU; rank 0 writes every
output and check to ``OUT.npz`` (and the model stack's checkpoint under
``OUT-ckpt/``).  ``jax`` sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before importing
jax and runs the reference's runners inside ``with jax.set_mesh(mesh):``
(its reshapes and ``jax.grad`` over explicitly sharded arrays need the
mesh context).  Keys are ``<case>/<quantity>``; the port's own checks are
0/1 or counts under ``check/...``.  Inputs are made with numpy from the
case's seed.  A rank's failure prints its traceback and fails the run.

``serve-jax`` runs the reference's jitted ``make_prefill_step`` and
``make_serve_step`` on a ``(2, 2)`` mesh of ``AxisType.Auto`` axes for each
``SERVE`` config, on parameters put by ``param_shardings`` and a cache by
``cache_shardings``, and writes each device's shard of the logits and of
every cache leaf after the prefill and after each decode step
(``serve/<config>/<phase>/...``); ``tests/test_torch_serve_mesh.py`` holds
the port's ranks against them.

The model stack sharded over the mesh (``MODEL``): both sides start from
the same numpy parameters, put by ``param_shardings`` and
``opt_state_shardings``, take the same numpy tokens by ``token_sharding``,
and record the loss, every gradient, the parameters after one step of the
train step and each device's shard of them.  The reference runs on a mesh
of ``AxisType.Auto`` axes inside ``with mesh:``; under jax 0.9 the default
(explicit) axes fail its vocabulary-sharded embedding gather.
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
# A leaf sharded over (pod, data) on one dim: the shard order on the pod mesh.
POD_SPEC, POD_LEAF = (("pod", "data"), "model"), (8, 6)

# name -> (arch, reduced() overrides, optimizer): the model stack on the
# (2, 4) mesh.  "experts": the MoE's expert count (2 of them on a 4-way
# model axis run tensor-parallel inside each expert; the reduced config's 4
# run expert-parallel).  d_model 1024 shards the final norm over the model
# axis; 2 heads on a 4-way axis run context-parallel.
MODEL = {
    "qwen3-kron": ("qwen3-4b", dict(kron_ffn=True, kron_factors=2), "adamw"),
    "qwen3-kron-shampoo": ("qwen3-4b", dict(kron_ffn=True, kron_factors=2), "shampoo"),
    "deepseek-kron": ("deepseek-moe-16b", dict(kron_ffn=True, kron_factors=2), "adamw"),
    "deepseek-tp-experts": ("deepseek-moe-16b", dict(experts=2), "adamw"),
    "mamba2": ("mamba2-130m", {}, "adamw"),
    "qwen3-d1024": ("qwen3-4b", dict(d_model=1024), "adamw"),
    "qwen3-context-parallel": ("qwen3-4b", dict(n_heads=2, n_kv_heads=1), "adamw"),
}
MODEL_SEED, MODEL_BATCH, MODEL_SEQ = 7, 4, 16
# eps at 1e-3 keeps the first Adam step a smooth function of the gradient:
# at 1e-8 it is sign(g), which flips where g sits at the summation-order
# noise floor.
MODEL_OPT = dict(lr=1e-2, warmup_steps=1, eps=1e-3)
CKPT_CASE = "qwen3-kron"
# The serving steps on a (data, model) = (2, 2) mesh: config name ->
# reduced() overrides of qwen3-4b (f32), and the served batch.
SERVE = {"dense": {}, "kron_ffn": dict(kron_ffn=True)}
SERVE_GRID, SERVE_SEED = (2, 2), 8
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_STEPS = 4, 12, 16, 2
_VECTORS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "norm", "conv_b", "dt_bias",
            "a_log", "d_skip", "bq", "bk", "bv")


def model_cfg(name, get_config, reduced):
    """The case's config in either package (f32)."""
    import dataclasses

    arch, over, _ = MODEL[name]
    over = dict(over)
    experts = over.pop("experts", None)
    cfg = reduced(get_config(arch), dtype="float32", **over)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=experts))
    return cfg


def model_opt(name, opt_config, shampoo_config):
    if MODEL[name][2] == "shampoo":
        return shampoo_config(precond_every=1, **MODEL_OPT)
    return opt_config(**MODEL_OPT)


def model_arrays(leaves):
    """f32 parameters for ``[(path, shape), ...]`` in flatten order: fan-in
    scaled matrices, 0.02 embeddings, 0.1 vectors (norm scales, biases)."""
    out = []
    for i, (path, shape) in enumerate(leaves):
        rng = np.random.default_rng([MODEL_SEED, i])
        last = path.rsplit("/", 1)[-1]
        if last == "embed":
            scale = 0.02
        elif last in _VECTORS or len(shape) < 2:
            scale = 0.1
        else:
            scale = shape[-2] ** -0.5
        out.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return out


def model_batch(vocab):
    rng = np.random.default_rng(MODEL_SEED)
    toks = rng.integers(0, vocab, (2, MODEL_BATCH, MODEL_SEQ)).astype(np.int32)
    return toks[0], toks[1]


def serve_cfg(name, get_config, reduced):
    """The serving config in either package (f32)."""
    return reduced(get_config("qwen3-4b"), dtype="float32", **SERVE[name])


def serve_tokens(vocab):
    """The prompt (B, PROMPT) and each decode step's tokens (STEPS, B, 1)."""
    rng = np.random.default_rng(SERVE_SEED)
    return (rng.integers(0, vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32),
            rng.integers(0, vocab, (SERVE_STEPS, SERVE_BATCH, 1)).astype(np.int32))


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
    _jax_models(out)
    np.savez(out_path, **out)
    print("ALL-OK", flush=True)


def _by_device(arr) -> np.ndarray:
    """Each device's shard, stacked in device order (device i is rank i)."""
    return np.stack([np.asarray(s.data) for s in sorted(arr.addressable_shards,
                                                        key=lambda s: s.device.id)])


def _jax_models(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.models import model as JM
    from repro.models.config import reduced
    from repro.optim.adamw import OptConfig
    from repro.optim.shampoo import ShampooConfig, opt_for
    from repro.runtime import sharding as JSH
    from repro.train import steps as JT

    devices = np.array(jax.devices()[:G_M * G_K])
    pod = Mesh(devices.reshape(POD_MESH), POD_AXES)
    leaf = np.arange(math.prod(POD_LEAF), dtype=np.float32).reshape(POD_LEAF)
    out["podspec/shards"] = _by_device(jax.device_put(leaf, NamedSharding(pod, P(*POD_SPEC))))

    mesh = Mesh(devices.reshape(G_M, G_K), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    for name in MODEL:
        cfg = model_cfg(name, get_config, reduced)
        shapes = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
        flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        leaves = [(JSH._path_str(kp), tuple(x.shape)) for kp, x in flat]
        toks, labels = model_batch(cfg.vocab)
        oc = model_opt(name, OptConfig, ShampooConfig)
        with mesh:
            p_sh = JSH.param_shardings(shapes, mesh, tied_embed=cfg.tie_embeddings)
            params = jax.device_put(jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(a) for a in model_arrays(leaves)]), p_sh)
            opt = opt_for(oc)[0](params, oc)
            opt = jax.device_put(opt, JT.opt_state_shardings(opt, p_sh, NamedSharding(mesh, P())))
            tsh = JSH.token_sharding(mesh, MODEL_BATCH)
            tj, lj = jax.device_put(jnp.asarray(toks), tsh), jax.device_put(jnp.asarray(labels), tsh)
            grads = jax.jit(jax.grad(lambda p: JT.loss_fn(cfg, p, tj, lj)[0]))(params)
            state = JT.TrainState(params, opt, jnp.zeros((), jnp.int32))
            new, metrics = jax.jit(JT.make_train_step(cfg, oc))(
                state, {"tokens": tj, "labels": lj})
            new_params = jax.device_put(new.params, p_sh)
        out[f"model/{name}/loss"] = np.asarray(metrics["loss"])
        for i, (g, p) in enumerate(zip(jax.tree.leaves(grads), jax.tree.leaves(new_params))):
            out[f"model/{name}/grad/{i}"] = np.asarray(g)
            out[f"model/{name}/param/{i}"] = np.asarray(p)
            out[f"model/{name}/shard/{i}"] = _by_device(p)


def run_jax_serve(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh

    from repro.configs import get_config
    from repro.models import model as JM
    from repro.models.config import reduced
    from repro.runtime import sharding as JSH
    from repro.train import steps as JT

    mesh = Mesh(np.array(jax.devices()[:math.prod(SERVE_GRID)]).reshape(SERVE_GRID),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name in SERVE:
        cfg = serve_cfg(name, get_config, reduced)
        shapes = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
        flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        leaves = [(JSH._path_str(kp), tuple(x.shape)) for kp, x in flat]
        prompt, steps = serve_tokens(cfg.vocab)

        def record(phase, logits, cache):
            out[f"serve/{name}/{phase}/logits"] = _by_device(logits)
            for i, leaf in enumerate(jax.tree.leaves(cache)):
                out[f"serve/{name}/{phase}/cache/{i}"] = _by_device(leaf)

        with mesh:
            p_sh = JSH.param_shardings(shapes, mesh, tied_embed=cfg.tie_embeddings)
            params = jax.device_put(jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(a) for a in model_arrays(leaves)]), p_sh)
            c_sh = JSH.cache_shardings(
                jax.eval_shape(lambda: JM.init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN)), mesh,
                SERVE_BATCH)
            tsh = JSH.token_sharding(mesh, SERVE_BATCH)
            logits, cache = jax.jit(JT.make_prefill_step(cfg, SERVE_MAX_LEN),
                                    out_shardings=(None, c_sh))(
                params, jax.device_put(jnp.asarray(prompt), tsh))
            record("prefill", logits, cache)
            step = jax.jit(JT.make_serve_step(cfg), out_shardings=(None, c_sh))
            for i in range(SERVE_STEPS):
                logits, cache = step(params, cache, jax.device_put(jnp.asarray(steps[i]), tsh),
                                     jnp.int32(SERVE_PROMPT + i))
                record(f"decode{i}", logits, cache)
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
        out.update(_torch_models(rank, os.path.splitext(out_path)[0] + "-ckpt"))
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


def _torch_models(rank: int, ckpt_dir: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as CM
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as TM
    from repro_torch.models.config import reduced
    from repro_torch.optim import OptConfig, ShampooConfig
    from repro_torch.optim.shampoo import opt_for
    from repro_torch.runtime import sharding as S
    from repro_torch.train import steps as TT

    out: dict = {}
    world = dist.get_world_size()

    def by_rank(local: torch.Tensor) -> np.ndarray:
        """Every rank's shard, stacked in rank order (on every rank)."""
        buf = torch.empty(world * local.numel(), dtype=local.dtype)
        dist.all_gather_into_tensor(buf, local.contiguous().reshape(-1))
        return buf.reshape(world, *local.shape).numpy()

    def all_ranks(ok: bool) -> int:
        t = torch.tensor([int(ok)])
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())

    from torch.distributed.device_mesh import init_device_mesh

    pod = init_device_mesh("cpu", POD_MESH, mesh_dim_names=POD_AXES)
    leaf = torch.arange(math.prod(POD_LEAF), dtype=torch.float32).reshape(POD_LEAF)
    pod_sh = S.NamedSharding(pod, POD_SPEC)
    out["podspec/shards"] = by_rank(S.local_shard(leaf, pod_sh))
    whole, S._GATHER_PIECE = S._GATHER_PIECE, 96  # a few bytes: many pieces a leaf
    out["check/podspec/gather_to_host"] = all_ranks(
        torch.equal(S.gather_to_host(S.local_shard(leaf, pod_sh), pod_sh), leaf))
    S._GATHER_PIECE = whole

    mesh = make_debug_mesh(G_M, G_K, device_type="cpu")
    for name in MODEL:
        cfg = model_cfg(name, get_config, reduced)
        meta = TM.init_params(cfg, None, device="meta")
        leaves = [(path, tuple(x.shape)) for path, x in tree.leaves_with_path(meta)]
        params = tree.unflatten_like(meta, [torch.from_numpy(a) for a in model_arrays(leaves)])
        oc = model_opt(name, OptConfig, ShampooConfig)
        state = TT.TrainState(params, opt_for(oc)[0](params, oc), torch.zeros((), dtype=torch.int32))
        state = TT.TrainState(**tree.map(S.local_shard, state._asdict(),
                                         TT.state_shardings(state, cfg, mesh)))
        p_sh = tree.leaves(TM.param_layout(cfg, mesh))
        toks, labels = (torch.from_numpy(a) for a in model_batch(cfg.vocab))

        rows = S.token_sharding(mesh, MODEL_BATCH)
        mine = [p.detach().requires_grad_() for p in tree.leaves(state.params)]
        with S.use_mesh(mesh, batch_axes=S._entry_axes(rows.spec[0])):
            loss, _ = TT.loss_fn(cfg, tree.unflatten_like(meta, mine), rank_rows(toks, rows),
                                 rank_rows(labels, rows))
            grads = torch.autograd.grad(loss, mine, allow_unused=True, materialize_grads=True)
        new, metrics = TT.make_train_step(cfg, oc, mesh=mesh)(
            state, {"tokens": toks, "labels": labels})
        out[f"model/{name}/loss"] = metrics["loss"].numpy()
        shapes_ok = True
        for i, (g, p, m, sh) in enumerate(zip(grads, tree.leaves(new.params),
                                              tree.leaves(new.opt["m"]), p_sh)):
            out[f"model/{name}/grad/{i}"] = S.gather_shards(g, sh).numpy()
            out[f"model/{name}/param/{i}"] = S.gather_shards(p, sh).numpy()
            out[f"model/{name}/shard/{i}"] = by_rank(p)
            shapes_ok &= tuple(g.shape) == tuple(p.shape) == tuple(m.shape) == sh.shard_shape()
        out[f"check/model/{name}/shard_shapes"] = all_ranks(shapes_ok)

        if name == CKPT_CASE:  # gathered on save, cut back on restore
            st = new._asdict()
            shardings = TT.state_shardings(new, cfg, mesh)
            mgr = CheckpointManager(ckpt_dir, keep=1)
            # the save gathers one leaf and (rank 0) copies it to the host
            # before it gathers the next; the host copy is the gathered leaf
            seen, orig = [], (S.gather_to_host, CM._to_host)
            S.gather_to_host = lambda *a, **k: (seen.append("g"), orig[0](*a, **k))[1]
            CM._to_host = lambda t: (seen.append("h"), orig[1](t))[1]
            try:
                mgr.save(1, st, shardings=shardings)
            finally:
                S.gather_to_host, CM._to_host = orig
            mgr.wait()
            n = len(tree.leaves(st))
            out["check/ckpt/one_leaf_at_a_time"] = all_ranks(
                "".join(seen) == ("gh" * n if rank == 0 else "g" * n))
            whole, S._GATHER_PIECE = S._GATHER_PIECE, 4096  # several pieces a leaf
            out["check/ckpt/gather_to_host"] = all_ranks(all(
                torch.equal(S.gather_to_host(a, sh), S.gather_shards(a, sh))
                for a, sh in zip(tree.leaves(st), tree.leaves(shardings))))
            S._GATHER_PIECE = whole
            back = mgr.restore(st, shardings=shardings)
            out["check/ckpt/restored_bitwise"] = all_ranks(all(
                torch.equal(a, b) for a, b in zip(tree.leaves(back), tree.leaves(st))))
    return out


def run_torch(out_path: str) -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_torch_rank, args=(G_M * G_K, os.path.join(tmp, "store"), out_path),
                           nprocs=G_M * G_K, start_method="spawn")
    print("ALL-OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    {"torch": run_torch, "jax": run_jax, "serve-jax": run_jax_serve}[sys.argv[1]](sys.argv[2])
