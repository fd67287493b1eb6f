"""The port's KronOp (repro_torch.core.engine) against repro.core.KronOp on
both JAX backends, the autograd contract without gradient inputs, the
device rule, the import boundary of the port and chip_smoke.py, and the
one module that calls the CUDA libraries.  The gradients are in
test_torch_grad.py."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, make_inputs, to_jax, to_torch
from repro.core import KronOp as JKronOp
from repro_torch.convert import factors_from_numpy
from repro_torch.core import KronOp, KronPlan
from repro_torch.core.autotune import Stage, TileConfig
from repro_torch.runtime import guard

jax.config.update("jax_enable_x64", True)

REPO = Path(__file__).resolve().parents[1]
CASES = [
    (8, (4, 4), (4, 4)),
    (4, (4, 2, 3), (3, 2, 4)),
    (8, (8, 16, 32), (8, 16, 32)),
    (10, (52, 65), (50, 20)),
    (6, (5, 3), (2, 7)),
]


@pytest.mark.parametrize("plan", ["auto", None])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,ps,qs", CASES)
def test_kronop_forward_matches_jax(m, ps, qs, backend, plan):
    x, fs = make_inputs(20, m, ps, qs)
    jop = JKronOp(ps, qs, backend=backend, plan=plan)
    if backend == "pallas" and plan is None and m > 8 and m % 8:
        # The JAX sliced kernel keeps the TPU's default t_m=8, which must
        # divide M; the port picks its tiles per shape (ROADMAP queue 3).
        with pytest.raises(ValueError, match="tiles must divide"):
            jop(to_jax(x), [to_jax(f) for f in fs])
        jop = JKronOp(ps, qs, backend="xla", plan=plan)
    want = jop(to_jax(x), [to_jax(f) for f in fs])
    op = KronOp(ps, qs, plan=plan)
    got = op(to_torch(x), factors_from_numpy(fs, device="cpu"))
    assert_close(got, want, 1e-9)
    assert op.out_shape(x.shape) == JKronOp(ps, qs).out_shape(x.shape) == tuple(got.shape)


@pytest.mark.parametrize("m,ps,qs", CASES[:3])
def test_kronop_f32_and_leading_dims_match_jax(m, ps, qs):
    x, fs = make_inputs(21, 2 * m, ps, qs, dtype=np.float32)
    x = x.reshape(2, m, -1)
    want = JKronOp(ps, qs, backend="xla")(to_jax(x), [to_jax(f) for f in fs])
    got = KronOp(ps, qs)(to_torch(x), [to_torch(f) for f in fs])
    assert got.shape == (2, m, int(np.prod(qs)))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("m,ps,qs", CASES[:3])
def test_shared_factor_batch_matches_jax(m, ps, qs):
    b = 3
    x, fs = make_inputs(22, m, ps, qs, batch=b)
    fs = [f[0] for f in fs]
    want = JKronOp(ps, qs).with_batch(b)(to_jax(x), [to_jax(f) for f in fs])
    op = KronOp(ps, qs).with_batch(b)
    got = op(to_torch(x), [to_torch(f) for f in fs])
    assert_close(got, want, 1e-9)
    assert op.out_shape(x.shape) == tuple(got.shape)
    assert op.cost(m).flops == JKronOp(ps, qs, batch=b).cost(m).flops


@pytest.mark.parametrize("m,ps,qs", CASES)
def test_cost_matches_jax(m, ps, qs):
    want = JKronOp(ps, qs).cost(m)
    got = KronOp(ps, qs).cost(m)
    assert (got.flops, got.comm_elems_per_device, got.rounds) == (
        want.flops, want.comm_elems_per_device, want.rounds,
    )


def test_explicit_plan_and_describe():
    ps, qs = (4, 4), (4, 4)
    plan = KronPlan((Stage((0, 1), False, TileConfig(2, 1, 16)),))
    op = KronOp(ps, qs, plan=plan, m=8)
    assert op.plan == plan
    assert op.describe().endswith(":: " + plan.describe())
    assert "single, local" in op.describe()
    assert KronOp(ps, qs, plan=None).describe().endswith(":: unfused")
    x, fs = make_inputs(23, 8, ps, qs)
    want = JKronOp(ps, qs, plan=None)(to_jax(x), [to_jax(f) for f in fs])
    assert_close(op(to_torch(x), [to_torch(f) for f in fs]), want, 1e-9)


def test_prekron_plan_executes():
    m, ps, qs = 4, (2, 3, 2), (3, 2, 2)
    x, fs = make_inputs(24, m, ps, qs)
    op = KronOp(ps, qs, enable_prekron=True)
    got = op(to_torch(x), [to_torch(f) for f in fs])
    assert any(st.prekron for st in op.plan.stages)
    assert_close(got, JKronOp(ps, qs, enable_prekron=True)(to_jax(x), [to_jax(f) for f in fs]), 1e-9)
    assert not any(st.prekron for st in KronOp(ps, qs, m=m).plan.stages)  # gate off


def test_no_grad_inputs_give_no_graph():
    x, fs = make_inputs(26, 4, (4, 4), (4, 4))
    y = KronOp((4, 4), (4, 4))(to_torch(x), [to_torch(f) for f in fs])
    assert y.grad_fn is None and not y.requires_grad


def test_rejects_what_the_slice_leaves_out_and_bad_inputs():
    # Per-sample factors run since the batched slice, measured tuning since
    # the consumers' slice; an unknown tune mode raises, and measuring on the
    # card without one raises instead of measuring on the CPU.
    assert KronOp((4,), (4,), batch=2, shared_factors=False).shared_factors is False
    with pytest.raises(guard.PlanError):
        KronOp((4,), (4,), tune="fastest")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KronOp((4,), (4,), m=4, tune="measure", cache_path="plans.json")
    with pytest.raises(ValueError):
        KronOp((4, 4), (4,))
    with pytest.raises(ValueError):
        KronOp((4,), (4,), backend="xla")
    op = KronOp((4, 4), (4, 4))
    with pytest.raises(ValueError):
        op(torch.zeros(2, 15), [torch.zeros(4, 4)] * 2)
    with pytest.raises(ValueError):
        op(torch.zeros(2, 16), [torch.zeros(4, 4), torch.zeros(4, 3)])
    with pytest.raises(ValueError, match="CUDA"):
        KronOp((4, 4), (4, 4), backend="cuda")(torch.zeros(2, 16), [torch.zeros(4, 4)] * 2)


def test_factors_from_numpy_device_rule():
    _, fs = make_inputs(27, 1, (3, 2), (2, 3))
    got = factors_from_numpy(fs, device="cpu", dtype=torch.float32)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in got)
    if torch.cuda.is_available():
        assert factors_from_numpy(fs)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factors_from_numpy(fs)


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_only_the_launch_boundary_touches_ctypes():
    """The CUDA libraries are loaded by kernels/_build.py and called by
    kernels/_launch.py; no other module of the port imports ctypes."""
    root = REPO / "src" / "repro_torch"
    users = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "ctypes" for n in names):
                users.add(path.relative_to(root).as_posix())
    assert users == {"kernels/_build.py", "kernels/_launch.py"}
