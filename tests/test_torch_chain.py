"""The persistent chain kernels' host side (``csrc/chain_fwd.cu``,
``csrc/chain_bwd.cu``): shared-memory models, block tiles and the walk.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain twins there); these tests pin what the wrappers decide
on the host, at the shapes of the smoke's main path and its kernel cases.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.core import KronOp
from repro_torch.core.engine import _lowered
from repro_torch.kernels import emit as TE
from repro_torch.runtime import guard as TG

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
)
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)


def _main_stages():
    """(case, direction, stage, dX columns, planned instruction, input
    bytes) of every chain launch of the smoke's main path: the planned
    forward calls (and their remats in the backward cases) and fig9-dx's
    transposed chain; ffn in f32 and bf16."""
    cases = [(name, m, ps, qs, torch.tensor([], dtype=dt).element_size(), "fwd")
             for name, m, ps, qs, dt, plan in SMOKE.MAIN_CASES if plan == "auto"]
    cases.append(("ffn f32", 4096, (64, 40), (128, 76), 4, "fwd"))
    cases.append(("fig9-dx", 1024, (32,) * 4, (32,) * 4, 4, "bwd"))
    out = []
    for name, m, ps, qs, in_bytes, direction in cases:
        op = KronOp(ps, qs, m=m, dtype_bytes=in_bytes)
        k = math.prod(ps)
        for idx, ins in enumerate(_lowered(op.plan, op.ps, op.qs).instrs):
            k_out = k // ins.pprod * ins.qprod
            out.append(pytest.param(
                m, k, k_out, ins if direction == "fwd" else ins.transpose(), in_bytes,
                id=f"{name}-{direction}-{idx}",
            ))
            k = k_out
    return out


def _geometry(m, k, k_out, ins, in_bytes, b=1):
    shape = (b, m, k) if ins.direction == "fwd" else (b, m, k_out)
    return TE.chain_geometry(
        shape, [(b, p, q) for p, q in zip(ins.ps, ins.qs)], t_m=ins.t_m, t_k=ins.t_k,
        t_qs=ins.t_qs, in_bytes=in_bytes, direction=ins.direction,
    )


def _smem(geo, in_bytes, acc_bytes=4):
    return TE.block_smem_bytes(
        geo.block_m, geo.block_k, geo.ps, geo.t_qs, acc_bytes, kind=f"chain_{geo.direction}",
        q_tiled=geo.t_qs != geo.qs, in_bytes=in_bytes,
    )


@pytest.mark.parametrize("m,k,k_out,ins,in_bytes", _main_stages())
def test_main_path_chain_tiles_leave_room_for_a_second_block(m, k, k_out, ins, in_bytes):
    # Every chain launch of the main path keeps its slot(s), states, panels
    # and table within half of an SM, and its block tile divides the plan's.
    geo = _geometry(m, k, k_out, ins, in_bytes)
    assert _smem(geo, in_bytes) <= TE.TWO_BLOCK_SMEM_BYTES
    assert min(ins.t_m, m) % geo.block_m == 0
    assert min(ins.t_k or k, k) % geo.block_k == 0
    assert geo.block_k % math.prod(ins.ps) == 0


# The smoke's phase-2 cases whose stages cannot keep a second block: a fused
# (64,40)->(128,76) stage's transposed chain holds two dY slots of 9,728
# columns and both factors' panels even at the smallest t_k' (2,560).
SHRINKS = {"P!=Q (64,40)->(128,76)", "P!=Q (64,40)->(128,76) bf16"}


def _chain_cases():
    out = []
    for name, ps, qs, m, s, dtype, t_qs, b in SMOKE.CHAIN_CASES:
        for direction in ("fwd", "bwd"):
            out.append(pytest.param(name, ps, qs, m, s, dtype, t_qs, b, direction,
                                    id=f"{name}-{direction}"))
    return out


@pytest.mark.parametrize("name,ps,qs,m,s,dtype,t_qs,b,direction", _chain_cases())
def test_smoke_chain_cases_block_tiles(name, ps, qs, m, s, dtype, t_qs, b, direction):
    k = math.prod(ps) * s
    in_bytes = torch.tensor([], dtype=dtype).element_size()
    acc_bytes = TE.acc_dtype_for(dtype).itemsize
    t_m, t_k = SMOKE.stage_tiles(m, k, ps, qs, t_qs or qs, TE.SMEM_BUDGET_ELEMS, kind=direction)
    shape = (b, m, k) if direction == "fwd" else (b, m, math.prod(qs) * s)
    geo = TE.chain_geometry(
        shape, [(b, p, q) for p, q in zip(ps, qs)], t_m=t_m, t_k=t_k, t_qs=t_qs,
        acc_bytes=acc_bytes, in_bytes=in_bytes, direction=direction,
    )
    assert t_m % geo.block_m == 0 and t_k % geo.block_k == 0
    nbytes = _smem(geo, in_bytes, acc_bytes)
    assert nbytes <= TE.SMEM_BYTES
    if direction == "bwd" and name in SHRINKS:
        # Even the smallest tile needs more than half an SM: one block per SM.
        smallest = TE.block_smem_bytes(1, math.prod(ps), ps, geo.t_qs, acc_bytes,
                                       kind="chain_bwd", in_bytes=in_bytes)
        assert smallest > TE.TWO_BLOCK_SMEM_BYTES and nbytes > TE.TWO_BLOCK_SMEM_BYTES
    else:
        assert nbytes <= TE.TWO_BLOCK_SMEM_BYTES


@pytest.mark.parametrize("nblk", [1, 2, 3, 7, 64, 264, 1000])
@pytest.mark.parametrize(
    "shape,fs,t_qs,t_k,direction",
    [
        ((3, 8, 256), ((4, 4), (4, 4)), None, 32, "fwd"),   # crosses samples
        ((1, 8, 256), ((4, 8), (4, 8)), (4, 2), 32, "fwd"),  # crosses Q-tile digits
        ((2, 6, 96), ((4, 4), (6, 2)), (2, 1), 48, "bwd"),  # digits looped inside a tile
    ],
)
def test_persistent_walk_covers_every_tile_once(nblk, shape, fs, t_qs, t_k, direction):
    b = shape[0]
    geo = TE.chain_geometry(shape, [(b, p, q) for p, q in fs], t_m=2, t_k=t_k, t_qs=t_qs,
                            direction=direction)
    assert (geo.block_m, geo.block_k) == (2, t_k)
    walks = [list(TE.chain_walk(j, nblk, geo.tiles)) for j in range(nblk)]
    seen = sorted(t for w in walks for t in w)
    assert seen == list(range(geo.tiles))  # each tile exactly once, more blocks than tiles too
    m_tiles, k_tiles = geo.m // geo.block_m, geo.k // geo.block_k
    q_tiles = geo.q_tiles if direction == "fwd" else 1
    coords = {TE.chain_tile_coords(geo, t) for t in range(geo.tiles)}
    assert len(coords) == geo.tiles == b * q_tiles * m_tiles * k_tiles
    for w in walks:
        # A block's (sample, digit) never goes back: its panels load once per
        # change, at most once per group of the walk.
        groups = [TE.chain_tile_coords(geo, t)[:2] for t in w]
        assert groups == sorted(groups)


@pytest.mark.parametrize("kind", ["chain_fwd", "chain_bwd"])
def test_chain_kinds_raise_when_no_block_tile_fits(kind):
    # Two 256 x 256 f64 factors: the smallest tile's panels alone exceed a block.
    with pytest.raises(TG.VmemOverflowError):
        TE.block_tile(1, 256 * 256, (256, 256), (256, 256), 8, kind=kind)
    # A tile above half an SM is still taken when nothing smaller fits it.
    tm, tk = TE.block_tile(2, 2560, (40, 64), (76, 128), 4, kind="chain_bwd")
    assert (tm, tk) == (1, 2560)
    assert TE.TWO_BLOCK_SMEM_BYTES < TE.block_smem_bytes(
        1, 2560, (40, 64), (76, 128), 4, kind="chain_bwd") <= TE.SMEM_BYTES


def test_chain_smem_models_count_every_region():
    # The Figure 9 stage at t_m'=1, t_k'=8192, by hand.  Forward in bf16 on
    # the CUDA cores: the raw x slot (8192), states 0 and 1 (32 rows of 256
    # slices at stride 257), both 32 x 32 panels, the table of 256 final
    # offsets (ints).
    assert TE.block_smem_bytes(1, 8192, (32, 32), (32, 32), 4, kind="chain_fwd",
                               in_bytes=2) == (
        8192 * 2 + 2 * 32 * 257 * 4 + 2 * 32 * 32 * 4 + 256 * 4)
    # Forward in f32 on the tensor cores: no slot; two buffers of a
    # row-major state (256 rows of 32 + 4), both panels split (hi and lo),
    # the table.
    assert TE.block_smem_bytes(1, 8192, (32, 32), (32, 32), 4, kind="chain_fwd") == (
        2 * 256 * 36 * 4 + 2 * 2 * 32 * 32 * 4 + 256 * 4)
    # Transposed: two dY slots (8192), the flat G_1 (8192), both transposed
    # panels, the table of 1024 runs of 8 elements.
    assert TE.block_smem_bytes(1, 8192, (32, 32), (32, 32), 4, kind="chain_bwd") == (
        2 * 8192 * 4 + 8192 * 4 + 2 * 32 * 32 * 4 + 1024 * 4)
    # bf16 slots hold the input dtype; Q-tiles (16, 32) shrink the states
    # and panels and add the (t_m, t_k) sum of dX.
    assert TE.block_smem_bytes(1, 4096, (32, 32), (16, 32), 4, kind="chain_bwd",
                               q_tiled=True, in_bytes=2) == (
        2 * 2048 * 2 + 2048 * 4 + (16 * 32 + 32 * 32) * 4 + 512 * 4 + 4096 * 4)
    # Odd sizes round every region to 16 bytes: (5,7)->(3,2) bf16 at
    # (16, 105): slot 3360 B, states 16 x 7 x 15 and 16 x 5 x 7 floats,
    # panels 7 x 8 and 5 x 8 floats (columns padded to 8), 6 ints of table
    # (24 -> 32 B).
    assert TE.block_smem_bytes(16, 105, (7, 5), (2, 3), 4, kind="chain_fwd", in_bytes=2) == (
        3360 + 6720 + 2240 + 224 + 160 + 32)


def test_chain_geometry_reports_the_walk():
    geo = TE.chain_geometry((3, 8, 256), [(3, 4, 8), (3, 4, 8)], t_m=2, t_k=32, t_qs=(4, 2))
    assert geo.q_tiles == 8 and geo.tiles == 3 * 8 * 4 * 8
    bwd = TE.chain_geometry((3, 8, 1024), [(3, 4, 8), (3, 4, 8)], t_m=2, t_k=32, t_qs=(4, 2),
                            direction="bwd")
    assert bwd.k == 256 and bwd.tiles == 3 * 4 * 8
    assert TE.chain_tile_coords(geo, 4 * 8 + 5) == (0, 1, 0, 5)
    assert TE.chain_tile_coords(bwd, 4 * 8 * 2 + 9) == (2, 0, 1, 1)


# ---------------------------------------------------------------------------
# The f32 forward chain on the tensor cores (chain_tf32_kernel, 3xTF32)
# ---------------------------------------------------------------------------


def _mesh_round_stages():
    """The launches of the mesh cell's two rounds at P = 32 on a 4-row slab
    of one card's stripe (K = 2^28): round 0 chains five factors, round 1
    one."""
    from repro_torch.core import distributed

    ps = (32,) * 5
    out = [ins for ins, _ in distributed._round_instrs(4, 2 ** 28, ps, ps, False, 4, 4)]
    out += [ins for ins, _ in distributed._round_instrs(4, 2 ** 28, (32,), (32,), False, 4, 4)]
    return out


def test_mesh_rounds_chain_two_stages_of_two_and_two_of_one():
    assert [ins.ps for ins in _mesh_round_stages()] == [(32, 32), (32, 32), (32,), (32,)]


@pytest.mark.parametrize(
    "ps,qs,in_bytes,acc_bytes,want",
    [
        ((32, 32), (32, 32), 4, 4, "chain_tf32_kernel"),  # fig9's stage
        ((16, 16), (16, 16), 4, 4, "chain_tf32_kernel"),  # gp16's stage
        ((32,), (32,), 4, 4, "chain_tf32_kernel"),  # the mesh rounds' single factor
        ((65,), (20,), 4, 4, "chain_tf32_kernel"),  # odd P and Q, padded
        ((65, 52), (20, 50), 4, 4, "chain_tf32_kernel"),
        ((8, 8, 8), (8, 8, 8), 4, 4, "chain_tf32_kernel"),  # the smallest factors it takes
        ((16, 16), (16, 8), 4, 4, "chain_tf32_kernel"),  # a Q-tile of 8
        ((16, 16), (16, 4), 4, 4, "chain_fwd_kernel<float, float>"),  # a Q-tile under 8
        ((4, 4), (4, 4), 4, 4, "chain_fwd_kernel<float, float>"),  # under 8 x 8
        ((8, 4), (8, 8), 4, 4, "chain_fwd_kernel<float, float>"),
        # The split panels leave no room for a second block even at the
        # smallest tile: the CUDA cores keep two.
        ((40, 64), (76, 128), 4, 4, "chain_fwd_kernel<float, float>"),
        ((32, 32), (32, 32), 2, 4, "chain_fwd_kernel<__nv_bfloat16, float>"),  # bf16 input
        ((32, 32), (32, 32), 4, 8, "chain_fwd_kernel<float, double>"),  # an f64 accumulator
        ((32, 32), (32, 32), 8, 8, "chain_fwd_kernel<double, double>"),  # float64
    ],
)
def test_forward_chain_kernel_follows_dtype_and_factor_shapes(ps, qs, in_bytes, acc_bytes, want):
    # chain_fwd.cu picks its kernel from what the stage shows: f32 stages
    # whose factors and Q-tiles are at least 8 wide, and whose layout keeps
    # two blocks an SM, run on the tensor cores in 3xTF32; the rest on the
    # CUDA cores.
    assert TE.chain_kernel_name(ps, qs, in_bytes, acc_bytes) == want
    assert TE.chain_uses_tf32(ps, qs, in_bytes, acc_bytes) == (want == "chain_tf32_kernel")


def test_the_cells_f32_stages_take_the_tensor_cores():
    # kron32x4-m1024-train and kron32x4-m1-fwd (fig9's factors at M = 1024
    # and 1), ski16x6-epoch (gp16), ski32x6-mesh4 (the rounds' stages).
    for m, ps in ((1024, (32,) * 4), (1, (32,) * 4), (16, (16,) * 6)):
        op = KronOp(ps, ps, m=m, dtype_bytes=4)
        instrs = _lowered(op.plan, op.ps, op.qs).instrs
        assert instrs and all(TE.chain_uses_tf32(ins.ps, ins.t_qs or ins.qs, 4) for ins in instrs)
    assert all(TE.chain_uses_tf32(ins.ps, ins.t_qs or ins.qs, 4) for ins in _mesh_round_stages())
    # kronffn-decode's stages are bf16: the CUDA cores.
    assert not TE.chain_uses_tf32((64, 40), (128, 76), 2)


@pytest.mark.parametrize(
    "t_m,t_k,ps,t_qs,want",
    [
        # fig9's stage at t_m'=1, t_k'=8192: two buffers of 256 rows of 32 + 4
        # floats, both panels split (hi and lo, 32 x 32 each), 256 ints.
        (1, 8192, (32, 32), (32, 32), 2 * 256 * 36 * 4 + 2 * 2 * 32 * 32 * 4 + 256 * 4),
        # gp16's: 512 rows of 16 + 4, two 16 x 16 panels, 512 ints.
        (1, 8192, (16, 16), (16, 16), 2 * 512 * 20 * 4 + 2 * 2 * 16 * 16 * 4 + 512 * 4),
        # The mesh round's single factor: one panel, 256 slices.
        (1, 8192, (32,), (32,), 2 * 256 * 36 * 4 + 2 * 32 * 32 * 4 + 256 * 4),
        # Odd sizes: 3 rows of 5 slices padded to 16 rows of 80 + 4; the
        # panel padded to 72 x 24; 5 ints (20 -> 32 bytes).
        (3, 325, (65,), (20,), 2 * 16 * 84 * 4 + 2 * 72 * 24 * 4 + 32),
        # Two odd factors: state 0 (104 rows of 65) is the larger; 20 ints.
        (2, 3380, (65, 52), (20, 50), 2 * 112 * 84 * 4 + 2 * (72 * 24 + 56 * 56) * 4 + 80),
        # Q-tiles (16, 8) shrink the later states and panels; the buffers
        # take the largest state (512 rows of 16 + 4).
        (2, 4096, (16, 16), (16, 8), 2 * 512 * 20 * 4 + 2 * (16 * 16 + 16 * 8) * 4 + 256 * 4),
    ],
)
def test_chain_tf32_smem_model_counts_every_region(t_m, t_k, ps, t_qs, want):
    assert TE._chain_tf32_smem_bytes(t_m, t_k, ps, t_qs) == want
    assert TE.block_smem_bytes(t_m, t_k, ps, t_qs, 4, kind="chain_fwd",
                               q_tiled=t_qs != ps) == want


@pytest.mark.parametrize(
    "m,k,ps,t_m,t_k",
    [
        (1024, 2 ** 20, (32, 32), 1, 8192),  # fig9's stage
        (16, 16 ** 6, (16, 16), 1, 8192),  # gp16's
        (4, 2 ** 28, (32, 32), 4, 8192),  # the mesh round's, a 4-row slab
        (4, 2 ** 28, (32,), 4, 8192),
        (1, 2 ** 20, (32, 32), 1, 8192),  # one row
    ],
)
def test_tf32_block_tiles_keep_two_blocks_an_sm(m, k, ps, t_m, t_k):
    geo = TE.chain_geometry((1, m, k), [(1, p, p) for p in ps], t_m=t_m, t_k=t_k, in_bytes=4)
    assert TE.chain_uses_tf32(ps, ps, 4)
    assert (geo.block_m, geo.block_k) == (1, 8192)
    assert _smem(geo, 4) <= TE.TWO_BLOCK_SMEM_BYTES


def test_plain_tf32_control_rounds_as_the_split_and_reads_worse():
    # The chip check's control (hi*hi alone): each step's operands rounded
    # to TF32 as cvt.rna rounds them.  On the CPU it reads about a thousand
    # times worse than the float32 chain, against float64.
    g = torch.Generator().manual_seed(32)
    v = torch.randn(4096, generator=g) * torch.logspace(-3, 3, 4096)
    r = SMOKE.tf32_rounded(v)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())  # 10 explicit mantissa bits left
    assert float(((r - v).abs() / v.abs()).max()) <= 2.0 ** -11  # to nearest
    halfway = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert SMOKE.tf32_rounded(halfway).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    x = torch.randn(1, 4, 32 * 32 * 8, generator=g)
    fs = [torch.randn(1, 32, 32, generator=g) for _ in range(2)]
    ref = TE.chain_reference(x.double(), *(f.double() for f in fs))
    f32 = SMOKE.compare(TE.chain_reference(x, *fs), ref)[1]
    control = SMOKE.compare(SMOKE.plain_tf32_chain(x, fs), ref)[1]
    assert f32 < 1e-6 and control > 1e-4 and control > 100 * SMOKE.TF32_ERR_RATIO * f32


def test_cuda_core_q_tiles_keep_the_stage_off_the_tensor_cores():
    for _, m, ps, qs, s in SMOKE.CHAIN_TF32_CASES:
        t_qs = SMOKE.cuda_core_t_qs(qs)
        assert all(q % t == 0 and t < TE._TC_MIN_DIM for q, t in zip(qs, t_qs))
        assert TE.chain_uses_tf32(ps, qs, 4) and not TE.chain_uses_tf32(ps, t_qs, 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/chain_fwd.cu runs only there")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins in full float32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("name,m,ps,qs,s", SMOKE.CHAIN_TF32_CASES,
                         ids=[c[0] for c in SMOKE.CHAIN_TF32_CASES])
def test_f32_chain_on_the_tensor_cores_reads_as_float32(card, name, m, ps, qs, s):
    # Against the float64 twin, the 3xTF32 chain is within TF32_ERR_RATIO of
    # the CUDA-core kernel on the same inputs, and the plain-TF32 control
    # (hi*hi alone) is not; each tensor-core launch counts once under
    # chain_tf32, the CUDA-core one not at all.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    e = SMOKE.tf32_chain_errors(gen, m, ps, qs, s)
    assert e["tensor_cores_kernel"] == "chain_tf32_kernel"
    assert e["cuda_cores_kernel"] == "chain_fwd_kernel<float, float>"
    assert e["tensor_cores_tf32_launches"] == 1 and e["cuda_cores_tf32_launches"] == 0
    assert e["tensor_cores"] <= SMOKE.TF32_ERR_RATIO * e["cuda_cores"], e
    assert e["control"] > SMOKE.TF32_ERR_RATIO * e["cuda_cores"], e
