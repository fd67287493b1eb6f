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
    # The Figure 9 stage at t_m'=1, t_k'=8192 in f32, by hand.  Forward: the
    # raw x slot (8192), states 0 and 1 (32 rows of 256 slices at stride
    # 257), both 32 x 32 panels, the table of 256 final offsets (ints).
    assert TE.block_smem_bytes(1, 8192, (32, 32), (32, 32), 4, kind="chain_fwd") == (
        8192 * 4 + 2 * 32 * 257 * 4 + 2 * 32 * 32 * 4 + 256 * 4)
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
