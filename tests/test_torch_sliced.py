"""The sliced-multiply kernel's host side (``csrc/sliced.cu``): its
shared-memory model, tile rule and tensor-core predicate.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain twin there); these tests pin what the wrapper decides on the host, at
the shapes of the smoke's main path and its kernel cases.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import emit as TE
from repro_torch.kernels import kron_sliced
from repro_torch.runtime import guard as TG

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
)
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)

SMEM = kron_sliced.sliced_smem_bytes


def test_sliced_smem_model_counts_every_region():
    # Figure 9 in f32 at (t_m, t_s, t_q) = (1, 256, 32): three slots of 256
    # slices at 8 chunks each plus one skew chunk per 4 slices; the 32 x 32
    # panel in f32.
    assert SMEM(1, 256, 32, 32, 32, 4, 4) == 3 * (256 * 8 + 64) * 16 + 32 * 32 * 4
    # ffn's first stage in bf16 on the tensor cores at (2, 64, 76): P 40 ->
    # 48, so a slice takes 48/8 + 1 = 7 chunks, 128 slices a slot; F^T
    # (80, 48 + 8) in bf16; the staged output, 76 rows of 128 slices
    # (16 chunks, even) -> 136.
    assert SMEM(2, 64, 40, 76, 76, 2, 4, mma=True) == (
        3 * 128 * 7 * 16 + 80 * 56 * 2 + 76 * 136 * 2)
    # ffn's second stage at (1, 76, 128): 76 slices rounded to 80, 9 chunks
    # each; F^T (128, 72); staging 128 rows of 80 -> 88 (11 chunks, odd).
    assert SMEM(1, 76, 64, 128, 128, 2, 4, mma=True) == (
        3 * 80 * 9 * 16 + 128 * 72 * 2 + 128 * 88 * 2)
    # The same shape on the CUDA cores: 8 bf16 per chunk, 8 chunks a slice
    # plus 19 skew chunks; the (64, 128) panel in f32.
    assert SMEM(1, 76, 64, 128, 128, 2, 4) == 3 * (76 * 8 + 19) * 16 + 64 * 128 * 4
    # Odd P and Q in f32 (compress, 65 -> 20 at (5, 26, 20)): 17 chunks a
    # slice (P padded to 68 with zeros), 7 skew chunks a row; panel rows
    # padded to 68, columns to 24.
    assert SMEM(5, 26, 65, 20, 20, 4, 4) == 3 * 5 * (26 * 17 + 7) * 16 + 68 * 24 * 4
    # f64: two elements a chunk (40 -> 20 chunks); the panel in f64.
    assert SMEM(4, 16, 40, 76, 76, 8, 8) == 3 * 4 * (16 * 20 + 4) * 16 + 40 * 80 * 8


@pytest.mark.parametrize(
    "p,q,in_bytes,want",
    [(40, 76, 2, True), (64, 128, 2, True), (65, 20, 2, True), (128, 128, 2, True),
     (16, 16, 2, True), (256, 256, 2, False), (40, 76, 4, False), (32, 32, 8, False)],
)
def test_sliced_uses_mma(p, q, in_bytes, want):
    # bf16 only, and only while the whole transposed panel leaves room for a
    # second block at the smallest tile: a 256 x 256 bf16 factor
    # (135,168 bytes of panel) stays on the CUDA cores.
    assert kron_sliced.sliced_uses_mma(p, q, in_bytes) is want
    if want:
        assert SMEM(1, 1, p, q, q, 2, 4, mma=True) <= TE.TWO_BLOCK_SMEM_BYTES


MAIN_LAUNCHES = [  # (M, S, P, Q, input bytes, tiles) of the sliced launches the smoke times
    pytest.param(1024, 32768, 32, 32, 4, (1, 256, 32), id="fig9-unfused"),
    pytest.param(4096, 64, 40, 76, 2, (2, 64, 76), id="ffn-stage0-bf16"),
    pytest.param(4096, 76, 64, 128, 2, (1, 76, 128), id="ffn-stage1-bf16"),
    pytest.param(4096, 64, 40, 76, 4, (2, 64, 76), id="ffn-stage0-f32"),
    pytest.param(4096, 76, 64, 128, 4, (1, 76, 128), id="ffn-stage1-f32"),
    pytest.param(10, 52, 65, 20, 4, (5, 26, 20), id="compress-stage0"),
    pytest.param(10, 20, 52, 50, 4, (5, 20, 50), id="compress-stage1"),
]


@pytest.mark.parametrize("m,s,p,q,in_bytes,want", MAIN_LAUNCHES)
def test_sliced_tiles_at_the_main_shapes(m, s, p, q, in_bytes, want):
    # Q whole, runs of at least a 32-byte sector, within the two-block share.
    tiles = kron_sliced.sliced_tiles(m, s, p, q, 4, in_bytes=in_bytes)
    assert tiles == want
    t_m, t_s, t_q = tiles
    assert m % t_m == 0 and s % t_s == 0 and q % t_q == 0 and t_q == q
    assert t_s * in_bytes >= 32
    mma = kron_sliced.sliced_uses_mma(p, q, in_bytes)
    assert SMEM(t_m, t_s, p, q, t_q, in_bytes, 4, mma) <= TE.TWO_BLOCK_SMEM_BYTES


def _smoke_cases():
    return [pytest.param(*case, id=case[0]) for case in SMOKE.SLICED_CASES]


@pytest.mark.parametrize("name,m,p,q,s,dtype,offset", _smoke_cases())
def test_smoke_sliced_cases_reach_their_branches(name, m, p, q, s, dtype, offset):
    in_bytes = torch.tensor([], dtype=dtype).element_size()
    acc_bytes = TE.acc_dtype_for(dtype).itemsize
    t_m, t_s, t_q = kron_sliced.sliced_tiles(m, s, p, q, acc_bytes, in_bytes=in_bytes)
    mma = kron_sliced.sliced_uses_mma(p, q, in_bytes)
    assert m % t_m == 0 and s % t_s == 0 and q % t_q == 0
    assert SMEM(t_m, t_s, p, q, t_q, in_bytes, acc_bytes, mma) <= TE.TWO_BLOCK_SMEM_BYTES
    assert mma == name.startswith("mma")
    tiles = (q // t_q) * (m // t_m) * (s // t_s)
    grid = 132 * 2  # an H100 at two blocks per SM
    if "many tiles" in name:
        assert tiles >= 4 * grid
    if "crossing Q-tiles" in name:
        # Block j takes tiles j, j + grid, ...: with more tiles per Q-tile
        # than blocks, every block's walk moves on to the next Q-tile.
        assert t_q < q and tiles > grid and tiles // (q // t_q) > grid // 2
    if "odd S" in name:
        assert t_s % 2 == 1
    if "odd P" in name:
        assert p % 2 == 1 and in_bytes == 2  # runs of 130 bytes: element by element
    if "offset" in name:
        assert offset % (16 // in_bytes)


def test_sliced_tiles_raise_when_nothing_fits():
    # f64 P = 2048: three one-slice slots and the (2048, 8) panel alone
    # exceed the two-block share.
    assert SMEM(1, 1, 2048, 8, 1, 8, 8) > TE.TWO_BLOCK_SMEM_BYTES
    with pytest.raises(TG.VmemOverflowError):
        kron_sliced.sliced_tiles(4, 8, 2048, 8, 8)
    with pytest.raises(ValueError, match="kind"):
        kron_sliced.sliced_tiles(4, 8, 32, 32, 4, kind="chain_fwd")
