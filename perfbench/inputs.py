"""Inputs made from ``--seed``: on the device, in few large calls."""
from __future__ import annotations

import math
from typing import Sequence

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` (the card's own for a CUDA device)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    return gen


def host_generator(seed: int) -> torch.Generator:
    """A CPU generator for choices the host makes (sampled step indices)."""
    gen = torch.Generator()
    gen.manual_seed(seed % 2**64)
    return gen


def randn(gen: torch.Generator, shape, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def factor_sets(gen, n_sets: int, ps: Sequence[int], qs: Sequence[int], dtype, device, *,
                requires_grad: bool = False) -> list[tuple[torch.Tensor, ...]]:
    """``n_sets`` sets of factors ``F^i (P_i, Q_i)``, entries N(0, 1/P_i) so
    that the product keeps the input's scale; one draw for all of them."""
    sizes = [p * q for p, q in zip(ps, qs)]
    flat = randn(gen, (n_sets, sum(sizes)), dtype, device)
    sets = []
    for row in flat:
        fs, at = [], 0
        for p, q, n in zip(ps, qs, sizes):
            f = (row[at:at + n].reshape(p, q) / math.sqrt(p)).contiguous()
            fs.append(f.requires_grad_(requires_grad))
            at += n
        sets.append(tuple(fs))
    return sets


__all__ = ["DTYPES", "generator", "host_generator", "randn", "factor_sets"]
