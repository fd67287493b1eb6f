"""The plain reference of a Kron-Matmul no card holds: chosen columns, in float64.

Plain PyTorch, independent of the program under test, as ``reference.py``
is (TF32 is off for every library multiply, as the harness sets it).  For
``Y = X (F^1 (x) ... (x) F^N)`` with ``X`` too large for one card, the
check needs a few columns of ``Y``: column ``j`` is ``X`` times column
``j`` of the Kronecker matrix, and that column is the Kronecker product of
each factor's ``j_i``-th column (``j``'s digits in the bases ``Q_i``,
``F^1``'s the most significant).

* ``stripe_chunks`` makes a rank's stripe of ``X`` from the seed, chunk by
  chunk, as the benchmark's step makes it and as this reference remakes it.
* ``stripe_partial`` is one rank's share, ``X_r`` times its rows of those
  columns, summed chunk by chunk in float64 (the ranks' partials sum to
  the columns of ``Y``): rows ``[k0, k0 + C)`` of the chosen columns, ``C``
  a product of trailing ``P_i``, are the trailing factors' columns as one
  Kronecker product (``trailing_columns``) times the leading factors'
  entries at ``k0``'s digits (``leading_scale``).
* ``columns`` is the whole of it for an ``X`` held in one piece (the tests'
  small problems).
"""
from __future__ import annotations

import math
from typing import Iterable, Iterator, Sequence

import torch


def stripe_chunks(gen: torch.Generator, m: int, k_loc: int, chunk: int, dtype,
                  device) -> Iterator[tuple[int, torch.Tensor]]:
    """``(k0, X[:, k0:k0+chunk])`` of one rank's ``(m, k_loc)`` stripe, in
    order, each chunk one ``randn`` draw of ``gen``: the same generator
    state gives the same stripe, made whole or remade chunk by chunk."""
    if k_loc % chunk:
        raise ValueError(f"chunk {chunk} does not divide the stripe's {k_loc} columns")
    for k0 in range(0, k_loc, chunk):
        yield k0, torch.randn((m, chunk), generator=gen, dtype=dtype, device=device)


def digits(j: int, bases: Sequence[int]) -> list[int]:
    """``j``'s digits in ``bases``, the first the most significant."""
    out = []
    for b in reversed(bases):
        out.append(j % b)
        j //= b
    return out[::-1]


def _split(ps: Sequence[int], chunk: int) -> int:
    """The first trailing factor of a chunk: ``prod(ps[t:]) == chunk``."""
    for t in range(len(ps) + 1):
        if math.prod(ps[t:]) == chunk:
            return t
    raise ValueError(f"a chunk of {chunk} rows is no product of trailing factors {list(ps)}")


def trailing_columns(factors: Sequence[torch.Tensor], cols: Sequence[int], t: int) -> torch.Tensor:
    """``(prod P[t:], n)``: for each global column ``j`` of ``cols``, the
    Kronecker product of ``F^i[:, j_i]`` over the factors from ``t`` on."""
    qs = [int(f.shape[1]) for f in factors]
    device = factors[0].device
    ds = torch.tensor([digits(int(j), qs) for j in cols], dtype=torch.long, device=device)
    out = torch.ones((1, len(cols)), dtype=torch.float64, device=device)
    for i in range(t, len(factors)):
        f = factors[i].double()[:, ds[:, i]]  # (P_i, n)
        out = (out[:, None, :] * f[None, :, :]).reshape(-1, len(cols))
    return out


def leading_scale(factors: Sequence[torch.Tensor], cols: Sequence[int], t: int,
                  k0: int) -> torch.Tensor:
    """``(n,)``: the product of ``F^i[k0_i, j_i]`` over the factors before
    ``t``, ``k0_i`` the digits of row ``k0`` in the bases ``P_i``."""
    ps = [int(f.shape[0]) for f in factors]
    qs = [int(f.shape[1]) for f in factors]
    rows = digits(k0 // math.prod(ps[t:]), ps[:t])
    scale = torch.ones(len(cols), dtype=torch.float64, device=factors[0].device)
    for i in range(t):
        q = torch.tensor([digits(int(j), qs)[i] for j in cols], device=factors[0].device)
        scale = scale * factors[i].double()[rows[i], q]
    return scale


def stripe_partial(chunks: Iterable[tuple[int, torch.Tensor]], factor_sets, cols: Sequence[int],
                   k_start: int, chunk: int) -> list[torch.Tensor]:
    """One rank's ``(m, n)`` share of ``Y[:, cols]`` for each factor set:
    the stripe's chunks (``(k0, X chunk)``, ``k0`` within the stripe, which
    begins at global row ``k_start`` of the Kronecker matrix) times their
    rows of each set's columns, in float64."""
    sets = [[f.double() for f in fs] for fs in factor_sets]
    t = _split([int(f.shape[0]) for f in sets[0]], chunk)
    trail = [trailing_columns(fs, cols, t) for fs in sets]
    out = None
    for k0, x in chunks:
        x = x.double()
        if out is None:
            out = [x.new_zeros((x.shape[0], len(cols))) for _ in sets]
        for acc, fs, tr in zip(out, sets, trail):
            acc += x @ tr * leading_scale(fs, cols, t, k_start + k0)
    return out


def columns(x: torch.Tensor, factors: Sequence[torch.Tensor], cols: Sequence[int],
            chunk: int) -> torch.Tensor:
    """``Y[:, cols]`` of ``Y = x (F^1 (x) ... (x) F^N)`` for an ``x`` held
    whole, chunk by chunk."""
    k = int(x.shape[1])
    parts = ((k0, x[:, k0:k0 + chunk]) for k0 in range(0, k, chunk))
    return stripe_partial(parts, [factors], cols, 0, chunk)[0]


__all__ = ["stripe_chunks", "digits", "trailing_columns", "leading_scale", "stripe_partial",
           "columns"]
