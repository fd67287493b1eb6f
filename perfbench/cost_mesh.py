"""The yardstick of a Kron-Matmul spread over a mesh: one card's share.

Counted from the problem's shapes and the paper's round schedule (§5:
each round applies as many factors as stay rank-local and ends in one
all-to-all over the model axis), never from what the program chooses:

* FLOPs: the problem's sliced-multiply count (``cost.forward_flops``)
  over the ``G_M * G_K`` cards, which share every factor's multiply
  evenly;
* HBM bytes: each round reads the card's input stripe once and writes its
  output stripe once (the stripe must be whole before the round's
  exchange), plus the factors;
* all-to-all bytes: each round's output stripe less the card's own
  ``1/G_K`` of it, sent once.

``MeshCost.step_roofline_s`` is the least time a card could take a step:
the larger of the local chains' roofline (``cost.Cost.roofline_s``) and
the exchange at ``LINK_BYTES_PER_S``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from perfbench import cost

# NVLink 4 on an H100 SXM: 900 GB/s of a card's links, 450 GB/s in each
# direction (NVIDIA data sheet).
LINK_BYTES_PER_S = 450e9


@dataclass(frozen=True)
class MeshCost(cost.Cost):
    """One card's work of a step, and the bytes it sends to the others."""

    a2a_bytes: int = 0

    @property
    def a2a_s(self) -> float:
        return self.a2a_bytes / LINK_BYTES_PER_S

    @property
    def step_roofline_s(self) -> float:
        return max(self.roofline_s, self.a2a_s)


def rounds(k_loc: int, ps: Sequence[int], qs: Sequence[int], g_k: int) -> list[int]:
    """The round lengths over the factors in application order (the last
    factor of the problem first): each round the most factors whose
    ``prod(P)`` divides the columns a card holds and whose ``prod(Q)`` the
    model axis divides."""
    out, i, cols = [], 0, k_loc
    while i < len(ps):
        best = 0
        for j in range(i, len(ps)):
            if cols % math.prod(ps[i:j + 1]):
                break
            if math.prod(qs[i:j + 1]) % g_k == 0:
                best = j + 1 - i
        if best == 0:
            raise ValueError(f"no round of {list(ps[i:])} x {list(qs[i:])} on {g_k} cards")
        cols = cols // math.prod(ps[i:i + best]) * math.prod(qs[i:i + best])
        out.append(best)
        i += best
    return out


def mesh_forward(m: int, ps: Sequence[int], qs: Sequence[int], g_m: int, g_k: int,
                 dtype: str) -> MeshCost:
    """One card's share of ``Y = X (F^1 (x) ... (x) F^N)`` on a ``(g_m, g_k)``
    mesh: rows over ``g_m``, columns over ``g_k``."""
    size = cost.ITEMSIZE[dtype]
    m_loc = m // g_m
    ps_app, qs_app = list(ps)[::-1], list(qs)[::-1]
    cols = math.prod(ps) // g_k
    elems, sent, i = 0, 0, 0
    for r in rounds(cols, ps_app, qs_app, g_k):
        out = cols // math.prod(ps_app[i:i + r]) * math.prod(qs_app[i:i + r])
        elems += m_loc * (cols + out)
        sent += m_loc * out * (g_k - 1) // g_k
        cols = out
        i += r
    elems += sum(p * q for p, q in zip(ps, qs))
    flops = cost.forward_flops(m, ps, qs) // (g_m * g_k)
    return MeshCost(flops, elems * size, dtype, sent * size)


__all__ = ["LINK_BYTES_PER_S", "MeshCost", "rounds", "mesh_forward"]
