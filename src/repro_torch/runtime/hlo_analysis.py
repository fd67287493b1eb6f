"""Collective accounting from what torch gives: the port of
``repro.runtime.hlo_analysis``.

The reference parses the collectives out of compiled, post-SPMD HLO text.
An eager step has no HLO: every collective it makes is a ``c10d`` op (a
direct ``torch.distributed`` call) or a ``_c10d_functional`` op (DTensor's
and the functional API's) that a ``TorchDispatchMode`` sees, on real
process groups and on a fake one alike.  ``kind_of`` maps such an op onto
the reference's five kind names (``COLLECTIVE_OPS``), and a recorded trace
is a list of ``(kind, payload bytes)`` pairs (``hlo_cost.CostMode`` records
them, with the tensors' shapes and the call site).

Per-device semantics, as the reference's: a rank's collective moves its
own tensors, so the bytes of a call are what this participant receives —
its output bytes (for an all-reduce, the reduced tensor; for an
all-gather, the gathered result; for a send or receive, the message).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import torch

COLLECTIVE_OPS = (
    "all-to-all",
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
)

# c10d / _c10d_functional op names (the overload packet's last component)
# -> the reference's kind.  Ops outside the table (barrier, broadcast,
# gather, scatter, reduce) move no payload the reference's HLO would name,
# and no step of the package makes them.
_KINDS = {
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
_NAMESPACES = ("c10d", "_c10d_functional")


def kind_of(func) -> str | None:
    """The reference's kind of a dispatched op (an ``OpOverload``), or None
    for an op that is no collective."""
    if func.namespace not in _NAMESPACES:
        return None
    return _KINDS.get(func._opname)


def _tensors(value) -> Iterable[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def payload(func, args: Sequence, out) -> list[torch.Tensor]:
    """The tensors whose bytes a collective's call moves to this rank: its
    output.  The in-place ``c10d`` ops write their first argument (the
    output list or tensor; for ``send``, the message it sends); the
    functional ops return theirs."""
    if func.namespace == "c10d":
        return list(_tensors(args[0]))
    return list(_tensors(out))


def shape_bytes(t) -> int:
    """Bytes of a tensor, of a ``(dtype, shape)`` pair, or of a sequence of
    either."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if (isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], torch.dtype)):
        n = 1
        for d in t[1]:
            n *= int(d)
        return n * t[0].itemsize
    return sum(shape_bytes(x) for x in t)


@dataclass
class CollectiveStats:
    """Per-collective-op byte counts (per participating device)."""

    bytes_by_op: dict[str, int] = field(default_factory=dict)
    count_by_op: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def summary(self) -> str:
        if not self.bytes_by_op:
            return "no collectives"
        parts = [
            f"{op}: n={self.count_by_op[op]} {self.bytes_by_op[op]/1e6:.2f}MB"
            for op in sorted(self.bytes_by_op)
        ]
        return ", ".join(parts)


def collective_stats(trace: Iterable) -> CollectiveStats:
    """Sum a recorded trace of collectives: each entry a ``(kind, bytes)``
    pair, or an object with ``kind`` and ``nbytes`` (``hlo_cost.Site``)."""
    stats = CollectiveStats()
    for entry in trace:
        kind, nbytes = ((entry.kind, entry.nbytes) if hasattr(entry, "kind")
                        else entry)
        if kind not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective kind {kind!r}: want one of {COLLECTIVE_OPS}")
        stats.bytes_by_op[kind] = stats.bytes_by_op.get(kind, 0) + int(nbytes)
        stats.count_by_op[kind] = stats.count_by_op.get(kind, 0) + 1
    return stats


def collective_bytes(trace: Iterable) -> int:
    return collective_stats(trace).total_bytes


__all__ = ["collective_stats", "collective_bytes", "shape_bytes", "CollectiveStats",
           "COLLECTIVE_OPS", "kind_of", "payload"]
