"""Cost counting of an eager step: the port of ``repro.runtime.hlo_cost``.

The reference re-derives FLOPs, HBM bytes and collective payloads from
compiled HLO text, weighting each computation by the trip counts of the
loops around it.  An eager PyTorch step has no HLO: ``analyze(fn, *args)``
runs ``fn`` under ``CostMode``, a ``TorchDispatchMode`` that sees every
aten op the step dispatches, on real tensors or on fake ones
(``FakeTensorMode``, the dry-run's).  Python runs every loop iteration
(layers, microbatches, query chunks, the remat re-forwards), so each op is
seen once per execution and no trip-count weighting is needed
(``HloCost.trip_weighted`` stays True: the counts are per executed op).

Accounting conventions (per device: an SPMD rank runs its own step):
  * dot flops      = ``torch.utils.flop_counter``'s formulas for the
                     matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
                     ``_scaled_mm`` and the fused attention ops), plus the
                     port's own kernels (``count_kernel``), which bypass the
                     dispatcher: each launch, real or fake, reports its
                     FLOPs (``emit`` and the sliced kernels' wrappers);
  * elementwise    = numel(output) per ``pointwise`` op but copies (the
                     reference's 1-flop-per-element); reduce = numel(input) per
                     ``reduction`` op; softmax and log-softmax as the
                     reductions and elementwise ops XLA expands them into;
                     convolutions by ``flop_counter``'s formula (not dots);
  * bytes accessed = operands + outputs of every aten op that is not a view
                     or shape-only op: in eager mode every op is a launch
                     that reads and writes HBM (the eager analogue of the
                     reference's fusion boundaries, so more bytes than XLA
                     counts for the same step), plus each kernel launch's
                     input, factors and output;
  * collectives    = payload bytes by kind (``hlo_analysis``), one count per
                     call.

``CostMode(memory=device_type)`` also tracks the bytes of the live tensor
storages on that device type (fake ones too) and their peak over the run:
the dry-run's per-device memory.
"""
from __future__ import annotations

import os
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from .hlo_analysis import COLLECTIVE_OPS, kind_of, payload, shape_bytes

aten = torch.ops.aten

_DOTS = {getattr(aten, name) for name in (
    "mm", "addmm", "bmm", "baddbmm", "_scaled_mm",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_cudnn_attention_backward",
    "_flash_attention_forward", "_flash_attention_backward",
    "_efficient_attention_forward", "_efficient_attention_backward",
) if hasattr(aten, name)}
# Elementwise ops and reductions XLA expands these into, per input element:
# softmax = max, subtract, exp, sum, divide; log-softmax adds a log.
_EXPANDED = {
    aten._softmax: 5, aten._log_softmax: 6,
    aten._softmax_backward_data: 4, aten._log_softmax_backward_data: 4,
}
# Copies carry the pointwise tag but do no arithmetic (XLA counts none).
_COPIES = {aten.clone}
# Ops that move no tensor data: allocations, aliases, shape queries; the
# allocations among them still make storages.
_ALLOCS = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
           aten.new_empty_strided}
_FREE = _ALLOCS | {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten._unsafe_view, aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size, aten.set_,
    aten.resize_, aten._has_compatible_shallow_copy_type,
}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_QUIET = ("hlo_cost.py", "hlo_analysis.py", "sharding.py", "tree.py")


@dataclass
class HloCost:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=dict)
    collective_counts: dict[str, float] = field(default_factory=dict)
    trip_weighted: bool = True
    # FLOPs of the port's kernels by name (part of flops and dot_flops).
    kernel_flops: dict[str, float] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


@dataclass(frozen=True)
class Site:
    """One collective call: its kind, payload bytes, the payload's shapes
    and dtype, and where in the package it was made."""

    kind: str
    nbytes: int
    shape: tuple
    dtype: str
    site: str


# The CostModes collecting now (innermost last); the kernels' wrappers
# report to every one of them (``count_kernel``).
ACTIVE: list["CostMode"] = []


def count_kernel(name: str, flops: float, nbytes: float) -> None:
    """One launch of a port kernel (real, or a fake tensor's stand-in):
    its FLOPs (dots) and HBM bytes, into every active ``CostMode``."""
    for mode in ACTIVE:
        c = mode.cost
        c.flops += flops
        c.dot_flops += flops
        c.bytes_accessed += nbytes
        c.kernel_flops[name] = c.kernel_flops.get(name, 0.0) + flops


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def _call_site() -> str:
    """``file:line function`` of the package frame that made the call: the
    first frame in the package outside the sharding moves and this module,
    else the first in the package (a backward pass run by autograd)."""
    first = None
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG):
            here = f"{os.path.relpath(path, _PKG)}:{f.f_lineno} {f.f_code.co_name}"
            if not path.endswith(_QUIET):
                return here
            if first is None and not path.endswith(_QUIET[:2]):
                first = here
        f = f.f_back
    return first or "outside the package"


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes and collectives of every op dispatched inside
    it into ``self.cost``.  ``sites``: also keep each collective as a
    ``Site`` (``self.sites``).  ``memory``: a device type ("cuda", "cpu")
    whose live storages are tracked (``track`` adds tensors made before the
    mode; ``self.live_bytes``, ``self.peak_bytes``)."""

    def __init__(self, *, sites: bool = False, memory: str | None = None):
        super().__init__()
        self.cost = HloCost()
        self.sites: list[Site] | None = [] if sites else None
        self.memory = memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, weakref.ref] = {}

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- memory --------------------------------------------------------------

    def track(self, *trees) -> None:
        """Count tensors made before the mode (a step's inputs) as live."""
        for t in _tensors(list(trees)):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        if t.device.type != self.memory:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = weakref.ref(st, lambda _, key=key, n=n: self._drop(key, n))
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes

    def _drop(self, key: int, n: int) -> None:
        # A storage's last reference dies on whichever thread drops it; the
        # caller and autograd's device thread never run ops at once (the
        # caller waits in the engine), so the counters need no lock.
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    # -- counting ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":  # metadata (prim.device): a fake tensor's only
            return out
        rule = _RULES.get(func)
        if rule is None:
            rule = _RULES[func] = _rule(func)
        kind, flop_fn, dot, per_elem, counts_out, counts_in, moves, allocates = rule
        c = self.cost
        if kind is not None:
            moved = payload(func, args, out)
            nbytes = shape_bytes(moved)
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + nbytes
            c.collective_counts[kind] = c.collective_counts.get(kind, 0.0) + 1
            if self.sites is not None:
                self.sites.append(Site(
                    kind, nbytes, tuple(tuple(t.shape) for t in moved),
                    str(moved[0].dtype).removeprefix("torch.") if moved else "", _call_site()))
        elif flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out))
            c.flops += f
            if dot:
                c.dot_flops += f
        elif per_elem:
            c.flops += per_elem * args[0].numel()
        elif counts_out:
            c.flops += sum(t.numel() for t in _tensors(out))
        elif counts_in:
            c.flops += args[0].numel()
        if moves:
            c.bytes_accessed += (sum(t.numel() * t.element_size() for t in _tensors(args))
                                 + sum(t.numel() * t.element_size() for t in _tensors(kwargs))
                                 + sum(t.numel() * t.element_size() for t in _tensors(out)))
        if allocates and self.memory is not None:
            for t in _tensors(out):
                self._add(t)
        return out


# op -> how CostMode counts it (``_rule``), filled as ops are first seen
_RULES: dict = {}


def _rule(func) -> tuple:
    """(collective kind, flop formula, is a dot, flops per input element,
    flops = output elements, flops = input elements, moves bytes,
    allocates its outputs) of one op."""
    packet = func._overloadpacket
    kind = kind_of(func)
    flop_fn = flop_counter.flop_registry.get(packet) if kind is None else None
    tags = func.tags
    moves = not (func.is_view or packet in _FREE)
    allocates = (moves or packet in _ALLOCS) and not func._schema.is_mutable
    return (kind, flop_fn, packet in _DOTS, _EXPANDED.get(packet, 0),
            torch.Tag.pointwise in tags and packet not in _COPIES,
            torch.Tag.reduction in tags, moves, allocates)


def analyze(fn, *args, **kwargs) -> HloCost:
    """The cost of one call ``fn(*args, **kwargs)`` (``CostMode``'s
    conventions); the call's result is dropped."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.cost


__all__ = ["analyze", "HloCost", "CostMode", "Site", "count_kernel", "ACTIVE",
           "COLLECTIVE_OPS"]
