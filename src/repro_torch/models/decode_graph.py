"""The decode step as a chain of CUDA graphs cut at the model's spans.

``model.decode_step`` runs through ``step`` here.  A call runs from graphs
when it is eligible and its key was also the key of the previous call, so
that every shape it meets has run eagerly once (kernels built, plans and
occupancy queries memoized): the first such call captures one whole step,
and every later call with that key replays it.  Every other call runs the
eager step, unchanged.

**Eligible:** tokens on the card and no parameter or cache leaf that
requires grad; no mesh (no ``use_mesh``, no ``kron_distributed`` scope;
``decode_step_on_mesh`` is another entry point); no chaos injection and the
numerics guard off (its check reads a flag on the host); no capture already
under way and no dispatch mode (a dry run's fake tensors, a cost count);
outside any ``eager()`` block.

**Key:** the config, the backend, the tokens' shape and dtype, the
positions' shape, whether a ``moe.route_record`` block is open (and the
shapes of its next buffers), and the parameter and cache leaves themselves:
a new cache is a new key, even where its memory is the old one's.

**Capture:** one full step on a side stream, into one memory pool.  A new
graph starts at every ``telemetry.span`` that the step enters or leaves,
down to and including ``op``; spans inside an op (``program``, ``stage``,
``launch``, ``plan``) do not cut.  The capture keeps the sequence of span
events and graphs, drops empty graphs, and keeps the telemetry counters
the step made without making them (``telemetry.observed``): its replays
do.  It works with telemetry inactive.  The step reads its tokens and
positions from static tensors, and writes a route record into static
buffers.  The kernel wrappers count their launches in
``kernels/_launch.launches`` as they are captured, once; a replay calls no
wrapper and counts none.

**Replay:** the call's tokens and positions are copied into the static
inputs; the graphs replay in capture order on the side stream, each inside
the spans its eager counterpart ran in when telemetry is active, so a trace
attributes the device work to the same ``kronscope.*`` ranges as an eager
step; the static router logits are copied into the caller's route buffers;
the counters are added again; the logits come back as a fresh tensor (a
caller may keep them across later steps).

**Store:** one captured step.  A capture under another key releases it
first, and so does a miss once its leaves have died: its graphs and pool go
with it.

The telemetry counters ``decode.graph_steps``, ``decode.eager_steps`` and
``decode.graph_captures`` say which path each call took.  A replay runs no
Python of the step: a patch of the step's functions that keeps Python state
per call (a check that records or replaces routes call by call, a fault
that feeds one call's tensors to the next) must run its steps inside
``eager()``.  Under graphs the capture freezes that state: every replay
repeats the capture's call, and reads tensors the patch held then, which
may since have been freed.
"""
from __future__ import annotations

import contextlib
import warnings
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .. import tree
from ..core import layers
from ..runtime import chaos, guard, sharding, telemetry
from . import moe

CUT_BELOW = "op"  # spans inside this one do not cut
EMPTY = "The CUDA Graph is empty"  # what ``capture_end`` warns of a graph with no node
DEVICES = ("cuda",)  # device types whose steps are captured

_ENTER, _EXIT = "enter", "exit"
_EAGER = [0]  # open eager() blocks


@contextlib.contextmanager
def eager():
    """Decode steps inside the block run eager."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


# ---------------------------------------------------------------------------
# Graphs on the card
# ---------------------------------------------------------------------------


class CudaGraphs:
    """The pieces of one step: captured into one memory pool and replayed,
    both on a side stream that waits for the current stream's work before
    and holds it back until its own is done after.  (Replayed on the
    default stream, a chain of some 330 graphs took 62 ms of the card where
    it takes 36 on a side stream: an H100, torch 2.11.)"""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    @staticmethod
    def busy(device: torch.device) -> bool:
        return torch.cuda.is_current_stream_capturing()

    @contextlib.contextmanager
    def on_side(self):
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            main.wait_stream(self.stream)

    capturing = replaying = on_side

    def begin(self) -> torch.cuda.CUDAGraph:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=self.pool)
        return g

    def end(self, g: torch.cuda.CUDAGraph):
        """The graph, instantiated, or None where it holds no node (which
        ``capture_end`` warns of)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        empty = False
        for w in caught:
            if str(w.message).startswith(EMPTY):
                empty = True
            else:  # any other warning goes on as it came
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        if empty:
            g.reset()
            return None
        return g


GRAPHS = CudaGraphs


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


class _Cutter:
    """The ``telemetry.observed`` hook of a capture pass: ends the open graph
    and starts the next at every span event outside an op."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.plan: list = []  # graphs and (_ENTER, name, attrs) / (_EXIT, name)
        self.stack: list[str] = []
        self.counters: dict[str, int] = {}
        self.open = None

    def begin(self) -> None:
        self.open = self.graphs.begin()

    def end(self) -> None:
        g, self.open = self.open, None
        piece = self.graphs.end(g)
        if piece is not None:
            self.plan.append(piece)

    def abort(self) -> None:
        """End an open capture after a failure, keeping the failure's error."""
        if self.open is not None:
            with contextlib.suppress(Exception):
                self.end()

    def _cut(self, event: tuple) -> None:
        self.end()
        self.plan.append(event)
        self.begin()

    def enter(self, name: str, attrs: dict) -> None:
        if CUT_BELOW not in self.stack:
            self._cut((_ENTER, name, attrs))
        self.stack.append(name)

    def exit(self, name: str) -> None:
        self.stack.pop()
        if CUT_BELOW not in self.stack:
            self._cut((_EXIT, name))

    def counter(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


class _Step:
    """One captured step: its plan, static inputs and outputs, and what it
    counts."""

    def __init__(self, refs, graphs, cutter, tokens, pos, logits, routes):
        self.refs = refs
        self.graphs = graphs
        self.plan = cutter.plan
        self.pieces = [p for p in cutter.plan if type(p) is not tuple]
        self.counters = cutter.counters
        self.tokens, self.pos, self.logits, self.routes = tokens, pos, logits, routes

    def release(self) -> None:
        for p in self.pieces:
            p.reset()
        self.plan = self.pieces = []
        self.graphs = self.tokens = self.pos = self.logits = self.routes = None


def _capture(run, cfg, params, cache, tokens, pos, backend, refs) -> _Step:
    device = tokens.device
    graphs = GRAPHS(device)
    st_tokens = tokens.clone()
    st_pos = torch.empty(tuple(pos.shape) if isinstance(pos, torch.Tensor) else (),
                         dtype=torch.int32, device=device)
    record = moe._RECORD
    routes = None if record is None else [torch.empty_like(b) for b in record[0][record[1]:]]
    cutter = _Cutter(graphs)
    with graphs.capturing():
        moe._RECORD = None if routes is None else [routes, 0]
        try:
            with telemetry.observed(cutter):
                cutter.begin()
                try:
                    logits, _ = run(cfg, params, cache, st_tokens, st_pos, backend=backend)
                except BaseException:
                    cutter.abort()
                    raise
                cutter.end()
            if routes is not None:
                routes = routes[:moe._RECORD[1]]
        finally:
            moe._RECORD = record
    return _Step(refs, graphs, cutter, st_tokens, st_pos, logits, routes)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def _walk(plan: list) -> None:
    """The graphs in order, each inside the spans it was captured in."""
    open_spans = []
    try:
        for item in plan:
            if type(item) is not tuple:
                item.replay()
            elif item[0] is _ENTER:
                s = telemetry.span(item[1], **item[2])
                s.__enter__()
                open_spans.append(s)
            else:
                open_spans.pop().__exit__(None, None, None)
    finally:
        while open_spans:
            open_spans.pop().__exit__(None, None, None)


def _replay(entry: _Step, tokens, pos):
    """The step from its graphs, with the spans and counters of its
    capture."""
    entry.tokens.copy_(tokens)
    if isinstance(pos, torch.Tensor):
        entry.pos.copy_(pos)
    else:
        entry.pos.fill_(int(pos))
    with entry.graphs.replaying():
        if telemetry.active():
            _walk(entry.plan)
        else:
            for p in entry.pieces:
                p.replay()
    for r in entry.routes or ():
        moe._next_record().copy_(r)
    logits = entry.logits.clone()
    for name, n in entry.counters.items():
        telemetry.counter_inc(name, n)
    telemetry.counter_inc("decode.graph_steps")
    return logits


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


_HELD: list = [None, None]  # the captured step's key and its _Step
_PREV: list = [None, ()]  # the previous eligible call's key and weakrefs


def _eligible(tokens: torch.Tensor) -> bool:
    return (tokens.device.type in DEVICES and type(tokens) is torch.Tensor
            and not _EAGER[0] and not chaos.active() and guard.numerics_policy() == "off"
            and sharding.ambient_mesh() is None and not layers._DIST_SCOPES
            and _get_current_dispatch_mode() is None and not GRAPHS.busy(tokens.device))


def _key(cfg, backend, tokens, pos, leaves) -> tuple:
    record = moe._RECORD
    routes = None if record is None else (
        record[1], tuple((b.shape, b.dtype) for b in record[0][record[1]:]))
    pos_shape = tuple(pos.shape) if isinstance(pos, torch.Tensor) else ()
    return (cfg, backend, tokens.shape, tokens.dtype, tokens.device, pos_shape, routes,
            tuple(map(id, leaves)))


def _same(refs: list, leaves: list) -> bool:
    """Whether weak references ``refs`` hold ``leaves`` themselves (a key's
    ids may be a dead tensor's, reused)."""
    return len(refs) == len(leaves) and all(r() is leaf for r, leaf in zip(refs, leaves))


def _release() -> None:
    """Release the captured step, if any."""
    entry, _HELD[:] = _HELD[1], (None, None)
    if entry is not None:
        entry.release()


def step(run: Callable, cfg, params: dict, cache: dict, tokens: torch.Tensor, pos,
         backend: str) -> tuple[torch.Tensor, Any]:
    """``run(cfg, params, cache, tokens, pos, backend=)`` (the eager step,
    ``(logits, cache)``) from graphs where the call is eligible and its key
    was the previous call's (module docstring), else eager."""
    leaves = tree.leaves(params) + tree.leaves(cache) if _eligible(tokens) else None
    if leaves is None or any(leaf.requires_grad for leaf in leaves):
        telemetry.counter_inc("decode.eager_steps")
        return run(cfg, params, cache, tokens, pos, backend=backend)
    key = _key(cfg, backend, tokens, pos, leaves)
    held_key, entry = _HELD
    if entry is not None and held_key == key and _same(entry.refs, leaves):
        _PREV[:] = key, entry.refs
        return _replay(entry, tokens, pos), cache
    if entry is not None and any(r() is None for r in entry.refs):
        _release()
    prev_key, prev_refs = _PREV
    if prev_key != key or not _same(prev_refs, leaves):
        _PREV[:] = key, [weakref.ref(leaf) for leaf in leaves]
        telemetry.counter_inc("decode.eager_steps")
        return run(cfg, params, cache, tokens, pos, backend=backend)
    _release()
    entry = _capture(run, cfg, params, cache, tokens, pos, backend, prev_refs)
    _HELD[:] = key, entry
    telemetry.counter_inc("decode.graph_captures")
    return _replay(entry, tokens, pos), cache


def clear() -> None:
    """Release the captured step and forget the previous call."""
    _release()
    _PREV[:] = None, ()


__all__ = ["step", "eager", "clear"]
