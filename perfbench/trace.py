"""Reading a ``torch.profiler`` trace: device intervals, host ranges, launches.

The traced part of a ``--trace 1`` run is one ``perfbench.window`` range on
the host, holding one ``perfbench.step`` range per step and ending after
the device has finished (the harness synchronises inside it).  The reader
works on the Chrome-trace form the profiler exports (``traceEvents``, times
in microseconds), which is also what the tests build by hand:

* device operations: categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``;
* launches: ``cuda_runtime`` and ``cuda_driver`` events, joined to the
  device operation they started by ``args.correlation``;
* host ranges: ``user_annotation`` (``record_function``, so the
  program's ``kronscope.*`` spans and the harness's own) and ``cpu_op``.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Iterable

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
HOST_CATS = frozenset({"user_annotation", "cpu_op"})
WINDOW = "perfbench.window"
STEP = "perfbench.step"


@dataclass(frozen=True)
class Span:
    name: str
    cat: str
    start: float  # seconds
    dur: float  # seconds
    tid: object = None
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.start + self.dur


def union(intervals: Iterable[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, merged
    and sorted."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The events of one traced window."""

    def __init__(self, events: Iterable[dict]):
        self.device: list[Span] = []
        self.launches: dict[int, Span] = {}
        self.host: list[Span] = []
        self._named: dict[frozenset, list[Span]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            corr = args.get("correlation")
            span = Span(e.get("name", ""), cat, float(e["ts"]) * 1e-6,
                        float(e.get("dur", 0.0)) * 1e-6, e.get("tid"), corr)
            if cat in DEVICE_CATS:
                self.device.append(span)
            elif cat in LAUNCH_CATS:
                if corr is not None:
                    self.launches[corr] = span
            elif cat in HOST_CATS:
                self.host.append(span)
        windows = self.ranges(WINDOW)
        if len(windows) != 1:
            raise ValueError(f"a trace holds one {WINDOW!r} range, found {len(windows)}")
        self.window = windows[0]
        self.steps = len(self.ranges(STEP))

    @classmethod
    def from_chrome(cls, data) -> "Trace":
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """Export ``prof``'s trace to a temporary file (under ``TMPDIR``),
        read it and delete it."""
        fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                return cls.from_chrome(json.load(fh))
        finally:
            os.unlink(path)

    # -- what the metrics read ------------------------------------------------

    def ranges(self, name: str) -> list[Span]:
        return [s for s in self.host if s.cat == "user_annotation" and s.name == name]

    @property
    def window_s(self) -> float:
        return self.window.dur

    def device_ops(self) -> list[Span]:
        """Device operations that overlap the window."""
        lo, hi = self.window.start, self.window.end
        return [s for s in self.device if s.end > lo and s.start < hi]

    def kernels(self) -> list[Span]:
        return [s for s in self.device_ops() if s.cat == "kernel"]

    def busy(self) -> list[tuple[float, float]]:
        return union(((s.start, s.end) for s in self.device_ops()),
                     self.window.start, self.window.end)

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy())

    def launched_in(self, op: Span, names: Iterable[str]) -> bool | None:
        """Whether ``op`` was launched inside a host range named in ``names``
        on the launching thread; None where the trace joins no launch to it."""
        launch = self.launches.get(op.corr) if op.corr is not None else None
        if launch is None:
            return None
        key = frozenset(names)
        if key not in self._named:
            self._named[key] = [s for s in self.host
                                if s.cat == "user_annotation" and s.name in key]
        return any(s.tid == launch.tid and s.start <= launch.start and launch.end <= s.end
                   for s in self._named[key])

    # -- the breakdown ----------------------------------------------------------

    def top_device_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations that took most time, summed by name."""
        by_name: dict[str, float] = defaultdict(float)
        lo, hi = self.window.start, self.window.end
        for s in self.device_ops():
            by_name[s.name] += min(s.end, hi) - max(s.start, lo)
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle time of the device, summed by what the host was doing in the
        middle of each gap (the innermost host range of the window's thread
        covering that instant), the ``k`` largest."""
        lo, hi = self.window.start, self.window.end
        edges = [lo]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(hi)
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        tid = self.window.tid
        spans = sorted((s for s in self.host if s.tid == tid and s is not self.window),
                       key=lambda s: (s.start, -s.dur))
        by_name: dict[str, float] = defaultdict(float)
        stack: list[Span] = []
        j = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            t = (a + b) / 2
            while j < len(spans) and spans[j].start <= t:
                while stack and stack[-1].end <= spans[j].start:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1].end < t:
                stack.pop()
            by_name[stack[-1].name if stack else "outside host ranges"] += b - a
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]


__all__ = ["Span", "Trace", "union", "WINDOW", "STEP", "DEVICE_CATS"]
