"""Self time of the program's ``kronscope.*`` ranges in a traced window.

The program's telemetry spans land in the profiler's trace as
``user_annotation`` ranges named ``kronscope.<span>``.  On one thread they
nest strictly, so a range's self time is its duration less the part its
nested ``kronscope.*`` ranges cover (each clipped to it).  Ranges on every
thread count: the backward's ranges run on the autograd engine's thread.
A range belongs to the window when it starts inside it.
"""
from __future__ import annotations

from collections import defaultdict

PREFIX = "kronscope."
OP = "kronscope.op"
OP_BWD = "kronscope.op_bwd"
EXECUTOR = ("kronscope.program", "kronscope.stage", "kronscope.stage_grad")
LAUNCH = "kronscope.launch"
CG = "kronscope.cg"
CG_ITER = "kronscope.cg_iter"


def ranges(tr, names=None) -> list:
    """The window's ``kronscope.*`` ranges, on every thread; only those named
    in ``names`` where it is given."""
    lo, hi = tr.window.start, tr.window.end
    return [s for s in tr.host
            if s.cat == "user_annotation" and s.name.startswith(PREFIX) and lo <= s.start < hi
            and (names is None or s.name in names)]


def self_seconds(tr) -> dict[str, float]:
    """Self time of the window's ``kronscope.*`` ranges, summed by name (s)."""
    by_tid = defaultdict(list)
    for s in ranges(tr):
        by_tid[s.tid].append(s)
    out: dict[str, float] = defaultdict(float)
    for spans in by_tid.values():
        # Entries [range, end clipped to its parents', covered by children].
        stack: list[list] = []
        for s in sorted(spans, key=lambda s: (s.start, -s.dur)):
            while stack and stack[-1][1] <= s.start:
                top, _, covered = stack.pop()
                out[top.name] += top.dur - covered
            end = s.end
            if stack:
                end = min(end, stack[-1][1])
                stack[-1][2] += end - s.start
            stack.append([s, end, 0.0])
        for top, _, covered in stack:
            out[top.name] += top.dur - covered
    return dict(out)


def self_us_per_step(run, names) -> float | None:
    """Microseconds per traced step of the self time of the ranges named in
    ``names``.  None where the window holds no ``kronscope.op`` range (a
    program without the op's span)."""
    tr = run.trace
    if tr is None or tr.steps == 0 or not ranges(tr, (OP,)):
        return None
    selfs = self_seconds(tr)
    return sum(selfs.get(n, 0.0) for n in names) / tr.steps * 1e6


def self_us_per_range(run, name) -> float | None:
    """Microseconds of self time per ``name`` range in the window.  None
    where the window holds none."""
    tr = run.trace
    n = len(ranges(tr, (name,))) if tr is not None else 0
    return self_seconds(tr)[name] / n * 1e6 if n else None


__all__ = ["ranges", "self_seconds", "self_us_per_step", "self_us_per_range", "PREFIX", "OP",
           "OP_BWD", "EXECUTOR", "LAUNCH", "CG", "CG_ITER"]
