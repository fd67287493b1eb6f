"""``mesh.a2a_exposed_ms``: device time per traced step in which a kernel
of the relocations' all-to-alls runs (``mesh.a2a_device_ms``'s) and no
other device operation does: the exchange the slab pipeline left unhidden
(ms).  At most ``mesh.a2a_device_ms``."""
from pathlib import Path

from perfbench.harness import load_module
from perfbench.trace import union

_device = load_module(Path(__file__).with_name("mesh.a2a_device_ms.py"), "metric")


def exposed_s(tr) -> float | None:
    """Seconds of the window covered by the exchange's kernels alone."""
    ops = _device.exchange_kernels(tr)
    if not ops:
        return None
    lo, hi = tr.window.start, tr.window.end
    mine = {id(op) for op in ops}
    comm = union(((op.start, op.end) for op in ops), lo, hi)
    rest = union(((op.start, op.end) for op in tr.device_ops() if id(op) not in mine), lo, hi)
    total, j = 0.0, 0
    for a, b in comm:
        covered = 0.0
        while j < len(rest) and rest[j][1] <= a:
            j += 1
        k = j
        while k < len(rest) and rest[k][0] < b:
            covered += min(b, rest[k][1]) - max(a, rest[k][0])
            k += 1
        total += (b - a) - covered
    return total


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or not tr.ranges(_device.RANGES[0]):
        return None
    s = exposed_s(tr)
    return None if s is None else s / tr.steps * 1e3
