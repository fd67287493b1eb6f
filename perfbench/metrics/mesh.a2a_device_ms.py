"""``mesh.a2a_device_ms``: device time per traced step of the collective
kernels (NCCL's) launched inside the program's ``kronscope.relocate``
ranges: the round schedule's all-to-alls as the card runs them, waits for
the peers included (ms).

A kernel is the exchange's by its name (``nccl``); where the trace joins
its launch, that launch lies in a ``kronscope.relocate`` range.  None where
the window holds no such kernel (a program without the mesh's spans)."""

RANGES = ("kronscope.relocate",)


def exchange_kernels(tr) -> list:
    """The window's kernels of the relocations' all-to-alls."""
    out = []
    for op in tr.kernels():
        if "nccl" not in op.name.lower():
            continue
        if tr.launched_in(op, RANGES) is False:
            continue
        out.append(op)
    return out


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or not tr.ranges(RANGES[0]):
        return None
    ops = exchange_kernels(tr)
    if not ops:
        return None
    lo, hi = tr.window.start, tr.window.end
    return sum(min(op.end, hi) - max(op.start, lo) for op in ops) / tr.steps * 1e3
