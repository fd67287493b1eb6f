"""``optim.device_ms``: device time per traced step of the operations
launched inside the program's ``kronscope.optim`` ranges: the optimizer's
update, its global norm included (ms).  An operation is placed by the
launch the profiler joins to it; one with no joined launch is left out.
None where the window holds no such range (a program without the span)."""
from perfbench import spans

RANGE = "kronscope.optim"


def device_s_per_step(run):
    """Device seconds per traced step launched in ``kronscope.optim``; None
    where the window holds no such range."""
    tr = run.trace
    if tr is None or tr.steps == 0 or not spans.ranges(tr, (RANGE,)):
        return None
    lo, hi = tr.window.start, tr.window.end
    total = sum(min(op.end, hi) - max(op.start, lo) for op in tr.device_ops()
                if tr.launched_in(op, (RANGE,)))
    return total / tr.steps if total > 0 else None


def read(run):
    s = device_s_per_step(run)
    return None if s is None else s * 1e3
