"""``moe.experts_device_ms``: device time per traced step of the operations
launched inside the program's ``kronscope.moe_experts`` ranges: the
dispatch into capacity buckets, the three expert einsums and the combine
(ms).  An operation is placed by the launch the profiler joins to it; one
with no joined launch is left out.  None where the window holds no such
range."""
from perfbench import spans

RANGE = "kronscope.moe_experts"


def device_ms_per_step(run, name: str):
    """Device ms per traced step of the operations launched in ``name``
    ranges; None where the window holds none."""
    tr = run.trace
    if tr is None or tr.steps == 0 or not spans.ranges(tr, (name,)):
        return None
    lo, hi = tr.window.start, tr.window.end
    total = sum(min(op.end, hi) - max(op.start, lo) for op in tr.device_ops()
                if tr.launched_in(op, (name,)))
    return total / tr.steps * 1e3


def read(run):
    return device_ms_per_step(run, RANGE)
