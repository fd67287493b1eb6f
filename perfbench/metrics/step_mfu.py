"""``step_mfu``: the step's FLOPs (``cost.py``) over the traced step time
(the traced window over its steps, idle time included) at the dtype's
peak, in %."""
from perfbench import cost


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or tr.busy_s <= 0:
        return None
    step_s = tr.window_s / tr.steps
    return run.cost.flops / (step_s * cost.PEAK_FLOPS[run.cost.dtype]) * 100
