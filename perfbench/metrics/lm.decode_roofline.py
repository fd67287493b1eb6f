"""``lm.decode_roofline``: a decode step's roofline time (``cost_lm.py``: the
larger of its FLOPs at the dtype's peak and its bytes at the HBM
bandwidth) over the device-busy time of one traced step, in %.  None
where the step's cost is not a decode step's."""
from perfbench import cost_lm


def read(run):
    tr = run.trace
    if (tr is None or tr.steps == 0 or tr.busy_s <= 0
            or not isinstance(run.cost, cost_lm.DecodeCost)):
        return None
    return run.cost.roofline_s / (tr.busy_s / tr.steps) * 100
