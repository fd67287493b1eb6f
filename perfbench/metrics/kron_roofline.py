"""``kron_roofline``: the step's roofline time (``cost.py``: the larger of
its FLOPs at the dtype's peak and its bytes at the HBM bandwidth) over the
device-busy time of one traced step, in %.  In the cells that list it all
device work is the op's."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or tr.busy_s <= 0:
        return None
    return run.cost.roofline_s / (tr.busy_s / tr.steps) * 100
