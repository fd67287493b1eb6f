"""``device.idle``: the share of the traced window in which no operation
ran on the device (1 minus the union of the device intervals), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100
