"""``launch.kernels_per_step``: device kernels (copies and memsets left
out) in the traced window over its steps."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    kernels = tr.kernels()
    return len(kernels) / tr.steps if kernels else None
