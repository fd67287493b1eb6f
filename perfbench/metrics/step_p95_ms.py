"""``step_p95_ms``: the 95th percentile of every window step's time (ms),
from the CUDA events recorded at the step boundaries (nearest rank)."""
import math


def read(run):
    times = sorted(run.window.step_ms)
    return times[max(0, math.ceil(0.95 * len(times)) - 1)]
