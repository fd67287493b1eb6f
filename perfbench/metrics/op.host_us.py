"""``op.host_us``: the median host time of a step's calls into the op
(forward, and ``torch.autograd.grad`` through it where the step trains),
each step issued on an idle device and timed by the harness's own clock,
with no synchronisation inside (us)."""
import statistics


def read(run):
    return statistics.median(run.host_us) if run.host_us else None
