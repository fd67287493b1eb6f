"""``optim.roofline``: AdamW's byte bound (``cost_lm_train.py``: every
parameter's value, gradient and moments read, its value and moments
written, the gradient read again for the norm, at the HBM bandwidth) over
``optim.device_ms``'s device time a step, in %.  None where the step's
cost has no optimizer pass or the window no ``kronscope.optim`` range."""
from pathlib import Path

from perfbench.harness import load_module

_DEVICE = load_module(Path(__file__).with_name("optim.device_ms.py"), "metric")


def read(run):
    optim = getattr(run.cost, "optim", None)
    s = _DEVICE.device_s_per_step(run)
    if optim is None or s is None:
        return None
    return optim.memory_s / s * 100
