"""``kronffn.roofline``: the Kron FFNs' own roofline time (``cost_lm.py``:
each Kron projection of a step as ``cost.kron_forward`` at M = the batch)
over the device time per traced step of the kernels launched inside both
a ``kronscope.ffn`` and a ``kronscope.op`` range: the Kron-Matmuls of the
dense layer's FFN and of the shared experts, the FFN's elementwise gate
left out (%).  None where the step's cost has no Kron FFN or the window
no such kernel."""
from perfbench import spans

FFN = "kronscope.ffn"


def read(run):
    tr = run.trace
    kron = getattr(run.cost, "kron", None)
    if tr is None or tr.steps == 0 or kron is None or kron.bytes == 0:
        return None
    lo, hi = tr.window.start, tr.window.end
    busy = sum(min(k.end, hi) - max(k.start, lo) for k in tr.kernels()
               if tr.launched_in(k, (FFN,)) and tr.launched_in(k, (spans.OP,)))
    if busy <= 0:
        return None
    return kron.roofline_s / (busy / tr.steps) * 100
