"""``kronffn.train_roofline``: the Kron FFNs' own roofline time in a
training step (``cost_lm_train.py``: each Kron projection's forward, input
gradient and factor gradients as ``cost.kron_train_step`` at M = the
step's tokens) over the device time per traced step of the kernels
launched inside a ``kronscope.op`` or ``kronscope.op_bwd`` range and, in
it, inside one of the Kron-Matmul executor's (``kronscope.program``,
``.stage``, ``.stage_grad``), on either thread: every Kron projection's
forward, remat's second forward and backward (%).  The executor's ranges
leave out what else runs in an ``op_bwd``: the backward's first read of a
checkpointed layer's saved tensors there runs the whole layer's second
forward (attention, norms) before the Kron backward.  None where the
step's cost is not a training step's or the window holds no such
kernel."""
from perfbench import cost_lm_train, spans


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or not isinstance(run.cost, cost_lm_train.TrainCost):
        return None
    lo, hi = tr.window.start, tr.window.end
    busy = sum(min(k.end, hi) - max(k.start, lo) for k in tr.kernels()
               if tr.launched_in(k, (spans.OP, spans.OP_BWD))
               and tr.launched_in(k, spans.EXECUTOR))
    if busy <= 0:
        return None
    return run.cost.kron.roofline_s / (busy / tr.steps) * 100
