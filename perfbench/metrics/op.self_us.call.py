"""``op.self_us.call``: the self time of the program's ``kronscope.op`` ranges
per traced call (us): ``KronOp.__call__``'s checks, plan memo, autograd entry
and forward ladder, outside the executor's and the launches' ranges.  With
``executor.self_us.call`` and ``launch.host_us.call`` it sums to the op
ranges' duration (``spans.py``)."""
from perfbench import spans


def read(run):
    return spans.self_us_per_step(run, (spans.OP,))
