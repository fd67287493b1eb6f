"""``op.self_us``: the self time of the program's ``kronscope.op`` and
``kronscope.op_bwd`` ranges per traced training step (us): the forward's
checks, plan memo, autograd entry and ladder, and the backward's entry
(``_program_bwd``'s set-up, the casts) on the autograd engine's thread,
outside the executor's and the launches' ranges (``spans.py``)."""
from perfbench import spans


def read(run):
    return spans.self_us_per_step(run, (spans.OP, spans.OP_BWD))
