"""``gp.cg_iter_self_us``: the self time of the program's ``kronscope.cg_iter``
ranges per CG iteration (us): the host work of an iteration's dot products
and vector updates, outside the MVM's ``kronscope.op`` range (``spans.py``)."""
from perfbench import spans


def read(run):
    return spans.self_us_per_range(run, spans.CG_ITER)
