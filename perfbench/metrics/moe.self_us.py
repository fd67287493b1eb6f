"""``moe.self_us``: the self time of the program's ``kronscope.moe``,
``.moe_route`` and ``.moe_experts`` ranges per traced step (us): the MoE
block's own host work (routing, dispatch, the expert einsums' launches,
the combine, the aux loss), outside the shared experts' ``kronscope.ffn``
(``spans.py``).  None where the window holds no ``kronscope.moe`` range."""
from perfbench import spans

NAMES = ("kronscope.moe", "kronscope.moe_route", "kronscope.moe_experts")


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or not spans.ranges(tr, NAMES[:1]):
        return None
    selfs = spans.self_seconds(tr)
    return sum(selfs.get(n, 0.0) for n in NAMES) / tr.steps * 1e6
