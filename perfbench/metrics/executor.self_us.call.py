"""``executor.self_us.call``: the self time of the program's
``kronscope.program``, ``.stage`` and ``.stage_grad`` ranges per traced call
(us): the executor's checks, geometry and output allocation, outside the
launches' ranges (``spans.py``)."""
from perfbench import spans


def read(run):
    return spans.self_us_per_step(run, spans.EXECUTOR)
