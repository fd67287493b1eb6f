"""``launch.host_us.call``: the self time of the program's ``kronscope.launch``
ranges per traced call (us), which is their duration, as no range nests in
one: each launcher's occupancy lookup, marshalling and the library's host
work, from the occupancy query to the launch's status check (``spans.py``)."""
from perfbench import spans


def read(run):
    return spans.self_us_per_step(run, (spans.LAUNCH,))
