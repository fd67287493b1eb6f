"""``gp.cg_kernels_per_epoch``: device kernels per traced epoch launched inside
the program's ``kronscope.cg`` range and outside its Kron-Matmul ranges
(``kronscope.program`` and ``kronscope.stage``): CG's vector work as a count.

A kernel is placed by the launch the profiler joins to it.  One that has no
joined launch is placed by name, as ``gp.cg_device_ms`` places it: the port's
kernels are the Kron-Matmul's, anything else CG's.  None where the window
holds no ``kronscope.cg`` range or no kernel."""
from pathlib import Path

from perfbench import spans
from perfbench.harness import load_module

_cg = load_module(Path(__file__).with_name("gp.cg_device_ms.py"), "metric")


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0 or not spans.ranges(tr, (spans.CG,)):
        return None
    kernels = tr.kernels()
    if not kernels:
        return None
    n = 0
    for k in kernels:
        kron = tr.launched_in(k, _cg.RANGES)
        if kron is None:
            n += not any(name in k.name for name in _cg.KRON_KERNELS)
        elif not kron and tr.launched_in(k, (spans.CG,)):
            n += 1
    return n / tr.steps
