"""``gp.cg_device_ms``: device time per traced epoch of the operations
launched outside the program's Kron-Matmul ranges (``kronscope.program``
and ``kronscope.stage``): CG's vector updates, its dot products and the
noise term (ms).

An operation is placed by the launch the profiler joins to it.  One that
has no joined launch is placed by name: the port's kernels are the
Kron-Matmul's, anything else CG's."""

RANGES = ("kronscope.program", "kronscope.stage")
KRON_KERNELS = ("chain_fwd_kernel", "chain_bwd_kernel", "grad_kernel", "grad_mma_kernel",
                "grad_reduce_kernel", "sliced_kernel", "sliced_t_kernel")


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    ops = tr.device_ops()
    if not ops:
        return None
    lo, hi = tr.window.start, tr.window.end
    total = 0.0
    for op in ops:
        inside = tr.launched_in(op, RANGES)
        if inside is None:
            inside = any(k in op.name for k in KRON_KERNELS)
        if not inside:
            total += min(op.end, hi) - max(op.start, lo)
    return total / tr.steps * 1e3
