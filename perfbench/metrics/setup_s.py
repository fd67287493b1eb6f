"""``setup_s``: seconds from the process's start to the first timed step:
imports, the CUDA context, the inputs, the kernels' build where the
checkout has none, and the warm-up steps."""


def read(run):
    return run.setup_s
