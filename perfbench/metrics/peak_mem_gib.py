"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start, in GiB: the inputs and every buffer live then count."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
