"""``step_ms``: the window's wall time over the steps it completed (ms).

From the first step's issue to the end of the synchronisation that closes
the window, on the host clock: every step's work and every gap between."""


def read(run):
    return run.window.seconds / run.window.steps * 1e3
