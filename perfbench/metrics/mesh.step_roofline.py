"""``mesh.step_roofline``: one card's least time for a step over the traced
step time (the traced window over its steps), in %.  The least time is
``cost_mesh.MeshCost.step_roofline_s``: the larger of the card's local
chains at the roofline (``cost.py``'s peaks) and its share of the
all-to-alls at the link's data-sheet rate.  None for a step whose cost
counts no exchange."""


def read(run):
    tr = run.trace
    bound = getattr(run.cost, "step_roofline_s", None)
    if tr is None or tr.steps == 0 or tr.busy_s <= 0 or bound is None:
        return None
    return bound / (tr.window_s / tr.steps) * 100
