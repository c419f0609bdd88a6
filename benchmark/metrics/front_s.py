"""Seconds a front: the window's wall seconds over the fronts completed in
it (the whole window over all its fronts)."""

UNIT, LAYER, MOVES = "s", None, None


def read(run):
    done = sum(1 for f in run.fronts if f.points is not None)
    return run.window_s / done if done else None
