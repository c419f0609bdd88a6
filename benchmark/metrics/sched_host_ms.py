"""Host milliseconds a front outside the backend: each front's wall time
(reading the LP, building the backend, ``solve_front``) less the time inside
its ``lex_solve_batch`` calls, over the fronts."""

UNIT, LAYER, MOVES = "ms", "AIRA scheduler", "front_s"


def read(run):
    fronts = [f for f in run.fronts if f.points is not None]
    if not fronts:
        return None
    return 1e3 * sum(f.wall_s - f.lex_s for f in fronts) / len(fronts)
