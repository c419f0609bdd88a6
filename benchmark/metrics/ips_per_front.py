"""IPs a front: ``FrontResult.ip_count`` summed over the window's fronts,
over the fronts (a count that repeats exactly)."""

UNIT, LAYER, MOVES = "IP", "AIRA scheduler", "front_s"


def read(run):
    fronts = [f for f in run.fronts if f.points is not None]
    return sum(f.ips for f in fronts) / len(fronts) if fronts else None
