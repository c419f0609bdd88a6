"""Deciding ``correct``: every front the window produced, against the plain
reference's front of the same instance.

The guarantee is the exact nondominated set: every point, every objective
value, no point missing, none extra.  So the comparison is exact, and each
number it gives has the limit 0."""

from __future__ import annotations

import numpy as np

#: the numbers compared, each with its limit
LIMITS = {
    # points in one front and not the other, over all fronts
    "points_wrong": 0,
    # fronts whose program output is not a set of whole numbers
    "fronts_not_integral": 0,
    # fronts that raised instead of returning
    "fronts_failed": 0,
}


def as_points(points) -> set:
    return {tuple(int(v) for v in row) for row in np.asarray(points)}


def integral(points) -> bool:
    P = np.asarray(points, dtype=np.float64)
    return bool(np.all(np.isfinite(P)) and np.all(P == np.rint(P)))


def compare(fronts, reference_fronts) -> tuple:
    """``fronts``: [(instance index, points, or None for a front that
    raised)]; ``reference_fronts``: {instance index: points}.  Returns the
    compared numbers, each {"value", "limit"}, and how many fronts are
    wrong."""
    wrong_points = not_integral = failed = wrong_fronts = 0
    for idx, points in fronts:
        if points is None:
            failed += 1
        elif not integral(points):
            not_integral += 1
        else:
            miss = len(as_points(points) ^ as_points(reference_fronts[idx]))
            wrong_points += miss
            wrong_fronts += miss > 0
            continue
        wrong_fronts += 1
    values = {"points_wrong": wrong_points, "fronts_not_integral": not_integral,
              "fronts_failed": failed}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}, wrong_fronts


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
