"""Lanes a K6 launch: the lex backend's ``lanes`` over K6's launches
(``kernel_launches``)."""

UNIT, LAYER, MOVES = "lanes", "lex backend", "front_s"


def read(run):
    launches = run.total("kernel_launches")
    return run.total("lanes") / launches if launches else None
