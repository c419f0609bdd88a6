"""Set-up seconds: from the start of ``run.py`` to the first timed front
(imports, CUDA start-up, loading the kernels, writing the instance set, the
warm front)."""

UNIT, LAYER, MOVES = "s", None, None


def read(run):
    return run.setup_s
