"""Extension-dispatched problem reading (reference: src/problem.cpp:15-26)."""

from __future__ import annotations

from moip_aira_tpu_torch.problem import Problem


def read_problem(filename: str) -> Problem:
    low = filename.lower()
    if low.endswith(".lp"):
        from moip_aira_tpu_torch.io.lp_reader import read_lp

        return read_lp(filename)
    if low.endswith(".mop") or low.endswith(".mps"):
        from moip_aira_tpu_torch.io.mop_reader import read_mop

        return read_mop(filename)
    raise ValueError(
        f"unrecognised problem file type: {filename!r} (expected .lp or .mop)"
    )
