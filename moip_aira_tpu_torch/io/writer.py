"""Output-file writer matching the reference format byte-for-byte.

Reference parity: src/aira.cpp:252 (banner) and aira.cpp:326-358 (solution
rows + footer).  The test oracle (scripts/checkResults.sh:10) diffs outputs
whitespace-insensitively while ignoring lines containing ``seconds``,
``solved`` or ``Using`` — so the solution rows and the final
``N Solutions found`` line are the binding contract.
"""

from __future__ import annotations

from typing import TextIO

import numpy as np

from moip_aira_tpu_torch.api import FrontResult


def write_out(fh: TextIO, front: FrontResult, version_tag: str) -> None:
    fh.write("\n")
    fh.write(f"Using improved algorithm at {version_tag}\n")
    for row in front.points:
        for v in row:
            fh.write(f"{int(v)}\t")
        fh.write("\n")
    fh.write("\n---\n")
    fh.write(f"{front.cpu_seconds:8.3f} CPU seconds\n")
    fh.write(f"{front.elapsed_seconds:8.3f} elapsed seconds\n")
    fh.write(f"{front.ip_count:8d} IPs solved\n")
    fh.write(f"{front.solution_count:8d} Solutions found\n")
