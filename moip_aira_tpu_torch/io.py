"""Problem readers and the `.out` writer of the port.

The readers (LP and MOP formats) and the byte-equal writer are pure numpy;
the port uses ``moip_aira_tpu.io``'s as they are and names them here, so
code that drives the port imports only ``moip_aira_tpu_torch``."""

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.io.writer import write_out

__all__ = ["read_problem", "write_out"]
