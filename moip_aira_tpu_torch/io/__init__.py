"""Problem readers/writers (reference: src/problem.cpp file-type dispatch)."""

from moip_aira_tpu_torch.io.reader import read_problem

__all__ = ["read_problem"]
