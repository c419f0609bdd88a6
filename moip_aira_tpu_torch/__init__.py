"""moip_aira_tpu_torch — the PyTorch and CUDA port of moip_aira_tpu.

The exact multi-objective integer programming engine of ``moip_aira_tpu``
(the AIRA algorithm with its synergistic and EPP decompositions) with the
device side rebuilt for an NVIDIA GPU: batched LP relaxations run in a
hand-written CUDA kernel (``csrc/dense_simplex.cu``) on the card, or in its
plain PyTorch version on the CPU.  The host engines that never touched JAX
(readers, scheduler, workers, the numpy oracle, the combinatorial engines)
are imported from ``moip_aira_tpu`` as they are.  This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense

__all__ = ["Sense", "INF", "Problem", "__version__"]
