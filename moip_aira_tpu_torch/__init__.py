"""moip_aira_tpu_torch — the PyTorch and CUDA port of moip_aira_tpu.

The exact multi-objective integer programming engine of ``moip_aira_tpu``
(the AIRA algorithm with its synergistic and EPP decompositions) with the
device side rebuilt for an NVIDIA GPU: batched LP relaxations run in
hand-written CUDA kernels on the card (``csrc/dense_simplex.cu``, the dense
tableau, and ``csrc/revised_simplex.cu``, the revised simplex), or in their
plain PyTorch versions on the CPU.  The host engines (readers, writer,
scheduler, workers, the numpy oracle, the combinatorial engines) are the
package's own copies of ``moip_aira_tpu``'s pure-numpy modules.  This
package imports ``torch``, never ``jax`` and nothing of ``moip_aira_tpu``.
"""

__version__ = "0.1.0"

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense

__all__ = ["Sense", "INF", "Problem", "__version__"]
