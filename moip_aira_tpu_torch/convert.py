"""From the reference's numpy ``Problem`` to the port's LP tensors.

Builds exactly what the reference wave backend builds
(``moip_aira_tpu/solver/wave.py:205-219``): the full row matrix
``A_full = [A; C]`` (structural rows, then one objective-bound row per
objective), the f64 system ``W = [A_full | -I]`` that certification reads,
the row scale ``s = 1 / max|row|`` and the row-equilibrated device system
``[diag(s) A_full | -I]``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from moip_aira_tpu.problem import Problem


class LPTensors(NamedTuple):
    A_full: np.ndarray  # (m, n) f64 [A; C]
    W_np: np.ndarray  # (m, n + m) f64 [A_full | -I], for certification
    row_scale: np.ndarray  # (m,) f64 1 / max|row|
    W_dev: torch.Tensor  # (m, n + m) [diag(s) A_full | -I] on the device


def lp_tensors(
    problem: Problem, device: torch.device, dtype: torch.dtype = torch.float32
) -> LPTensors:
    A_full = np.vstack([problem.A, problem.C])
    m = A_full.shape[0]
    W_np = np.hstack([A_full, -np.eye(m)])
    row_scale = 1.0 / np.maximum(np.abs(A_full).max(axis=1), 1e-12)
    W_sc = np.hstack([A_full * row_scale[:, None], -np.eye(m)])
    W_dev = torch.as_tensor(W_sc, dtype=dtype).to(device).contiguous()
    return LPTensors(A_full, W_np, row_scale, W_dev)
