"""The port's LP tensors equal what the reference wave backend builds, and
the device helper never picks a device on its own."""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.solver.wave import WaveLexBackend as RefWave
from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.device import resolve_device

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.mark.parametrize(
    "name", ["G2AP05.lp", "G3KP10.lp", "KP2D50.lp", "moip_2_30_knapsack.mop"]
)
def test_lp_tensors_match_reference_backend(name):
    p = read_problem(os.path.join(EX, name))
    ref = RefWave(p, engine="xla", fragments=False)
    t = lp_tensors(p, torch.device("cpu"))
    np.testing.assert_array_equal(t.A_full, ref._A_full)
    np.testing.assert_array_equal(t.row_scale, ref._row_scale)
    m = ref._A_full.shape[0]
    np.testing.assert_array_equal(t.W_np, np.hstack([ref._A_full, -np.eye(m)]))
    # the kernel's matrix, built as wave.py:219 and cast as wave.py:237
    W_dev = np.hstack([ref._A_full * ref._row_scale[:, None], -np.eye(m)])
    assert t.W_dev.dtype == torch.float32 and t.W_dev.is_contiguous()
    np.testing.assert_array_equal(t.W_dev.numpy(), W_dev.astype(np.float32))
    t64 = lp_tensors(p, torch.device("cpu"), dtype=torch.float64)
    np.testing.assert_array_equal(t64.W_dev.numpy(), W_dev)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
