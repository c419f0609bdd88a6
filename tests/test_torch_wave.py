"""The port's wave backend (device="cpu": the plain K1) against the
reference wave backend with the Pallas kernel in interpret mode and with
the XLA twin, on grids of lexicographic requests: every request's status,
objective vector and IP count must be exactly equal."""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.solver.lex import LexRequest
from moip_aira_tpu.solver.wave import WaveLexBackend as RefWave
from moip_aira_tpu_torch.solver.cuda_lp import CudaLPBatch
from moip_aira_tpu_torch.solver.wave import WaveLexBackend

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def g2ap05_grid():
    """Both objective orderings over a grid of objective-bound boxes, as
    bench.py:48-55 builds its workload, cut to the bundled front's range."""
    reqs = []
    for perm in ([0, 1], [1, 0]):
        for b1 in (24, 29, 35, 41, 50):
            for b0 in (np.inf, 42, 27):
                rhs = np.array([float(b0), float(b1)])
                if perm == [1, 0]:
                    rhs = rhs[::-1]
                reqs.append(LexRequest(rhs=rhs, perm=perm))
    return reqs


def g3kp10_grid():
    """Three orderings of the 3-objective knapsack (MAX) under lower caps."""
    reqs = []
    for perm in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        for b in (-np.inf, 380.0, 400.0, 420.0):
            reqs.append(LexRequest(rhs=np.array([b, -np.inf, b - 20.0]), perm=perm))
    return reqs


GRIDS = {"G2AP05": g2ap05_grid, "G3KP10": g3kp10_grid}


def outcomes(be, reqs):
    return [
        (int(o.status), None if o.result is None else tuple(int(v) for v in o.result),
         o.ip_solves)
        for o in be.lex_solve_batch(reqs)
    ]


@pytest.mark.parametrize("name", ["G2AP05", "G3KP10"])
@pytest.mark.parametrize("ref_engine", ["pallas", "xla"])
def test_lex_outcomes_match_reference(name, ref_engine):
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    reqs = GRIDS[name]()
    port = WaveLexBackend(p, device="cpu", batch_width=64)
    ref = RefWave(p, engine=ref_engine, fragments=False, batch_width=64)
    got = outcomes(port, reqs)
    want = outcomes(ref, reqs)
    assert got == want
    assert port.device_waves > 0 and port.lp_count >= port.device_waves
    assert {o[0] for o in got} == {0, 1}  # feasible and infeasible requests


def test_warm_start_on_gives_the_same_outcomes():
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    reqs = g2ap05_grid()
    cold = WaveLexBackend(p, device="cpu", batch_width=64)
    warm = WaveLexBackend(p, device="cpu", batch_width=64, warm_start=True)
    assert not cold.warm_start and warm.warm_start
    assert outcomes(warm, reqs) == outcomes(cold, reqs)


def test_feeder_streams_requests():
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    reqs = g2ap05_grid()
    be = WaveLexBackend(p, device="cpu", batch_width=64)
    fed = []

    def feeder(ri, out):
        fed.append(ri)
        return [reqs[len(fed)]] if len(fed) < 4 else []

    outs = be.lex_solve_batch(reqs[:1], feeder=feeder)
    assert len(outs) == 4 and sorted(fed) == [0, 1, 2, 3]
    ref = outcomes(WaveLexBackend(p, device="cpu", batch_width=64), reqs[:4])
    assert [(int(o.status), None if o.result is None else tuple(int(v) for v in o.result),
             o.ip_solves) for o in outs] == ref


def test_engine_and_fragments_choices():
    """One LP engine, K1, chosen by nothing but the device: on the CPU its
    wrapper runs the plain version and counts no launch."""
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    be = WaveLexBackend(p, device="cpu")
    assert isinstance(be.lp_kernel, CudaLPBatch)
    assert be.lp_kernel.device == torch.device("cpu")
    assert be.name == "wave" and be.supports_feeder and be.batch_width == 256
    be.lex_solve_batch(g2ap05_grid()[:2])
    assert be.device_waves > 0 and be.lp_kernel.launches == 0
    for frag in (True, "auto"):
        with pytest.raises(NotImplementedError, match="K3"):
            WaveLexBackend(p, device="cpu", fragments=frag)
    with pytest.raises(TypeError):
        WaveLexBackend(p, device="cpu", engine="torch")
