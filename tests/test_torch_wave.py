"""The port's wave backend (device="cpu": the plain versions of K1 and K2)
against the reference wave backend with its Pallas kernels in interpret
mode and with the XLA twin, on grids of lexicographic requests: every
request's status, objective vector and IP count must be exactly equal."""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem as ref_read_problem
from moip_aira_tpu.solver.wave import WaveLexBackend as RefWave
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver.cuda_bb import CudaBBBatch
from moip_aira_tpu_torch.solver.cuda_lp import CudaLPBatch, CudaRevBatch
from moip_aira_tpu_torch.solver.lex import LexRequest
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


#: the port's engine held against each reference engine: its shape choice
#: ("auto", which is K1 at these widths) against the dense Pallas kernel and
#: the XLA twin, the port's XLA engine against the XLA twin, and K2 against
#: the revised Pallas kernel, both warm
ENGINE_PAIRS = [("pallas", "auto"), ("xla", "auto"), ("xla", "xla"), ("pallas_rev", "revised")]


@pytest.mark.parametrize("name", ["G2AP05", "G3KP10"])
@pytest.mark.parametrize(
    "ref_engine,port_engine", ENGINE_PAIRS, ids=["pallas", "xla", "xla-xla", "pallas_rev"]
)
def test_lex_outcomes_match_reference(name, ref_engine, port_engine):
    path = os.path.join(EX, f"{name}.lp")
    reqs = GRIDS[name]()
    port = WaveLexBackend(
        read_problem(path), device="cpu", batch_width=64, engine=port_engine,
    )
    ref = RefWave(
        ref_read_problem(path), engine=ref_engine, fragments=False, batch_width=64
    )
    assert port.warm_start == ref.warm_start == (ref_engine == "pallas_rev")
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
    """The LP engine is chosen by the LP's shape and nothing else; the
    device alone picks the kernel or its plain version: on the CPU the
    wrapper runs the plain version and counts no launch.  ``fragments``
    takes True (K3's wrapper, solver/cuda_bb.py), False and "auto", which
    is off on the CPU."""
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    be = WaveLexBackend(p, device="cpu")
    assert be.engine == "dense" and type(be.lp_kernel) is CudaLPBatch
    assert not be.warm_start
    assert be.lp_kernel.device == torch.device("cpu")
    assert be.name == "wave" and be.supports_feeder and be.batch_width == 256
    be.lex_solve_batch(g2ap05_grid()[:2])
    assert be.device_waves > 0 and be.lp_kernel.launches == 0
    for frag, on in ((True, True), ("auto", False), (False, False)):
        fb = WaveLexBackend(p, device="cpu", fragments=frag)
        assert fb.fragments is on
        assert (fb.frag_kernel is not None) == on
        if on:
            assert type(fb.frag_kernel) is CudaBBBatch and fb.frag_kernel.F == 32
    with pytest.raises(ValueError, match="engine"):
        WaveLexBackend(p, device="cpu", engine="torch")


@pytest.mark.parametrize(
    "name,engine,kernel",
    [("2AP20", "dense", CudaLPBatch), ("2AP40", "revised", CudaRevBatch)],
)
def test_auto_engine_follows_the_reference_threshold(name, engine, kernel):
    """n + m >= 512 takes K2 with warm starts (2AP40: 1,600 + 82 columns),
    below it K1 cold (2AP20: 400 + 42), as the reference's wave chooses
    between its Pallas kernels.  Built only, not solved."""
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    be = WaveLexBackend(p, device="cpu")
    assert (p.n + p.m_total >= 512) == (engine == "revised")
    assert be.engine == engine and type(be.lp_kernel) is kernel
    assert be.warm_start == (engine == "revised")
    # K2's pivots stop on their own per lane, so it gets the higher cap
    assert be.lp_kernel.max_iters == {"dense": 2000, "revised": 6000}[engine]
    assert WaveLexBackend(p, device="cpu", warm_start=False).warm_start is False
