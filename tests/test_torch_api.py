"""The port's front driver and CLI on the CPU: the bundled golden fronts,
the reference CLI's .out, a run with jax and the JAX package made
unimportable, and the port's imports read from its source."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from moip_aira_tpu.cli import main as ref_main
from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.cli import main as port_main
from moip_aira_tpu_torch.io import read_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")


def bundled_front(name):
    """The golden front, parsed as tests/test_bundled_examples.py does."""
    rows = []
    with open(f"{EX}/{name}.out") as fh:
        for line in fh:
            parts = line.split()
            if parts and all(p.lstrip("-").isdigit() for p in parts):
                rows.append([int(p) for p in parts])
    return np.array(rows)


def filtered(path):
    """An .out file as the golden contract binds it (the verify recipe's
    filter): whitespace-insensitive, without timing/IP-count/banner lines."""
    with open(path) as fh:
        return [
            line.split()
            for line in fh
            if not any(k in line for k in ("seconds", "solved", "Using"))
        ]


@pytest.mark.parametrize(
    "name,cfg",
    [
        ("G2AP05", dict(n_workers=2)),  # k=2: the bound sweep
        ("G3AP05", dict(n_workers=2)),  # k=3: the AIRA scheduler
        ("G3KP10", dict(n_workers=2)),
        ("G2AP05", dict(n_workers=2, split=True)),  # EPP strips
    ],
    ids=["G2AP05", "G3AP05", "G3KP10", "G2AP05-split"],
)
def test_wave_front_matches_golden(name, cfg):
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    front = solve_front(p, backend="wave", device="cpu", **cfg)
    expect = bundled_front(name)
    assert front.points.shape == expect.shape
    assert (front.points == expect).all()
    stats = front.backend_stats
    assert stats["backend"] == "wave" and stats["device_waves"] > 0
    assert stats["kernel_launches"] == 0  # the CPU runs the plain version


def test_cli_out_matches_reference_cli(tmp_path):
    ex = os.path.join(EX, "G3AP05.lp")
    ours, theirs = tmp_path / "port.out", tmp_path / "ref.out"
    assert port_main(["-p", ex, "-o", str(ours), "--backend", "wave",
                      "--device", "cpu", "-t", "2"]) == 0
    assert ref_main(["-p", ex, "-o", str(theirs), "--backend", "wave",
                     "-t", "2"]) == 0
    assert filtered(ours) == filtered(theirs)
    assert filtered(ours) == filtered(os.path.join(EX, "G3AP05.out"))


#: (instance, backend) the jax-free run solves: the wave on the bound sweep,
#: auto, which routes G3AP05 to ap_bb and G3KP10 to kp_bb (both k = 3, so
#: through the AIRA scheduler), the wave's fragment path on G3AP05, the
#: knapsack front DP (dp="on") on G2KP50, the lex backend ("jax") on
#: G3AP05, and the mesh scheduler (6 workers, the wave, mesh_devices=8) on
#: G3AP05
NO_JAX_RUNS = (
    ("G2AP05", "wave"), ("G3AP05", "auto"), ("G3KP10", "auto"),
    ("G3AP05", "fragments"), ("G2KP50", "dp"), ("G3AP05", "jax"),
    ("G3AP05", "mesh"),
)


def test_port_runs_without_jax():
    """With ``jax`` and ``moip_aira_tpu`` both unimportable, the port
    reproduces the goldens on every route it has: the wave backend and its
    fragment path, the AIRA scheduler, the ap_bb and kp_bb engines, the
    knapsack front DP, the lex backend and the mesh scheduler."""
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['moip_aira_tpu'] = None\n"
        "from moip_aira_tpu_torch.api import solve_front\n"
        "from moip_aira_tpu_torch.io import read_problem\n"
        "from moip_aira_tpu_torch.solver.wave import WaveLexBackend\n"
        "out = {}\n"
        f"for name, backend in {NO_JAX_RUNS!r}:\n"
        f"    p = read_problem({EX!r} + '/' + name + '.lp')\n"
        "    be, dp, kw = backend, 'auto', {}\n"
        "    if backend == 'fragments':\n"
        "        be = WaveLexBackend(p, device='cpu', fragments=True, batch_width=8)\n"
        "    if backend == 'dp':\n"
        "        be, dp = 'auto', 'on'\n"
        "    if backend == 'mesh':\n"
        "        be, kw = 'wave', dict(n_workers=6, mesh_devices=8)\n"
        "    f = solve_front(p, backend=be, device='cpu', dp=dp, **kw)\n"
        "    out[name + '/' + backend] = [\n"
        "        f.backend_stats['backend'], f.backend_stats.get('kernel'),\n"
        "        f.points.tolist()]\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {k: v[:2] for k, v in got.items()} == {
        "G2AP05/wave": ["wave", "dense_simplex"],
        "G3AP05/auto": ["apbb", None],
        "G3KP10/auto": ["kpbb", None],
        "G3AP05/fragments": ["wave", "bb_fragment"],
        "G2KP50/dp": ["kp_front", "kp_dp"],
        "G3AP05/jax": ["jax", None],
        "G3AP05/mesh": ["wave", "dense_simplex"],
    }
    for name, backend in NO_JAX_RUNS:
        pts = np.array(got[name + "/" + backend][2])
        assert (pts == bundled_front(name)).all(), (name, backend)


def imported_modules(path):
    """Every module an ``import`` or ``from`` statement in ``path`` names."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_imports_nothing_of_the_jax_package():
    """No file of the port, and not chip_smoke.py, imports moip_aira_tpu or
    a module under it: the port owns copies of what it runs."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "moip_aira_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    assert os.path.join(REPO, "moip_aira_tpu_torch", "solver", "cuda_lex.py") in files
    for path in files:
        bad = sorted(
            n for n in imported_modules(path)
            if n == "moip_aira_tpu" or n.startswith("moip_aira_tpu.")
            or n in ("jax", "jaxlib") or n.startswith("jax.")
        )
        assert not bad, (os.path.relpath(path, REPO), bad)


def test_unported_paths_raise(tmp_path):
    """The paths that raised while the port lacked them now run and give
    the golden front: ``backend="jax"`` (the lex backend), ``mesh_devices``
    (the mesh scheduler) and the CLI's ``--backend jax`` and ``--mesh``."""
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    want = bundled_front("G2AP05")
    # dp="on" on a problem the knapsack DP does not detect takes the AIRA
    # engine
    front = solve_front(p, backend="wave", device="cpu", dp="on")
    assert front.backend_stats["backend"] == "wave" and front.ip_count > 0
    assert (front.points == want).all()
    mesh = solve_front(p, backend="wave", device="cpu", mesh_devices=2)
    assert (mesh.points == want).all()
    assert mesh.domain_ips and mesh.backend_stats["mesh"]["shape"] == {
        "workers": 1, "strips": 1,
    }
    lex = solve_front(p, backend="jax", device="cpu")
    assert lex.backend_stats["backend"] == "jax" and (lex.points == want).all()
    ex = os.path.join(EX, "G2AP05.lp")
    for flags in (["--backend", "jax"], ["--backend", "wave", "--mesh", "2", "-t", "2"]):
        out = tmp_path / "x.out"
        assert port_main(["-p", ex, "-o", str(out), "--device", "cpu"] + flags) == 0
        assert filtered(out) == filtered(os.path.join(EX, "G2AP05.out"))
        out.unlink()


def test_chip_smoke_imports_only_the_port():
    """The smoke drives the port alone: no import of jax or of the JAX
    package, only torch, the standard library and moip_aira_tpu_torch."""
    names = imported_modules(os.path.join(REPO, "chip_smoke.py"))
    tops = {n.split(".")[0] for n in names}
    assert "moip_aira_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "moip_aira_tpu"}, sorted(names)


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke exits non-zero and prints no result line."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the smoke would run")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
