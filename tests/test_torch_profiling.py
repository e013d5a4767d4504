"""The port's stage profiler (``utils/profiling.py``) and the solvers'
``_profile_phases``: twins of tests/test_profiling.py:47-74.

For the four solvers (and the decoupled solver's Krylov force path):
chaining the phases for 3 steps equals 3 production steps bit for bit on
the CPU; the phase names are the JAX package's; ``profile_stages`` leaves
the solver's state alone and writes the JAX package's table;
``--profile-stages 2`` through the Navier-Stokes CLI prints and writes
it.
"""

import numpy as np
import pytest
import torch

from petibm_tpu.solvers.decoupledibpm import DecoupledIBPMSolver as JaxDec
from petibm_tpu.solvers.ibpm import IBPMSolver as JaxIBPM
from petibm_tpu.solvers.navierstokes import NavierStokesSolver as JaxNS
from petibm_tpu.solvers.rigidkinematics import RigidKinematicsSolver as JaxRK
from petibm_tpu_torch.cli import navierstokes as tcli
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.ibpm import IBPMSolver
from petibm_tpu_torch.solvers.navierstokes import NavierStokesSolver
from petibm_tpu_torch.solvers.rigidkinematics import RigidKinematicsSolver
from petibm_tpu_torch.utils.profiling import chain_phases
from test_ibm import ib_config
from test_navierstokes import run_config

torch.set_num_threads(2)


def _moving(tmp_path, nt):
    cfg = ib_config(tmp_path, nt=nt)
    cfg["bodies"][0]["kinematics"] = {
        "type": "oscillation", "f": 0.2, "D": 0.4, "KC": 2.0}
    return cfg


def _krylov(tmp_path, nt):
    cfg = ib_config(tmp_path, nt=nt)
    cfg["parameters"]["deltaEngine"] = "windowed"
    return cfg


#: name -> (config maker, port class, JAX class)
SOLVERS = {
    "navierstokes": (run_config, NavierStokesSolver, JaxNS),
    "decoupledibpm": (ib_config, DecoupledIBPMSolver, JaxDec),
    "decoupledibpm_windowed": (_krylov, DecoupledIBPMSolver, JaxDec),
    "ibpm": (ib_config, IBPMSolver, JaxIBPM),
    "rigidkinematics": (_moving, RigidKinematicsSolver, JaxRK),
}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _make(name, tmp_path, cls=None, nt=3):
    make, port_cls, _ = SOLVERS[name]
    d = tmp_path / (name if cls is None else f"{name}_jax")
    d.mkdir()
    cfg = make(d, nt=nt)
    return (port_cls(cfg, device="cpu") if cls is None else cls(cfg))


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_phases_match_step(name, tmp_path):
    solver = _make(name, tmp_path)
    phases = solver._profile_phases()
    chained = fused = solver.state
    for _ in range(3):
        chained = chain_phases(phases, chained)["state"]
        fused, _ = solver._step_fn(fused)
    a, b = _leaves(chained), _leaves(fused)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    solver.close()


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_phase_names_match_jax(name, tmp_path):
    port = _make(name, tmp_path)
    jsolver = _make(name, tmp_path, cls=SOLVERS[name][2])
    assert ([n for n, _ in port._profile_phases()]
            == [n for n, _ in jsolver._profile_phases()])
    port.close()
    jsolver.close()


@pytest.mark.parametrize("name", ["navierstokes", "decoupledibpm"])
def test_profile_stages_writes_table(name, tmp_path):
    solver = _make(name, tmp_path)
    before = [x.clone() for x in _leaves(solver.state)]
    result = solver.profile_stages(steps=3, warmup=1)
    names = [n for n, _ in solver._profile_phases()]
    assert list(result) == names + ["_total", "_fused"]
    assert all(np.isfinite(v) and v >= 0.0 for v in result.values())
    assert result["_total"] == pytest.approx(sum(result[n] for n in names))
    for x, y in zip(_leaves(solver.state), before):
        assert torch.equal(x, y)  # the solver's state is left as it was
    path = tmp_path / name / "output" / "logs" / "stages-0.txt"
    lines = path.read_text().splitlines()
    assert lines[0].startswith("stage breakdown")
    assert lines[1].split() == ["stage", "ms/step", "%"]
    assert [ln.split()[0] for ln in lines[2:2 + len(names)]] == names
    assert lines[-2].split()[:2] == ["total", "(phases)"]
    assert lines[-1].split()[:2] == ["fused", "step"]
    solver.close()


def test_profile_stages_cli(tmp_path, capsys):
    """``--profile-stages 2`` after a 2-step cavity run on the CPU."""
    import yaml

    cfg = run_config(tmp_path, nt=2, nsave=2, nrestart=2)
    body = {k: cfg[k] for k in ("mesh", "flow", "parameters")}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(body))
    assert tcli.main(["-directory", str(tmp_path), "-device", "cpu",
                      "--profile-stages", "2"]) == 0
    out = capsys.readouterr().out
    for name in ("rhsVelocity", "solveVelocity", "rhsPoisson",
                 "solvePoisson", "update", "_total", "_fused"):
        assert f"{name}:" in out
    assert (tmp_path / "output" / "logs" / "stages-2.txt").is_file()
