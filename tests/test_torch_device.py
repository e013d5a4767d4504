"""The port's entry points run on the card unless asked for the CPU.

Without a card (``torch.cuda.is_available`` patched to False):
(a) ``NavierStokesSolver`` and ``DecoupledIBPMSolver`` built without a
    device raise and say how to ask for the CPU;
(b) both CLIs without ``-device`` exit non-zero with that message;
(c) ``device="cpu"`` and ``-device cpu`` are taken, and a solver asked for
    the CPU runs.
"""

import os

import pytest
import torch

from chip_smoke import small_config
from petibm_tpu_torch.cli import decoupledibpm as cli_dibpm
from petibm_tpu_torch.cli import navierstokes as cli_ns
from petibm_tpu_torch.cli.common import parse_args
from petibm_tpu_torch.solvers.decoupledibpm import DecoupledIBPMSolver
from petibm_tpu_torch.solvers.navierstokes import (NavierStokesSolver,
                                                   resolve_device)

torch.set_num_threads(2)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("cls", [NavierStokesSolver, DecoupledIBPMSolver])
def test_solver_without_a_card_raises(tmp_path, no_card, cls):
    cfg = small_config(str(tmp_path / "case"), nt=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(cfg, device="cuda")


@pytest.mark.parametrize("cli", [cli_ns, cli_dibpm])
def test_cli_without_a_card_exits_with_the_message(tmp_path, capsys, no_card,
                                                   cli):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["-directory", str(tmp_path)])
    assert exit_info.value.code != 0
    assert "-device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["-device", "--device"])
def test_cli_takes_device_cpu(no_card, flag):
    args = parse_args("test", ["-directory", "case", flag, "cpu"])
    assert args.device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_solver_asked_for_the_cpu_runs(tmp_path, no_card):
    solver = DecoupledIBPMSolver(small_config(str(tmp_path / "case"), nt=2,
                                              dtype="float64"),
                                 device="cpu")
    solver.run()
    solver.close()
    assert solver.device == torch.device("cpu")
    assert len(solver.stats_history) == 2
    assert torch.isfinite(solver.state["p"]).all()
    assert os.path.isdir(solver.output_dir)
