"""The port's console entry points, driven in-process on the CPU, and held
against the JAX package's on the shipped problems."""
import os

import numpy as np
import pytest
import torch

from etol_tpu import cli as jcli
from etol_tpu_torch import cli

torch.set_num_threads(1)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """The commands write their CSV files into the working directory."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _score(text):
    for line in text.splitlines():
        if line.startswith("Minimization Score:"):
            return float(line.split(":")[1])
    raise AssertionError(text)


def test_default_config_is_the_ports_copy():
    for name in ("ocp_2d_ex1.xml", "mip_2d_ex1.xml"):
        path = cli.default_config(name)
        assert os.path.join("etol_tpu_torch", "configs") in path
        with open(path, "rb") as a, open(jcli.default_config(name),
                                         "rb") as b:
            assert a.read() == b.read()


def test_solve_ocp_matches_the_reference(in_tmp, capsys):
    assert cli.solve_ocp(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Status:\t\t\tSOLVED" in out and "on cpu" in out
    assert jcli.solve_ocp([]) == 0
    jout = capsys.readouterr().out
    np.testing.assert_allclose(_score(out), _score(jout), rtol=1e-3)
    rows = (in_tmp / "state_etol_tpu_torch.csv").read_text().splitlines()
    assert rows[0] == "time,traj0,traj1" and len(rows) == 34
    assert (in_tmp / "control_etol_tpu_torch.csv").exists()
    X = np.loadtxt(in_tmp / "state_etol_tpu_torch.csv", delimiter=",",
                   skiprows=1)
    JX = np.loadtxt(in_tmp / "state_etol_tpu.csv", delimiter=",",
                    skiprows=1)
    np.testing.assert_allclose(X, JX, atol=2e-3)


def test_solve_ocp_takes_a_config_path(in_tmp, capsys):
    assert cli.main(["solve_ocp", cli.default_config("ocp_2d_ex1.xml"),
                     "--device", "cpu"]) == 0
    assert 1.2 < _score(capsys.readouterr().out) < 1.8


def test_solve_mip_smooth_path(in_tmp, capsys):
    assert cli.solve_mip(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "nSteps:\t\t16" in out and "Status:\t\t\tSOLVED" in out
    # the smooth routes of this field cost about 12.1 or 13.9
    assert 11.9 < _score(out) < 14.1
    assert (in_tmp / "state_mip_etol_tpu_torch.csv").exists()


def test_solve_mip_exact_matches_the_reference_cli(in_tmp, capsys):
    """``solve_mip --exact`` runs the branch-and-bound under
    the search's defaults and reports what the JAX CLI reports — the
    auto-detected convexity is off on this field (its L1 epigraph rows
    are user path inequalities), so the tree is not closed: MAX_ITER,
    uncertified, exit code 1, at the same objective."""
    assert cli.solve_mip(["--exact", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert jcli.solve_mip(["--exact"]) == 1
    jout = capsys.readouterr().out
    for text in (out, jout):
        assert "Status:\t\t\tMAX_ITER" in text
        assert "certified=False" in text and "[side-bb] incumbent" in text
    np.testing.assert_allclose(_score(out), _score(jout), rtol=1e-3)
    np.testing.assert_allclose(_score(out), 11.958, rtol=1e-3)
    assert "on cpu" in out
    X = np.loadtxt(in_tmp / "state_mip_etol_tpu_torch.csv", delimiter=",",
                   skiprows=1)
    np.testing.assert_allclose(X[-1, 1:], [5.0, 4.0], atol=0.011)


def test_solve_exact_composed(in_tmp, capsys):
    assert cli.main(["solve_exact_composed", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Status:\t\t\tSOLVED (certified=True)" in out
    np.testing.assert_allclose(_score(out.replace("  bound", "\nbound")),
                               8.44876, atol=1e-3)
    sched = out.split("boost schedule:")[1].splitlines()[0]
    assert "1" in sched and "on cpu" in out


def test_solve_3d(in_tmp, capsys):
    """With an output directory, as the JAX CLI, it also writes the xy
    plot with the zones and the animation there."""
    assert cli.solve_3d([str(in_tmp / "art"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Status: SOLVED") and "xN =" in out
    for name in ("pm3d_xy.png", "pm3d.gif"):
        path = in_tmp / "art" / name
        assert path.exists() and path.stat().st_size > 1000, name
    assert "artifacts:" in out


def test_mpc_demo(in_tmp, capsys):
    assert cli.mpc_demo(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cold solve:" in out and "mpc step 1:" in out
    assert "p50 warm re-solve latency" in out


def test_arguments_and_the_default_device():
    with pytest.raises(SystemExit, match="usage"):
        cli.main([])
    with pytest.raises(SystemExit, match="usage"):
        cli.main(["no_such_command"])
    with pytest.raises(SystemExit, match="--device"):
        cli.solve_ocp(["--device"])
    assert set(cli.COMMANDS) == {"solve_ocp", "solve_mip", "solve_3d",
                                 "mpc_demo", "solve_exact_composed",
                                 "fleet_batch", "bench"}
    if not torch.cuda.is_available():
        # no --device means the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.solve_ocp([])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["fleet_batch", "8"])
