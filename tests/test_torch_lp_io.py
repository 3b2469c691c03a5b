"""Port parity: the LP dump (``etol_tpu_torch.io.lp_export``), the eGLPK
file functions (``etol_tpu_torch.io.lp_io``) and the checkpoints
(``etol_tpu_torch.io.checkpoint``), against ``etol_tpu.io`` on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from etol_tpu.io.lp_export import write_lp as jwrite_lp
from etol_tpu.models import canonical_ocp_2d as jcanonical_ocp_2d
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.io import (LPModel, load_checkpoint, read_lp,
                               save_checkpoint, solve_lp, write_lp,
                               write_sol)
from etol_tpu_torch.models import problems
from etol_tpu_torch.solve import al_sqp

from _torch_parity import carry_data

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ocp_dumps(ocp_xml):
    """ocp_2d_ex1.xml's LP dump from both packages (at the initial
    guess) and the port's problem."""
    jv, jn = jcanonical_ocp_2d(ocp_xml)
    tv, tn = problems.canonical_ocp_2d(ocp_xml)
    jd, td = carry_data(jv, tv)
    return write_lp(tn, td), jwrite_lp(jn, jd), tn, td


def test_write_lp_structure(ocp_dumps, tmp_path):
    text, _, tn, td = ocp_dumps
    p = tmp_path / "debug.lp"
    assert write_lp(tn, td, path=str(p)) == text == p.read_text()
    lines = text.splitlines()
    assert lines[2] == "Minimize" and lines[-1] == "End"
    assert "Subject To" in lines and "Bounds" in lines
    assert sum(1 for l in lines if l.startswith(" defect_")) == 32 * 2
    assert any("x_0_0" in l for l in lines)
    assert any("u_5_1" in l for l in lines)
    assert sum(1 for l in lines if l.startswith(" ineq_")) == 33 * (9 + 3 + 2)
    assert any(l.strip().startswith("x_0_0 = 1") for l in lines)


def test_write_lp_matches_the_reference(ocp_dumps):
    """Both dumps parse to the same model: the same names and rows, and
    c, A and the bounds within 1e-5 relative (the texts may differ in a
    last ``%.6g`` digit)."""
    text, jtext, _, _ = ocp_dumps
    assert text.splitlines()[1] == jtext.splitlines()[1]
    m, jm = read_lp(text), read_lp(jtext)
    assert m.names == jm.names
    assert m.row_names == jm.row_names and m.m == jm.m
    np.testing.assert_allclose(m.c, jm.c, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(m.c0, jm.c0, rtol=1e-5)
    np.testing.assert_allclose(m.A, jm.A, rtol=1e-5, atol=1e-8)
    for a, b in ((m.lhs, jm.lhs), (m.rhs, jm.rhs), (m.lb, jm.lb),
                 (m.ub, jm.ub)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


def test_read_lp_roundtrip_of_dump(ocp_dumps):
    text, _, tn, _ = ocp_dumps
    dims = tn.dims
    model = read_lp(text)
    assert model.n == dims.nodes * (dims.nx + dims.nu)
    n_eq = sum(1 for lo, hi in zip(model.lhs, model.rhs)
               if np.isfinite(lo) and lo == hi)
    assert n_eq == dims.nsteps * dims.nx
    assert model.names[0] == "x_0_0"
    j = model.names.index("x_0_1")
    assert model.lb[j] == model.ub[j] == pytest.approx(2.0)


def _toy_lp():
    # min -x - 2y  s.t.  x + y <= 4, x <= 3, y <= 2, x,y >= 0 -> (2, 2), -6
    return LPModel(
        names=["x", "y"], c=np.array([-1.0, -2.0]), c0=0.0,
        A=np.array([[1.0, 1.0]]), lhs=np.array([-np.inf]),
        rhs=np.array([4.0]), lb=np.zeros(2), ub=np.array([3.0, 2.0]),
        row_names=["cap"],
    )


def test_solve_lp_toy():
    sol = solve_lp(_toy_lp())
    assert sol.status == "optimal"
    np.testing.assert_allclose(sol.x, [2.0, 2.0], atol=1e-4)
    assert sol.obj == pytest.approx(-6.0, abs=1e-3)


@pytest.mark.parametrize("seed", [3, 4])
def test_solve_lp_matches_scipy(seed):
    from scipy.optimize import linprog

    rng = np.random.default_rng(seed)
    n, m = 8, 5
    A = rng.normal(size=(m, n))
    b = rng.uniform(1.0, 2.0, size=m)
    c = rng.normal(size=n)
    model = LPModel(
        names=[f"v{i}" for i in range(n)], c=c, c0=0.0, A=A,
        lhs=np.full(m, -np.inf), rhs=b, lb=np.zeros(n),
        ub=np.full(n, 1.0), row_names=[f"r{i}" for i in range(m)],
    )
    sol = solve_lp(model)
    ref = linprog(c, A_ub=A, b_ub=b, bounds=[(0, 1)] * n, method="highs")
    assert ref.success
    assert sol.obj == pytest.approx(ref.fun, abs=1e-3)


def test_lp_text_parse_and_sol_file(tmp_path):
    text = """\\ demo
Minimize
 obj: - x - 2 y
Subject To
 cap: x + y <= 4
Bounds
 0 <= x <= 3
 0 <= y <= 2
End
"""
    p = tmp_path / "toy.lp"
    p.write_text(text)
    model = read_lp(str(p))
    sol = solve_lp(model)
    out = write_sol(model, sol, str(tmp_path / "toy.sol"))
    body = open(out).read().splitlines()
    assert body[0] == "status optimal" and body[1].startswith("objective")
    assert body[3].startswith("x ") and body[4].startswith("y ")
    assert sol.obj == pytest.approx(-6.0, abs=1e-3)


def test_checkpoint_roundtrip_of_solver_state(tmp_path):
    """A SolveResult and a VGPData through one .npz each: every field
    back with its dtype and device, from a template of the same tree."""
    tv, tn = problems.canonical_ocp_2d()
    data, _ = tv.to_device(device="cpu")
    batch = tproblem.batch_tile(data, 2)
    res = al_sqp.solve_batched(tn, al_sqp.SolverConfig(max_total=3), batch)
    for name, tree in (("result", res), ("data", batch)):
        path = save_checkpoint(str(tmp_path / f"{name}.npz"), tree)
        with np.load(path) as f:
            keys = sorted(f.files, key=lambda k: int(k.split("|")[0][4:]))
        if name == "result":
            assert keys[0] == "leaf0|z" and keys[2] == "leaf2|status"
        else:
            assert "leaf8|obstacles/ellipses" in keys
        back = load_checkpoint(path, tree)
        assert type(back) is type(tree)
        for a, b in zip(tproblem.tree_flatten(back),
                        tproblem.tree_flatten(tree)):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
    # the template sets dtype and device: float64 in, float64 out
    like = dataclasses.replace(res, z=res.z.double())
    back = load_checkpoint(str(tmp_path / "result.npz"), like)
    assert back.z.dtype == torch.float64
    np.testing.assert_array_equal(back.z.numpy(), res.z.numpy())


def test_checkpoint_nested_containers_and_refusals(tmp_path):
    tree = {
        "z": torch.arange(12.0).reshape(3, 4),
        "nested": {"mu": torch.ones((2, 5)), "it": torch.tensor(7)},
        "warm": (torch.zeros(2), np.arange(3)),
    }
    p = save_checkpoint(str(tmp_path / "state.npz"), tree)
    back = load_checkpoint(p, tree)
    assert list(back) == list(tree)
    assert torch.equal(back["z"], tree["z"])
    assert torch.equal(back["nested"]["mu"], torch.ones((2, 5)))
    assert int(back["nested"]["it"]) == 7
    assert back["nested"]["it"].dtype == torch.int64
    assert isinstance(back["warm"], tuple)
    np.testing.assert_array_equal(back["warm"][1], np.arange(3))
    with pytest.raises(ValueError, match="orbax"):
        save_checkpoint(str(tmp_path / "ckpt_dir"), tree)
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tmp_path / "ckpt_dir"), tree)
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(p, {"z": tree["z"]})
