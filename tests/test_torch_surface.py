"""Port parity: the JAX package's public surface.

Every name that a JAX subpackage exports imports from the port's
counterpart (``force_platform``, a JAX backend workaround, excepted), in
any import order and without building the kernel; ``SolverConfig`` has
the JAX package's fields and defaults; and the geometry, collocation,
obstacle, KKT and problem-data helpers agree with the JAX package's on
the JAX package's own test cases (``tests/test_geometry.py``,
``tests/test_native.py``, ``tests/test_transcribe.py:15-95``,
``tests/test_cyclic_reduction.py:25``)."""
import dataclasses
import importlib
import inspect
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etol_tpu
from etol_tpu.core import _native as j_native
from etol_tpu.core import geometry as jgeo
from etol_tpu.core import problem as jproblem
from etol_tpu.core import types as jtypes
from etol_tpu.models import dynamics as jdyn
from etol_tpu.solve import al_sqp as jal
from etol_tpu.solve import btridiag as jbt
from etol_tpu.transcribe import collocation as jcol
from etol_tpu.transcribe import obstacles as jobs
from etol_tpu_torch.core import _native as t_native
from etol_tpu_torch.core import geometry as tgeo
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.core import types as ttypes
from etol_tpu_torch.core.xml_io import load_configs as tload
from etol_tpu_torch.models import dynamics as tdyn
from etol_tpu_torch.ops import cyclic_reduction as tcr
from etol_tpu_torch.solve import al_sqp as tal
from etol_tpu_torch.solve import btridiag as tbt
from etol_tpu_torch.transcribe import collocation as tcol
from etol_tpu_torch.transcribe import obstacles as tobs
from etol_tpu_torch.utils import sync

torch.set_num_threads(1)

SUBPACKAGES = ("solve", "core", "transcribe", "ops", "models", "utils")
# JAX backend-registration workarounds with no counterpart in the port
NOT_PORTED = {"force_platform"}
REPO = pathlib.Path(__file__).resolve().parent.parent

SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
# the canonical nonconvex 5-corner obstacle from mip_2d_ex1.xml
EXZ0 = np.array(
    [[3.2, 2.5], [3.4, 2.6], [3.5, 3.4], [3.3, 3.0], [3.1, 3.5]])
# tests/test_native.py's polygons
POLYS = [
    SQUARE,
    EXZ0,
    np.array([[2.2, 2.5], [2.4, 2.6], [2.5, 3.4], [2.1, 3.5]]),
    np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], dtype=float),
]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    """Every name of the JAX subpackage's ``__all__`` is in the port's and
    is the same kind of thing: a module where JAX's is a module, else not
    a module (a function must not be shadowed by a submodule of its
    name)."""
    jpkg = importlib.import_module(f"etol_tpu.{sub}")
    tpkg = importlib.import_module(f"etol_tpu_torch.{sub}")
    names = [n for n in jpkg.__all__ if n not in NOT_PORTED]
    assert set(names) <= set(tpkg.__all__)
    for name in names:
        ours = getattr(tpkg, name)
        assert isinstance(ours, types.ModuleType) == isinstance(
            getattr(jpkg, name), types.ModuleType), (sub, name)
    assert set(NOT_PORTED) & set(tpkg.__all__) == set()


def test_readme_and_authoring_imports():
    """The imports the README's example and docs/authoring.md make, from
    the port."""
    from etol_tpu_torch.models import tuned_config, uas_2d
    from etol_tpu_torch.solve import (
        SolverConfig, shooting, solve, solve_batched_staged)

    assert callable(solve) and callable(solve_batched_staged)
    assert inspect.ismodule(shooting)
    assert tuned_config("uas_2d")[0] == SolverConfig(
        **dict(etol_tpu.models.tuned._TUNED["uas_2d"][0],
               kkt_solver="kernel"))
    assert callable(uas_2d)


def test_every_module_imports_first_without_a_kernel_build():
    """Each module of the port, imported first into a fresh interpreter
    state (every import order a user can start from): no import cycle,
    no jax, and the kernel not built."""
    code = r"""
import importlib, pathlib, sys
import torch
port = pathlib.Path(sys.argv[1])
mods = sorted(str(f.relative_to(port))[:-3] for f in port.rglob("*.py"))
for m in mods:
    for k in [k for k in sys.modules if k.startswith("etol_tpu_torch")]:
        del sys.modules[k]
    name = ".".join(["etol_tpu_torch"] + m.split("/"))
    importlib.import_module(name.replace(".__init__", ""))
    bt = sys.modules.get("etol_tpu_torch.ops.bt_cuda")
    assert bt is None or (bt._LIB is None and bt.BUILD_SECONDS is None), m
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "etol_tpu")]
print(len(mods))
"""
    out = subprocess.run(
        [sys.executable, "-c", code, str(REPO / "etol_tpu_torch")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 50


def test_solver_config_fields_are_the_jax_packages():
    """Name for name, in order, default for default; ``kkt_solver`` names
    the port's routes ("kernel" where the JAX package defaults to its
    "scan")."""
    jf = dataclasses.fields(jal.SolverConfig)
    tf = dataclasses.fields(tal.SolverConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        if a.name == "kkt_solver":
            assert (a.default, b.default) == ("kernel", "scan")
        else:
            assert a.default == b.default, a.name


# ---- geometry (tests/test_geometry.py, tests/test_native.py) ----------


def _points(poly, n=128, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = poly.min(axis=0) - 0.5, poly.max(axis=0) + 0.5
    return rng.uniform(lo, hi, size=(n, 2))


@pytest.mark.parametrize("i", range(len(POLYS)))
def test_point_in_polygon_agrees_exactly(i):
    poly = POLYS[i]
    pts = list(_points(poly)) + [np.array(v) for v in poly]  # corners too
    pts += [0.5 * (poly[k] + poly[(k + 1) % len(poly)])
            for k in range(len(poly))]                  # edge midpoints
    z = np.full((len(poly), 1), 7.0)
    for p in pts:
        want = jgeo.point_in_polygon(p, poly)
        assert tgeo.point_in_polygon(p, poly) == want, p
        # a stored z column: the test is on the xy footprint
        assert tgeo.point_in_polygon(p, np.hstack([poly, z])) == want, p
    assert tgeo.point_in_polygon([0.5, 0.5], SQUARE)
    assert tgeo.point_in_polygon([1.0, 0.5], SQUARE)  # boundary inside
    assert not tgeo.point_in_polygon([1.5, 0.5], SQUARE)


@pytest.mark.parametrize("i", range(len(POLYS)))
def test_chains_edges_and_regions_match(i):
    poly = POLYS[i]
    for piece in jgeo.convex_partition(poly):
        for a, b in zip(tgeo.lower_upper_chains(piece),
                        jgeo.lower_upper_chains(piece)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
            np.testing.assert_allclose(tgeo.chain_edges(a),
                                       jgeo.chain_edges(b), rtol=0,
                                       atol=1e-12)
    ours, theirs = tgeo.gen_region(poly), jgeo.gen_region(poly)
    assert len(ours) == len(theirs)
    for (lo_t, up_t), (lo_j, up_j) in zip(ours, theirs):
        np.testing.assert_allclose(lo_t, lo_j, rtol=0, atol=1e-12)
        np.testing.assert_allclose(up_t, up_j, rtol=0, atol=1e-12)
    # a vertical edge has slope inf, as in the JAX package's test
    edges = tgeo.chain_edges(np.array([[0.0, 0.0], [1.0, 1.0], [1.0, 2.0]]))
    assert edges[0][2] == pytest.approx(1.0) and np.isinf(edges[1][2])
    assert edges[0][3] == pytest.approx(np.sqrt(2.0))


@pytest.mark.parametrize("i", range(len(POLYS)))
def test_native_engine_matches_the_jax_packages(i):
    """The port's bindings to native/libetpu_geometry.so against the JAX
    package's, on the same library; skipped, as tests/test_native.py is,
    where the library is not built."""
    if not j_native.available():
        pytest.skip("native geometry library not built")
    assert t_native.available()
    poly = POLYS[i]
    ccw = jgeo.ensure_ccw(poly)
    for p in _points(poly):
        assert t_native.point_in_polygon(p, poly) == \
            j_native.point_in_polygon(p, poly)
    for piece in jgeo.convex_partition(ccw):
        np.testing.assert_allclose(t_native.piece_halfspaces(piece),
                                   j_native.piece_halfspaces(piece),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(tgeo.piece_halfspaces(piece),
                                   jgeo.piece_halfspaces(piece),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_native.edge_ellipses(ccw, 0.2),
                               j_native.edge_ellipses(ccw, 0.2), rtol=0,
                               atol=1e-12)


def test_native_bindings_answer_none_without_the_library(monkeypatch):
    """Without the library every binding says None, and the geometry
    falls back to the Python versions (the JAX package's contract)."""
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setattr(t_native, "_TRIED", True)
    assert not t_native.available()
    assert t_native.point_in_polygon([0.5, 0.5], SQUARE) is None
    assert t_native.piece_halfspaces(SQUARE) is None
    assert t_native.edge_ellipses(SQUARE, 0.2) is None
    assert tgeo.point_in_polygon([0.5, 0.5], SQUARE)


# ---- collocation (tests/test_transcribe.py:15-53) ----------------------


def _single_integrator(x, u, t, data):
    return u[: x.shape[0]]


def _both(fn_name, *args, **kw):
    """``collocation.<fn_name>`` of both packages on the same float32
    numpy arguments (the dynamics or integrand first)."""
    f_j, f_t = args[0]
    arrays = [np.asarray(a, np.float32) for a in args[1:3]]
    j = getattr(jcol, fn_name)(f_j, *map(jnp.asarray, arrays), *args[3:],
                               **kw)
    t = getattr(tcol, fn_name)(f_t, *map(torch.from_numpy, arrays),
                               *args[3:], **kw)
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("scheme", tcol.SCHEMES)
def test_defects_match(scheme):
    # x(t) = t under u = 1: every scheme's defects vanish
    K, dt = 9, 0.25
    ts = np.arange(K) * dt
    X, U = np.stack([ts, ts], axis=-1), np.ones((K, 2))
    si = (_single_integrator, _single_integrator)
    t, j = _both("defects", si, X, U, dt, None, scheme)
    assert t.shape == (K - 1, 2)
    np.testing.assert_allclose(t, j, atol=1e-5)
    np.testing.assert_allclose(t, 0.0, atol=1e-5)
    # an infeasible trajectory: nonzero, and the same numbers
    t, j = _both("defects", si, np.zeros((5, 2)), np.ones((5, 2)), 0.5,
                 None, scheme)
    np.testing.assert_allclose(t, j, atol=1e-5)
    assert np.abs(t).max() > 0.1
    # the nonlinear unicycle on a seeded random trajectory
    rng = np.random.default_rng(7)
    X, U = rng.normal(size=(13, 3)), rng.normal(size=(13, 2))
    t, j = _both("defects", (jdyn.unicycle, tdyn.unicycle), X, U, 0.4,
                 None, scheme)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["trapezoidal", "euler"])
def test_costs_and_node_times_match(scheme):
    # integral of u^2 with u(t) = t over [0, 1]: 1/3 by the trapezoid
    K, dt = 101, 0.01
    U = (np.arange(K) * dt)[:, None]
    X = np.zeros((K, 1))
    ell = (lambda x, u, t, d: u[0] ** 2,) * 2
    t, j = _both("integral_cost", ell, X, U, dt, None, scheme)
    np.testing.assert_allclose(t, j, rtol=1e-5)
    if scheme == "trapezoidal":
        assert float(t) == pytest.approx(1.0 / 3.0, abs=1e-3)
    t, j = _both("sum_cost", ell, X, U, dt, None)
    np.testing.assert_allclose(t, j, rtol=1e-5)
    np.testing.assert_allclose(tcol.node_times(4, 0.25).numpy(),
                               np.asarray(jcol.node_times(4, 0.25)))
    assert tcol.node_times(4, torch.tensor(0.5, dtype=torch.float64)
                           ).dtype == torch.float64


# ---- obstacles, KKT, problem data, types, utils -------------------------


def test_inside_any_piece_agrees_exactly(mip_xml):
    """tests/test_transcribe.py's random points on mip_2d_ex1.xml: the
    same answer as the JAX package's at every point."""
    jv = etol_tpu.load_configs(mip_xml)
    jdata, _ = jv.to_device()
    tdata, _ = tload(mip_xml).to_device(device="cpu")
    pts = np.random.default_rng(0).uniform(1.5, 4.5, size=(64, 2))
    pts = np.concatenate([pts, np.asarray(jv.obstacles[0])[:, :2]])
    inside = [bool(tobs.inside_any_piece(torch.tensor(p, dtype=torch.float32),
                                         tdata.obstacles)) for p in pts]
    want = [bool(jobs.inside_any_piece(jnp.asarray(p, jnp.float32),
                                       jdata.obstacles)) for p in pts]
    assert inside == want
    assert any(inside) and not all(inside)


@pytest.mark.parametrize("K,w", [(1, 3), (4, 4), (7, 5), (33, 4), (51, 5)])
def test_to_dense_matches(K, w):
    """tests/test_cyclic_reduction.py:25's systems: the same dense
    matrix, and cyclic reduction against its dense solve at that test's
    tolerance."""
    rng = np.random.default_rng(K * 7 + w)
    D = rng.normal(size=(K, w, w))
    D = D @ D.transpose(0, 2, 1) + 5.0 * np.eye(w)
    O = rng.normal(size=(max(K - 1, 0), w, w)) * 0.3
    r = rng.normal(size=(K, w))
    H = tbt.to_dense(torch.from_numpy(D), torch.from_numpy(O)).numpy()
    with jax.enable_x64(True):
        Hj = np.asarray(jbt.to_dense(jnp.asarray(D), jnp.asarray(O)))
    np.testing.assert_array_equal(H, Hj)
    f32 = [torch.tensor(a, dtype=torch.float32) for a in (D, O, r)]
    x = tcr.solve(*f32).numpy()
    x_ref = np.linalg.solve(H, r.reshape(-1)).reshape(K, w)
    np.testing.assert_allclose(x, x_ref, rtol=3e-4, atol=3e-5)


def test_problem_data_helpers_match():
    T = tproblem.TrackData.empty(0, 3, ndim=3, device="cpu")
    J = jproblem.TrackData.empty(0, 3, ndim=3)
    O = tproblem.ObstacleData.empty(4, 0, 5, dtype=torch.float64,
                                    device="cpu")
    with jax.enable_x64(True):
        P = jproblem.ObstacleData.empty(4, 0, 5, dtype=jnp.float64)
    for ours, theirs in ((T, J), (O, P)):
        a, b = tproblem.tree_flatten(ours), jax.tree.leaves(theirs)
        assert [tuple(x.shape) for x in a] == [x.shape for x in b]
        assert [str(x.dtype).split(".")[-1] for x in a] == [
            str(x.dtype) for x in b]
        assert all(float(x.abs().max()) == 0.0 for x in a)
    from etol_tpu.models import problems as jproblems
    from etol_tpu_torch.models import problems as tproblems

    jdata, _ = jproblems.uas_2d(nsteps=8)[0].to_device()
    tdata = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jdata)], device="cpu")
    assert tdata.dtype == torch.float32 and str(jdata.dtype) == "float32"
    t64 = tdata.astype(torch.float64)
    assert type(t64) is tproblem.VGPData and t64.dtype == torch.float64
    with jax.enable_x64(True):
        j64 = jdata.astype(jnp.float64)
        for a, b in zip(tproblem.tree_flatten(t64), jax.tree.leaves(j64)):
            assert a.dtype == torch.float64 and str(b.dtype) == "float64"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_default_float_and_sync():
    assert ttypes.default_float() is torch.float32
    assert np.dtype(jtypes.default_float()) == np.float32
    assert sync({"a": torch.ones(2)}) is None  # CPU tensors: nothing to wait
    assert sync(tproblem.ObstacleData.empty(1, 1, 1, device="cpu")) is None
