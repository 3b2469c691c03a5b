"""Port parity: the scaling ladder's three other models
(``double_integrator_2d``, ``point_mass_3d``, ``fixed_wing_3dof``) at a
small size, each through ``solve_batched_staged`` under its registry
config with ``kkt_solver="scan"`` in both packages, from the same
numpy-made scattered batch.

Compared on converged outcomes: the same statuses and objectives within
1%. Iterates are not compared: the KKT systems at rho=3160 amplify one
float32 ulp of the blocks into 1e-5 of the step, so two lanes may take a
different number of iterations to the same outcome. The fixed-wing solve
(radau, ``chord_steps=2``) is the best conditioned of the three and is
also held to the same per-lane iteration count on at least 3 of 4 lanes,
which a miscounted chord sub-step would break on every lane."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etol_tpu.core import problem as jproblem
from etol_tpu.models import problems as jproblems
from etol_tpu.models import tuned as jtuned
from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch import bench_scaling
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.models import tuned as ttuned
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

B = 4
# model -> (factory arguments, x0 scatter half-width, scattered dims)
CASES = {
    "double_integrator_2d": (
        dict(nsteps=8, dt=0.5, xf=(3.0, 2.4, 0.0, 0.0),
             obstacle_centers=((1.5, 1.2),), obstacle_half=0.4),
        0.4, [0, 1]),
    "point_mass_3d": (dict(nsteps=10, dt=0.8), 0.3, [0, 1, 2]),
    "fixed_wing_3dof": (
        dict(nsteps=12, dt=2.0, xf=(0.4, 0.3, 0.12, 0.02, 0.0, 0.8)),
        0.05, [0, 1]),
}
MODELS = sorted(CASES)


@functools.lru_cache(maxsize=None)
def _setup(model):
    """Both packages' model with the registry's transcription choices, on
    the same scattered batch."""
    kw, scale, dims_free = CASES[model]
    jv, jnlp = getattr(jproblems, model)(**kw)
    _, tnlp = getattr(tproblems, model)(**kw)
    picks = {k: v for k, v in jtuned.tuned_extras(model).items()
             if k in ("obstacle_form", "scheme")}
    jnlp = dataclasses.replace(jnlp, **picks)
    tnlp, ex = bench_scaling.apply_extras(tnlp, model)
    assert ex == jtuned.tuned_extras(model)
    assert (tnlp.scheme, tnlp.obstacle_form) == (jnlp.scheme,
                                                 jnlp.obstacle_form)
    jdata, _ = jv.to_device()
    nx = jnlp.dims.nx
    rng = np.random.default_rng(1)
    d = rng.uniform(-scale, scale, size=(B, nx)).astype(np.float32)
    mask = np.zeros(nx, np.float32)
    mask[dims_free] = 1.0
    jb = jproblem.batch_tile(jdata, B)
    jb = dataclasses.replace(jb, x0=jb.x0 + jnp.asarray(d * mask))
    tb = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jb)], device="cpu")
    return jnlp, jb, tnlp, tb


@functools.lru_cache(maxsize=None)
def _torch_solve(model):
    _, _, tnlp, tb = _setup(model)
    cfg, stages = ttuned.tuned_config(model, batch=B, kkt_solver="scan")
    return tal.solve_batched_staged(tnlp, cfg, tb, None, stages)


@pytest.mark.parametrize("model", MODELS + ["uas_2d"])
def test_registry_matches_the_jax_registry(model):
    """The port's entry is the JAX package's, field for field
    (``ls_backtracks`` and ``lm_rule`` included)."""
    overrides, stages = jtuned._TUNED[model]
    jcfg = jal.SolverConfig(kkt_solver="scan", **overrides)
    assert jcfg.ls_backtracks == 16 and jcfg.hessian == "defect"
    tcfg, tstages = ttuned.tuned_config(model, kkt_solver="scan")
    assert [f.name for f in dataclasses.fields(tcfg)] == [
        f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert ttuned._TUNED[model][0] == overrides
    assert tstages == stages
    assert ttuned.tuned_config(model, batch=64)[1] == jtuned.tuned_config(
        model, batch=64, kkt_solver="scan")[1]
    assert ttuned.tuned_extras(model) == jtuned.tuned_extras(model)
    assert ttuned.tuned_config(model)[0].kkt_solver == "kernel"


@pytest.mark.parametrize("model", MODELS)
def test_problem_data_matches(model):
    """The port's ``VGP.to_device`` and ``vgpdata_from_numpy`` of the JAX
    package's leaves hold the same numbers: 3-D track waypoints (``point_mass_3d``)
    and a problem without obstacles (``fixed_wing_3dof``) included."""
    kw = CASES[model][0]
    jdata, jdims = getattr(jproblems, model)(**kw)[0].to_device()
    tv, tnlp = getattr(tproblems, model)(**kw)
    tdata, tdims = tv.to_device(device="cpu")
    assert tdims == tnlp.dims
    assert dataclasses.asdict(tdims) == dataclasses.asdict(jdims)
    carried = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jdata)], device="cpu")
    for a, b in zip(tproblem.tree_flatten(tdata),
                    tproblem.tree_flatten(carried)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    if model == "point_mass_3d":
        assert tdata.tracks.xy.shape == (2, 2, 3)
        assert tnlp.pos_dims(tdata) == 3
    if model == "fixed_wing_3dof":
        assert float(tdata.obstacles.piece_mask.sum()) == 0.0
        k = torch.zeros((), dtype=torch.long)
        assert tnlp.node_ineq(torch.zeros(9), k, tdata).shape == (0,)


@pytest.mark.parametrize("model", MODELS)
def test_staged_solve_outcomes_match(model):
    jnlp, jb, tnlp, tb = _setup(model)
    jcfg, jstages = jtuned.tuned_config(model, batch=B, kkt_solver="scan")
    jres = jal.solve_batched_staged(jnlp, jcfg, jb, None, jstages)
    tres = _torch_solve(model)
    jstat, tstat = np.asarray(jres.status), tres.status.numpy()
    assert (jstat == 1).all(), jstat
    np.testing.assert_array_equal(tstat, jstat)
    np.testing.assert_allclose(tres.obj.numpy(), np.asarray(jres.obj),
                               rtol=1e-2)
    assert float(torch.maximum(tres.viol_eq, tres.viol_in).max()) <= 1e-4
    assert bool(torch.isfinite(tres.z).all())
    if model == "fixed_wing_3dof":
        assert ttuned.tuned_config(model)[0].chord_steps == 2
        same = np.asarray(jres.inner_iters) == tres.inner_iters.numpy()
        assert same.sum() >= 3, (jres.inner_iters, tres.inner_iters)
        # every trip is a full step and two chord steps
        assert (tres.inner_iters.numpy() % 3 == 0).all()


@pytest.mark.parametrize("model", MODELS)
def test_kernel_route_gets_float32_blocks(model):
    """Under ``kkt_solver="kernel"`` the wrapper checks what it is given
    (float32, contiguous, the shapes) on the CPU too: a trip of the
    registry config goes through it. Dynamics written with Python scalars
    on elements (``10.0 * x[3]``) come out of forward-mode AD as float64
    unless the solver casts."""
    _, _, tnlp, tb = _setup(model)
    cfg, _ = ttuned.tuned_config(model)
    assert cfg.kkt_solver == "kernel"
    res = tal.solve_batched(
        tnlp, dataclasses.replace(cfg, max_total=1), tb)
    assert res.z.dtype == torch.float32
    assert res.inner_iters.tolist() == [1 + cfg.chord_steps] * B
    F = tal._ALFuncs(tnlp, cfg, tb)
    Z = res.z.reshape(B, F.K, F.w)
    g = F.residuals(Z)[2]
    D, O = F.gn_blocks(Z, res.lam_def, res.lam_eq, res.mu, res.rho,
                       torch.ones_like(Z, dtype=torch.bool),
                       torch.full((B,), 1e-3), g)
    assert D.dtype == O.dtype == torch.float32


def test_fixed_wing_chord_quality_no_drift():
    """The port's counterpart of the JAX package's fixed-wing quality
    guard: the chord composite lands mean objectives within 3% of the
    pure-Newton path with a fat budget."""
    model = "fixed_wing_3dof"
    _, _, tnlp, tb = _setup(model)
    cfg, stages = ttuned.tuned_config(model, batch=B, kkt_solver="scan")
    cum = cfg.max_total + sum(b for _, b in stages)
    res = tal.solve_batched(
        tnlp, dataclasses.replace(cfg, max_total=cum), tb)
    assert res.status.tolist() == [1] * B
    ref = tal.solve_batched(
        tnlp, dataclasses.replace(cfg, chord_steps=0, max_total=400), tb)
    ok = ref.status == 1
    assert int(ok.sum()) >= B - 1
    ratio = float(res.obj[ok].mean() / ref.obj[ok].mean())
    assert ratio <= 1.03, ratio


def test_scatter_x0_moves_only_the_free_dims():
    tv, _ = tproblems.point_mass_3d(nsteps=4)
    data, _ = tv.to_device(device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = bench_scaling.scatter_x0(data, 16, 0.3, (0, 1), gen)
    d = out.x0 - data.x0
    assert out.x0.shape == (16, 3) and out.xf.shape == (16, 3)
    assert float(d[:, :2].abs().max()) <= 0.3
    assert float(d[:, :2].abs().min()) > 0.0
    assert float(d[:, 2].abs().max()) == 0.0


def test_ladder_configs_are_the_reference_ladder():
    """(model, batch, scatter, dims, seed) as ``tools/bench_scaling.py``
    runs them."""
    got = {k: v[1:] for k, v in bench_scaling.LADDER.items()}
    assert got == {
        "pm20": ("double_integrator_2d", {}, 1024, 0.4, (0, 1), 0),
        "pm3d": ("point_mass_3d", dict(nsteps=40), 1024, 0.3, (0, 1, 2), 1),
        "fw100": ("fixed_wing_3dof", {}, 256, 0.05, (0, 1), 2),
        "fleet4096": ("uas_2d", dict(nsteps=50), 4096, 0.5, (0, 1), 3),
    }
    for name, (K, w) in dict(pm20=(21, 6), pm3d=(41, 6), fw100=(101, 9),
                             fleet4096=(51, 5)).items():
        _, model, kw = bench_scaling.LADDER[name][:3]
        dims = getattr(tproblems, model)(**kw)[1].dims
        assert (dims.nodes, dims.node_width) == (K, w)


def test_run_config_on_the_cpu():
    lines = []
    label, nlp, bdata, cfg, stages, ex, gen = bench_scaling.prepare(
        "pm20", "cpu", batch=8)
    assert bdata.x0.shape == (8, 4) and cfg.kkt_solver == "kernel"
    assert stages == ((2, 10), (1, 256))
    out = bench_scaling.run_config(label, nlp, bdata, cfg, stages, reps=1,
                                   generator=gen, log=lines.append)
    assert out["solved_fraction"] >= 0.75
    assert len(out["stage_trips"]) == 3 and out["batch_s"] > 0
    assert out["solves_per_s"] == pytest.approx(
        8 * out["solved_fraction"] / out["batch_s"])
    assert len(lines) == 1 and "SOLVED solves/s" in lines[0]
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_scaling.prepare("pm20", batch=8)
    with pytest.raises(SystemExit):
        bench_scaling.main(["--device", "cpu", "nope"])


def test_run_config_warns_when_lanes_are_left_unsolved(capsys):
    """A budget of one iteration and no stages leaves every lane
    unsolved: the line still comes, and the warning goes to stderr."""
    label, nlp, bdata, cfg, _, _, gen = bench_scaling.prepare(
        "pm20", "cpu", batch=4)
    cfg = dataclasses.replace(cfg, max_total=1)
    # reps=0: the first run is the timed one
    out = bench_scaling.run_config(label, nlp, bdata, cfg, (), reps=0,
                                   generator=gen, log=lambda line: None)
    assert out["solved_fraction"] == 0.0 and out["solves_per_s"] == 0.0
    assert out["batch_s"] == out["first_s"] > 0
    err = capsys.readouterr().err
    assert "LADDER UNHEALTHY" in err and "solved fraction 0.000" in err
