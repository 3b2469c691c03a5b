"""The line search's candidate kernel (``ops/ls_candidates.py``,
``csrc/ls_candidates.cu``) on the CPU: which problems the solver routes to
it, the wrapper's checks and counters, the bound's cost, and the kernel's
arithmetic built by the host's C++ compiler against the solver's own
candidate pass (``_ALFuncs.candidate_residuals``, ``al_from_parts`` and the
pick of ``al_sqp._body``). The kernel itself runs on the card only, where
``chip_smoke.py`` holds it against the plain pass at every shape the paths
launch."""
import copy
import ctypes
import dataclasses
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from etol_tpu_torch import TrajectoryOptimizer
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import dynamics
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.ops import ls_candidates
from etol_tpu_torch.parallel import dryrun
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

CUDA = torch.device("cuda")
OCP_XML = "etol_tpu_torch/configs/ocp_2d_ex1.xml"
# |host - plain| over the sum of the magnitudes of a candidate's terms
# (_magnitudes), for its AL value and its decrease: float32 sums of ~500
# terms in another order, 4.1e-7 at most here (the chip check's limit too)
VAL_TOL = 1e-5


def _ocp():
    """ocp_2d_ex1.xml through the facade, on the CPU: (vgp, nlp)."""
    topt = TrajectoryOptimizer(device="cpu")
    topt.load_configs(OCP_XML)
    topt.set_dynamics(dynamics.single_integrator)
    topt.set_objective(lambda x, u, t, d: u[0] ** 2 + u[1] ** 2)
    topt.setup()
    return topt.vgp, topt.nlp


def _pm3d():
    return tproblems.point_mass_3d(nsteps=40)


def _variant(name):
    """A problem changed in one respect, its dtype and its device."""
    _, ocp = _ocp()
    rep = dataclasses.replace
    f32 = torch.float32
    return {
        "ocp2d_facade": (ocp, f32, CUDA),
        "pm3d": (_pm3d()[1], f32, CUDA),
        "euler": (rep(ocp, scheme="euler"), f32, CUDA),
        "no_obstacles": (rep(ocp, use_obstacles=False), f32, CUDA),
        "pieces": (rep(ocp, obstacle_form="pieces"), f32, CUDA),
        "uas2d_hs": (tproblems.uas_2d(nsteps=12)[1], f32, CUDA),
        "milp_user_rows": (tproblems.canonical_mip_2d()[1], f32, CUDA),
        "user_eq": (rep(ocp, path_eq=(lambda x, u, t, d: x[0],)), f32,
                    CUDA),
        "delayed": (rep(ocp, x_delay=1), f32, CUDA),
        "params": (rep(ocp, dims=rep(ocp.dims, n_params=1)), f32, CUDA),
        "double_integrator": (tproblems.double_integrator_2d()[1], f32,
                              CUDA),
        "radau": (rep(ocp, scheme="radau"), f32, CUDA),
        "user_lambda": (rep(ocp, dynamics=lambda x, u, t, d: u[:2]), f32,
                        CUDA),
        "float64": (ocp, torch.float64, CUDA),
        "cpu": (ocp, f32, torch.device("cpu")),
    }[name]


TAKEN = ("ocp2d_facade", "pm3d", "euler", "no_obstacles", "pieces")


@pytest.mark.parametrize("name", TAKEN + (
    "uas2d_hs", "milp_user_rows", "user_eq", "delayed", "params",
    "double_integrator", "radau", "user_lambda", "float64", "cpu"))
def test_route_from_the_input(name):
    nlp, dtype, device = _variant(name)
    assert ls_candidates.takes(nlp, dtype, device) == (name in TAKEN)


def _funcs(vgp_nlp, B, cfg=None, **change):
    """The solver's building blocks over B lanes of the problem (changed
    by ``change``) on the CPU, starts moved by a fixed draw."""
    vgp, nlp = vgp_nlp
    nlp = dataclasses.replace(nlp, **change)
    data, _ = vgp.to_device(device="cpu")
    data = tproblem.batch_tile(data, B)
    rng = np.random.default_rng(B)
    x0 = data.x0 + torch.from_numpy(
        rng.uniform(-0.05, 0.05, tuple(data.x0.shape)).astype(np.float32))
    data = dataclasses.replace(data, x0=x0)
    return tal._ALFuncs(nlp, cfg or tal.SolverConfig(), data)


def _state(F, cfg, rng, trips=2):
    """A loop state after a few trips from the cold start, its
    multipliers redrawn so that every AL term counts, and the pass's
    inputs there: (st, grad, p, ref, exps)."""
    nlp, data = F.nlp, F.data
    st = tal._start(F, cfg, tal.map_lanes(nlp.initial_guess, data),
                    tal.init_multipliers(nlp, data))
    exps = tal._exponents(cfg, F.dtype, F.lb.device)
    for _ in range(trips):
        st = tal._trip(F, cfg, st, exps, tal._active(cfg, st, 10 ** 6))
    B = st["Z"].shape[0]
    st["lam_def"] = torch.from_numpy(rng.uniform(
        -5.0, 5.0, tuple(st["lam_def"].shape)).astype(np.float32))
    st["mu"] = torch.from_numpy(rng.uniform(
        0.0, 2.0, tuple(st["mu"].shape)).astype(np.float32))
    st["rho"] = torch.from_numpy(np.exp(rng.uniform(
        np.log(10.0), np.log(1e4), B)).astype(np.float32))
    args = (st["Z"], st["lam_def"], st["lam_eq"], st["mu"], st["rho"])
    grad = F.al_grad(*args)
    p, _ = F.direction(st["Z"], grad, st["lam_def"], st["lam_eq"],
                       st["mu"], st["rho"], st["lm"], st["g"])
    ref = F.al_from_parts(st["cost"], st["cd"], st["ce"], st["g"],
                          st["lam_def"], st["lam_eq"], st["mu"], st["rho"])
    return st, grad, p, ref, exps


def _plain_pass(F, st, grad, p, exps):
    """The solver's own candidate pass, as ``al_sqp._body`` runs it:
    (Zc, valc, decc, cdc, gc, costc)."""
    Z = st["Z"]
    alphas = 0.5 ** exps
    Zc = torch.clamp(Z[:, None] + alphas[None, :, None, None] * p[:, None],
                     F.lb[:, None], F.ub[:, None])
    (cdc, cec, gc), costc = F.candidate_residuals(Zc)
    valc = F.al_from_parts(costc, cdc, cec, gc, st["lam_def"][:, None],
                           st["lam_eq"][:, None], st["mu"][:, None],
                           st["rho"][:, None])
    decc = torch.sum(grad[:, None] * (Zc - Z[:, None]), dim=(2, 3))
    return Zc, valc, decc, cdc, gc, costc


def _magnitudes(F, st, grad, Zc, cdc, gc, costc):
    """The sums of the magnitudes of each candidate's terms, [B, n] each:
    1 + |cost| + the AL terms' (|lam c|, rho/2 c^2, (s^2 + mu^2)/(2 rho))
    for its value, 1 + |grad (Zc - Z)| for its decrease. Float32 sums in
    another order differ by a small share of these."""
    rho = st["rho"][:, None]
    mu = st["mu"][:, None]
    s = torch.clamp(mu + rho[..., None, None] * gc, min=0.0)
    val = (1.0 + costc.abs()
           + (st["lam_def"][:, None] * cdc).abs().sum(dim=(-2, -1))
           + 0.5 * rho * (cdc ** 2).sum(dim=(-2, -1))
           + (0.5 / rho) * (s * s + mu * mu).sum(dim=(-2, -1)))
    dec = 1.0 + (grad[:, None] * (Zc - st["Z"][:, None])).abs().sum(
        dim=(-2, -1))
    return val, dec


def _rel(got, ref):
    """max |got - ref| / (1 + max |ref|); 0 for empty tensors."""
    if not ref.numel():
        return 0.0
    return float((got - ref).abs().max()) / (1.0 + float(ref.abs().max()))


def _pick(cfg, valc, decc, ref):
    """The Armijo test and the pick of ``al_sqp._body``: (sel, the
    Armijo margins ref + c1 dec - val)."""
    margin = ref[:, None] + cfg.ls_c1 * decc - valc
    okc = (margin >= 0) & torch.isfinite(valc) & (decc < 0.0)
    if cfg.ls_rule == "best":
        sel = torch.argmin(torch.where(okc, valc, torch.full_like(
            valc, float("inf"))), dim=1)
    else:
        sel = torch.argmax(okc.to(torch.int32), dim=1)
    return sel, margin


def _decided(cfg, sel, valc, decc, margin, scale, dtol):
    """Lanes whose pick (``sel``) no difference within ``scale`` of a
    candidate's value and ``dtol`` of its decrease ([B, n] each) can move:
    for "first" every candidate before the pick clearly fails and the pick
    clearly passes; for "best" the pick clearly passes and every other
    candidate clearly fails or lies more than twice the tolerance above
    it; where none passes, every candidate clearly fails."""
    passes = (margin > scale) & (decc < -dtol) & torch.isfinite(valc)
    fails = (margin < -scale) | (decc > dtol) | ~torch.isfinite(valc)
    lanes = torch.arange(valc.shape[0])
    j = torch.arange(valc.shape[1])[None, :]
    none = fails.all(dim=1)
    won = passes[lanes, sel]
    if cfg.ls_rule == "best":
        v = valc[lanes, sel][:, None]
        others = (fails | (valc > v + 2 * scale) | (j == sel[:, None]))
    else:
        others = fails | (j >= sel[:, None])
    return none | (won & others.all(dim=1))


def _inputs(F, st, grad, p, exps):
    lanes = ls_candidates.Lanes.of(F.lb, F.ub, F.cscale, F.track_ctrs,
                                   F.data)
    return (F.nlp, lanes, st["Z"].contiguous(), p.contiguous(),
            grad.contiguous(), (0.5 ** exps).contiguous(),
            st["lam_def"].contiguous(), st["mu"].contiguous(),
            st["rho"].contiguous())


# ---- the wrapper --------------------------------------------------------

def _args(device="meta", B=2, K=5, **change):
    """Well-formed arguments of the ocp2d problem's shape on ``device``."""
    _, nlp = _ocp()
    E, P, H, T, D = 9, 3, 4, 2, 2
    m = E + P + T

    def t(*shape):
        return torch.zeros(shape, device=device)

    lanes = ls_candidates.Lanes(
        t(B, K, 4), t(B, K, 4), t(B, 2) + 1, t(B) + 0.5, t(B, E, 6),
        t(B, E), t(B, P, H, 3), t(B, P, H), t(B, P), t(B, K, T, D),
        t(B, T, D), t(B, T), t(B, T))
    lanes = lanes._replace(**{k: v for k, v in change.items()
                              if k in lanes._fields})
    kw = dict(Z=t(B, K, 4), p=t(B, K, 4), grad=t(B, K, 4), alpha=t(3) + 1,
              lam=t(B, K - 1, 2), mu=t(B, K, m), rho=t(B) + 1)
    kw.update({k: v for k, v in change.items() if k in kw})
    return nlp, lanes, kw


@pytest.mark.parametrize("change, error", [
    (dict(Z=torch.empty(2, 5, 4, dtype=torch.float64, device="meta")),
     TypeError),
    (dict(Z=torch.empty(2, 5, 6, device="meta")), ValueError),
    (dict(Z=torch.empty(2, 1, 4, device="meta")), ValueError),
    (dict(p=torch.empty(2, 5, 3, device="meta")), ValueError),
    (dict(alpha=torch.empty(0, device="meta")), ValueError),
    (dict(lam=torch.empty(2, 5, 2, device="meta")), ValueError),
    (dict(mu=torch.empty(2, 5, 13, device="meta")), ValueError),
    (dict(rho=torch.empty(2, 1, device="meta")), ValueError),
    (dict(cs=torch.empty(2, 3, device="meta")), ValueError),
    (dict(centers=torch.empty(2, 4, 2, 2, device="meta")), ValueError),
    (dict(halfspaces=torch.empty(2, 3, 4, 2, device="meta")), ValueError),
    (dict(grad=torch.empty(2, 4, 5, device="meta").transpose(1, 2)),
     ValueError),
    (dict(dt=torch.empty(2)), ValueError),
    (dict(mu=np.zeros((2, 5, 14), np.float32)), TypeError),
    ({}, ValueError),
])
def test_wrapper_checks_before_any_launch(change, error):
    launches = ls_candidates.TALLY.count, dict(ls_candidates.TALLY.by)
    nlp, lanes, kw = _args(**change)
    with pytest.raises(error):
        ls_candidates.candidates(nlp, lanes, **kw)
    assert (ls_candidates.TALLY.count, ls_candidates.TALLY.by) == launches


def test_wrapper_checks_the_problem_and_the_chosen_index():
    nlp, lanes, kw = _args()
    with pytest.raises(ValueError, match="memoryless euler or trap"):
        ls_candidates.candidates(
            dataclasses.replace(nlp, scheme="hermite_simpson"), lanes, **kw)
    with pytest.raises(TypeError, match="int64"):
        ls_candidates.chosen(nlp, lanes, **kw,
                             sel=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="sel must be"):
        ls_candidates.chosen(nlp, lanes, **kw,
                             sel=torch.zeros(3, dtype=torch.int64))
    assert ls_candidates.TALLY.count == 0


def test_cpu_tensors_are_refused_before_any_launch():
    nlp, lanes, kw = _args("cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls_candidates.candidates(nlp, lanes, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls_candidates.chosen(nlp, lanes, **kw, sel=torch.tensor([2, 0]))
    assert ls_candidates.TALLY.count == 0 and not ls_candidates.TALLY.by


def test_captured_launches_count_at_each_replay(monkeypatch):
    monkeypatch.setattr(ls_candidates.TALLY, "by", {})
    with ls_candidates.TALLY.recording() as record:
        ls_candidates.TALLY.add((33, 4, 24, 64))
        ls_candidates.TALLY.add((33, 4, 24, 64))
    assert record == {(33, 4, 24, 64): 2} and ls_candidates.TALLY.count == 0
    ls_candidates.TALLY.replayed(record, 5)
    ls_candidates.TALLY.add((41, 6, 16, 1))
    assert ls_candidates.TALLY.count == 11
    assert ls_candidates.TALLY.by == {(33, 4, 24, 64): 10,
                                      (41, 6, 16, 1): 1}


def test_cost_counts_each_tensor_once():
    K, nx, nu, n, B = 33, 2, 2, 24, 2048
    E, P, H, T, D = 9, 3, 4, 2, 2
    w, m = nx + nu, E + P + T
    flops, nbytes = ls_candidates.cost(K, nx, nu, n, B, E, P, H, T, D)
    read = (5 * B * K * w, n, B * (K - 1) * nx, B * K * m, B, B * nx, B,
            B * E * 6, B * E, B * P * H * 3, B * P * H, B * P,
            B * K * T * D, B * T * D, B * T, B * T)
    written = (B * n * K * w, B * n, B * n)
    assert nbytes == 4 * (sum(read) + sum(written))
    assert flops > 0 and flops % (B * n) == 0
    # the rows' work scales with the rows a form keeps
    assert ls_candidates.cost(K, nx, nu, n, B, T=T, D=D)[0] < flops


# ---- the kernel's arithmetic, built for the host -------------------------

_HOST_LOOP = r"""
#include "%(source)s"
// The kernel's groups one after another: node_terms over each lane's
// candidates and nodes, without the threads' split and shuffles.
template <int NX, int NU>
void host_run(const etol_ls::Args* a) {
  using namespace etol_ls;
  constexpr int W = NX + NU;
  const bool chosen = a->sel != nullptr;
  const int n = chosen ? 1 : a->n;
  const int M = rows(*a);
  for (long long b = 0; b < a->B; ++b) {
    for (int j = 0; j < n; ++j) {
      const long long group = b * n + j;
      const float alpha = chosen ? a->alpha[a->sel[b]] : a->alpha[j];
      Sums s = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < a->K; ++k) {
        float* cd = chosen && k + 1 < a->K
                        ? a->cd + (b * (a->K - 1) + k) * NX : nullptr;
        float* g = chosen ? a->g + (b * a->K + k) * M : nullptr;
        node_terms<NX, NU>(*a, b, k, alpha,
                           a->Zc + (group * a->K + k) * W, cd, g, s);
      }
      if (!chosen) {
        a->val[group] = lane_value(s, a->rho[b]);
        a->dec[group] = s.dec;
      }
    }
  }
}

extern "C" void host_candidates(int model, const etol_ls::Args* a) {
  if (model == 0) host_run<2, 2>(a);
  else host_run<3, 3>(a);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The source's arithmetic compiled by the host's C++ compiler (no
    nvcc: everything but the kernel and its launch)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler builds the kernel's arithmetic"
    d = tmp_path_factory.mktemp("ls_host")
    src = d / "ls_host.cpp"
    src.write_text(_HOST_LOOP % dict(source=ls_candidates._SOURCE))
    lib = d / "libls_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    out.host_candidates.argtypes = [
        ctypes.c_int, ctypes.POINTER(ls_candidates._Args)]
    return out


def _host(host_lib, F, inputs, sel=None):
    """The host build over the wrapper's own packed arguments."""
    nlp, lanes = inputs[:2]
    model, m = ls_candidates._check(*inputs, sel)
    out, args = ls_candidates._pack(nlp, model, m, lanes, *inputs[2:], sel)
    host_lib.host_candidates(model.id, ctypes.byref(args))
    return out


def _dryrun():
    """The dry run's long-horizon single integrator (a zone and a moving
    track) at K = 257 on the CPU: (what gives its data, nlp)."""
    nlp, data, _ = dryrun.horizon_problem(256, "cpu")
    return types.SimpleNamespace(to_device=lambda device: (data, None)), nlp


CASES = {
    "ocp2d": (_ocp, 6, {}),
    "ocp2d_ellipses": (_ocp, 6, dict(obstacle_form="ellipses")),
    "ocp2d_pieces_margin": (_ocp, 6, dict(obstacle_form="pieces",
                                          obstacle_margin=0.02)),
    "ocp2d_euler_no_obstacles": (_ocp, 5, dict(scheme="euler",
                                               use_obstacles=False)),
    "pm3d": (_pm3d, 5, {}),
    "pm3d_pieces": (_pm3d, 5, dict(obstacle_form="pieces")),
    "dryrun_long": (_dryrun, 3, {}),
}


@pytest.mark.parametrize("rule", ["first", "best"])
@pytest.mark.parametrize("case", list(CASES))
def test_host_build_of_the_arithmetic_matches_the_plain_pass(
        host_lib, case, rule):
    make, B, change = CASES[case]
    cfg = tal.SolverConfig(ls_rule=rule,
                           ls_grid=16 if make is _pm3d else 24)
    F = _funcs(make(), B, cfg, **change)
    st, grad, p, ref, exps = _state(F, cfg, np.random.default_rng(3))
    Zc, valc, decc, cdc, gc, costc = _plain_pass(F, st, grad, p, exps)
    inputs = _inputs(F, st, grad, p, exps)

    hZc, part, hdec = _host(host_lib, F, inputs)
    assert torch.equal(hZc, Zc)  # the steps rounded as torch rounds them
    hval = F.candidate_cost(hZc) + part
    mval, mdec = _magnitudes(F, st, grad, Zc, cdc, gc, costc)
    for got, ref_, mag in ((hval, valc, mval), (hdec, decc, mdec)):
        assert float(((got - ref_).abs() / mag).max()) <= VAL_TOL, case

    sel, margin = _pick(cfg, valc, decc, ref)
    hsel, _ = _pick(cfg, hval, hdec, ref)
    decided = _decided(cfg, sel, valc, decc, margin, VAL_TOL * mval,
                       VAL_TOL * mdec)
    assert decided.sum() >= B - 1
    assert torch.equal(hsel[decided], sel[decided])
    assert bool((margin.max(dim=1).values >= 0).any())  # some lane passes

    # the chosen step's point, defects and rows: the plain pass's own
    # candidates at the pick
    lanes_ = torch.arange(B)
    Zs, cd, g = _host(host_lib, F, inputs, sel)
    assert torch.equal(Zs, Zc[lanes_, sel])
    for got, ref_ in ((cd, cdc[lanes_, sel]), (g, gc[lanes_, sel])):
        assert got.shape == ref_.shape
        assert _rel(got, ref_) <= VAL_TOL


@pytest.mark.parametrize("rule", ["first", "best"])
def test_kernel_route_of_the_trip_matches_the_plain_route(
        host_lib, monkeypatch, rule):
    """``al_sqp._body`` with the kernel route forced on the CPU (the
    source's host build in the launch's place) against the plain route:
    three trips, the same state within float32 noise."""

    def host_launch(nlp, model, m, lanes, *tensors):
        out, args = ls_candidates._pack(nlp, model, m, lanes, *tensors)
        host_lib.host_candidates(model.id, ctypes.byref(args))
        return out

    monkeypatch.setattr(ls_candidates, "_launch", host_launch)
    cfg = tal.SolverConfig(ls_rule=rule)
    F = _funcs(_ocp(), 4, cfg)
    K = copy.copy(F)
    K.line_search = "kernel"
    assert F.line_search == "plain"
    nlp, data = F.nlp, F.data
    st = tal._start(F, cfg, tal.map_lanes(nlp.initial_guess, data),
                    tal.init_multipliers(nlp, data))
    exps = tal._exponents(cfg, F.dtype, F.lb.device)
    a = b = st
    for _ in range(3):
        a = tal._trip(F, cfg, a, exps, tal._active(cfg, a, 10 ** 6))
        b = tal._trip(K, cfg, b, exps, tal._active(cfg, b, 10 ** 6))
    for key in ("Z", "cd", "g", "cost", "lam_def", "mu", "rho", "lm"):
        assert torch.allclose(a[key], b[key], rtol=1e-4, atol=1e-5), key
    for key in ("in_it", "o_it", "tot", "done"):
        assert torch.equal(a[key], b[key]), key
