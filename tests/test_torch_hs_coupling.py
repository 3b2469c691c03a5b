"""The Hermite–Simpson step coupling's kernel (``ops/hs_coupling.py``,
``csrc/hs_coupling.cu``) on the CPU: which problems the solver routes to
it, the wrapper's checks and counters, and the kernel's per-step
arithmetic built by the host's C++ compiler against the plain version
(``_ALFuncs._pair_coupling``). The kernel itself runs on the card only,
where ``chip_smoke.py`` holds it against the plain version at every
shape the paths launch."""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.models import dynamics
from etol_tpu_torch.models import problems as tproblems
from etol_tpu_torch.ops import hs_coupling
from etol_tpu_torch.solve import al_sqp as tal

torch.set_num_threads(1)

CUDA = torch.device("cuda")


def _uas(nsteps=12):
    return tproblems.uas_2d(nsteps=nsteps)


def _unicycle_body(x, u, t, data):
    return torch.stack(
        [u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]), u[1]])


def _variant(name):
    """uas_2d's NLP changed in one respect, and the device it runs on."""
    _, nlp = _uas()
    rep = dataclasses.replace
    return {
        "kernel": (nlp, torch.float32, CUDA),
        "cpu": (nlp, torch.float32, torch.device("cpu")),
        "float64": (nlp, torch.float64, CUDA),
        "trapezoidal": (rep(nlp, scheme="trapezoidal"), torch.float32, CUDA),
        "euler": (rep(nlp, scheme="euler"), torch.float32, CUDA),
        "radau": (rep(nlp, scheme="radau"), torch.float32, CUDA),
        "delayed": (rep(nlp, x_delay=1), torch.float32, CUDA),
        "params": (rep(nlp, dims=rep(nlp.dims, n_params=1)), torch.float32,
                   CUDA),
        "user_lambda": (rep(nlp, dynamics=_unicycle_body), torch.float32,
                        CUDA),
        "other_model": (rep(nlp, dynamics=dynamics.double_integrator),
                        torch.float32, CUDA),
    }[name]


@pytest.mark.parametrize("name", [
    "kernel", "cpu", "float64", "trapezoidal", "euler", "radau", "delayed",
    "params", "user_lambda", "other_model"])
def test_route_from_the_input(name):
    nlp, dtype, device = _variant(name)
    assert hs_coupling.takes(nlp, dtype, device) == (name == "kernel")


def _batch(nlp_vgp, B, dtype=torch.float32):
    vgp, nlp = nlp_vgp
    data, _ = vgp.to_device(device="cpu")
    data = tproblem.batch_tile(data, B)
    return nlp, data.astype(dtype)


def test_cpu_solver_takes_the_plain_route_and_launches_nothing():
    launches = hs_coupling.TALLY.count, dict(hs_coupling.TALLY.by)
    nlp, data = _batch(_uas(), 3)
    F = tal._ALFuncs(nlp, tal.SolverConfig(), data)
    assert F.coupling == "plain"
    Z, lam_def, rho = _point(F, np.random.default_rng(0))
    B, K, w = Z.shape
    m_eq, m_in = tal._result_sizes(nlp, data)
    g = F.residuals(Z)[2]
    D, O = F.gn_blocks(Z, lam_def, torch.zeros(B, K, m_eq),
                       torch.zeros(B, K, m_in), rho,
                       torch.ones(B, K, w, dtype=torch.bool),
                       torch.full((B,), 1e-3), g)
    assert torch.isfinite(D).all() and torch.isfinite(O).all()
    assert (hs_coupling.TALLY.count, hs_coupling.TALLY.by) == launches


def _args(B=2, K=6, device="meta", **change):
    kw = dict(Z=torch.empty(B, K, 5, device=device),
              lam=torch.empty(B, K - 1, 3, device=device),
              rho=torch.empty(B, device=device),
              cs=torch.empty(B, 3, device=device),
              dt=torch.empty(B, device=device))
    kw.update(change)
    return kw


@pytest.mark.parametrize("change, error", [
    (dict(Z=torch.empty(2, 6, 5, dtype=torch.float64, device="meta")),
     TypeError),
    (dict(Z=torch.empty(2, 6, 4, device="meta")), ValueError),
    (dict(Z=torch.empty(12, 5, device="meta")), ValueError),
    (dict(lam=torch.empty(2, 6, 3, device="meta")), ValueError),
    (dict(rho=torch.empty(2, 1, device="meta")), ValueError),
    (dict(cs=torch.empty(2, 5, device="meta")), ValueError),
    (dict(dt=torch.empty(3, device="meta")), ValueError),
    (dict(Z=torch.empty(2, 5, 6, device="meta").transpose(1, 2)),
     ValueError),
    (dict(dt=torch.empty(2)), ValueError),
    (dict(lam=np.zeros((2, 5, 3), np.float32)), TypeError),
    ({}, ValueError),
])
def test_wrapper_checks_before_any_launch(change, error):
    launches = hs_coupling.TALLY.count, dict(hs_coupling.TALLY.by)
    with pytest.raises(error):
        hs_coupling.coupling(dynamics.unicycle, **_args(**change))
    assert (hs_coupling.TALLY.count, hs_coupling.TALLY.by) == launches


def test_wrapper_refuses_cpu_tensors_and_other_dynamics():
    with pytest.raises(ValueError, match="CUDA"):
        hs_coupling.coupling(dynamics.unicycle, **_args(device="cpu"))
    with pytest.raises(ValueError, match="no device code"):
        hs_coupling.coupling(_unicycle_body, **_args())
    assert hs_coupling.TALLY.count == 0


def test_captured_launches_count_at_each_replay(monkeypatch):
    monkeypatch.setattr(hs_coupling.TALLY, "by", {})
    with hs_coupling.TALLY.recording() as record:
        hs_coupling.TALLY.add((51, 5, 64))
    assert record == {(51, 5, 64): 1} and hs_coupling.TALLY.count == 0
    hs_coupling.TALLY.replayed(record, 7)
    hs_coupling.TALLY.add((51, 5, 1))
    assert hs_coupling.TALLY.count == 8
    assert hs_coupling.TALLY.by == {(51, 5, 64): 7, (51, 5, 1): 1}


def test_cost_counts_each_tensor_once():
    B, K, w, nx = 2048, 51, 5, 3
    flops, nbytes = hs_coupling.cost(K, w, nx, B)
    tensors = (B * K * w, B * (K - 1) * nx, B, B * nx, B,
               B * K * w * w, B * (K - 1) * w * w)
    assert nbytes == 4 * sum(tensors)
    assert flops > 0 and flops % (B * (K - 1)) == 0


# ---- the kernel's arithmetic, built for the host --------------------------

_HOST_LOOP = r"""
#include "%(source)s"
// Dc and O over a batch, a step at a time: the kernel's step_coupling
// without its block's exchange and staging.
extern "C" void host_coupling(const float* Z, const float* lam,
                              const float* rho, const float* cs,
                              const float* dt, float* Dc, float* O, int K,
                              int B, int exact) {
  using namespace etol_hs;
  using M = Unicycle;
  constexpr int NX = M::NX, W = NX + M::NU, WW = W * W, TW = tri(W);
  for (long long i = 0; i < (long long)B * K * WW; ++i) Dc[i] = 0.0f;
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k + 1 < K; ++k) {
      float Daa[TW], Dbb[TW], Oab[WW];
      const float* z0 = Z + ((long long)b * K + k) * W;
      const float* l = lam + ((long long)b * (K - 1) + k) * NX;
      const float h = dt[b];
      if (exact) {
        step_coupling<M, true>(z0, z0 + W, l, cs + b * NX, rho[b], h,
                               (float)k * h, Daa, Dbb, Oab);
      } else {
        step_coupling<M, false>(z0, z0 + W, l, cs + b * NX, rho[b], h,
                                (float)k * h, Daa, Dbb, Oab);
      }
      float* d0 = Dc + ((long long)b * K + k) * WW;
      for (int r = 0; r < W; ++r) {
        for (int q = 0; q < W; ++q) {
          d0[r * W + q] += Daa[sym(W, r, q)];
          d0[WW + r * W + q] += Dbb[sym(W, r, q)];
        }
      }
      float* o = O + ((long long)b * (K - 1) + k) * WW;
      for (int i = 0; i < WW; ++i) o[i] = Oab[i];
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The source's arithmetic compiled by the host's C++ compiler (no
    nvcc: everything but the kernel and its launch)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler builds the kernel's arithmetic"
    d = tmp_path_factory.mktemp("hs_host")
    src = d / "hs_host.cpp"
    src.write_text(_HOST_LOOP % dict(source=hs_coupling._SOURCE))
    lib = d / "libhs_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    out.host_coupling.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
    return out


def _point(F, rng):
    """Z drawn inside the bounds, multipliers, and rho from the solver's
    rho0 range up to rho_max."""
    Z = torch.from_numpy(rng.uniform(F.lb.numpy(), F.ub.numpy())
                         .astype(np.float32))
    B, K, _ = Z.shape
    lam = torch.from_numpy(
        rng.uniform(-50.0, 50.0, (B, K - 1, 3)).astype(np.float32))
    rho = torch.from_numpy(np.exp(rng.uniform(
        np.log(10.0), np.log(1e5), B)).astype(np.float32))
    return Z, lam, rho


@pytest.mark.parametrize("hessian", ["defect", "gn", "full"])
def test_host_build_of_the_arithmetic_matches_the_plain_version(
        host_lib, hessian):
    nlp, data = _batch(_uas(), 5)
    F = tal._ALFuncs(nlp, tal.SolverConfig(hessian=hessian), data)
    Z, lam, rho = _point(F, np.random.default_rng(7))
    Dr, Or = F._lanes(F._pair_coupling, F.cscale, Z, lam, rho)
    B, K, w = Z.shape
    Dc, O = torch.empty(B, K, w, w), torch.empty(B, K - 1, w, w)
    cs, dt = F.cscale.contiguous(), data.dt.contiguous()
    host_lib.host_coupling(Z.data_ptr(), lam.data_ptr(), rho.data_ptr(),
                           cs.data_ptr(), dt.data_ptr(), Dc.data_ptr(),
                           O.data_ptr(), K, B, int(hessian != "gn"))
    # float32 in another order of operations: the chip check's limit
    for got, ref in ((Dc, Dr), (O, Or)):
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
