"""A configuration joins the benchmark as new files alone: the program's
entry, the check's dynamics and scheme are files found by the names the
configuration gives, and a checkout with a new configuration's files added
runs it through the harness, on one device with no process started and no
process group made."""
import os

import pytest
import torch

from perfbench import draws, entries, harness, ranks
from perfbench.reference import check
from perfbench.reference.problem import Problem, load_config, problem_of


def _old_dynamics(name, x, u):
    """The check's formulas before they moved to files of their own."""
    if name == "unicycle":
        return torch.stack([u[..., 0] * torch.cos(x[..., 2]),
                            u[..., 0] * torch.sin(x[..., 2]),
                            u[..., 1]], dim=-1)
    return u[..., :x.shape[-1]]


def _old_defects(dynamics, scheme, dt, X, U):
    x0, x1, u0, u1 = X[:, :-1], X[:, 1:], U[:, :-1], U[:, 1:]
    f0 = _old_dynamics(dynamics, x0, u0)
    f1 = _old_dynamics(dynamics, x1, u1)
    if scheme == "trapezoidal":
        return x1 - x0 - 0.5 * dt * (f0 + f1)
    xm = 0.5 * (x0 + x1) + (dt / 8.0) * (f0 - f1)
    fm = _old_dynamics(dynamics, xm, 0.5 * (u0 + u1))
    return x1 - x0 - (dt / 6.0) * (f0 + 4.0 * fm + f1)


@pytest.mark.parametrize("dynamics,nx", [("unicycle", 3),
                                         ("single_integrator", 2)])
@pytest.mark.parametrize("scheme", ["trapezoidal", "hermite_simpson"])
def test_moved_dynamics_and_schemes_give_the_old_numbers(dynamics, nx,
                                                         scheme):
    gen = torch.Generator().manual_seed(2 ** 31 + 21)
    X = torch.randn((5, 12, nx), generator=gen, dtype=torch.float64)
    U = torch.randn((5, 12, 2), generator=gen, dtype=torch.float64)
    prob = Problem(nsteps=11, dt=0.3, x0=(0.0,) * nx, xf=(1.0,) * nx,
                   xtol=(0.1,) * nx, x_lower=(-5.0,) * nx,
                   x_upper=(5.0,) * nx, u_lower=(-2.0, -2.0),
                   u_upper=(2.0, 2.0), dynamics=dynamics, scheme=scheme,
                   cost_weights=(1.0, 1.0), polygons=(), tracks=())
    assert torch.equal(check._dynamics(prob, X, U),
                       _old_dynamics(dynamics, X, U))
    assert torch.equal(check._defects(prob, X, U),
                       _old_defects(dynamics, scheme, 0.3, X, U))


def test_an_unknown_model_name_is_refused():
    prob = Problem(nsteps=2, dt=0.1, x0=(0.0,), xf=(1.0,), xtol=(0.1,),
                   x_lower=(-1.0,), x_upper=(1.0,), u_lower=(-1.0,),
                   u_upper=(1.0,), dynamics="no_such_model",
                   scheme="trapezoidal", cost_weights=(1.0,), polygons=(),
                   tracks=())
    with pytest.raises(ValueError, match="no reference dynamics"):
        check._defects(prob, torch.zeros(1, 3, 1, dtype=torch.float64),
                       torch.zeros(1, 3, 1, dtype=torch.float64))


def test_the_cells_entries_resolve_from_their_files():
    bench = harness.load_benchmark()
    needs = {("fleet", "cold"): ("batch",), ("fleet", "warm"): ("warm",),
             ("episodes", None): ("episode", "tick")}
    for cell in bench["workloads"]:
        config = load_config(cell["config"])
        t = draws.load_traffic(cell["traffic"])
        name = config["entry"]
        assert os.path.exists(harness.bench_path(harness.ROOT, "entries",
                                                 f"{name}.py"))
        cls = entries.load(name)
        assert isinstance(cls.synced, bool)
        for method in needs[t["loop"], t.get("start")]:
            assert callable(getattr(cls, method)), (cell["name"], method)
        # the configurations name the pos_dims and params they keep
        prob = problem_of(config)
        assert prob.pos_dims == 2 and prob.params is None


#: a configuration a later change could bring: the port's 2D double
#: integrator, cold fleets through its batched solve, no zone
DI_ENTRY = '''"""The port's 2D double integrator: cold fleets through its batched
solve."""
import dataclasses

import torch


class Entry:
    synced = False

    def __init__(self, config, traffic, device, group, config_dir):
        from etol_tpu_torch.core.problem import batch_tile
        from etol_tpu_torch.models.problems import double_integrator_2d
        from etol_tpu_torch.solve.al_sqp import SolverConfig

        p = config["problem"]
        vgp, self.nlp = double_integrator_2d(
            nsteps=p["nsteps"], dt=p["dt"], x0=tuple(p["x0"]),
            xf=tuple(p["xf"]), obstacle_centers=p["obstacle_centers"])
        self.single = vgp.to_device(device=torch.device(device))[0]
        self.base = batch_tile(self.single, traffic["batch"])
        self.cfg = SolverConfig(max_total=config["solver"]["max_total"])

    @property
    def x0(self):
        return self.single.x0

    @property
    def xf(self):
        return self.single.xf

    def batch(self, x0, xf, seeds, spans, k):
        from etol_tpu_torch.solve import al_sqp

        with spans("perfbench.solve", k):
            return al_sqp.solve_batched(
                self.nlp, self.cfg,
                dataclasses.replace(self.base, x0=x0, xf=xf))
'''
DI_DYNAMICS = '''"""The double integrator: x = (px, py, vx, vy), u = force."""
import torch


def f(x, u, params):
    return torch.cat([x[..., 2:4], u[..., :2] / params["mass"]], dim=-1)
'''
DI_CONFIG = {
    "name": "di2d_n8", "source": "https://github.com/olasanni1/ETOL",
    "reduced": [], "entry": "di2d_port",
    "problem": {"nsteps": 8, "dt": 0.5, "x0": [0.0, 0.0, 0.0, 0.0],
                "xf": [5.0, 4.0, 0.0, 0.0], "xtol": [0.05, 0.05, 0.1, 0.1],
                "x_lower": [-10.0, -10.0, -3.0, -3.0],
                "x_upper": [10.0, 10.0, 3.0, 3.0], "u_lower": [-2.0, -2.0],
                "u_upper": [2.0, 2.0], "obstacle_centers": [],
                "obstacle_half": 0.6, "dynamics": "double_integrator",
                "params": {"mass": 1.0}, "scheme": "hermite_simpson",
                "cost_weights": [1.0, 1.0]},
    "solver": {"max_total": 400},
    "limits": {"defect": 1e-3, "bound": 1e-4, "zone_depth": 0.0,
               "obj_gap": 1e-4, "stationarity": 1e-2}}
DI_TRAFFIC = {"loop": "fleet", "start": "cold", "batch": 2,
              "x0_offset": {"low": [-0.2, -0.2, 0.0, 0.0],
                            "high": [0.2, 0.2, 0.0, 0.0]},
              "xf_offset": None}


def test_a_configuration_of_new_files_runs_on_one_device_alone(
        checkout, monkeypatch):
    import subprocess

    import torch.distributed as dist

    checkout.add("entries/di2d_port.py", DI_ENTRY)
    checkout.add("reference/dynamics/double_integrator.py", DI_DYNAMICS)
    checkout.add_json("configs/di2d_n8.json", DI_CONFIG)
    checkout.add_json("traffic/di2d_cold.json", DI_TRAFFIC)
    checkout.add("metrics/solved_solves_per_s.di2d.py",
                 '"""solved_solves_per_s in the di2d cell."""\n\n\n'
                 'def read(ctx):\n'
                 '    return ctx.metric("solved_solves_per_s")\n')
    checkout.add_entries(
        configs=[{"name": "di2d_n8", "source": DI_CONFIG["source"],
                  "file": "perfbench/configs/di2d_n8.json", "reduced": [],
                  "why": "a double integrator"}],
        workloads=[{"name": "di2d_fleet_cold", "config": "di2d_n8",
                    "traffic": "di2d_cold", "chips": 1,
                    "why": "cold fleets of two lanes"}],
        end_to_end=[{"name": "solved_solves_per_s.di2d",
                     "unit": "solves/s", "better": "higher", "bound": 0.12,
                     "source": "host_clock",
                     "workloads": ["di2d_fleet_cold"]}])

    def refused(*a, **kw):
        raise AssertionError("a one-device cell started a process or a group")

    monkeypatch.setattr(subprocess, "Popen", refused)
    monkeypatch.setattr(dist, "init_process_group", refused)
    line = ranks.run("di2d_fleet_cold", 2 ** 31 + 77, 0.0, False, 1, "cpu",
                     root=checkout.root)
    assert not dist.is_initialized()
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] == 2 and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"setup_s", "solved_solves_per_s.di2d"}
    assert line["metrics"]["solved_solves_per_s.di2d"]["value"] > 0
    assert set(line["compared"]) == {"defect", "bound", "obj_gap",
                                     "stationarity", "nonfinite"}
    assert checkout.edited() == []
