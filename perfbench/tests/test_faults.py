"""Whole runs on the CPU at a test's size, the harness's look for a chip
skipped: sound, every number within its limit; with the timed path broken
underneath (a solve that returns its start unchanged, half the batch left
out, one answer altered where it is produced), ``correct`` false; and the
check's control (the window's outputs in bfloat16) rejected.

A fault of optimality returns feasible answers with their true cost, so
that only ``stationarity`` can see it: a solver that optimises another
cost (the second control's weight 4 times the configuration's). On a card
(``chip``) it runs at the cell's own size and prints what the check
reads.

The real solves are cached by their inputs, so that the faults' runs of a
cell pay for each distinct solve once."""
import dataclasses
import functools
import json

import pytest
import torch

from perfbench import draws, harness

SEED = 2 ** 31 + 4242
#: the cells at a test's size: lanes a batch, rescued lanes, ticks, chain
SMALL = {"batch": 4, "rescue_lanes": 1, "ticks": 2, "chain": 2, "bases": 2,
         "pool": 3}
_CACHE = {}


def _traffic(cell):
    bench = harness.load_benchmark()
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    t = draws.load_traffic(spec["traffic"])
    return bench, {k: SMALL.get(k, v) for k, v in t.items()}


def _run(cell, seconds=0.0, control=False):
    bench, t = _traffic(cell)
    return harness.run(cell, SEED, seconds, False, device="cpu", bench=bench,
                       traffic=t, control=control)


def _cached(real):
    """``real`` with its results kept by its inputs' bytes."""
    @functools.wraps(real)
    def solve(nlp, cfg, data, *args, **kw):
        key = (real.__name__, cfg.max_total, data.x0.numpy().tobytes(),
               data.xf.numpy().tobytes(),
               data.tracks.times.numpy().tobytes())
        if key not in _CACHE:
            _CACHE[key] = real(nlp, cfg, data, *args, **kw)
        return _CACHE[key]
    return solve


def _start(args, kw, res):
    """The start a solve was handed (its z0), or zeros where it had none."""
    z0 = kw.get("z0", args[0] if args else None)
    return torch.zeros_like(res.z) if z0 is None else z0.reshape(res.z.shape)


def _broken(fault, real):
    cached = _cached(real)

    def solve(nlp, cfg, data, *args, **kw):
        res = cached(nlp, cfg, data, *args, **kw)
        z, status = res.z.clone(), res.status.clone()
        if fault == "unchanged":
            z = _start(args, kw, res).clone()
        elif fault == "half":
            n = z.shape[0]
            z[n // 2:] = z[: n - n // 2]
            status[n // 2:] = status[: n - n // 2]
        elif fault == "altered":
            z.view(-1)[7] += 0.05
        return dataclasses.replace(res, z=z,
                                   status=torch.ones_like(status))
    return solve


def _reweighted(nlp):
    """``nlp`` with the second control's cost weight 4 times its own."""
    cost = nlp.running_cost

    def running_cost(x, u, t, d, *p):
        return cost(x, torch.cat([u[:1], 2.0 * u[1:]]), t, d, *p)
    return dataclasses.replace(nlp, running_cost=running_cost)


def _reweighted_solver(real):
    """``real`` run on another cost, its objective the true cost of its
    answer: feasible, and optimal for a cost the configuration does not
    state."""
    from etol_tpu_torch.core.problem import map_lanes

    def solve(nlp, cfg, data, *args, **kw):
        res = real(_reweighted(nlp), cfg, data, *args, **kw)
        if res.z.dim() == 1:
            obj = nlp.score(res.z, data)
        else:
            obj = map_lanes(lambda dat, zz: nlp.score(zz, dat), data, res.z)
        return dataclasses.replace(res, obj=obj)
    return solve


ENTRY = {"uas2d_fleet_cold": "solve_batched_staged",
         "uas2d_fleet_warm": "solve_batched_staged",
         "ocp2d_fleet_rescue": "solve_batched_rescue",
         "ocp2d_mpc_tick": "solve"}
CASES = [(c, f) for c in ENTRY for f in ("unchanged", "half", "altered")
         if not (c == "ocp2d_mpc_tick" and f == "half")]


@pytest.mark.parametrize("cell", list(ENTRY))
def test_sound_run_is_correct_and_its_control_is_not(cell, monkeypatch,
                                                     capsys):
    from etol_tpu_torch.solve import al_sqp

    name = ENTRY[cell]
    monkeypatch.setattr(al_sqp, name, _cached(getattr(al_sqp, name)))
    line = _run(cell, control=True)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in line["compared"].values())
    err = capsys.readouterr().err
    control = json.loads(err.split("control (outputs in bfloat16): ")
                                 [1].splitlines()[0])
    assert any(c["value"] > c["limit"] for c in control.values())


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from etol_tpu_torch.solve import al_sqp

    name = ENTRY[cell]
    monkeypatch.setattr(al_sqp, name, _broken(fault, getattr(al_sqp, name)))
    line = _run(cell)
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.parametrize("cell", list(ENTRY))
def test_solver_on_another_cost_is_not_correct(cell, monkeypatch):
    from etol_tpu_torch.solve import al_sqp

    name = ENTRY[cell]
    monkeypatch.setattr(al_sqp, name,
                        _reweighted_solver(getattr(al_sqp, name)))
    line = _run(cell)
    c = line["compared"]
    assert not line["correct"]
    assert c["stationarity"]["value"] > c["stationarity"]["limit"]
    # feasible, and the cost it reports is its answer's: nothing else fails
    assert all(v["value"] <= v["limit"] for k, v in c.items()
               if k != "stationarity")


@pytest.mark.chip
@pytest.mark.parametrize("cell", list(ENTRY))
def test_solver_on_another_cost_on_the_card(cell, monkeypatch):
    """At the cell's own size, a short window on three seeds: not correct
    on any; prints what the check reads."""
    import torch as _torch

    if not _torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from etol_tpu_torch.solve import al_sqp

    name = ENTRY[cell]
    monkeypatch.setattr(al_sqp, name,
                        _reweighted_solver(getattr(al_sqp, name)))
    built = harness.Cell(cell, "cuda:0")
    built.build()
    for seed in (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903):
        line = harness.run(cell, seed, 4.0, False, device="cuda:0",
                           cell=built)
        print(f"another cost, {cell} seed {seed}: correct "
              f"{line['correct']} compared {json.dumps(line['compared'])}",
              flush=True)
        assert not line["correct"]
