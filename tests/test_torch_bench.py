"""The port's bench harness on the CPU at a small size: the timed cold and
warm batches, the single-problem MPC re-solve, and the JSON line of
``main`` (the keys of the JAX bench's line, without its TPU north star).
The numbers here are CPU times and say nothing of the card; what is
checked is the structure, the counts and the statuses."""
import dataclasses
import json

import pytest
import torch

from etol_tpu_torch import bench_harness
from etol_tpu_torch.models.tuned import warm_config

torch.set_num_threads(1)

# uas_2d at its own dt and goal needs ~25 steps to reach the goal at all
NSTEPS, B = 30, 4

EXTRAS = {
    "device", "batch", "nsteps", "obstacle_form", "audit_node_depth_max",
    "audit_midseg_depth_max", "solved_fraction",
    "raw_solves_per_s_per_chip", "warm_solves_per_s_per_chip",
    "warm_solved_fraction", "p50_mpc_latency_ms", "p50_mpc_device_ms",
    "stage_trip_counts",
}


def test_main_prints_one_json_line(capsys, monkeypatch):
    # two MPC re-solves instead of the bench's 20, to keep the test short
    run_mpc = bench_harness.run_mpc
    monkeypatch.setattr(bench_harness, "run_mpc",
                        lambda *a: run_mpc(*a, steps=2))
    line = bench_harness.main([
        "--batch", str(B), "--nsteps", str(NSTEPS), "--iters", "1",
        "--device", "cpu"])
    out, err = capsys.readouterr()
    assert out.count("\n") == 1
    parsed = json.loads(out)
    assert parsed == line
    assert set(parsed) == {"metric", "value", "unit", "extras"}
    assert "vs_baseline" not in parsed
    assert parsed["metric"] == "uas2d_n50_solved_solves_per_s_per_chip"
    assert parsed["unit"] == "solves/s/chip"
    ex = parsed["extras"]
    assert set(ex) == EXTRAS
    assert (ex["device"], ex["batch"], ex["nsteps"]) == ("cpu", B, NSTEPS)
    assert ex["obstacle_form"] == "pieces"
    assert len(ex["stage_trip_counts"]) == 4
    assert 0.0 <= ex["solved_fraction"] <= 1.0
    assert parsed["value"] == pytest.approx(
        ex["raw_solves_per_s_per_chip"] * ex["solved_fraction"], rel=0.02,
        abs=0.02)
    assert ex["p50_mpc_latency_ms"] > 0 and ex["p50_mpc_device_ms"] > 0
    assert ex["audit_node_depth_max"] <= 1e-3
    # the detail goes to stderr
    assert "SOLVED solves/s/chip" in err and "MPC re-solve" in err
    assert "2 dispatched back to back" in err


def test_bench_takes_an_mpc_result_already_made(monkeypatch):
    """A caller that has just run ``run_mpc`` hands its result over and
    the bench does not measure it again."""
    nlp, cfg, _, _, _ = bench_harness.prepare(1, NSTEPS, "cpu")
    single = bench_harness.single_problem(NSTEPS, "cpu")
    mpc = bench_harness.run_mpc(nlp, cfg, single, steps=2)

    def refuse(*a, **k):
        raise AssertionError("the bench ran the MPC re-solve again")

    monkeypatch.setattr(bench_harness, "run_mpc", refuse)
    line = bench_harness.bench(2, NSTEPS, 1, "cpu", mpc=mpc)
    assert line["extras"]["p50_mpc_latency_ms"] == round(mpc["p50_ms"], 3)
    assert line["extras"]["p50_mpc_device_ms"] == round(
        mpc["pipelined_ms"], 3)


def test_run_mpc_resolves_warm():
    nlp, cfg, _, _, _ = bench_harness.prepare(1, NSTEPS, "cpu")
    single = bench_harness.single_problem(NSTEPS, "cpu")
    assert single.x0.shape == (3,)
    out = bench_harness.run_mpc(nlp, cfg, single, steps=3)
    assert out["cold"].z.shape == (nlp.dims.nz,)
    assert out["finite"] and len(out["statuses"]) == 3
    assert out["statuses"].count(1) >= 2
    assert out["p50_ms"] > 0 and out["pipelined_ms"] > 0


def test_timed_batches_count_solved_lanes_only():
    nlp, cfg, stages, data, gen = bench_harness.prepare(B, NSTEPS, "cpu")
    single = bench_harness.single_problem(NSTEPS, "cpu")
    cold = bench_harness.run_cold_timed(nlp, cfg, single, B, stages,
                                        iters=1)
    assert cold["solves_per_s"] == pytest.approx(
        B * cold["solved_fraction"] / cold["batch_s"])
    assert cold["raw_solves_per_s"] == pytest.approx(B / cold["batch_s"])
    first = bench_harness.run_cold(nlp, cfg, data, stages, gen)
    cfg_w, stages_w = warm_config(cfg, batch=B)
    warm = bench_harness.run_warm_timed(
        nlp, cfg_w, data, first["result"], stages_w, iters=2)
    assert warm["solved_fraction"] >= first["solved_fraction"] - 0.25
    assert warm["solves_per_s"] == pytest.approx(
        B * warm["solved_fraction"] / warm["batch_s"])
    # the drift is applied to copies: the batch itself is unchanged
    again = bench_harness.prepare(B, NSTEPS, "cpu")[3]
    assert torch.equal(data.x0, again.x0)
    assert dataclasses.is_dataclass(first["result"])


def test_tuned_uas_quality_no_drift():
    """The port's counterpart of the JAX package's uas quality guard
    (``tests/test_models.py::test_tuned_uas_quality_no_drift``): on the
    bench's batch of scattered problems, the registry uas config (pieces
    containment, the registry's seeds, its cumulative budget) lands
    objectives within 2% of a fat-budget reference solve of the same
    transcription on the mean, and within 10% on any lane."""
    from etol_tpu_torch.models import tuned
    from etol_tpu_torch.models.problems import uas_2d
    from etol_tpu_torch.solve import al_sqp, shooting

    B = 16
    vgp, nlp = uas_2d(nsteps=50)
    ex = tuned.tuned_extras("uas_2d")
    nlp = dataclasses.replace(nlp, obstacle_form=ex["obstacle_form"])
    data, _ = vgp.to_device(device="cpu")
    gen = torch.Generator().manual_seed(5)
    bdata = bench_harness.make_batch(nlp, data, B, gen)
    cfg, stages = tuned.tuned_config("uas_2d", batch=B, kkt_solver="scan")
    z0 = shooting.plan_guess(nlp, bdata, ex["seed_walks"], gen,
                             pulled=ex["seed_pulled"])
    # cumulative budget (the stage ladder's shapes mean nothing at B=16)
    cum = cfg.max_total + sum(b for _, b in stages)
    res = al_sqp.solve_batched(
        nlp, dataclasses.replace(cfg, max_total=cum), bdata, z0)
    assert res.status.tolist() == [1] * B
    ref = al_sqp.solve_batched(
        nlp, dataclasses.replace(cfg, max_total=600, rho0=1000.0,
                                 rho_growth=2.0), bdata, z0)
    ok = ref.status == 1
    assert int(ok.sum()) >= B - 1
    r, f = res.obj[ok], ref.obj[ok]
    assert float(r.mean() / f.mean()) <= 1.02, (float(r.mean()),
                                               float(f.mean()))
    assert float((r / f).max()) <= 1.10, float((r / f).max())
