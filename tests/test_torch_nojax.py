"""The PyTorch port imports no jax and nothing of the JAX package, and its
CPU main path (seeds, staged solve, audit, warm re-solve) runs end to end
at a small size."""
import ast
import dataclasses
import pathlib

import torch

from etol_tpu_torch import bench_harness
from etol_tpu_torch.models import problems, tuned
from etol_tpu_torch.ops import bt_cuda

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "etol_tpu_torch"
CHIP_SMOKE = PORT.parent / "chip_smoke.py"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [CHIP_SMOKE]
    assert len(files) > 10
    offenders = {
        str(f.relative_to(PORT.parent)): m
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in ("jax", "jaxlib", "etol_tpu")
    }
    assert not offenders, offenders


def test_cpu_main_path_runs():
    # uas_2d cut to 12 steps of 0.4 s with a near goal; the registry's
    # seeds, solver config and warm phase
    B = 4
    vgp, nlp = problems.uas_2d(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))
    nlp = dataclasses.replace(nlp, obstacle_form="pieces")
    data, _ = vgp.to_device(device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = bench_harness.make_batch(nlp, data, B, gen)
    assert batch.x0.shape == (B, 3)
    assert float((batch.x0[:, :2]).abs().max()) <= 0.5
    cfg, stages = tuned.tuned_config("uas_2d", batch=B)
    before = bt_cuda.LAUNCHES
    cold = bench_harness.run_cold(nlp, cfg, batch, stages, gen)
    assert bt_cuda.LAUNCHES == before  # CPU tensors: the plain version
    assert len(cold["stage_trips"]) == 1 + len(stages)
    assert cold["solved_fraction"] >= 0.75
    assert cold["audit_node_depth_max"] <= 1e-3
    cfg_w, stages_w = tuned.warm_config(cfg, batch=B)
    drifted = dataclasses.replace(batch, x0=batch.x0 + 0.01)
    warm = bench_harness.run_warm(nlp, cfg_w, drifted, cold["result"],
                                  stages_w)
    assert warm["solved_fraction"] >= cold["solved_fraction"] - 0.25
    z = warm["result"].z
    assert z.shape == (B, nlp.dims.nz) and bool(torch.isfinite(z).all())
