"""The PyTorch port imports no jax and nothing of the JAX package, and its
CPU main path (seeds, staged solve, audit, warm re-solve) runs end to end
at a small size."""
import ast
import dataclasses
import pathlib

import pytest
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


# every module of the port; a new module is added here with its slice
MODULES = [
    "__init__", "bench_harness", "bench_scaling", "cli", "kernel_ab",
    "optimizer",
    "core/__init__", "core/_native", "core/device", "core/geometry",
    "core/problem", "core/trajectory", "core/types", "core/xml_io",
    "io/__init__", "io/checkpoint", "io/lp_export", "io/lp_io",
    "models/__init__", "models/dynamics", "models/fleet", "models/problems",
    "models/tuned",
    "ops/__init__", "ops/bt_cuda", "ops/cyclic_reduction", "ops/graph_loop",
    "ops/hs_coupling", "ops/ls_candidates", "ops/tally",
    "parallel/__init__", "parallel/axis", "parallel/distributed",
    "parallel/dryrun", "parallel/horizon", "parallel/kkt", "parallel/mesh",
    "parallel/solve_sharded",
    "solve/__init__", "solve/al_sqp", "solve/branch_bound",
    "solve/btridiag", "solve/options", "solve/planners", "solve/refine",
    "solve/shooting", "solve/side_branch", "solve/trip_graph",
    "transcribe/__init__", "transcribe/collocation", "transcribe/nlp",
    "transcribe/obstacles", "utils/__init__", "utils/profiling",
    "viz/__init__", "viz/plots",
]


def test_module_list_is_complete():
    found = sorted(str(f.relative_to(PORT))[:-3] for f in PORT.rglob("*.py"))
    assert found == sorted(MODULES)


@pytest.mark.parametrize("module", MODULES + ["../chip_smoke"])
def test_module_imports_torch_side_only(module):
    """Per module, function-level imports included: nothing of jax or of
    the JAX package, and no import relative to a package above the
    port's."""
    path = (PORT / f"{module}.py").resolve()
    mods = list(_imported_modules(path))
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "etol_tpu", "flax",
                                  "optax")]
    assert not bad, bad
    depth = len(path.relative_to(PORT.parent).parts) - 1
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            assert node.level <= depth, (module, node.module, node.level)


def test_shipped_configs_are_the_references_bytes():
    """The port keeps its own copies of the shipped XML problems (it
    reads nothing of the JAX package), and they are the same files."""
    ours = sorted((PORT / "configs").glob("*.xml"))
    theirs = sorted((PORT.parent / "etol_tpu" / "configs").glob("*.xml"))
    assert [f.name for f in ours] == [f.name for f in theirs]
    assert len(ours) == 2
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_cpu_main_path_runs():
    # uas_2d cut to 12 steps of 0.4 s with a near goal; the registry's
    # seeds, solver config and warm phase
    B = 4
    vgp, nlp = problems.uas_2d(nsteps=12, dt=0.4, xf=(4.0, 3.0, 0.0))
    nlp = dataclasses.replace(nlp, obstacle_form="pieces")
    data, _ = vgp.to_device(device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(0)
    batch = bench_harness.make_batch(nlp, data, B, gen)
    assert batch.x0.shape == (B, 3)
    assert float((batch.x0[:, :2]).abs().max()) <= 0.5
    cfg, stages = tuned.tuned_config("uas_2d", batch=B)
    before = bt_cuda.TALLY.count
    cold = bench_harness.run_cold(nlp, cfg, batch, stages, gen)
    assert bt_cuda.TALLY.count == before  # CPU tensors: the plain version
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
