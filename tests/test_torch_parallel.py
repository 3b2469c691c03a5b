"""Port parity: meshes, the batch-sharded solve and the horizon-sharded
evaluators, on the CPU (the multichip dry-run and ``cli fleet_batch``:
tests/test_torch_dryrun.py).

The port has no fake devices: a mesh of ``["cpu"] * 8`` is eight entries
of one CPU, the batch chunks that share it solved as one batch and the
horizon slabs stacked on it (parallel/axis.py::SlabAxis). The JAX side
runs over 8 fake CPU devices (tests/conftest.py), as tests/test_parallel.py
runs it. Tolerances are tests/test_parallel.py's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_parity import carry_data
from etol_tpu.models import problems as jproblems
from etol_tpu.parallel import horizon as jhz
from etol_tpu_torch.core.problem import batch_tile
from etol_tpu_torch.models import problems
from etol_tpu_torch.parallel import (horizon as hz, make_mesh,
                                     shard_batch, solve_sharded)
from etol_tpu_torch.solve.al_sqp import SolverConfig, solve_batched

torch.set_num_threads(1)


def test_make_mesh():
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.shape == {"batch": 8} and not mesh.processes
    mesh = make_mesh(["cpu"] * 8, (4, 2), ("batch", "horizon"))
    assert mesh.shape == {"batch": 4, "horizon": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_batch_sharded_solve_matches_single_device():
    vgp, nlp = problems.canonical_ocp_2d()
    data, _ = vgp.to_device(device="cpu")
    B = 8
    x0s = torch.tensor([[1.0 + 0.03 * i, 2.0] for i in range(B)])
    bdata = dataclasses.replace(batch_tile(data, B), x0=x0s)
    cfg = SolverConfig(max_outer=6, max_inner=15)

    res_local = solve_batched(nlp, cfg, bdata)
    mesh = make_mesh(["cpu"] * 8)
    chunks = shard_batch(bdata, mesh)
    assert len(chunks) == 8 and all(c.x0.shape == (1, 2) for c in chunks)
    res_shard = solve_sharded(nlp, cfg, bdata, mesh)
    np.testing.assert_allclose(res_local.obj.numpy(), res_shard.obj.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(res_local.z.numpy(), res_shard.z.numpy(),
                               atol=1e-3)
    with pytest.raises(ValueError, match="must divide"):
        shard_batch(bdata, make_mesh(["cpu"] * 3))


def _evaluator_setup():
    """uas_2d, K=16, in both packages, at one Z (initial guess plus a
    fixed wiggle), and both meshes (1 x 8 for JAX, 8 horizon entries)."""
    jv, jnlp = jproblems.uas_2d(nsteps=15, dt=0.4)
    tv, tnlp = problems.uas_2d(nsteps=15, dt=0.4)
    jdata, tdata = carry_data(jv, tv)
    K = tv.dims().nodes
    Z = np.asarray(jnlp.initial_guess(jdata)).reshape(K, -1)
    Z = (Z + 0.01 * np.sin(np.arange(Z.size)).reshape(Z.shape)).astype(
        np.float32)
    jmesh = Mesh(np.array(jax.devices()).reshape(1, 8),
                 ("batch", "horizon"))
    mesh = make_mesh(["cpu"] * 8, (1, 8), ("batch", "horizon"))
    Zs = jax.device_put(Z, NamedSharding(jmesh, P("horizon", None)))
    return (jnlp, jdata, jmesh, Zs), (tnlp, tdata, mesh), Z


def test_horizon_sharded_defects_match_the_reference():
    (jnlp, jdata, jmesh, Zs), (tnlp, tdata, mesh), Z = _evaluator_setup()
    with jmesh:
        jdefs = np.asarray(jhz.sharded_defects(jnlp, jdata, jmesh,
                                               "horizon")(Zs, jdata))
    defs = hz.sharded_defects(tnlp, tdata, mesh, "horizon")(
        torch.from_numpy(Z)).numpy()
    assert defs.shape == jdefs.shape == (16, 3)
    np.testing.assert_allclose(defs, jdefs, atol=1e-5)
    np.testing.assert_allclose(
        defs[:-1], tnlp.step_defects(torch.from_numpy(Z).reshape(-1),
                                     tdata).numpy(), atol=1e-5)
    np.testing.assert_allclose(defs[-1], 0.0, atol=1e-7)


def test_horizon_sharded_al_pieces_match_the_reference():
    (jnlp, jdata, jmesh, Zs), (tnlp, tdata, mesh), Z = _evaluator_setup()
    with jmesh:
        jcost, jviol = jhz.sharded_al_pieces(jnlp, jdata, jmesh,
                                             "horizon")(Zs, jdata)
    cost, viol = hz.sharded_al_pieces(tnlp, tdata, mesh, "horizon")(
        torch.from_numpy(Z))
    assert float(cost) == pytest.approx(float(jcost), rel=1e-5)
    assert float(viol) == pytest.approx(float(jviol), rel=1e-5, abs=1e-7)
    z = torch.from_numpy(Z).reshape(-1)
    assert float(cost) == pytest.approx(float(tnlp.objective(z, tdata)),
                                        rel=1e-5)
