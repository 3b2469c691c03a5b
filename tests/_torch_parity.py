"""Helpers of the port's parity tests: the JAX package's problem data
carried into the port, both packages' Hessian blocks at one seeded
point, and a dispatch mode that records host reads."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from etol_tpu.solve import al_sqp as jal
from etol_tpu_torch.core import problem as tproblem
from etol_tpu_torch.solve import al_sqp as tal


def carry_data(jv, tv):
    """The JAX leaves carried into the port, and the port's own
    to_device: the same numbers."""
    jd, _ = jv.to_device()
    td = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jd)], device="cpu")
    own, _ = tv.to_device(device="cpu")
    for a, b in zip(tproblem.tree_flatten(td), tproblem.tree_flatten(own)):
        assert torch.equal(a, b)
    return jd, td


def lane(t):
    return tal.tree_map(lambda a: a[None], t)


def blocks_both(jn, jd, tn, td, hessian="defect", seed=3):
    """D and O of both packages at one seeded point."""
    rng = np.random.default_rng(seed)
    K, w, nx = jn.dims.nodes, jn.dims.node_width, jn.dims.nx
    jcfg = jal.SolverConfig(hessian=hessian)
    tcfg = tal.SolverConfig(hessian=hessian)
    m_eq, m_in = jal._result_sizes(jn, jd)
    Z = (np.asarray(jn.initial_guess(jd)).reshape(K, w)
         + rng.normal(scale=0.2, size=(K, w))).astype(np.float32)
    lam_def = rng.normal(scale=0.5, size=(K - 1, nx)).astype(np.float32)
    lam_eq = rng.normal(scale=0.5, size=(K, m_eq)).astype(np.float32)
    mu = np.abs(rng.normal(scale=0.5, size=(K, m_in))).astype(np.float32)
    rho, lm = np.float32(100.0), np.float32(1e-3)
    free = np.ones((K, w), bool)
    free[0, :nx] = False
    JF = jal._ALFuncs(jn, jcfg, jd)
    g = np.asarray(JF.residuals(jnp.asarray(Z))[2])
    jD, jO = JF.gn_blocks(*(jnp.asarray(a) for a in (
        Z, lam_def, lam_eq, mu, rho, free, lm, g)))
    TF = tal._ALFuncs(tn, tcfg, lane(td))
    tD, tO = TF.gn_blocks(*(torch.from_numpy(np.asarray(a))[None] for a in (
        Z, lam_def, lam_eq, mu, rho, free, lm, g)))
    # residuals and the exact gradient through the whole window
    jres = JF.residuals(jnp.asarray(Z))
    tres = TF.residuals(torch.from_numpy(Z)[None])
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-5)
    jgrad = JF.al_grad(*(jnp.asarray(a) for a in (
        Z, lam_def, lam_eq, mu, rho)))
    tgrad = TF.al_grad(*(torch.from_numpy(np.asarray(a))[None] for a in (
        Z, lam_def, lam_eq, mu, rho)))
    np.testing.assert_allclose(tgrad[0].numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-4)
    return tD[0].numpy(), tO[0].numpy(), np.asarray(jD), np.asarray(jO)




def uas_batch(B=8, seed=0, nsteps=12):
    """Both packages' uas_2d (pieces containment, ``nsteps`` of 0.4 s to a
    near goal) on the same batch of B problems whose starts and goals are
    scattered by a seeded numpy draw: (jnlp, jdata, tnlp, tdata)."""
    import dataclasses

    from etol_tpu.core import problem as jproblem
    from etol_tpu.models import problems as jproblems
    from etol_tpu_torch.models import problems as tproblems

    kw = dict(nsteps=nsteps, dt=0.4, xf=(4.0, 3.0, 0.0))
    jv, jnlp = jproblems.uas_2d(**kw)
    jnlp = dataclasses.replace(jnlp, obstacle_form="pieces")
    _, tnlp = tproblems.uas_2d(**kw)
    tnlp = dataclasses.replace(tnlp, obstacle_form="pieces")
    jdata, _ = jv.to_device()
    rng = np.random.default_rng(seed)
    off = np.zeros((2, B, 3), np.float32)
    off[:, :, :2] = rng.uniform(-0.5, 0.5, size=(2, B, 2))
    jb = jproblem.batch_tile(jdata, B)
    jb = dataclasses.replace(jb, x0=jnp.asarray(off[0]),
                             xf=jb.xf + jnp.asarray(off[1]))
    tb = tproblem.vgpdata_from_numpy(
        [np.asarray(a) for a in jax.tree.leaves(jb)], device="cpu")
    return jnlp, jb, tnlp, tb


class HostReads(TorchDispatchMode):
    """Records the ops of a captured body (a solver trip, the seeds, a
    planner) that would read the device from the host, or copy host data
    to it, under a CUDA graph's capture."""

    READS = ("_local_scalar_dense", "item", "nonzero", "lift_fresh",
             "lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if name in self.READS:
            self.seen.append(str(func))
        elif name == "_to_copy" and kwargs.get("device") is not None and \
                src is not None and kwargs["device"] != src.device:
            self.seen.append(f"{func} {src.device} -> {kwargs['device']}")
        elif name == "copy_" and args[0].device != args[1].device:
            self.seen.append(f"{func} {args[1].device} -> {args[0].device}")
        return func(*args, **kwargs)
