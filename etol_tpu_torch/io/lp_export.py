"""LP-format transcription dump — the debug() artifact parity.

Counterpart of ``etol_tpu/io/lp_export.py``. Every reference backend
dumps its solver model for inspection (``debug_glpk.lp``, eGLPK.cpp:258;
``debug.lp``, eGurobi.cpp:127, eSCIP.cpp:75). The smooth solver's
analog: the NLP *linearized at a point* as a CPLEX-LP text file —
objective gradient, Jacobian rows of every defect, equality and
inequality, and the variable boxes — with the reference's variable
naming scheme ``x_t_s`` / ``u_t_s`` (eGLPK.cpp:103-124). The derivatives
come from ``torch.func.grad`` and ``torch.func.jacfwd``; the text is the
JAX package's dialect, line for line.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import grad, jacfwd

from ..core.problem import VGPData
from ..core.trajectory import to_host
from ..transcribe.nlp import NLP


def _terms(coeffs, names, tol=1e-10):
    parts = []
    for c, n in zip(coeffs, names):
        c = float(c)
        if abs(c) < tol:
            continue
        sign = "+" if c >= 0 else "-"
        parts.append(f"{sign} {abs(c):.6g} {n}")
    if not parts:
        return "0 x_0_0"
    out = " ".join(parts)
    return out[2:] if out.startswith("+ ") else out


def write_lp(
    nlp: NLP,
    data: VGPData,
    z: Optional[torch.Tensor] = None,
    path: Optional[str] = None,
) -> str:
    """Serialize the linearization of the transcribed problem at ``z``
    (default: the initial guess) for one problem (``data`` without a lane
    axis, on any device). Returns the LP text; writes to ``path`` when
    given."""
    d = nlp.dims
    if z is None:
        z = nlp.initial_guess(data)
    K = d.nodes

    names = []
    for k in range(K):
        names += [f"x_{k}_{s}" for s in range(d.nx)]
        names += [f"u_{k}_{s}" for s in range(d.nu)]

    def jac(fn):
        # forward mode may promote to float64 (see al_sqp._jacfwd); the
        # rows stay in z's dtype, as the JAX package's do
        return to_host(jacfwd(fn)(z, data).to(z.dtype))

    g_obj = to_host(grad(nlp.objective)(z, data))
    obj0 = float(nlp.objective(z, data))

    c_eq = to_host(nlp.eq_residuals(z, data))
    J_eq = jac(nlp.eq_residuals)
    g_in = to_host(nlp.ineq_residuals(z, data))
    J_in = jac(nlp.ineq_residuals)
    lb, ub = (to_host(a) for a in nlp.bounds(data))
    zh = to_host(z)

    lines = [
        f"\\ etol-tpu transcription dump (linearized at z0; "
        f"objective offset {obj0:.6g})",
        f"\\ nodes={K} nx={d.nx} nu={d.nu} scheme={nlp.scheme}",
        "Minimize",
        f" obj: {_terms(g_obj, names)}",
        "Subject To",
    ]
    n_def = d.nsteps * d.nx
    for i in range(J_eq.shape[0]):
        if i < n_def:
            t, s = divmod(i, d.nx)
            rname = f"defect_{t}_{s}"
        else:
            rname = f"eq_{i - n_def}"
        rhs = float(np.dot(J_eq[i], zh)) - float(c_eq[i])
        lines.append(f" {rname}: {_terms(J_eq[i], names)} = {rhs:.6g}")
    m_node = J_in.shape[0] // K if K else 0
    for i in range(J_in.shape[0]):
        t, j = divmod(i, m_node) if m_node else (0, i)
        rhs = float(np.dot(J_in[i], zh)) - float(g_in[i])
        lines.append(
            f" ineq_{t}_{j}: {_terms(J_in[i], names)} <= {rhs:.6g}"
        )
    lines.append("Bounds")
    for n, lo, hi in zip(names, lb, ub):
        if lo == hi:
            lines.append(f" {n} = {lo:.6g}")
        else:
            lines.append(f" {lo:.6g} <= {n} <= {hi:.6g}")
    lines.append("End")
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text
