"""LP-file read / solve / solution-write — eGLPK file-I/O parity.

The port's own copy of ``etol_tpu/io/lp_io.py`` (pure numpy; the port
imports nothing of the JAX package). The reference's eGLPK exposes
``read_lp`` / ``solve_lp`` / ``write_sol`` (eGLPK.cpp:253-272): load a
CPLEX-LP model from disk, solve it, dump the solution. Here
:func:`read_lp` parses the CPLEX-LP dialect written by
:func:`etol_tpu_torch.io.lp_export.write_lp` into dense matrices,
:func:`solve_lp` solves the LP with a self-contained ADMM (host-side
float64 — a file-utility path like the reference's, not the batched
device solver), and :func:`write_sol` mirrors the
``sol_glpk_compact.txt`` dump (eGLPK.cpp:261-264).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_INF = float("inf")


@dataclasses.dataclass
class LPModel:
    """Dense LP: min/max c'x + c0  s.t.  lhs <= A x <= rhs, lb <= x <= ub."""

    names: List[str]
    c: np.ndarray           # [n]
    c0: float               # objective offset (from the dump comment)
    A: np.ndarray           # [m, n]
    lhs: np.ndarray         # [m] row lower bounds (-inf where one-sided)
    rhs: np.ndarray         # [m] row upper bounds (+inf where one-sided)
    lb: np.ndarray          # [n]
    ub: np.ndarray          # [n]
    row_names: List[str]
    maximize: bool = False
    integer: Optional[np.ndarray] = None  # [n] bool (Generals/Binaries)

    @property
    def n(self) -> int:
        return self.c.size

    @property
    def m(self) -> int:
        return self.A.shape[0]


_TERM = re.compile(
    r"([+-])?\s*(\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)?\s*"
    r"([A-Za-z_][A-Za-z0-9_\.]*)"
)
_NUM = r"[+-]?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?|[+-]?\.\d+(?:[eE][+-]?\d+)?"


def _parse_terms(expr: str, index: Dict[str, int], coeffs: Dict[int, float]):
    for sign, num, name in _TERM.findall(expr):
        if name.lower() in ("inf", "infinity"):
            continue
        c = float(num) if num else 1.0
        if sign == "-":
            c = -c
        j = index.setdefault(name, len(index))
        coeffs[j] = coeffs.get(j, 0.0) + c


def read_lp(path_or_text: str) -> LPModel:
    """Parse a CPLEX-LP file (the dialect of ``lp_export.write_lp``, which
    is also what the reference's debug dumps use): sections
    Minimize/Maximize, Subject To, Bounds, General(s), Binar(y|ies), End.
    """
    if "\n" in path_or_text or path_or_text.strip().lower().startswith(
        ("minimize", "maximize", "\\")
    ):
        text = path_or_text
    else:
        with open(path_or_text) as fh:
            text = fh.read()

    c0 = 0.0
    m0 = re.search(r"objective offset\s+(" + _NUM + ")", text)
    if m0:
        c0 = float(m0.group(1))

    # strip comments, split logical lines, normalise sections
    lines = []
    for raw in text.splitlines():
        line = raw.split("\\")[0].strip()
        if line:
            lines.append(line)

    section = None
    maximize = False
    index: Dict[str, int] = {}
    obj: Dict[int, float] = {}
    rows: List[Tuple[str, Dict[int, float], float, float]] = []
    bounds: List[Tuple[str, float, float]] = []
    int_names: List[str] = []
    pending = ""  # constraint continuation buffer

    def flush_row(buf: str):
        if not buf.strip():
            return
        rname = f"r{len(rows)}"
        if ":" in buf:
            rname, buf = buf.split(":", 1)
            rname = rname.strip()
        m = re.search(r"(<=|>=|=)\s*(" + _NUM + r")\s*$", buf)
        if not m:
            raise ValueError(f"cannot parse LP row: {buf!r}")
        op, b = m.group(1), float(m.group(2))
        coeffs: Dict[int, float] = {}
        _parse_terms(buf[: m.start()], index, coeffs)
        lo = b if op in (">=", "=") else -_INF
        hi = b if op in ("<=", "=") else _INF
        rows.append((rname, coeffs, lo, hi))

    for line in lines:
        low = line.lower()
        if low in ("minimize", "maximise", "minimise", "maximize",
                   "subject to", "st", "s.t.", "bounds", "general",
                   "generals", "binary", "binaries", "end"):
            if pending:
                flush_row(pending)
                pending = ""
            if low in ("minimize", "minimise"):
                section = "obj"
            elif low in ("maximize", "maximise"):
                section, maximize = "obj", True
            elif low in ("subject to", "st", "s.t."):
                section = "rows"
            elif low == "bounds":
                section = "bounds"
            elif low in ("general", "generals", "binary", "binaries"):
                section = "ints"
            else:
                section = None
            continue
        if section == "obj":
            expr = line.split(":", 1)[1] if ":" in line else line
            _parse_terms(expr, index, obj)
        elif section == "rows":
            pending += " " + line
            if re.search(r"(<=|>=|=)\s*(" + _NUM + r")\s*$", pending):
                flush_row(pending)
                pending = ""
        elif section == "bounds":
            if low.endswith(" free"):
                name = line.rsplit(None, 1)[0]
                bounds.append((name, -_INF, _INF))
                continue
            m = re.match(
                r"^(" + _NUM + r")\s*<=\s*(\S+)\s*<=\s*(" + _NUM + r")$",
                line,
            )
            if m:
                bounds.append(
                    (m.group(2), float(m.group(1)), float(m.group(3)))
                )
                continue
            m = re.match(r"^(\S+)\s*=\s*(" + _NUM + r")$", line)
            if m:
                v = float(m.group(2))
                bounds.append((m.group(1), v, v))
                continue
            m = re.match(r"^(\S+)\s*<=\s*(" + _NUM + r")$", line)
            if m:
                bounds.append((m.group(1), -_INF, float(m.group(2))))
                continue
            m = re.match(r"^(" + _NUM + r")\s*<=\s*(\S+)$", line)
            if m:
                bounds.append((m.group(2), float(m.group(1)), _INF))
                continue
            m = re.match(r"^(\S+)\s*>=\s*(" + _NUM + r")$", line)
            if m:
                bounds.append((m.group(1), float(m.group(2)), _INF))
                continue
            raise ValueError(f"cannot parse bound line: {line!r}")
        elif section == "ints":
            int_names.extend(line.split())
    if pending:
        flush_row(pending)

    n = len(index)
    names = [None] * n
    for name, j in index.items():
        names[j] = name
    c = np.zeros(n)
    for j, v in obj.items():
        c[j] = v
    A = np.zeros((len(rows), n))
    lhs = np.full(len(rows), -_INF)
    rhs = np.full(len(rows), _INF)
    row_names = []
    for i, (rname, coeffs, lo, hi) in enumerate(rows):
        row_names.append(rname)
        for j, v in coeffs.items():
            A[i, j] = v
        lhs[i], rhs[i] = lo, hi
    # LP default bounds: x >= 0 unless overridden
    lb = np.zeros(n)
    ub = np.full(n, _INF)
    for name, lo, hi in bounds:
        j = index.get(name)
        if j is None:
            continue
        lb[j], ub[j] = lo, hi
    integer = np.zeros(n, dtype=bool)
    for name in int_names:
        j = index.get(name)
        if j is not None:
            integer[j] = True
    return LPModel(
        names=names, c=c, c0=c0, A=A, lhs=lhs, rhs=rhs, lb=lb, ub=ub,
        row_names=row_names, maximize=maximize, integer=integer,
    )


@dataclasses.dataclass
class LPSolution:
    x: np.ndarray
    obj: float
    status: str           # "optimal" | "max_iter" | "infeasible"
    iterations: int
    pri_res: float
    dua_res: float


def solve_lp(
    model: LPModel,
    max_iter: int = 20000,
    eps: float = 1e-7,
    rho: float = 10.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
) -> LPSolution:
    """Solve the LP with dense ADMM (OSQP-style splitting, P = 0).

    Host-side float64: this mirrors the reference's CPU utility path
    (``glp_simplex`` behind solve_lp, eGLPK.cpp:266-270), not the batched
    device solver. Box bounds ride as extra identity rows.
    """
    n, m = model.n, model.m
    sign = -1.0 if model.maximize else 1.0
    q = sign * model.c.astype(np.float64)

    # stack [A; I] so boxes and rows share the projection
    Af = np.vstack([model.A, np.eye(n)])
    lo = np.concatenate([model.lhs, model.lb])
    hi = np.concatenate([model.rhs, model.ub])
    M = m + n

    # per-row scaling keeps rho meaningful across mixed units
    rnorm = np.maximum(np.linalg.norm(Af, axis=1), 1e-9)
    Af = Af / rnorm[:, None]
    lo = lo / rnorm
    hi = hi / rnorm

    KKT = sigma * np.eye(n) + rho * (Af.T @ Af)
    try:
        Lc = np.linalg.cholesky(KKT)
    except np.linalg.LinAlgError:
        return LPSolution(np.zeros(n), np.nan, "infeasible", 0, np.inf,
                          np.inf)

    import scipy.linalg as sla  # scipy is a baked-in dependency

    def kkt_solve(b):
        z = sla.solve_triangular(Lc, b, lower=True)
        return sla.solve_triangular(Lc.T, z, lower=False)

    x = np.zeros(n)
    z = np.clip(Af @ x, lo, hi)
    y = np.zeros(M)
    it = 0
    pri = dua = np.inf
    for it in range(1, max_iter + 1):
        rhs_x = sigma * x - q + Af.T @ (rho * z - y)
        x_new = kkt_solve(rhs_x)
        Ax = Af @ x_new
        z_new = np.clip(alpha * Ax + (1 - alpha) * z + y / rho, lo, hi)
        y = y + rho * (alpha * Ax + (1 - alpha) * z - z_new)
        x, z = x_new, z_new
        if it % 25 == 0:
            pri = float(np.max(np.abs(Ax - z)))
            dua = float(np.max(np.abs(q + sigma * 0.0 + Af.T @ y)))
            if pri < eps and dua < eps * (1.0 + np.max(np.abs(q))):
                break
    obj = float(model.c @ x) + model.c0
    status = "optimal" if pri < 10 * eps else "max_iter"
    return LPSolution(x=x, obj=obj, status=status, iterations=it,
                      pri_res=pri, dua_res=dua)


def write_sol(model: LPModel, sol: LPSolution, path: str) -> str:
    """Compact solution dump — ``sol_glpk_compact.txt`` parity
    (eGLPK.cpp:261-264): status, objective, then one ``name value`` row
    per variable."""
    lines = [
        f"status {sol.status}",
        f"objective {sol.obj:.9g}",
        f"iterations {sol.iterations}",
    ]
    for name, v in zip(model.names, sol.x):
        lines.append(f"{name} {v:.9g}")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as fh:
        fh.write(text)
    return path
