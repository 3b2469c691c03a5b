"""Reference solver-option surfaces mapped onto :class:`SolverConfig`.

The reference exposes per-backend tuning knobs: ePSOPT pokes the PSOPT
``algorithm`` struct (IPOPT tolerance/iterations/collocation/mesh
refinement, ePSOPT.cpp:62-72 and etol_psopt_example1.cpp:86-99), eDymos
configures pyOptSparse IPOPT/SNOPT plus Radau transcription order and a
refine-iteration limit (eDymos.cpp:409-466; setters eDymos.hpp:108-125).
Users migrating from those backends carry option dictionaries in those
dialects; this module translates them into the native knobs so existing
tuning intent survives the switch. A copy of
``etol_tpu/solve/options.py`` over the port's ``SolverConfig`` (host
Python only).

Anything without a meaningful equivalent is *accepted and recorded* (not
an error — the reference also silently ignores options the installed
solver build doesn't support) and reported via the returned hints so the
caller can see what was and wasn't mapped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from .al_sqp import SolverConfig

# option-name → handler; each handler mutates the cfg-field dict / hints
_SCHEME_MAP = {
    # collocation dialects → native schemes. Radau segments (eDymos,
    # eDymos.cpp:443-466) map to the native compressed Radau IIA(3)
    # scheme; Legendre/Chebyshev global pseudospectral and
    # Gauss-Lobatto segments become the matching-order Lobatto scheme
    # (Hermite-Simpson); trapezoidal maps 1:1.
    "legendre": "hermite_simpson",
    "chebyshev": "hermite_simpson",
    "radau": "radau",
    "gauss-lobatto": "hermite_simpson",
    "hermite-simpson": "hermite_simpson",
    "trapezoidal": "trapezoidal",
}

_HESSIAN_MAP = {
    # ePSOPT sets algorithm.hessian = "exact" (ePSOPT.cpp:67)
    "exact": "full",
    "limited-memory": "gn",
    "bfgs": "gn",
}


def nlp_config(
    options: Dict[str, Any],
    base: Optional[SolverConfig] = None,
) -> Tuple[SolverConfig, Dict[str, Any]]:
    """Translate a reference-dialect option dict into a SolverConfig.

    Accepts the union of the dialects (keys are case-insensitive;
    unknown keys are recorded in ``hints["ignored"]``):

    * PSOPT algorithm fields: ``nlp_tolerance``, ``nlp_iter_max_count``,
      ``collocation_method``, ``hessian``, ``mesh_refinement`` /
      ``mr_max_iterations``, ``nodes``
    * IPOPT options (eDymos opt_settings): ``tol``, ``max_iter``,
      ``mu_init``, ``acceptable_tol``, ``print_level``
    * Dymos optimizer fields: ``optimizer`` (IPOPT/SNOPT — accepted, the
      native AL-SQP serves both roles), ``transcription``,
      ``transcription_order``, ``refine_iteration_limit``,
      ``num_segments``

    Returns ``(config, hints)`` where hints carries transcription-level
    outcomes the config cannot hold: ``scheme``, ``nsteps``,
    ``refine_levels``, ``optimizer``, and ``ignored`` (keys with no
    equivalent).
    """
    base = base or SolverConfig()
    fields: Dict[str, Any] = {}
    hints: Dict[str, Any] = {"ignored": []}

    for raw_key, val in options.items():
        key = raw_key.strip().lower()
        if key in ("nlp_tolerance", "tol"):
            # IPOPT's tol is a KKT tolerance; split it into the pair.
            # f32 floors both (the reference runs f64 IPOPT at 1e-6;
            # SolverConfig docs why 1e-4/5e-4 are the f32 floors).
            fields["tol_cons"] = max(float(val), 1e-4)
            fields["tol_stat"] = max(5.0 * float(val), 5e-4)
        elif key in ("nlp_iter_max_count", "max_iter"):
            fields["max_inner"] = int(val)
        elif key in ("collocation_method", "transcription"):
            m = _SCHEME_MAP.get(str(val).strip().lower())
            if m is None:
                hints["ignored"].append(raw_key)
            else:
                hints["scheme"] = m
        elif key == "hessian":
            m = _HESSIAN_MAP.get(str(val).strip().lower())
            if m is None:
                hints["ignored"].append(raw_key)
            else:
                fields["hessian"] = m
        elif key in (
            "mesh_refinement",
            "mr_max_iterations",
            "refine_iteration_limit",
        ):
            # adaptive refinement → the fixed bucketed ladder
            # (solve/refine.py); the iteration limit bounds the rungs
            lvl = int(val) if not isinstance(val, bool) else (
                3 if val else 1
            )
            hints["refine_levels"] = max(1, min(lvl, 6))
        elif key in ("nodes", "num_segments"):
            hints["nsteps"] = int(val)
        elif key == "transcription_order":
            # Radau order-3 segments = the native radau scheme; higher
            # orders are served by a denser mesh instead. An explicit
            # collocation_method in the same dict wins regardless of
            # dict iteration order.
            hints.setdefault("scheme", "radau")
            if int(val) > 3:
                hints.setdefault("refine_levels", 2)
        elif key == "mu_init":
            # IPOPT barrier init ↔ AL penalty init (inverse roles: big
            # rho ~ small mu); keep the user's scale intent
            mu = float(val)
            if mu > 0:
                fields["rho0"] = float(
                    min(max(1.0 / mu, 1.0), 1e4)
                )
        elif key == "optimizer":
            # IPOPT/SNOPT both collapse onto the native AL-SQP; record
            # the request for debug dumps (setOptimizer parity,
            # eDymos.hpp:108)
            hints["optimizer"] = str(val).upper()
        elif key in ("print_level", "acceptable_tol", "derivative_test",
                     "linear_solver"):
            hints["ignored"].append(raw_key)
        else:
            hints["ignored"].append(raw_key)

    cfg = dataclasses.replace(base, **fields)
    return cfg, hints
