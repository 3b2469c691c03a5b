"""Vehicle dynamics, the problems built on them (single vehicles and the
deconflicted multi-vehicle fleet of :mod:`.fleet`) and measured solver
configs.

Counterpart of ``etol_tpu/models``, with the same public names.
"""

from . import dynamics
from .problems import (
    canonical_mip_2d,
    canonical_ocp_2d,
    composed_exact_demo,
    double_integrator_2d,
    fixed_wing_3dof,
    point_mass_3d,
    uas_2d,
)
from .tuned import tuned_config, warm_config

__all__ = [
    "dynamics",
    "canonical_mip_2d",
    "canonical_ocp_2d",
    "composed_exact_demo",
    "double_integrator_2d",
    "point_mass_3d",
    "uas_2d",
    "fixed_wing_3dof",
    "tuned_config",
    "warm_config",
]
