"""Problem core: types, geometry, VGP dataclasses, trajectories, XML I/O.

Counterpart of ``etol_tpu/core``, with the same public names.
"""

from . import geometry, trajectory
from .problem import VGP, VGPData, ObstacleData, Track, TrackData, stack
from .types import Dims, ParamConfig, Status, VarType
from .xml_io import load_configs, save_configs

__all__ = [
    "geometry",
    "trajectory",
    "VGP",
    "VGPData",
    "ObstacleData",
    "Track",
    "TrackData",
    "Dims",
    "ParamConfig",
    "Status",
    "VarType",
    "load_configs",
    "save_configs",
    "stack",
]
