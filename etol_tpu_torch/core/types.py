"""Shared types: a copy of ``etol_tpu/core/types.py``.

Pure Python, kept apart only because importing the JAX package imports
jax. Every cross-cutting concept is either a **static** Python dataclass
that fixes shapes and counts (:class:`Dims`), or a frozen dataclass of
tensors (:mod:`etol_tpu_torch.core.problem`).
"""
from __future__ import annotations

import dataclasses
import enum


class VarType(enum.IntEnum):
    """Variable kinds, mirroring the reference enum ``var_t``.

    The reference spells integer as ``INTERGER`` (ETOL_Types.hpp:33); we keep
    the canonical spelling and accept both in the XML loader.
    """

    CONTINUOUS = 0
    INTEGER = 1
    BINARY = 2

    @classmethod
    def from_xml(cls, s: str) -> "VarType":
        s = s.strip().upper()
        if s in ("C", "CONTINUOUS"):
            return cls.CONTINUOUS
        if s in ("I", "INTEGER", "INTERGER"):
            return cls.INTEGER
        if s in ("B", "BINARY"):
            return cls.BINARY
        raise ValueError(f"unknown vartype {s!r}")

    def to_xml(self) -> str:
        return {0: "C", 1: "I", 2: "B"}[int(self)]


@dataclasses.dataclass(frozen=True)
class ParamConfig:
    """A custom (auxiliary) variable's configuration.

    Mirrors ``param_configs_t`` (ETOL_Types.hpp:40-46): bounds plus an
    activation window ``[t_start, t_stop]`` in which the variable exists.
    """

    var_type: VarType = VarType.CONTINUOUS
    lower: float = 0.0
    upper: float = 0.0
    t_start: float = 0.0
    t_stop: float = 0.0


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static shape descriptor of a transcribed VGP.

    Variable-count features of the reference (obstacle corners, track
    waypoints) are padded to the maxima recorded here and masked at run
    time.
    """

    nx: int                  # number of states (reference: _nStates)
    nu: int                  # number of controls (reference: _nControls)
    nsteps: int              # N; horizon has N+1 nodes (reference: _nSteps)
    rhorizon: int = 1        # steps clamped to the initial state
    max_ellipses: int = 0    # padded static-obstacle edge-ellipse count
    max_halfspaces: int = 0  # padded per-convex-piece halfplane count
    max_pieces: int = 0      # padded convex-piece count
    max_tracks: int = 0      # padded moving-obstacle count
    max_waypoints: int = 2   # padded waypoints per track
    n_params: int = 0        # auxiliary per-node decision variables

    @property
    def nodes(self) -> int:
        return self.nsteps + 1

    @property
    def node_width(self) -> int:
        """Decision-variable count per node: [x, u, params]."""
        return self.nx + self.nu + self.n_params

    @property
    def nz(self) -> int:
        """Flat decision-vector length."""
        return self.nodes * self.node_width


class Status(enum.IntEnum):
    """Per-problem solve status carried in the batch."""

    RUNNING = 0
    SOLVED = 1
    MAX_ITER = 2
    INFEASIBLE = 3
    DIVERGED = 4
