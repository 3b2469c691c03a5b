"""A configuration's problem as plain numbers, read from the benchmark's own
files: the configuration's JSON and, where it names one, the ETOL XML beside
it.

Nothing here imports the program. The check (``check.py``) works every
number it compares out again from this description and from the inputs the
harness handed the program. Its dynamics and its collocation scheme are
files of their own, named by the configuration: ``dynamics/<name>.py``
(``f(x, u, params)``, float64 plain PyTorch) and ``schemes/<name>.py``
(``defects(f, X, U, dt)``) in the reference's directory.
"""
from __future__ import annotations

import dataclasses
import json
import os
import xml.etree.ElementTree as ET

REFERENCE_DIR = os.path.dirname(os.path.abspath(__file__))
CONFIG_DIR = os.path.join(os.path.dirname(REFERENCE_DIR), "configs")


@dataclasses.dataclass(frozen=True)
class Track:
    """A moving circular exclusion zone: ``radius`` around a centre that
    moves linearly between ``points`` at ``times`` (end segments
    extrapolated)."""

    radius: float
    times: tuple
    points: tuple


@dataclasses.dataclass(frozen=True)
class Problem:
    """One direct-collocation problem: node k holds (x_k, u_k), k = 0..N."""

    nsteps: int
    dt: float
    x0: tuple
    xf: tuple
    xtol: tuple
    x_lower: tuple
    x_upper: tuple
    u_lower: tuple
    u_upper: tuple
    dynamics: str          # a file of <reference_dir>/dynamics
    scheme: str            # a file of <reference_dir>/schemes
    cost_weights: tuple    # running cost sum_i w_i u_i^2, trapezoid rule
    polygons: tuple        # static zones: tuples of (x, y) corners
    tracks: tuple          # moving zones: Track
    params: object = None  # the dynamics' third argument, as the file has it
    pos_dims: int = 2      # the states a zone row holds: the position
    reference_dir: str = REFERENCE_DIR

    @property
    def nx(self) -> int:
        return len(self.x0)

    @property
    def nu(self) -> int:
        return len(self.u_lower)

    @property
    def nodes(self) -> int:
        return self.nsteps + 1


def load_config(name: str, config_dir: str = CONFIG_DIR) -> dict:
    """The configuration file ``<config_dir>/<name>.json``."""
    with open(os.path.join(config_dir, f"{name}.json")) as fh:
        return json.load(fh)


def _boxes(centers, half):
    return tuple(((cx - half, cy - half), (cx + half, cy - half),
                  (cx + half, cy + half), (cx - half, cy + half))
                 for cx, cy in centers)


def _from_xml(path: str, **common) -> Problem:
    root = ET.parse(path).getroot()

    def floats(nodes, attr):
        return tuple(float(n.get(attr)) for n in nodes)

    states = root.find("states").findall("state")
    controls = root.find("controls").findall("control")
    polygons = tuple(
        tuple((float(c.get("x")), float(c.get("y")))
              for c in border.findall("corner"))
        for border in root.find("exzones").findall("border"))
    tracks = tuple(
        Track(float(t.get("radius")),
              tuple(float(w.get("t")) for w in t.findall("waypoint")),
              tuple(tuple(float(d.text) for d in w.findall("datum"))
                    for w in t.findall("waypoint")))
        for t in root.find("mexzones").findall("track"))
    return Problem(
        nsteps=int(root.get("nsteps")), dt=float(root.get("dt")),
        x0=floats(states, "initial"), xf=floats(states, "terminal"),
        xtol=floats(states, "tolerance"),
        x_lower=floats(states, "lower"), x_upper=floats(states, "upper"),
        u_lower=floats(controls, "lower"), u_upper=floats(controls, "upper"),
        polygons=polygons, tracks=tracks, **common)


def problem_of(config: dict, config_dir: str = CONFIG_DIR,
               reference_dir: str = REFERENCE_DIR) -> Problem:
    """The problem a configuration runs: its ``problem`` numbers, or the
    XML file it names (``problem.xml``, beside the configuration). Its
    optional ``params`` go to the dynamics, and ``pos_dims`` (2 where it
    has none) says how many states a zone row holds."""
    spec = config["problem"]
    common = dict(dynamics=spec["dynamics"], scheme=spec["scheme"],
                  cost_weights=tuple(spec["cost_weights"]),
                  params=spec.get("params"),
                  pos_dims=spec.get("pos_dims", 2),
                  reference_dir=reference_dir)
    if "xml" in spec:
        return _from_xml(os.path.join(config_dir, spec["xml"]), **common)
    return Problem(
        nsteps=spec["nsteps"], dt=spec["dt"], x0=tuple(spec["x0"]),
        xf=tuple(spec["xf"]), xtol=tuple(spec["xtol"]),
        x_lower=tuple(spec["x_lower"]), x_upper=tuple(spec["x_upper"]),
        u_lower=tuple(spec["u_lower"]), u_upper=tuple(spec["u_upper"]),
        polygons=_boxes(spec["obstacle_centers"], spec["obstacle_half"]),
        tracks=(), **common)
