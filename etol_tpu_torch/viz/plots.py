"""Matplotlib plotting/animation with reference-parity entry points.

The port's own copy of ``etol_tpu/viz/plots.py``. All functions accept
trajectories as ``(times [K], values [K, d])`` pairs (the array form of
the reference's ``traj_t``), as numpy arrays or tensors on any device
(converted to numpy here), and return the Figure (or the saved path for
animations); pass ``show=True`` for interactive use, ``save=path`` to
write a file — headless-safe (Agg).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import animation as _anim  # noqa: E402
from matplotlib.patches import Circle, Polygon as MplPolygon  # noqa: E402


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def _finish(fig, show: bool, save: Optional[str]):
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig


def plot_x(traj, idx: int = 0, show=False, save=None):
    """plotX parity (TrajectoryOptimizer.cpp:227-253): state idx vs t."""
    times, vals = _np(traj[0]), _np(traj[1])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(times, vals[:, idx], "o-", ms=3)
    ax.set_xlabel("time [s]")
    ax.set_ylabel(f"x{idx}")
    ax.set_title(f"State {idx}")
    ax.grid(True, alpha=0.3)
    return _finish(fig, show, save)


def plot_u(traj, idx: int = 0, show=False, save=None):
    """plotU parity (TrajectoryOptimizer.cpp:255-281)."""
    times, vals = _np(traj[0]), _np(traj[1])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.step(times, vals[:, idx], where="post")
    ax.set_xlabel("time [s]")
    ax.set_ylabel(f"u{idx}")
    ax.set_title(f"Control {idx}")
    ax.grid(True, alpha=0.3)
    return _finish(fig, show, save)


def plot_xy(traj, show=False, save=None):
    """plotXY parity (TrajectoryOptimizer.cpp:283-311): state-0 vs
    state-1 path."""
    _, vals = traj
    vals = _np(vals)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(vals[:, 0], vals[:, 1], "o-", ms=3)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title("Trajectory")
    ax.grid(True, alpha=0.3)
    ax.set_aspect("equal", adjustable="datalim")
    return _finish(fig, show, save)


def _draw_zones(ax, obstacles: Sequence, tracks: Sequence = ()):
    for poly in obstacles or ():
        ax.add_patch(
            MplPolygon(
                np.asarray(poly)[:, :2],
                closed=True,
                facecolor="crimson",
                alpha=0.4,
                edgecolor="darkred",
            )
        )
    for trk in tracks or ():
        pts = np.asarray(trk.points)[:, :2]
        ax.plot(pts[:, 0], pts[:, 1], "--", color="gray", lw=1)
        for p in pts:
            ax.add_patch(
                Circle(p, trk.radius, facecolor="none", edgecolor="orange")
            )


def plot_xy_with_zones(
    traj, obstacles: Sequence, tracks: Sequence = (), show=False, save=None
):
    """plotXY_wExclZones parity (TrajectoryOptimizer.cpp:313-422):
    path + obstacle polygons (+ track waypoint circles)."""
    _, vals = traj
    vals = _np(vals)
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_zones(ax, obstacles, tracks)
    ax.plot(vals[:, 0], vals[:, 1], "o-", ms=3, zorder=3)
    ax.plot(vals[0, 0], vals[0, 1], "g^", ms=10, zorder=4, label="start")
    ax.plot(vals[-1, 0], vals[-1, 1], "r*", ms=12, zorder=4, label="goal")
    ax.legend(loc="best")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.grid(True, alpha=0.3)
    ax.set_aspect("equal", adjustable="datalim")
    return _finish(fig, show, save)


def animate2d(
    traj,
    obstacles: Sequence = (),
    tracks: Sequence = (),
    save: str = "animation.mp4",
    fps: int = 10,
):
    """animate2D parity (TrajectoryOptimizer.cpp:424-624): animated 2D
    path with moving-obstacle circles interpolated along their waypoint
    schedules. Writes mp4 when ffmpeg is present, else an animated GIF
    (Pillow), else a PNG frame strip directory. Returns the written path.
    """
    times, vals = _np(traj[0]), _np(traj[1])
    K = len(times)
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_zones(ax, obstacles)
    (line,) = ax.plot([], [], "b-", lw=2)
    (dot,) = ax.plot([], [], "bo", ms=8)
    circles = []
    for trk in tracks or ():
        c = Circle(
            np.asarray(trk.points[0])[:2],
            trk.radius,
            facecolor="orange",
            alpha=0.5,
        )
        ax.add_patch(c)
        circles.append((c, np.asarray(trk.times), np.asarray(trk.points)))
    lo = vals[:, :2].min(axis=0) - 1
    hi = vals[:, :2].max(axis=0) + 1
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_aspect("equal")

    def frame(k):
        line.set_data(vals[: k + 1, 0], vals[: k + 1, 1])
        dot.set_data([vals[k, 0]], [vals[k, 1]])
        t = times[k]
        for c, tt, pts in circles:
            x = np.interp(t, tt, pts[:, 0])
            y = np.interp(t, tt, pts[:, 1])
            c.center = (x, y)
        return [line, dot] + [c for c, _, _ in circles]

    ani = _anim.FuncAnimation(fig, frame, frames=K, blit=True)
    try:
        if save.endswith(".mp4"):
            ani.save(save, writer="ffmpeg", fps=fps)
        else:
            ani.save(save, writer="pillow", fps=fps)
    except (ValueError, RuntimeError, FileNotFoundError):
        # no ffmpeg: fall back to GIF via pillow
        save = save.rsplit(".", 1)[0] + ".gif"
        ani.save(save, writer="pillow", fps=fps)
    plt.close(fig)
    return save
