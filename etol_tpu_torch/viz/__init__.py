"""Visualization: plots and 2D animation.

Matplotlib replaces the reference's gnuplot-iostream pipelines
(``plot/plotX/plotU/plotXY/plotXY_wExclZones``,
TrajectoryOptimizer.cpp:203-422) and its PNG+ffmpeg animation
(``animate2D``, :424-624). Entry points mirror the reference names.
"""

from .plots import (
    animate2d,
    plot_u,
    plot_x,
    plot_xy,
    plot_xy_with_zones,
)

__all__ = [
    "plot_x",
    "plot_u",
    "plot_xy",
    "plot_xy_with_zones",
    "animate2d",
]
