"""The port's plots, animation and profiling helpers: the plots mirror
``tests/test_io_viz.py`` with tensors in place of JAX arrays."""
import os
import time

import torch

from etol_tpu_torch import load_configs
from etol_tpu_torch.utils import phase_report, phase_timer, trace
from etol_tpu_torch.viz import animate2d, plot_u, plot_x, plot_xy, \
    plot_xy_with_zones


def _path(K):
    times = torch.linspace(0.0, 8.0, K)
    X = torch.stack([torch.linspace(1.0, 5.0, K),
                     torch.linspace(2.0, 4.0, K)], dim=-1)
    return times, X


def test_plots_write_files(tmp_path, mip_xml):
    vgp = load_configs(mip_xml)
    traj = _path(17)
    p1 = tmp_path / "xy.png"
    plot_xy_with_zones(traj, vgp.obstacles, vgp.tracks, save=str(p1))
    assert p1.exists() and p1.stat().st_size > 1000
    p2 = tmp_path / "x.png"
    plot_x(traj, 0, save=str(p2))
    assert p2.exists()
    p3 = tmp_path / "u.png"
    plot_u(traj, 1, save=str(p3))
    assert p3.exists()
    p4 = tmp_path / "path.png"
    plot_xy(traj, save=str(p4))
    assert p4.exists()


def test_animate2d_writes(tmp_path, mip_xml):
    vgp = load_configs(mip_xml)
    out = animate2d(_path(9), vgp.obstacles, vgp.tracks,
                    save=str(tmp_path / "anim.gif"), fps=4)
    assert os.path.exists(out) and os.path.getsize(out) > 1000


def test_phase_timer_and_report():
    phase_report()  # start from an empty record
    for _ in range(3):
        a = torch.ones(4)
        with phase_timer("work", result={"a": a}):
            a.mul_(2.0)
            time.sleep(0.01)
    with phase_timer("other"):
        pass
    rep = phase_report()
    assert set(rep) == {"work", "other"}
    assert rep["work"]["calls"] == 3
    assert rep["work"]["total_s"] >= 0.03
    assert rep["work"]["mean_ms"] >= 10.0
    assert phase_report() == {}  # reset by the first report


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64) @ torch.ones(64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("matmul" in e.key or "dot" in e.key
               for e in prof.key_averages())
