"""The KKT kernel's share of its roofline: the least time of the window's
launches by the count of perfbench/roofline.py, over the kernel's own time
at the same (K, w, B), each shape weighted by its launches. The profiler
does not see kernels inside the solve's while bodies, so the kernel's time
at each shape is taken after the window with CUDA events around a graph of
launches over rotating inputs; the work counted is the problem's (K, w, B),
whatever implements it."""
from perfbench import roofline


def read(ctx):
    if not ctx.fleet or not ctx.traced or not ctx.launches:
        return None
    bound = spent = 0.0
    for (_, K, w, B), n in ctx.launches.items():
        bound += n * roofline.kkt_bound_ms(K, w, B)
        spent += n * roofline.kernel_ms(K, w, B)
    return 100.0 * bound / spent if spent > 0 else None
