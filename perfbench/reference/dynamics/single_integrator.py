"""The single integrator: xdot = u, the first nx controls."""


def f(x, u, params):
    return u[..., :x.shape[-1]]
