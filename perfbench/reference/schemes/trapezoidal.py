"""Trapezoidal collocation."""


def defects(f, X, U, dt):
    """[n, N, nx] defects of the nodes X [n, K, nx], U [n, K, nu] under
    f(x, u)."""
    x0, x1, u0, u1 = X[:, :-1], X[:, 1:], U[:, :-1], U[:, 1:]
    f0, f1 = f(x0, u0), f(x1, u1)
    return x1 - x0 - 0.5 * dt * (f0 + f1)
