"""Hermite-Simpson collocation, the midpoint's state by Hermite
interpolation and its control the mean of the step's two."""


def defects(f, X, U, dt):
    """[n, N, nx] defects of the nodes X [n, K, nx], U [n, K, nu] under
    f(x, u)."""
    x0, x1, u0, u1 = X[:, :-1], X[:, 1:], U[:, :-1], U[:, 1:]
    f0, f1 = f(x0, u0), f(x1, u1)
    xm = 0.5 * (x0 + x1) + (dt / 8.0) * (f0 - f1)
    fm = f(xm, 0.5 * (u0 + u1))
    return x1 - x0 - (dt / 6.0) * (f0 + 4.0 * fm + f1)
