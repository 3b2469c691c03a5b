"""Block-tridiagonal SPD factorization and solves, batched over leading
dims.

Counterpart of ``etol_tpu/solve/btridiag.py``: the plain PyTorch block
Cholesky. It is the KKT solve on the CPU and the plain version that the
CUDA kernel (:mod:`etol_tpu_torch.ops.bt_cuda`) is held against.

Convention: H[k,k] = D[..., k] (shape [..., K, w, w]), H[k, k+1] =
O[..., k] (shape [..., K-1, w, w]), H[k+1, k] = O[..., k]^T. The per-node
w×w algebra is unrolled into elementwise ops over the leading dims, as
the JAX package does for small w; a non-positive pivot gives NaN
(``sqrt`` of a negative), which the solver reads as a failed factor.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _chol(A):
    """Unrolled Cholesky of [..., w, w]."""
    w = A.shape[-1]
    L = [[None] * w for _ in range(w)]
    zero = torch.zeros_like(A[..., 0, 0])
    for i in range(w):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(w)], dim=-1)
        for i in range(w)
    ]
    return torch.stack(rows, dim=-2)


def _tri_solve(L, b, trans: bool = False):
    """Unrolled triangular solve: L y = b (or L^T y = b). L is
    [..., w, w] lower; b is [..., w, m]."""
    w = L.shape[-1]
    y = [None] * w
    if not trans:
        for i in range(w):
            s = b[..., i, :]
            for k in range(i):
                s = s - L[..., i, k, None] * y[k]
            y[i] = s / L[..., i, i, None]
    else:
        for i in reversed(range(w)):
            s = b[..., i, :]
            for k in range(i + 1, w):
                s = s - L[..., k, i, None] * y[k]
            y[i] = s / L[..., i, i, None]
    return torch.stack(y, dim=-2)


def factor(D, O) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block Cholesky of a block-tridiagonal SPD matrix.

    Returns (L_diag [..., K, w, w], L_sub [..., K-1, w, w]) with
    H = L L^T, L[k,k] = L_diag[k] lower triangular, L[k+1,k] = L_sub[k].

    Recurrence: S_0 = D_0; L_k = chol(S_k);
    L_sub[k] = O[k]^T L_k^{-T}; S_{k+1} = D_{k+1} - L_sub[k] L_sub[k]^T.
    """
    K = D.shape[-3]
    S = D[..., 0, :, :]
    diag, sub = [], []
    for k in range(K - 1):
        Lk = _chol(S)
        W = _tri_solve(Lk, O[..., k, :, :])      # W = L_k^{-1} O_k
        Wt = W.transpose(-1, -2)
        S = D[..., k + 1, :, :] - Wt @ W
        diag.append(Lk)
        sub.append(Wt)
    diag.append(_chol(S))
    L_diag = torch.stack(diag, dim=-3)
    if sub:
        L_sub = torch.stack(sub, dim=-3)
    else:
        L_sub = D.new_zeros(D.shape[:-3] + (0,) + D.shape[-2:])
    return L_diag, L_sub


def solve_factored(L_diag, L_sub, r):
    """Solve H x = r given the block Cholesky factor. r is [..., K, w]."""
    return solve_factored_multi(L_diag, L_sub, r[..., None])[..., 0]


def solve_factored_multi(L_diag, L_sub, R):
    """Solve H X = R for a block of right-hand sides: R is [..., K, w, m]
    (m columns a node).

    Forward: L Y = R, Y_k = L_k^{-1} (R_k - L_sub[k-1] Y_{k-1}); backward:
    L^T X = Y, X_k = L_k^{-T} (Y_k - L_sub[k]^T X_{k+1})."""
    K = L_diag.shape[-3]
    ys = []
    for k in range(K):
        rhs = R[..., k, :, :]
        if k:
            rhs = rhs - L_sub[..., k - 1, :, :] @ ys[-1]
        ys.append(_tri_solve(L_diag[..., k, :, :], rhs))
    xs = [None] * K
    for k in reversed(range(K)):
        rhs = ys[k]
        if k < K - 1:
            rhs = rhs - L_sub[..., k, :, :].transpose(-1, -2) @ xs[k + 1]
        xs[k] = _tri_solve(L_diag[..., k, :, :], rhs, trans=True)
    return torch.stack(xs, dim=-3)


def solve(D, O, r):
    """Factor + solve in one call. D [..., K,w,w], O [..., K-1,w,w],
    r [..., K,w]."""
    L_diag, L_sub = factor(D, O)
    return solve_factored(L_diag, L_sub, r)


def matvec(D, O, x):
    """H x. x is [..., K, w]."""
    y = torch.einsum("...kij,...kj->...ki", D, x)
    if O.shape[-3] > 0:
        up = torch.einsum("...kij,...kj->...ki", O, x[..., 1:, :])
        lo = torch.einsum("...kji,...kj->...ki", O, x[..., :-1, :])
        pad = x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))
        y = y + torch.cat([up, pad], dim=-2) + torch.cat([pad, lo], dim=-2)
    return y


def solve_refined(D, O, r):
    """Factor, solve, and one pass of iterative refinement against the
    same factor — what ``_bt_kernel`` computes with ``refine=1``, and the
    solver's "scan" KKT path (the refinement rescues f32 accuracy when
    rho makes the system ill-conditioned)."""
    L_diag, L_sub = factor(D, O)
    x = solve_factored(L_diag, L_sub, r)
    resid = r - matvec(D, O, x)
    return x + solve_factored(L_diag, L_sub, resid)


def to_dense(D: torch.Tensor, O: torch.Tensor) -> torch.Tensor:
    """The dense [K*w, K*w] matrix of one system D [K,w,w], O [K-1,w,w]
    (testing only)."""
    K, w, _ = D.shape
    H = D.new_zeros((K * w, K * w))
    for k in range(K):
        H[k * w:(k + 1) * w, k * w:(k + 1) * w] = D[k]
    for k in range(K - 1):
        H[k * w:(k + 1) * w, (k + 1) * w:(k + 2) * w] = O[k]
        H[(k + 1) * w:(k + 2) * w, k * w:(k + 1) * w] = O[k].T
    return H
