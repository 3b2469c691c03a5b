"""Block cyclic reduction for block-tridiagonal SPD systems, batched over
leading dims.

Counterpart of ``etol_tpu/ops/cyclic_reduction.py`` (array code there,
plain torch ops here). The sequential block Cholesky
(:mod:`etol_tpu_torch.solve.btridiag`) is K dependent steps; cyclic
reduction eliminates the odd-indexed nodes level by level:
ceil(log2(K+1)) levels, each one batch of small-matrix operations over
the surviving nodes and over every leading dim. The level loop is a
Python loop over sizes known from the shape.

It is the solver's ``kkt_solver="cr"`` path, and under ``"kernel"``
the path of node widths above the CUDA kernel's 9 and of float64
problems.

System convention matches btridiag: H[k,k] = D[..., k], H[k,k+1] =
O[..., k], H[k+1,k] = O[..., k]^T. Intended for the damped AL Hessian
(SPD, near block-diagonally dominant); a non-positive pivot gives NaN.
"""
from __future__ import annotations

import math

import torch

from ..solve import btridiag
from ..solve.btridiag import _chol, _tri_solve
from .tally import Tally

#: calls of :func:`solve_refined` in this process, by (K, w, leading
#: dims), those a CUDA graph captured counted at each replay; a run reads
#: it to show which KKT route its solves took
TALLY = Tally()


def _inv_apply(Dk, *rhs):
    """Solve D y = b for each b ([..., w, m]) through one unrolled
    Cholesky of D [..., w, w]."""
    L = _chol(Dk)
    return tuple(
        _tri_solve(L, _tri_solve(L, b), trans=True) for b in rhs
    )


def _mv(A, x):
    return torch.einsum("...nij,...nj->...ni", A, x)


def solve(D, O, r):
    """Solve H x = r. D [..., K, w, w], O [..., K-1, w, w], r [..., K, w]
    -> x [..., K, w].

    The node count is padded to M = 2^m - 1 with decoupled identity
    nodes."""
    lead = D.shape[:-3]
    K, w = D.shape[-3], D.shape[-1]
    m = max(1, math.ceil(math.log2(K + 1)))
    M = 2**m - 1

    def zeros(*tail):
        return D.new_zeros(lead + tail)

    eye = torch.eye(w, dtype=D.dtype, device=D.device).expand(
        lead + (M - K, w, w))
    Dp = torch.cat([D, eye], dim=-3)
    Op = torch.cat([O, zeros(M - 1 - O.shape[-3], w, w)], dim=-3)
    rp = torch.cat([r, zeros(M - K, w)], dim=-2)

    # per node: lower coupling L_i = O[i-1]^T (L_0 = 0) and upper
    # coupling U_i = O[i] (U_last = 0)
    zero = zeros(1, w, w)
    Dc = Dp
    Lc = torch.cat([zero, Op.transpose(-1, -2)], dim=-3)
    Uc = torch.cat([Op, zero], dim=-3)
    rc = rp

    # -------- forward elimination --------
    stack = []  # per level: (D_odd, L_odd, U_odd, r_odd)
    n = M
    while n > 1:
        Do, Lo, Uo = (a[..., 1::2, :, :] for a in (Dc, Lc, Uc))
        De, Le, Ue = (a[..., 0::2, :, :] for a in (Dc, Lc, Uc))
        ro, re = rc[..., 1::2, :], rc[..., 0::2, :]
        stack.append((Do, Lo, Uo, ro))

        # odd node j sits between evens j and j+1:
        # X = D_j^{-1} [L_j | U_j | r_j]
        XL, XU, Xr = _inv_apply(Do, Lo, Uo, ro[..., None])
        Xr = Xr[..., 0]

        # even i gains from its right odd neighbour (odd index i, absent
        # for the last even when the level's count is odd) and from its
        # left one (odd index i-1, absent for the first): a zero block
        # stands in for the absent one
        ne = De.shape[-3]
        z3, z2 = zeros(1, w, w), zeros(1, w)
        XLr, XUr = (torch.cat([a, z3], dim=-3)[..., :ne, :, :]
                    for a in (XL, XU))
        XLl, XUl = (torch.cat([z3, a], dim=-3)[..., :ne, :, :]
                    for a in (XL, XU))
        Xrr = torch.cat([Xr, z2], dim=-2)[..., :ne, :]
        Xrl = torch.cat([z2, Xr], dim=-2)[..., :ne, :]

        Dc = De - Ue @ XLr - Le @ XUl
        Uc = -(Ue @ XUr)
        Lc = -(Le @ XLl)
        rc = re - _mv(Ue, Xrr) - _mv(Le, Xrl)
        n = ne

    # the single remaining node
    (x0,) = _inv_apply(Dc[..., 0, :, :], rc[..., 0, :, None])
    xs = x0[..., 0][..., None, :]

    # -------- back substitution --------
    for Do, Lo, Uo, ro in reversed(stack):
        no, ne = Do.shape[-3], xs.shape[-2]
        # odd j sits between even j (left) and even j+1 (right; absent
        # for the last odd when the level's count is even, where U is 0)
        xr = torch.cat([xs[..., 1:, :], zeros(1, w)], dim=-2)[..., :no, :]
        rhs = ro - _mv(Lo, xs[..., :no, :]) - _mv(Uo, xr)
        (xo,) = _inv_apply(Do, rhs[..., None])
        # interleave evens and odds back: [e0, o0, e1, o1, ...]
        out = zeros(ne + no, w)
        out[..., 0::2, :] = xs
        out[..., 1::2, :] = xo[..., 0]
        xs = out

    return xs[..., :K, :]


def solve_refined(D, O, r):
    """:func:`solve` and one pass of iterative refinement (a second
    solve on the residual), which is how every caller uses it: the
    refinement rescues float32 accuracy when rho makes the system
    ill-conditioned."""
    TALLY.add((D.shape[-3], D.shape[-1]) + tuple(D.shape[:-3]))
    x = solve(D, O, r)
    resid = r - btridiag.matvec(D, O, x)
    return x + solve(D, O, resid)
