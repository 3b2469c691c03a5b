"""Horizon-sharded block-tridiagonal KKT solve (SPIKE partitioned
elimination).

Counterpart of ``etol_tpu/parallel/kkt.py``. The node axis of the KKT
system is split into n slabs of kb nodes; each slab's last node is a
separator:

1. **Interior elimination.** Each slab factors its interior chain (kb-1
   nodes, the only O(kb) sequential work) and solves it against the
   interior rhs and the two coupling blocks: one solve of 2w+1 columns.
2. **Separator system.** Eliminating every interior leaves an [n, w]
   block-tridiagonal system over the separators, gathered from the
   slabs' contributions and solved once on every process.
3. **Back-substitution** into each interior from step 1's columns.

Both solves are SPD block-tridiagonal solves: under ``route="kernel"``,
float32 and node widths up to 9 they go through
:func:`etol_tpu_torch.ops.bt_cuda.solve` (the CUDA kernel on a card, its
plain version on the CPU; one launch for every slab's interior with the
2w+1 columns as lanes, one for the separators), otherwise through the
plain :func:`~etol_tpu_torch.solve.btridiag.factor` and
:func:`~etol_tpu_torch.solve.btridiag.solve_factored_multi`. The kernel
adds one refinement pass to each solve that JAX's ``lax.scan`` solve
does not have.

The body is written once over a slab dim, with a leading batch dim:
[B, s, kb, ...], s = n on a :class:`~.axis.SlabAxis` and 1 on a
:class:`~.axis.GroupAxis`. Communication: one halo (each slab's view of
the left neighbour's last coupling block) and one gather of the
separator rows; the result is gathered so that every process holds all
of x.
"""
from __future__ import annotations

import math

import torch

from ..ops import bt_cuda
from ..solve import btridiag

ROUTES = ("kernel", "scan")


def _block_solve(D, O, R, route: str):
    """X [..., m, w, c] with H X = R for H = (D [..., m, w, w], O [...,
    m-1, w, w]) and c right-hand sides R [..., m, w, c]. The kernel route
    is one launch at (m, w, (lanes of ...) * c)."""
    w = D.shape[-1]
    if route == "kernel" and D.dtype == torch.float32 and w <= bt_cuda.MAX_W:
        lead, m, c = D.shape[:-3], D.shape[-3], R.shape[-1]
        lanes = math.prod(lead) * c
        Dl = D.unsqueeze(-4).expand(*lead, c, m, w, w).reshape(
            lanes, m, w, w)
        Ol = O.unsqueeze(-4).expand(*lead, c, m - 1, w, w).reshape(
            lanes, m - 1, w, w)
        rl = R.movedim(-1, -3).reshape(lanes, m, w)
        x = bt_cuda.solve(Dl.contiguous(), Ol.contiguous(), rl.contiguous())
        return x.reshape(*lead, c, m, w).movedim(-3, -1)
    L_diag, L_sub = btridiag.factor(D, O)
    return btridiag.solve_factored_multi(L_diag, L_sub, R)


def _solve_local(D_loc, O_loc, r_loc, halo_O, axis, route: str = "kernel"):
    """The slabs' body. D_loc [B, s, kb, w, w], O_loc [B, s, kb, w, w]
    (row k couples global node k to k+1; the global last row is
    padding), r_loc [B, s, kb, w], halo_O [B, s, w, w] = O[s_{d-1}] from
    the left neighbour (masked on shard 0). Returns x_loc [B, s, kb, w]."""
    B, s, kb, w, _ = D_loc.shape
    if kb < 2:
        raise ValueError("horizon-sharded KKT needs >= 2 nodes per shard")
    n = axis.size
    d = axis.index(D_loc.device)                       # [s]
    has_left = (d > 0)[:, None, None]
    has_right = (d < n - 1)[:, None, None]
    m = kb - 1  # interior chain length

    # interior chain: local nodes 0..kb-2; separator: local node kb-1
    Di = D_loc[:, :, :m]
    Oi = O_loc[:, :, :m - 1]
    A_blk = torch.where(has_left, halo_O.transpose(-1, -2),
                        torch.zeros_like(halo_O))      # H[first, s_left]
    B_blk = O_loc[:, :, m - 1]                         # H[last, own sep]

    # one interior solve of [r | A cols | B cols]
    R = D_loc.new_zeros((B, s, m, w, 2 * w + 1))
    R[..., 0] = r_loc[:, :, :m]
    R[:, :, 0, :, 1:w + 1] = A_blk
    R[:, :, m - 1, :, w + 1:] = B_blk
    X = _block_solve(Di, Oi, R, route)
    Xr = X[..., 0]                                     # [B, s, m, w]
    XA = X[..., 1:w + 1]                               # [B, s, m, w, w]
    XB = X[..., w + 1:]

    # Schur contributions (A's only block is at interior row 0, B's at
    # row m-1, so the products collapse to single-block matmuls)
    At, Bt = A_blk.transpose(-1, -2), B_blk.transpose(-1, -2)
    diag_own = D_loc[:, :, m] - Bt @ XB[:, :, m - 1]
    rhs_own = r_loc[:, :, m] - (Bt @ Xr[:, :, m - 1, :, None])[..., 0]
    diag_left = -(At @ XA[:, :, 0])
    rhs_left = -(At @ Xr[:, :, 0, :, None])[..., 0]
    off_left = -(At @ XB[:, :, 0])                     # s_{d-1} to s_d

    # separator d-1 takes shard d's left terms (d >= 1): shifted from the
    # right neighbour, the wrapped row of the last shard masked
    def from_right(t):
        mask = has_right if t.dim() == 4 else has_right[..., 0]
        return torch.where(mask, axis.from_right(t, 1), torch.zeros_like(t))

    Sdiag = axis.gather(diag_own + from_right(diag_left), 1)   # [B, n, w, w]
    Soff = axis.gather(from_right(off_left), 1)[:, :n - 1]
    rr = axis.gather(rhs_own + from_right(rhs_left), 1)        # [B, n, w]

    # the separator system, solved once on every process
    sep = _block_solve(Sdiag, Soff, rr[..., None], route)[..., 0]
    s_own = sep.index_select(1, d)                             # [B, s, w]
    s_left = torch.where(has_left[..., 0],
                         sep.index_select(1, (d - 1).clamp(min=0)),
                         torch.zeros_like(s_own))
    x_int = (
        Xr
        - torch.einsum("bsmwv,bsv->bsmw", XA, s_left)
        - torch.einsum("bsmwv,bsv->bsmw", XB, s_own)
    )
    return torch.cat([x_int, s_own[:, :, None]], dim=2)


def halo_left_O(O_loc, axis):
    """Each slab's view of the LEFT neighbour's last coupling row
    O[s_{d-1}] ([B, s, w, w]; the wrapped row on shard 0, masked in
    :func:`_solve_local`)."""
    return axis.from_left(O_loc[:, :, -1], 1)


def sharded_solve(D_loc, O_loc, r_loc, axis, route: str = "kernel"):
    """Slabs in, the slabs' solution out."""
    halo = halo_left_O(O_loc, axis)
    return _solve_local(D_loc, O_loc, r_loc, halo, axis, route)


def make_solver(mesh, axis: str = "horizon", route: str = "kernel"):
    """``f(D, O, r) -> x`` over whole systems with the node axis split
    over ``mesh[axis]``: D [B, K, w, w], O [B, K-1, w, w] (padded to K
    rows inside), r [B, K, w], or the same without the batch dim;
    K % mesh.shape[axis] == 0 with >= 2 nodes a slab. On a process mesh
    every rank passes the whole system, solves its slab and gets all of
    x. ``route`` is "kernel" or "scan" (see the module's docstring)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    ax = mesh.axis(axis)
    n = ax.size

    def global_solve(D, O, r):
        single = D.dim() == 3
        if single:
            D, O, r = D[None], O[None], r[None]
        B, K, w, _ = D.shape
        if K % n or K // n < 2:
            raise ValueError(
                f"nodes ({K}) must divide the {axis} axis ({n}) with >= 2 "
                "nodes per shard")
        kb = K // n
        Opad = torch.cat([O, O.new_zeros((B, K - O.shape[1], w, w))], dim=1)
        idx = ax.index(D.device)

        def slabs(a):
            return a.reshape((B, n, kb) + a.shape[2:]).index_select(1, idx)

        x_loc = sharded_solve(slabs(D), slabs(Opad), slabs(r), ax, route)
        x = ax.gather(x_loc, 1).reshape(B, K, w)
        return x[0] if single else x

    return global_solve
