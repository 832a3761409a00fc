"""Cell-patch PPPM pipeline — the scatter-free deposition/gather path.

The generic deposit/gather in pppm.py uses per-atom scatter/gather of
N * order^3 mesh points.  This module replaces them with dense work the
same way the cell-slot layout does for the pair pass:

* The PPPM grid is aligned to the MD cell grid (S grid points per cell and
  axis).  Each cell owns a (P, P, P) patch, P = S + order + margin, that
  covers every stencil its atoms can touch (margin absorbs inter-rebin
  drift, the skin argument).
* Deposition: per-cell dense B-spline weight planes (cap, P) per axis, then
  a batched rank-1-sum contraction (two batched matmuls) into patches;
  patches accumulate into the grid through 27 statically-sliced,
  cell-axis-rolled adds — NO scatter anywhere.
* Field gather: the exact transpose — 27 rolled slices assemble per-cell
  patches of each E component, three batched contractions produce per-slot
  forces.

This is the make_rho / fieldforce_ik pair of the reference
(pppm_intel.cpp:403-527, :540-640) in dense form: the reference's per-thread
grid privatization becomes patch privatization with a dense reduction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.box import Box
from ...core.precision import MATMUL
from ...neighbor.cell_slots import CellGrid, SlotState
from .base import KSpaceResult
from .pppm import PPPM, mspline, mspline_horner


@dataclasses.dataclass(frozen=True)
class PatchSpec:
    """Static geometry binding a PPPM grid to a CellGrid."""

    S: tuple[int, int, int]        # grid points per cell per axis
    P: tuple[int, int, int]        # patch extent per axis
    lo_off: tuple[int, int, int]   # patch start offset behind cell start
    order: int
    margin: int
    cell_tile: int                 # cells per lax.map tile


def make_patch_spec(pm: PPPM, grid: CellGrid, margin: int = 1,
                    cell_tile: Optional[int] = None,
                    skin: Optional[float] = None) -> PatchSpec:
    """margin=1 covers the base-index rounding slop; the skin term below
    raises it to cover inter-rebin drift.  Every patch axis P shrinks by
    2 per unit of margin, and the transfer cost scales with P_x*P_y —
    margin 2 -> 1 measured kspace 9.2 -> 7.3 ms at identical elong on
    the 259k north star."""
    if skin is not None:
        # Atoms drift up to skin/2 between rebins (the runner's cadence
        # bound); the patch margin must cover that drift in grid units or
        # B-spline weight mass silently falls off the patch.
        need = int(math.ceil((0.5 * skin) / float(np.min(pm.h)) - 1e-9))
        margin = max(margin, need)
    S = []
    P = []
    lo = []
    p = pm.order
    for ax in range(3):
        if pm.grid[ax] % grid.nc[ax]:
            raise ValueError(
                f"pppm grid {pm.grid} not aligned to cell grid {grid.nc}; "
                "pass multiple_of=cellgrid.nc to setup_pppm"
            )
        s = pm.grid[ax] // grid.nc[ax]
        if p % 2:
            lo_off = (p - 1) // 2 + margin
            ext = s + p + 2 * margin  # [-lo_off, s + (p-1)/2 + margin]
        else:
            lo_off = p // 2 - 1 + margin
            ext = s + p - 1 + 2 * margin
        # patch may only reach the two adjacent cells per side
        if lo_off > s or (ext - lo_off - s) > s:
            raise ValueError(
                f"patch overhang exceeds one cell on axis {ax} "
                f"(extent {ext}, S {s}): refine the pppm grid or coarsen "
                "the cell grid"
            )
        S.append(s)
        P.append(ext)
        lo.append(lo_off)
    if cell_tile is None:
        # bound the (tile, cap, Py*Pz) intermediates to ~64 MB
        cap = grid.cap
        vol = cap * P[1] * P[2] * 4
        cell_tile = max(32, min(grid.ncell, int(6.4e7 / max(vol, 1))))
    return PatchSpec(S=tuple(S), P=tuple(P), lo_off=tuple(lo),
                     order=p, margin=margin, cell_tile=int(cell_tile))


def _u_plane(pm: PPPM, planes, ax: int):
    """Grid-units coordinate along one mesh axis for every slot.

    Orthogonal: (x_ax - lo_ax)/h_ax.  Triclinic: the mesh is uniform in
    LAMDA space (particle_map under x2lamda, pppm_intel.cpp:153-157), so
    u_ax = n_ax * sum_c hinv[ax, c] (x_c - lo_c) — upper-triangular."""
    xplane = planes[ax] if isinstance(planes, (tuple, list)) else planes
    hinv = getattr(pm, "hinv", None)   # PPPMDisp solvers are orthogonal
    if hinv is None:
        return (xplane - pm.box_lo[ax]) * (1.0 / pm.h[ax])
    lam = None
    for c in range(ax, 3):
        hv = float(hinv[ax, c])
        if hv != 0.0:
            t = hv * (planes[c] - pm.box_lo[c])
            lam = t if lam is None else lam + t
    return lam * pm.grid[ax]


def _axis_weights(pm: PPPM, ps: PatchSpec, grid: CellGrid, planes, ax: int,
                  deriv: bool = False):
    """(NS, P_ax) dense B-spline weights of every slot on its cell patch.

    planes: the (x, y, z) slot-plane triple (triclinic lamda needs all
    three; orthogonal reads only axis ax) — or a single plane for
    orthogonal callers.  With deriv=True also returns d w / d u (grid
    units; divide by h for real-space derivatives) — the drho_coeff
    analog for the ad path."""
    ncell, cap = grid.ncell, grid.cap
    ns = grid.nslots
    # static per-slot cell coordinate along this axis
    cells = np.arange(ncell)
    if ax == 0:
        cc = cells // (grid.nc[1] * grid.nc[2])
    elif ax == 1:
        cc = (cells // grid.nc[2]) % grid.nc[1]
    else:
        cc = cells % grid.nc[2]
    slot_cell = np.repeat(cc, cap).astype(np.float64)       # (NS,)
    patch_lo = slot_cell * ps.S[ax] - ps.lo_off[ax]         # (NS,) static
    u = _u_plane(pm, planes, ax)                            # grid units
    px = np.arange(ps.P[ax], dtype=np.float64)
    arg = (u - jnp.asarray(patch_lo, u.dtype))[:, None] \
        - px[None, :] + ps.order / 2.0
    # piecewise-Horner evaluation (the reference's rho_coeff form,
    # pppm_intel.cpp:476-488) — ~2x cheaper than the Cox-de Boor
    # recursion, identical polynomial
    w = mspline_horner(ps.order, arg)                       # (NS, P_ax)
    if deriv:
        from .pppm import dmspline_horner

        return w, dmspline_horner(ps.order, arg)
    return w


_OFF3 = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]


def _ranges(ps: PatchSpec, ax: int, o: int):
    """(patch slice, cell-subgrid slice) for cell-offset o on axis ax."""
    S, lo = ps.S[ax], ps.lo_off[ax]
    P = ps.P[ax]
    if o == -1:
        return slice(0, lo), slice(S - lo, S)
    if o == 0:
        return slice(lo, lo + S), slice(0, S)
    return slice(lo + S, P), slice(0, P - lo - S)


def patches_to_grid(patches, ps: PatchSpec, grid: CellGrid, nxyz):
    """(ncell, Px, Py, Pz) -> (nx, ny, nz) via 27 rolled static-slice adds."""
    ncx, ncy, ncz = grid.nc
    Sx, Sy, Sz = ps.S
    pat = patches.reshape(ncx, ncy, ncz, *ps.P)
    G = jnp.zeros((ncx, Sx, ncy, Sy, ncz, Sz), patches.dtype)
    for (ox, oy, oz) in _OFF3:
        psx, gsx = _ranges(ps, 0, ox)
        psy, gsy = _ranges(ps, 1, oy)
        psz, gsz = _ranges(ps, 2, oz)
        part = pat[:, :, :, psx, psy, psz]
        part = jnp.roll(part, (ox, oy, oz), axis=(0, 1, 2))
        G = G.at[:, gsx, :, gsy, :, gsz].add(
            jnp.moveaxis(part, (3, 4, 5), (1, 3, 5))
        )
    return G.reshape(ncx * Sx, ncy * Sy, ncz * Sz)


def _pad_periodic(a, axis: int, lo: int, hi: int):
    idx_lo = [slice(None)] * a.ndim
    idx_hi = [slice(None)] * a.ndim
    idx_lo[axis] = slice(a.shape[axis] - lo, None)
    idx_hi[axis] = slice(0, hi)
    parts = []
    if lo:
        parts.append(a[tuple(idx_lo)])
    parts.append(a)
    if hi:
        parts.append(a[tuple(idx_hi)])
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else a


def _expand_axis(a, axis: int, n_c: int, S: int, P: int, lo: int,
                 periodic: bool = True, start: int = 0):
    """(… n …) -> (… n_c, P …): per-cell sliding windows along `axis` via
    P static strided slices (each a cheap lax.slice) + one stack.

    Replaces a 27-offset moveaxis/roll assembly — windows over a strided
    grid are slices, not gathers."""
    if periodic:
        a = _pad_periodic(a, axis, lo, max(P - lo - S, 0))
        start = 0
    parts = []
    for p in range(P):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(start + p, start + p + n_c * S, S)
        parts.append(a[tuple(idx)])
    return jnp.stack(parts, axis=axis + 1)


def grid_to_patches(mesh, ps: PatchSpec, grid: CellGrid):
    """(nx, ny, nz) -> (ncell, Px, Py, Pz): transpose of patches_to_grid."""
    ncx, ncy, ncz = grid.nc
    a = _expand_axis(mesh, 0, ncx, ps.S[0], ps.P[0], ps.lo_off[0])
    a = _expand_axis(a, 2, ncy, ps.S[1], ps.P[1], ps.lo_off[1])
    a = _expand_axis(a, 4, ncz, ps.S[2], ps.P[2], ps.lo_off[2])
    a = jnp.transpose(a, (0, 2, 4, 1, 3, 5))
    return a.reshape(grid.ncell, *ps.P)


def deposit_rho_cells(pm: PPPM, ps: PatchSpec, grid: CellGrid,
                      state: SlotState):
    """Charge deposition -> (nx, ny, nz) mesh, scatter-free."""
    cap = grid.cap
    ncell = grid.ncell
    wx = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0).reshape(ncell, cap, -1)
    wy = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1).reshape(ncell, cap, -1)
    wz = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2).reshape(ncell, cap, -1)
    qx = wx * state.q.reshape(ncell, cap)[:, :, None]

    tile = ps.cell_tile
    nt = -(-ncell // tile)
    pad = nt * tile - ncell

    def padc(a):
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

    qx_t = padc(qx).reshape(nt, tile, cap, ps.P[0])
    wy_t = padc(wy).reshape(nt, tile, cap, ps.P[1])
    wz_t = padc(wz).reshape(nt, tile, cap, ps.P[2])

    def one_tile(args):
        qxb, wyb, wzb = args
        wyz = jnp.einsum("tay,taz->tayz", wyb, wzb, precision=MATMUL)
        return jnp.einsum("tax,tayz->txyz", qxb, wyz, precision=MATMUL)

    pat = jax.lax.map(one_tile, (qx_t, wy_t, wz_t))
    pat = pat.reshape(nt * tile, *ps.P)[:ncell]
    return patches_to_grid(pat, ps, grid, pm.grid)


def gather_force_cells(pm: PPPM, ps: PatchSpec, grid: CellGrid,
                       state: SlotState, e_meshes):
    """E-field interpolation -> per-slot (fx, fy, fz), scatter-free.

    Caller multiplies by qqrd2e * q (or B for dispersion)."""
    cap = grid.cap
    ncell = grid.ncell
    wx = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0).reshape(ncell, cap, -1)
    wy = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1).reshape(ncell, cap, -1)
    wz = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2).reshape(ncell, cap, -1)

    tile = ps.cell_tile
    nt = -(-ncell // tile)
    pad = nt * tile - ncell

    def padc(a):
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

    wx_t = padc(wx).reshape(nt, tile, cap, ps.P[0])
    wy_t = padc(wy).reshape(nt, tile, cap, ps.P[1])
    wz_t = padc(wz).reshape(nt, tile, cap, ps.P[2])

    out = []
    for em in e_meshes:
        ep = grid_to_patches(em, ps, grid)
        ep_t = padc(ep).reshape(nt, tile, *ps.P)

        def one_tile(args):
            wxb, wyb, wzb, eb = args
            t1 = jnp.einsum("tax,txyz->tayz", wxb, eb, precision=MATMUL)
            t2 = jnp.einsum("tay,tayz->taz", wyb, t1, precision=MATMUL)
            return jnp.einsum("taz,taz->ta", wzb, t2, precision=MATMUL)

        f = jax.lax.map(one_tile, (wx_t, wy_t, wz_t, ep_t))
        out.append(f.reshape(nt * tile, cap)[:ncell].reshape(-1))
    return out


# ---------------------------------------------------------------------------
# Column-block transfer: the fast deposit/gather path.
#
# The patch pipeline above materializes per-cell (Px, Py, Pz) bricks; the
# 6-D window/transpose that builds them leaves Pz (~18) as the minor dim.
# The column scheme removes every small-minor tensor:
#
# * Work is grouped by (cx, cy) cell COLUMN (cells of a column are
#   contiguous in cell-id order, z-minor).  Per column the z-transfer is a
#   dense matmul against the RAW mesh z-axis: each slot's order-P_z spline
#   window is placed at its cell's static z offset inside an (A, nz) row
#   (block structure by construction), so  t1 = wz_rows @ E_col^T  contracts
#   nz as a matrix product with no expansion of z at all.
# * x/y windows are produced by static one-hot expansion MATMULS
#   (nx -> ncx*Px), a transpose that leaves the minor dim nz untouched, and
#   the remaining x/y contraction is one elementwise dot against the
#   (Px*Py)-flattened weight outer product (minor dim ~361).
#
# Deposition is the exact transpose: rho_col = (wxy*q)^T @ wz_rows, folded
# back through the transposed one-hot matmuls (which sum window overlaps
# automatically).  Same make_rho/fieldforce role as the patch pipeline
# (pppm_intel.cpp:403-527, :540-640), same results to f32 summation order.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """Static geometry for the column-block transfer."""

    ncol: int                  # ncx * ncy
    A: int                     # ncz * cap (slots per column)
    PXY: int                   # Px * Py
    col_tile: int              # columns per lax.map tile


def make_column_spec(ps: PatchSpec, grid: CellGrid, nz: int,
                     col_tile: Optional[int] = None) -> ColumnSpec:
    ncx, ncy, ncz = grid.nc
    if ps.P[2] > nz:
        raise ValueError("pppm z-grid smaller than one patch extent")
    A = ncz * grid.cap
    PXY = ps.P[0] * ps.P[1]
    if col_tile is None:
        # bound the (tile, A, PXY) t1 intermediate to ~96 MB
        per_col = A * PXY * 4
        col_tile = max(4, min(ncx * ncy, int(9.6e7 / max(per_col, 1))))
    return ColumnSpec(ncol=ncx * ncy, A=A, PXY=PXY, col_tile=int(col_tile))


def _onehot_expand(n: int, n_c: int, S: int, P: int, lo: int) -> np.ndarray:
    """(n, n_c*P) one-hot window matrix with periodic wrap."""
    m = np.zeros((n, n_c * P), np.float32)
    for c in range(n_c):
        for p in range(P):
            m[(c * S - lo + p) % n, c * P + p] = 1.0
    return m



def _spread_mats(Px: int, Py: int):
    """(Px, Px*Py) / (Py, Px*Py) one-hots: w_big = w @ K broadcasts a
    per-axis weight row onto the flattened (px, py) axis, keeping the
    minor dim at Px*Py (never a bare P_axis)."""
    PXY = Px * Py
    kx = np.zeros((Px, PXY), np.float32)
    ky = np.zeros((Py, PXY), np.float32)
    for a in range(Px):
        for b in range(Py):
            kx[a, a * Py + b] = 1.0
            ky[b, a * Py + b] = 1.0
    return kx, ky

def _expand_xy_cols(mesh, ps: PatchSpec, grid: CellGrid, ax_mats):
    """(..., nx, ny, nz) -> (..., ncol, Px*Py, nz); leading batch dims ok."""
    Ax, Ay = ax_mats
    ncx, ncy, _ = grid.nc
    Px, Py = ps.P[0], ps.P[1]
    nz = mesh.shape[-1]
    e = jnp.einsum("...xyz,yu->...xuz", mesh, jnp.asarray(Ay),
                   precision=MATMUL)
    e = jnp.einsum("...xuz,xv->...vuz", e, jnp.asarray(Ax), precision=MATMUL)
    lead = e.shape[:-3]
    e = e.reshape(*lead, ncx, Px, ncy, Py, nz)
    perm = tuple(range(len(lead))) + tuple(
        len(lead) + i for i in (0, 2, 1, 3, 4))
    e = jnp.transpose(e, perm)  # minor dim nz untouched
    return e.reshape(*lead, ncx * ncy, Px * Py, nz)


def _fold_xy_cols(cols, ps: PatchSpec, grid: CellGrid, ax_mats, nxyz):
    """Transpose of _expand_xy_cols: (ncol, Px*Py, nz) -> (nx, ny, nz),
    summing window overlaps."""
    Ax, Ay = ax_mats
    ncx, ncy, _ = grid.nc
    Px, Py = ps.P[0], ps.P[1]
    nz = cols.shape[-1]
    e = cols.reshape(ncx, ncy, Px, Py, nz)
    e = jnp.transpose(e, (0, 2, 1, 3, 4)).reshape(ncx * Px, ncy * Py, nz)
    e = jnp.einsum("vuz,xv->xuz", e, jnp.asarray(Ax), precision=MATMUL)
    return jnp.einsum("xuz,yu->xyz", e, jnp.asarray(Ay), precision=MATMUL)


def _wz_rows(pm: PPPM, ps: PatchSpec, grid: CellGrid, planes,
             deriv: bool = False):
    """(ncol, A, nz) z-spline rows: each slot's P_z window placed at its
    cell's static z offset (periodic wrap via roll of the zero-padded row).
    """
    ncx, ncy, ncz = grid.nc
    cap = grid.cap
    nz = pm.grid[2]
    Pz = ps.P[2]
    if deriv:
        w, dw = _axis_weights(pm, ps, grid, planes, 2, deriv=True)
        dw = dw * (-1.0 / pm.h[2])
    else:
        w = _axis_weights(pm, ps, grid, planes, 2)
    outs = []
    for a in ((w, dw) if deriv else (w,)):
        a4 = a.reshape(ncx * ncy, ncz, cap, Pz)
        padded = jnp.pad(a4, ((0, 0), (0, 0), (0, 0), (0, nz - Pz)))
        parts = []
        for cz in range(ncz):
            start = (cz * ps.S[2] - ps.lo_off[2]) % nz
            parts.append(jnp.roll(padded[:, cz], start, axis=-1))
        outs.append(jnp.stack(parts, axis=1).reshape(ncx * ncy,
                                                     ncz * cap, nz))
    return outs if deriv else outs[0]


def _col_tiles(a, tile: int, ncol: int, fill=0.0):
    nt = -(-ncol // tile)
    pad = nt * tile - ncol
    if pad:
        a = jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
    return a.reshape(nt, tile, *a.shape[1:])


def deposit_rho_columns(pm: PPPM, ps: PatchSpec, cs: ColumnSpec,
                        grid: CellGrid, state: SlotState, ax_mats):
    """Charge deposition -> (nx, ny, nz) mesh via column matmuls."""
    ncol, A, PXY = cs.ncol, cs.A, cs.PXY
    cap = grid.cap
    Px, Py = ps.P[0], ps.P[1]
    nz = pm.grid[2]
    wx = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0).reshape(ncol, A, Px)
    wy = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1).reshape(ncol, A, Py)
    wzr = _wz_rows(pm, ps, grid, (state.x, state.y, state.z))
    q = state.q.reshape(ncol, A)

    tile = cs.col_tile
    wx_t = _col_tiles(wx, tile, ncol)
    wy_t = _col_tiles(wy, tile, ncol)
    wz_t = _col_tiles(wzr, tile, ncol)
    q_t = _col_tiles(q, tile, ncol)

    Kx, Ky = _spread_mats(Px, Py)

    def one_tile(args):
        wxb, wyb, wzb, qb = args
        wxy = jnp.einsum("tax,xp->tap", wxb * qb[:, :, None],
                         jnp.asarray(Kx), precision=MATMUL) \
            * jnp.einsum("tay,yp->tap", wyb, jnp.asarray(Ky), precision=MATMUL)
        return jnp.einsum("tap,taz->tpz", wxy, wzb, precision=MATMUL)

    cols = jax.lax.map(one_tile, (wx_t, wy_t, wz_t, q_t))
    cols = cols.reshape(-1, PXY, nz)[:ncol]
    return _fold_xy_cols(cols, ps, grid, ax_mats, pm.grid)


def gather_columns(pm: PPPM, ps: PatchSpec, cs: ColumnSpec, grid: CellGrid,
                   state: SlotState, meshes, ax_mats, mode: str = "ik"):
    """Field interpolation via column matmuls.

    mode="ik": meshes = (Ex, Ey, Ez) -> per-slot (fx, fy, fz) (caller
    multiplies q).  mode="ad": meshes = (U,) potential -> (-dU/dx, ...)
    via derivative splines (fieldforce_ad analog).  mode="value": meshes =
    list of scalar meshes -> per-slot interpolated values."""
    ncol, A, PXY = cs.ncol, cs.A, cs.PXY
    Px, Py = ps.P[0], ps.P[1]
    nz = pm.grid[2]
    flt = state.x.dtype

    if mode == "ad":
        wx, dwx = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0, deriv=True)
        wy, dwy = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1, deriv=True)
        dwx = dwx * (-1.0 / pm.h[0])
        dwy = dwy * (-1.0 / pm.h[1])
        wzr, dwzr = _wz_rows(pm, ps, grid, (state.x, state.y, state.z), deriv=True)
        wx = wx.reshape(ncol, A, Px)
        dwx = dwx.reshape(ncol, A, Px)
        wy = wy.reshape(ncol, A, Py)
        dwy = dwy.reshape(ncol, A, Py)
    else:
        wx = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0).reshape(ncol, A, Px)
        wy = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1).reshape(ncol, A, Py)
        wzr = _wz_rows(pm, ps, grid, (state.x, state.y, state.z))

    em = jnp.stack([m.astype(flt) for m in meshes])       # (C, nx, ny, nz)
    ecols = _expand_xy_cols(em, ps, grid, ax_mats)        # (C, ncol, PXY, nz)
    C = em.shape[0]

    tile = cs.col_tile
    wx_t = _col_tiles(wx, tile, ncol)
    wy_t = _col_tiles(wy, tile, ncol)
    wz_t = _col_tiles(wzr, tile, ncol)
    e_t = _col_tiles(jnp.moveaxis(ecols, 0, 1), tile, ncol)  # (nt,t,C,PXY,nz)
    if mode == "ad":
        dwx_t = _col_tiles(dwx, tile, ncol)
        dwy_t = _col_tiles(dwy, tile, ncol)
        dwz_t = _col_tiles(dwzr, tile, ncol)

        Kx, Ky = _spread_mats(Px, Py)

        def one_tile(args):
            wxb, wyb, dwxb, dwyb, wzb, dwzb, eb = args
            u = eb[:, 0]                                  # (t, PXY, nz)
            t1 = jnp.einsum("taz,tpz->tap", wzb, u, precision=MATMUL)
            t1d = jnp.einsum("taz,tpz->tap", dwzb, u, precision=MATMUL)
            kxm, kym = jnp.asarray(Kx), jnp.asarray(Ky)
            xb = jnp.einsum("tax,xp->tap", wxb, kxm, precision=MATMUL)
            yb = jnp.einsum("tay,yp->tap", wyb, kym, precision=MATMUL)
            dxb = jnp.einsum("tax,xp->tap", dwxb, kxm, precision=MATMUL)
            dyb = jnp.einsum("tay,yp->tap", dwyb, kym, precision=MATMUL)
            return (jnp.sum(dxb * yb * t1, -1),
                    jnp.sum(xb * dyb * t1, -1),
                    jnp.sum(xb * yb * t1d, -1))

        outs = jax.lax.map(
            one_tile, (wx_t, wy_t, dwx_t, dwy_t, wz_t, dwz_t, e_t))
    else:
        Kx, Ky = _spread_mats(Px, Py)

        def one_tile(args):
            wxb, wyb, wzb, eb = args
            t1 = jnp.einsum("taz,tcpz->tcap", wzb, eb, precision=MATMUL)
            wxy = jnp.einsum("tax,xp->tap", wxb, jnp.asarray(Kx),
                             precision=MATMUL) \
                * jnp.einsum("tay,yp->tap", wyb, jnp.asarray(Ky),
                             precision=MATMUL)
            return tuple(jnp.sum(wxy * t1[:, c], -1) for c in range(C))

        outs = jax.lax.map(one_tile, (wx_t, wy_t, wz_t, e_t))
    return [o.reshape(-1, A)[:ncol].reshape(-1) for o in outs]


def _z_window_starts(ps: PatchSpec, ncz: int, nz: int):
    """Static z-window start index per z-cell (periodic)."""
    return [(cz * ps.S[2] - ps.lo_off[2]) % nz for cz in range(ncz)]


def _z_onehot(ps: PatchSpec, ncz: int, nz: int) -> np.ndarray:
    """(ncz * Pz, nz) one-hot: patch-local z rows -> mesh z (overlaps
    between adjacent cells' windows ADD, as deposition requires)."""
    Pz = ps.P[2]
    Z = np.zeros((ncz * Pz, nz), np.float32)
    for cz, start in enumerate(_z_window_starts(ps, ncz, nz)):
        for p in range(Pz):
            Z[cz * Pz + p, (start + p) % nz] = 1.0
    return Z


def _z_slice_windows(a, ps: PatchSpec, ncz: int, nz: int):
    """(..., nz) -> (..., ncz, Pz): static per-z-cell window extraction
    by contiguous slices (+wrap), stacked on a new axis -2 — pure data
    movement, no gather."""
    Pz = ps.P[2]
    parts = []
    for start in _z_window_starts(ps, ncz, nz):
        if start + Pz <= nz:
            parts.append(a[..., start:start + Pz])
        else:
            l1 = nz - start
            parts.append(jnp.concatenate(
                [a[..., start:], a[..., :Pz - l1]], axis=-1))
    return jnp.stack(parts, axis=-2)


def deposit_rho_zblock(pm: PPPM, ps: PatchSpec, cs: ColumnSpec,
                       grid: CellGrid, state: SlotState, ax_mats,
                       weights=None):
    """Two-stage deposition: per-(column, z-cell) patch-local matmuls,
    then a static one-hot z fold.

    The "columns" engine contracts every slot against FULL-length
    (nz,) z rows — nz/Pz (~6x) zero-work.  Here stage 1 runs the
    batched matmul at the patch-local z extent
    (batch (col, z-cell): (Pz x cap) @ (cap x PXY)) and stage 2 folds
    the (ncz * Pz) patch rows onto the (nz,) mesh with one static
    one-hot matmul — same arithmetic, ~5x fewer multiplies."""
    ncol, A, PXY = cs.ncol, cs.A, cs.PXY
    cap = grid.cap
    ncz = grid.nc[2]
    Px, Py = ps.P[0], ps.P[1]
    Pz = ps.P[2]
    nz = pm.grid[2]
    if weights is None:
        weights = (_axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0),
                   _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1),
                   _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2))
    wx = weights[0].reshape(ncol, A, Px)
    wy = weights[1].reshape(ncol, A, Py)
    wz = weights[2]                                       # (NS, Pz) local
    wzq = (wz * state.q[:, None]).reshape(ncol, ncz, cap, Pz)
    Z = jnp.asarray(_z_onehot(ps, ncz, nz))

    tile = cs.col_tile
    wx_t = _col_tiles(wx, tile, ncol)
    wy_t = _col_tiles(wy, tile, ncol)
    wz_t = _col_tiles(wzq, tile, ncol)

    Kx, Ky = _spread_mats(Px, Py)

    def one_tile(args):
        wxb, wyb, wzb = args
        # NOTE: the one-hot spreads FUSE into the following dot; a
        # broadcast-product wxy measured 3 ms SLOWER (fusion loss —
        # same lesson as the pair coef-select reassociation, PERF.md)
        wxy = jnp.einsum("tax,xp->tap", wxb, jnp.asarray(Kx),
                         precision=MATMUL) \
            * jnp.einsum("tay,yp->tap", wyb, jnp.asarray(Ky), precision=MATMUL)
        wxy = wxy.reshape(-1, ncz, cap, PXY)
        # (t,ncz,Pz,PXY)
        m = jnp.einsum("tkaw,tkap->tkwp", wzb, wxy, precision=MATMUL)
        m = m.reshape(-1, ncz * Pz, PXY)
        # (t, PXY, nz)
        return jnp.einsum("twp,wz->tpz", m, Z, precision=MATMUL)

    cols = jax.lax.map(one_tile, (wx_t, wy_t, wz_t))
    cols = cols.reshape(-1, PXY, nz)[:ncol]
    return _fold_xy_cols(cols, ps, grid, ax_mats, pm.grid)


def gather_zblock(pm: PPPM, ps: PatchSpec, cs: ColumnSpec, grid: CellGrid,
                  state: SlotState, meshes, ax_mats, mode: str = "ik",
                  weights=None):
    """Two-stage field interpolation (see deposit_rho_zblock): static
    z-window slices, then batched (cap x PXY) @ (PXY x C*Pz) matmuls
    with the channel and patch-z axes merged on the minor dim, then a
    tiny per-slot z-weight reduction.

    mode="ik": meshes (Ex, Ey, Ez) -> per-slot field components.
    mode="ad": meshes (U,) -> (-dU/dx, -dU/dy, -dU/dz) via derivative
    splines.  mode="value": meshes -> interpolated values."""
    ncol, A, PXY = cs.ncol, cs.A, cs.PXY
    cap = grid.cap
    ncz = grid.nc[2]
    Px, Py = ps.P[0], ps.P[1]
    Pz = ps.P[2]
    nz = pm.grid[2]
    flt = state.x.dtype

    ad = mode == "ad"
    if ad:
        if weights is None:
            weights = (_axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0, deriv=True),
                       _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1, deriv=True),
                       _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2, deriv=True))
        (wx, dwx), (wy, dwy), (wz, dwz) = weights
        dwx = (dwx * (-1.0 / pm.h[0])).reshape(ncol, A, Px)
        dwy = (dwy * (-1.0 / pm.h[1])).reshape(ncol, A, Py)
        dwz = dwz * (-1.0 / pm.h[2])
        wx = wx.reshape(ncol, A, Px)
        wy = wy.reshape(ncol, A, Py)
    else:
        if weights is None:
            weights = (_axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0),
                       _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1),
                       _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2))
        wx = weights[0].reshape(ncol, A, Px)
        wy = weights[1].reshape(ncol, A, Py)
        wz = weights[2]                                   # (NS, Pz)

    em = jnp.stack([m.astype(flt) for m in meshes])       # (C, nx, ny, nz)
    C = em.shape[0]
    ecols = _expand_xy_cols(em, ps, grid, ax_mats)        # (C, ncol, PXY, nz)
    ew = _z_slice_windows(ecols, ps, ncz, nz)             # (C,ncol,PXY,ncz,Pz)
    # merge (C, Pz) onto the lane dim: (ncol, ncz, PXY, C*Pz)
    ew = jnp.transpose(ew, (1, 3, 2, 0, 4)).reshape(ncol, ncz, PXY, C * Pz)

    tile = cs.col_tile
    wx_t = _col_tiles(wx, tile, ncol)
    wy_t = _col_tiles(wy, tile, ncol)
    e_t = _col_tiles(ew, tile, ncol)
    wz_r = wz.reshape(ncol, ncz, cap, Pz)
    wz_t = _col_tiles(wz_r, tile, ncol)
    if ad:
        dwx_t = _col_tiles(dwx, tile, ncol)
        dwy_t = _col_tiles(dwy, tile, ncol)
        dwz_t = _col_tiles(dwz.reshape(ncol, ncz, cap, Pz), tile, ncol)

    Kx, Ky = _spread_mats(Px, Py)

    if ad:
        def one_tile(args):
            wxb, wyb, dwxb, dwyb, wzb, dwzb, eb = args
            kxm, kym = jnp.asarray(Kx), jnp.asarray(Ky)
            xb = jnp.einsum("tax,xp->tap", wxb, kxm, precision=MATMUL)
            yb = jnp.einsum("tay,yp->tap", wyb, kym, precision=MATMUL)
            dxb = jnp.einsum("tax,xp->tap", dwxb, kxm, precision=MATMUL)
            dyb = jnp.einsum("tay,yp->tap", dwyb, kym, precision=MATMUL)
            outs = []
            for wxyb in (dxb * yb, xb * dyb, xb * yb):
                w4 = wxyb.reshape(-1, ncz, cap, PXY)
                # (t,ncz,cap,Pz)
                t = jnp.einsum("tkap,tkpw->tkaw", w4, eb, precision=MATMUL)
                outs.append(t)
            fx = jnp.sum(outs[0] * wzb, -1)
            fy = jnp.sum(outs[1] * wzb, -1)
            fz = jnp.sum(outs[2] * dwzb, -1)
            return (fx.reshape(-1, ncz * cap), fy.reshape(-1, ncz * cap),
                    fz.reshape(-1, ncz * cap))

        outs = jax.lax.map(
            one_tile, (wx_t, wy_t, dwx_t, dwy_t, wz_t, dwz_t, e_t))
        return [o.reshape(-1, A)[:ncol].reshape(-1) for o in outs]

    def one_tile(args):
        wxb, wyb, wzb, eb = args
        wxy = jnp.einsum("tax,xp->tap", wxb, jnp.asarray(Kx),
                         precision=MATMUL) \
            * jnp.einsum("tay,yp->tap", wyb, jnp.asarray(Ky), precision=MATMUL)
        wxy = wxy.reshape(-1, ncz, cap, PXY)
        # (t, ncz, cap, C*Pz): ONE batched matmul, K = PXY
        t = jnp.einsum("tkap,tkpw->tkaw", wxy, eb, precision=MATMUL)
        t = t.reshape(-1, ncz, cap, C, Pz)
        out = jnp.sum(t * wzb[:, :, :, None, :], -1)      # (t,ncz,cap,C)
        return tuple(out[..., c].reshape(-1, ncz * cap) for c in range(C))

    outs = jax.lax.map(one_tile, (wx_t, wy_t, wz_t, e_t))
    return [o.reshape(-1, A)[:ncol].reshape(-1) for o in outs]


def _half_weights(nz: int):
    """rfft spectrum weights along z: interior k planes count twice."""
    nzh = nz // 2 + 1
    wz = np.full(nzh, 2.0)
    wz[0] = 1.0
    if nz % 2 == 0:
        wz[-1] = 1.0
    return wz


class CellPPPM:
    """PPPM bound to a cell grid — plugs into CellPairSimulation.

    Exposes compute_slots(state) -> (fx, fy, fz, elong, virial) with all
    per-atom stages running through the patch pipeline.  Spectral work
    runs on the rfft half-spectrum (the density is real); differentiation
    follows pm.diff — "ik" (3 inverse FFTs of the E-field) or "ad" (one
    potential mesh, derivative-spline gather + measured self-force,
    /root/reference/pppm_intel.cpp:985-1054, :678-804).
    """

    def __init__(self, pm: PPPM, grid: CellGrid, margin: int = 1,
                 per_slot_charge=None, skin: Optional[float] = None,
                 transfer: str = "zblock"):
        self.pm = pm
        self._margin0 = margin
        self._skin0 = skin
        # kspace rides the COARSE (reach-1) view of the slot planes:
        # z-refined pair cells are contiguous, so merging them back into
        # cutneigh-sized cells is a free reshape (CellGrid.coarse) and
        # the patch geometry keeps its reach-1 contract
        grid = grid.coarse()
        self.grid = grid
        self.ps = make_patch_spec(pm, grid, margin=margin, skin=skin)
        # dispersion mode: override 'charge' source (B per slot is dynamic
        # via typ; caller passes a per-TYPE table instead)
        self.b_per_type = per_slot_charge
        # dispersion virial factor [d ln w/dk]/k (pppm_disp vfac);
        # CellPPPMDisp sets it — required for vflag in dispersion mode
        self.vfac = None
        # transfer engine: "zblock" (two-stage patch-local z matmuls —
        # fastest measured), "columns" (full-length z rows), or
        # "patches" (per-cell bricks; reference form, also the per-atom path)
        self.transfer = transfer
        if transfer in ("columns", "zblock"):
            self.cspec = make_column_spec(self.ps, grid, pm.grid[2])
            self.ax_mats = (
                _onehot_expand(pm.grid[0], grid.nc[0], self.ps.S[0],
                               self.ps.P[0], self.ps.lo_off[0]),
                _onehot_expand(pm.grid[1], grid.nc[1], self.ps.S[1],
                               self.ps.P[1], self.ps.lo_off[1]),
            )

    def rebind(self, grid: CellGrid) -> "CellPPPM":
        """Same solver bound to a re-sized cell grid (the engine's
        overflow auto-grow: cap changed, mesh/geometry unchanged)."""
        return CellPPPM(self.pm, grid, margin=self._margin0,
                        per_slot_charge=self.b_per_type, skin=self._skin0,
                        transfer=self.transfer)

    def _deposit(self, state: SlotState, weights=None):
        if self.transfer == "zblock":
            return deposit_rho_zblock(self.pm, self.ps, self.cspec,
                                      self.grid, state, self.ax_mats,
                                      weights=weights)
        if self.transfer == "columns":
            return deposit_rho_columns(self.pm, self.ps, self.cspec,
                                       self.grid, state, self.ax_mats)
        return deposit_rho_cells(self.pm, self.ps, self.grid, state)

    def _spectral(self, state: SlotState, qqrd2e: float, eflag: bool,
                  vflag: bool, weights=None):
        """Deposit + half-spectrum solve.  Returns (phi_hat, elong,
        virial) with energy/virial psums done."""
        pm = self.pm
        acc = pm.acc_dtype
        V = float(pm.volume)
        nz = pm.grid[2]
        nzh = nz // 2 + 1

        mesh = self._deposit(state, weights=weights)
        rhat = jnp.fft.rfftn(mesh.astype(acc))
        G = jnp.asarray(pm.greensfn[..., :nzh], acc)
        phi_hat = G * rhat

        wz = jnp.asarray(_half_weights(nz), acc)[None, None, :]
        if eflag or vflag:
            ek = G * jnp.real(rhat * jnp.conj(rhat)) * wz
        if self.b_per_type is not None and (eflag or vflag):
            # dispersion k=0 (neutralizing-background analog) + self
            # terms from the CURRENT slot composition (NPT-safe)
            bsum = jnp.sum(state.q.astype(acc))
            b2sum = jnp.sum((state.q * state.q).astype(acc))
            w0 = -(math.pi**1.5 * pm.g_ewald**3 / 3.0)
            e0 = (0.5 / V) * w0 * bsum * bsum
        if eflag:
            elong = (0.5 / V) * jnp.sum(ek.astype(acc)) * qqrd2e
            if self.b_per_type is not None:
                elong = elong + e0 + pm.g_ewald**6 / 12.0 * b2sum
            else:
                elong = elong + pm.elong_self
        else:
            elong = jnp.zeros((), acc)

        if vflag and self.b_per_type is None:
            kx3, ky3, kz3 = pm.k3(nzh)
            kx = jnp.asarray(kx3, acc)
            ky = jnp.asarray(ky3, acc)
            kz = jnp.asarray(kz3, acc)
            ksq = kx * kx + ky * ky + kz * kz
            ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
            pref = 2.0 * (1.0 / ksq_safe + 0.25 / pm.g_ewald**2)
            c = (0.5 / V) * qqrd2e
            virial = jnp.stack([
                jnp.sum((ek * (1.0 - pref * kx * kx)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * ky * ky)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * kz * kz)).astype(acc)),
                jnp.sum((ek * (-pref * kx * ky)).astype(acc)),
                jnp.sum((ek * (-pref * kx * kz)).astype(acc)),
                jnp.sum((ek * (-pref * ky * kz)).astype(acc)),
            ]) * c
        elif vflag:
            # anisotropic dispersion virial (1 + vfac k_a k_b) + e0 on
            # the diagonal — the energy_6/virial_6 reductions of
            # /root/reference/pppm_disp_intel.cpp:498-510
            if self.vfac is None:
                raise ValueError(
                    "dispersion-mode CellPPPM needs vfac for the virial "
                    "(construct via CellPPPMDisp)")
            kx3, ky3, kz3 = pm.k3(nzh)
            kx = jnp.asarray(kx3, acc)
            ky = jnp.asarray(ky3, acc)
            kz = jnp.asarray(kz3, acc)
            vf = jnp.asarray(self.vfac[..., :nzh], acc)
            c = (0.5 / V)
            virial = jnp.stack([
                jnp.sum((ek * (1.0 + vf * kx * kx)).astype(acc)),
                jnp.sum((ek * (1.0 + vf * ky * ky)).astype(acc)),
                jnp.sum((ek * (1.0 + vf * kz * kz)).astype(acc)),
                jnp.sum((ek * (vf * kx * ky)).astype(acc)),
                jnp.sum((ek * (vf * kx * kz)).astype(acc)),
                jnp.sum((ek * (vf * ky * kz)).astype(acc)),
            ]) * c
            virial = virial + e0 * jnp.asarray(
                [1.0, 1.0, 1.0, 0.0, 0.0, 0.0], acc)
        else:
            virial = jnp.zeros((6,), acc)
        return phi_hat, elong, virial

    def _contract(self, triples, meshes):
        """Batched patch contractions: one (wx, wy, wz, mesh) -> (NS,)."""
        ps, grid = self.ps, self.grid
        cap = grid.cap
        ncell = grid.ncell
        tile = ps.cell_tile
        nt = -(-ncell // tile)
        pad = nt * tile - ncell

        def padc(a):
            return jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

        out = []
        for (wx, wy, wz), em in zip(triples, meshes):
            ep = grid_to_patches(em, ps, grid)
            ep_t = padc(ep).reshape(nt, tile, *ps.P)
            wx_t = padc(wx).reshape(nt, tile, cap, ps.P[0])
            wy_t = padc(wy).reshape(nt, tile, cap, ps.P[1])
            wz_t = padc(wz).reshape(nt, tile, cap, ps.P[2])

            def one_tile(args):
                wxb, wyb, wzb, eb = args
                t1 = jnp.einsum("tax,txyz->tayz", wxb, eb, precision=MATMUL)
                t2 = jnp.einsum("tay,tayz->taz", wyb, t1, precision=MATMUL)
                return jnp.einsum("taz,taz->ta", wzb, t2, precision=MATMUL)

            f = jax.lax.map(one_tile, (wx_t, wy_t, wz_t, ep_t))
            out.append(f.reshape(nt * tile, cap)[:ncell].reshape(-1))
        return out

    def compute_slots(self, state: SlotState, eflag: bool, vflag: bool):
        pm = self.pm
        acc = pm.acc_dtype
        flt = state.x.dtype
        V = float(pm.volume)
        grid = self.grid
        ps = self.ps
        if self.b_per_type is not None:
            from ..pair.driver import _select_small

            b = _select_small(self.b_per_type, state.typ, state.typ.shape,
                              state.x.dtype)
            if isinstance(b, float):
                b = jnp.full(state.typ.shape, b, state.x.dtype)
            b = jnp.where(state.aid < self.grid.n_atoms, b, 0.0)
            state = state._replace(q=b)
            qqrd2e = 1.0
        else:
            qqrd2e = float(pm.qqrd2e)

        # zblock: the B-spline axis weights are shared between the
        # deposit and the gather (both evaluate the SAME splines at the
        # same positions — computing them twice measured ~1.5 ms/step)
        shared_w = None
        if self.transfer == "zblock":
            if pm.diff == "ad":
                shared_w = (
                    _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0, deriv=True),
                    _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1, deriv=True),
                    _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2, deriv=True),
                )
                dep_w = tuple(w for w, _ in shared_w)
            else:
                shared_w = (
                    _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0),
                    _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1),
                    _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2),
                )
                dep_w = shared_w

        phi_hat, elong, virial = self._spectral(
            state, qqrd2e, eflag, vflag,
            weights=dep_w if shared_w is not None else None)
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        scale = 1.0 / V
        cap = grid.cap
        ncell = grid.ncell

        if pm.diff == "ad":
            # ONE inverse FFT -> potential mesh; derivative-spline gather
            u = (jnp.real(jnp.fft.irfftn(phi_hat, s=pm.grid))
                 * (scale * ngrid)).astype(flt)
            if self.transfer == "zblock":
                fx, fy, fz = gather_zblock(
                    pm, ps, self.cspec, grid, state, [u], self.ax_mats,
                    mode="ad", weights=shared_w)
            elif self.transfer == "columns":
                fx, fy, fz = gather_columns(
                    pm, ps, self.cspec, grid, state, [u], self.ax_mats,
                    mode="ad")
            else:
                w = []
                dw = []
                for ax, p in enumerate((state.x, state.y, state.z)):
                    wa, dwa = _axis_weights(pm, ps, grid, p, ax, deriv=True)
                    w.append(wa.reshape(ncell, cap, -1))
                    dw.append(
                        (dwa * (-1.0 / pm.h[ax])).reshape(ncell, cap, -1))
                triples = [(dw[0], w[1], w[2]), (w[0], dw[1], w[2]),
                           (w[0], w[1], dw[2])]
                fx, fy, fz = self._contract(triples, [u, u, u])
            qf = (qqrd2e * state.q).astype(acc)
            fx = fx.astype(acc) * qf
            fy = fy.astype(acc) * qf
            fz = fz.astype(acc) * qf
            if pm.sf_sine is not None:
                from .pppm import sf_axis_series

                q2 = (qqrd2e * state.q * state.q).astype(acc)
                outs = [
                    sf_axis_series(pm, p, ax).astype(acc) * q2
                    for ax, p in enumerate((state.x, state.y, state.z))
                ]
                fx = fx - outs[0]
                fy = fy - outs[1]
                fz = fz - outs[2]
            return fx, fy, fz, elong, virial

        # ik: 3 spectral derivatives, one batched inverse real FFT
        return self._ik_forces(state, phi_hat, qqrd2e, elong, virial,
                               weights=shared_w)

    def _weight_triple(self, state: SlotState):
        pm, ps, grid = self.pm, self.ps, self.grid
        cap, ncell = grid.cap, grid.ncell
        wx = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 0).reshape(ncell, cap, -1)
        wy = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 1).reshape(ncell, cap, -1)
        wz = _axis_weights(pm, ps, grid, (state.x, state.y, state.z), 2).reshape(ncell, cap, -1)
        return wx, wy, wz

    def compute_peratom_slots(self, state: SlotState):
        """Per-slot k-space energy/virial (pppm_intel.cpp:224-252 analog)
        through the patch pipeline; pins exactly to the global sums.
        Returns (eatom (NS,), vatom (NS, 6)); zero at empty slots."""
        pm = self.pm
        if self.b_per_type is not None:
            return self._peratom_disp_slots(state)
        acc = pm.acc_dtype
        V = float(pm.volume)
        g = pm.g_ewald
        qqrd2e = float(pm.qqrd2e)
        nz = pm.grid[2]
        nzh = nz // 2 + 1
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        flt = state.x.dtype

        mesh = self._deposit(state)
        rhat = jnp.fft.rfftn(mesh.astype(acc))
        G = jnp.asarray(pm.greensfn[..., :nzh], acc)
        phi_hat = G * rhat
        scale = ngrid / V

        kx3, ky3, kz3 = pm.k3(nzh)
        kx = jnp.asarray(kx3, acc)
        ky = jnp.asarray(ky3, acc)
        kz = jnp.asarray(kz3, acc)
        ksq = kx * kx + ky * ky + kz * kz
        ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
        pref = 2.0 * (1.0 / ksq_safe + 0.25 / (g * g))
        comps = (
            1.0 - pref * kx * kx, 1.0 - pref * ky * ky,
            1.0 - pref * kz * kz, -pref * kx * ky,
            -pref * kx * kz, -pref * ky * kz,
        )
        specs = [phi_hat] + [c * phi_hat for c in comps]
        meshes = [
            (jnp.real(jnp.fft.irfftn(s, s=pm.grid)) * scale).astype(flt)
            for s in specs
        ]
        tri = self._weight_triple(state)
        vals = self._contract([tri] * 7, meshes)
        q = state.q
        eatom = 0.5 * q * vals[0] \
            - g / math.sqrt(math.pi) * q * q \
            - math.pi / (2.0 * g * g * V) * q * pm.qsum
        eatom = (qqrd2e * eatom).astype(acc)
        vatom = jnp.stack(
            [(0.5 * qqrd2e * q * v).astype(acc) for v in vals[1:]],
            axis=-1)
        return eatom, vatom

    def _peratom_disp_slots(self, state: SlotState):
        """Per-slot dispersion k-space energy/virial through the patch
        pipeline — the eflag_atom/vflag_atom dispersion corrections of
        /root/reference/pppm_disp_intel.cpp:512-537 (per-atom shares of
        the mesh sum plus the k=0 and self terms), pinned exactly to the
        compute_slots global sums.  Geometric mixing (one channel)."""
        from ..pair.driver import _select_small

        pm = self.pm
        acc = pm.acc_dtype
        V = float(pm.volume)
        g = pm.g_ewald           # the shim carries g_ewald_6 here
        nz = pm.grid[2]
        nzh = nz // 2 + 1
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        flt = state.x.dtype
        if self.vfac is None:
            raise ValueError(
                "dispersion-mode CellPPPM needs vfac for the per-atom "
                "virial (construct via CellPPPMDisp)")

        b = _select_small(self.b_per_type, state.typ, state.typ.shape, flt)
        if isinstance(b, float):
            b = jnp.full(state.typ.shape, b, flt)
        b = jnp.where(state.aid < self.grid.n_atoms, b, 0.0)
        state = state._replace(q=b)

        mesh = self._deposit(state)
        rhat = jnp.fft.rfftn(mesh.astype(acc))
        G = jnp.asarray(pm.greensfn[..., :nzh], acc)
        phi_hat = G * rhat
        scale = ngrid / V

        kx3, ky3, kz3 = pm.k3(nzh)
        kx = jnp.asarray(kx3, acc)
        ky = jnp.asarray(ky3, acc)
        kz = jnp.asarray(kz3, acc)
        vf = jnp.asarray(self.vfac[..., :nzh], acc)
        comps = (
            1.0 + vf * kx * kx, 1.0 + vf * ky * ky, 1.0 + vf * kz * kz,
            vf * kx * ky, vf * kx * kz, vf * ky * kz,
        )
        specs = [phi_hat] + [c * phi_hat for c in comps]
        meshes = [
            (jnp.real(jnp.fft.irfftn(s, s=pm.grid)) * scale).astype(flt)
            for s in specs
        ]
        tri = self._weight_triple(state)
        vals = self._contract([tri] * 7, meshes)
        ba = b.astype(acc)
        bsum = jnp.sum(ba)
        w0 = -(math.pi**1.5 * g**3 / 3.0)
        e0_share = (0.5 / V) * w0 * ba * bsum   # sums to e0
        eatom = (0.5 * ba * vals[0].astype(acc) + e0_share
                 + g**6 / 12.0 * ba * ba).astype(acc)
        vatom = jnp.stack(
            [(0.5 * ba * v.astype(acc)
              + (e0_share if ic < 3 else 0.0)).astype(acc)
             for ic, v in enumerate(vals[1:])], axis=-1)
        return eatom, vatom

    def _ik_forces(self, state: SlotState, phi_hat, qqrd2e, elong, virial,
                   weights=None):
        pm = self.pm
        acc = pm.acc_dtype
        flt = state.x.dtype
        V = float(pm.volume)
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        scale = 1.0 / V
        nzh = pm.grid[2] // 2 + 1
        kx3, ky3, kz3 = pm.k3(nzh)
        kx = jnp.asarray(jnp.broadcast_to(jnp.asarray(kx3, acc),
                                          phi_hat.shape), acc)
        ky = jnp.asarray(jnp.broadcast_to(jnp.asarray(ky3, acc),
                                          phi_hat.shape), acc)
        kz = jnp.asarray(jnp.broadcast_to(jnp.asarray(kz3, acc),
                                          phi_hat.shape), acc)
        ehat = jnp.stack([(-1j) * kax * phi_hat for kax in (kx, ky, kz)])
        e_stack = (jnp.fft.irfftn(ehat, s=pm.grid, axes=(1, 2, 3))
                   * (scale * ngrid)).astype(flt)
        if self.transfer == "zblock":
            fx, fy, fz = gather_zblock(
                pm, self.ps, self.cspec, self.grid, state,
                [e_stack[0], e_stack[1], e_stack[2]], self.ax_mats,
                weights=weights)
        elif self.transfer == "columns":
            fx, fy, fz = gather_columns(
                pm, self.ps, self.cspec, self.grid, state,
                [e_stack[0], e_stack[1], e_stack[2]], self.ax_mats)
        else:
            tri = self._weight_triple(state)
            fx, fy, fz = self._contract(
                [tri] * 3, [e_stack[0], e_stack[1], e_stack[2]])
        qf = (qqrd2e * state.q).astype(acc)
        return (fx.astype(acc) * qf, fy.astype(acc) * qf,
                fz.astype(acc) * qf, elong, virial)


class CellPPPMDisp(CellPPPM):
    """Geometric-mix dispersion PPPM through the cell-patch pipeline.

    The production (scatter-free) form of the ``function[1]`` dispersion
    pipeline of /root/reference/pppm_disp_intel.cpp:245-313: one density
    channel a = B[type] deposited on the ``_6`` mesh, the dispersion
    Green's-function solve, and ik E-field gathers — all through the
    same patch/zblock transfer machinery as the Coulomb ``CellPPPM``.
    The anisotropic virial and per-atom corrections (:498-510, :512-537)
    come from the vfac tensor of ``pppm_disp.py``.  Arithmetic-7-channel
    and no-mix decks keep the reference pipeline (``pppm_disp.py``);
    every shipped deck (in.hexane's ``mixing geometric``) mixes
    geometrically.
    """

    def __init__(self, pmd: "PPPMDisp", grid: CellGrid, margin: int = 1,
                 skin: Optional[float] = None, transfer: str = "zblock"):
        from .pppm import PPPM as _PPPMCls

        shim = _PPPMCls(
            g_ewald=pmd.g_ewald_6, grid=pmd.grid, order=pmd.order,
            greensfn=pmd.greensfn, kx=pmd.kx, ky=pmd.ky, kz=pmd.kz,
            qsum=0.0, qsqsum=0.0, qqrd2e=1.0, volume=float(pmd.volume),
            box_lo=pmd.box_lo, h=pmd.h, acc_dtype=pmd.acc_dtype,
            diff=pmd.diff, sf_sine=pmd.sf_sine)
        if pmd.mix != "geometric":
            raise NotImplementedError(
                f"CellPPPMDisp: mix {pmd.mix!r} (geometric single-channel "
                "only; arithmetic/no-mix run the channel pipeline)")
        super().__init__(shim, grid, margin=margin,
                         per_slot_charge=np.asarray(pmd.B, np.float64),
                         skin=skin, transfer=transfer)
        self.pmd = pmd
        self.vfac = pmd.vfac

    def rebind(self, grid: CellGrid) -> "CellPPPMDisp":
        return CellPPPMDisp(self.pmd, grid, margin=self._margin0,
                            skin=self._skin0, transfer=self.transfer)
