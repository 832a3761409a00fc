"""Dense cell-pair force kernel over the sorted slot layout.

The production hot path (see neighbor/cell_slots.py): for every cell,
interactions against the 27 neighbor cells are evaluated as dense masked
(cap, 27*cap) tiles — zero per-pair random access.  This is the SIMD
j-loop of the reference (pair_buck_intel.cpp:236-275) re-shaped into wide
elementwise tiles, with INTEL_VMASK-style ``where`` masks doing the
cutoff/validity work.  Physics comes from the same ``pair_terms`` used by
the neighbor-list driver, so both paths share one validated formula set.

Special bonds: per-slot padded partner tables (atom-id space) are carried
through the rebin permutation and matched against j atom-ids inside the
tile — the SBBITS analog (SURVEY.md H2) without bit packing.

``compute_cell_tiles`` is the general form: i-cells and j-cells live in
separate index spaces connected by an explicit (ncell_i, 27) neighbor
table.  The single-device path uses the grid's periodic 27-table with
i == j; the slab-sharded engine (parallel/slab.py) feeds local i-cells
against a halo-extended j-slab — the ghost-atom machinery of the
reference (SURVEY.md H3) reduced to one table swap, because full
neighbor lists need no reverse force scatter.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.box import Box
from ...neighbor.cell_slots import CellGrid, SlotState
from .styles import PairStyle, pair_terms
from .driver import _select_small, COEF_NAMES


class CellPairResult(NamedTuple):
    fx: jnp.ndarray
    fy: jnp.ndarray
    fz: jnp.ndarray
    evdwl: jnp.ndarray
    ecoul: jnp.ndarray
    virial: jnp.ndarray


def _cell_tile_size(cap: int, ncell: int, budget_bytes: float = 2.5e8,
                    stencil: int = 27) -> int:
    """Cells per lax.map tile: bound the ~6 live (tile, cap, stencil*cap)
    f32 temporaries to ~budget."""
    per_cell = 6 * cap * stencil * cap * 4
    t = max(8, int(budget_bytes / max(per_cell, 1)))
    return min(ncell, t)


def compute_cell_tiles(
    style: PairStyle,
    L,                       # (3,) box lengths (minimum image)
    n: int,                  # atom-id sentinel (aid == n marks empty)
    cap: int,
    nbr_np: np.ndarray,      # (ncell_i, 27) static j-cell ids
    i_planes: dict,          # x,y,z,typ,q,aid : (ncell_i * cap,) planes
    j_planes: dict,          # same keys       : (ncell_j * cap,) planes
    *,
    eflag: bool = False,
    vflag: bool = False,
    acc_dtype=jnp.float32,
    slot_special_idx: Optional[jnp.ndarray] = None,   # (NS_i, S) atom ids
    slot_special_code: Optional[jnp.ndarray] = None,  # (NS_i, S) int8
    h_matrix: Optional[np.ndarray] = None,  # triclinic cell rows (greedy
    # z->y->x min image instead of per-axis rounding)
) -> CellPairResult:
    ncell = nbr_np.shape[0]
    ncell_j = j_planes["x"].shape[0] // cap
    flt = i_planes["x"].dtype
    if isinstance(L, (np.ndarray, list, tuple)):
        L = [float(v) for v in np.asarray(L)]     # static box: baked
    else:
        L = [L[0], L[1], L[2]]                    # traced (3,) box (NPT)
    ntypes = style.tables.shape[0]
    has_special = (slot_special_idx is not None
                   and slot_special_idx.shape[1] > 0)

    # tile over cells: bounds the memory of the (tile, cap, 27*cap)
    # temporaries (a monolithic 288k-atom energy pass needs >18 GB)
    tile = _cell_tile_size(cap, ncell)
    nt = -(-ncell // tile)
    pad = nt * tile - ncell

    def cellv(p):
        return p.reshape(ncell, cap)

    def jv(p):
        return p.reshape(ncell_j, cap)[jnp.asarray(nbr_np)].reshape(
            ncell, 27 * cap)

    def tiled(a, fill=0):
        if pad:
            a = jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a.reshape(nt, tile, *a.shape[1:])

    xi_t = [tiled(cellv(i_planes["x"])), tiled(cellv(i_planes["y"])),
            tiled(cellv(i_planes["z"]))]
    xj_t = [tiled(jv(j_planes["x"])), tiled(jv(j_planes["y"])),
            tiled(jv(j_planes["z"]))]
    aid_i_t = tiled(cellv(i_planes["aid"]), fill=n)
    aid_j_t = tiled(jv(j_planes["aid"]), fill=n)
    if ntypes > 1:
        ti_t = tiled(cellv(i_planes["typ"]))
        tj_t = tiled(jv(j_planes["typ"]))
    else:
        z = jnp.zeros((nt, tile, 0), jnp.int32)
        ti_t = tj_t = z
    if style.cfg.has_coul:
        qi_t = tiled(cellv(i_planes["q"]))
        qj_t = tiled(jv(j_planes["q"]))
    else:
        qi_t = qj_t = jnp.zeros((nt, tile, 0), flt)
    if has_special:
        sp_i_t = tiled(slot_special_idx.reshape(ncell, cap, -1), fill=-1)
        sp_c_t = tiled(
            slot_special_code.reshape(ncell, cap, -1).astype(jnp.int32))
    else:
        sp_i_t = sp_c_t = jnp.zeros((nt, tile, 0), jnp.int32)
    has_mol = "mol" in i_planes
    if has_mol:
        # same-molecule exclusion (neigh_modify exclude molecule/intra —
        # fix rigid/small's pair semantics): one compare per tile
        mi_t = tiled(cellv(i_planes["mol"]), fill=-1)
        mj_t = tiled(jv(j_planes["mol"]), fill=-2)
    else:
        mi_t = jnp.zeros((nt, tile, 0), jnp.int32)
        mj_t = jnp.zeros((nt, tile, 0), jnp.int32)

    flat_tables = np.asarray(style.tables).reshape(ntypes * ntypes, -1)

    def one_tile(args):
        (xi, yi, zi, xj, yj, zj, aid_i, aid_j, ti, tj, qi, qj,
         sp_i, sp_c, mi, mj) = args
        mask = (
            (aid_i[:, :, None] != aid_j[:, None, :])
            & (aid_i[:, :, None] < n)
            & (aid_j[:, None, :] < n)
        )
        if has_mol:
            mask = mask & (mi[:, :, None] != mj[:, None, :])
        if h_matrix is not None:
            # greedy z->y->x triclinic minimum image (core/box.py form)
            hm = np.asarray(h_matrix, np.float64)  # upper-tri (cols = box
            lx, ly, lz = float(hm[0, 0]), float(hm[1, 1]), float(hm[2, 2])
            t_xy, t_xz, t_yz = (float(hm[0, 1]), float(hm[0, 2]),
                                float(hm[1, 2]))
            dx = xi[:, :, None] - xj[:, None, :]
            dy = yi[:, :, None] - yj[:, None, :]
            dz = zi[:, :, None] - zj[:, None, :]
            n3 = jnp.round(dz * (1.0 / lz))
            dx = dx - n3 * t_xz
            dy = dy - n3 * t_yz
            dz = dz - n3 * lz
            n2 = jnp.round(dy * (1.0 / ly))
            dx = dx - n2 * t_xy
            dy = dy - n2 * ly
            dx = dx - jnp.round(dx * (1.0 / lx)) * lx
            d = [dx, dy, dz]
            rsq = dx * dx + dy * dy + dz * dz
        else:
            d = []
            rsq = None
            for ax, (ci, cj) in enumerate(((xi, xj), (yi, yj), (zi, zj))):
                dd = ci[:, :, None] - cj[:, None, :]  # (tile, cap, 27cap)
                dd = dd - jnp.round(dd * (1.0 / L[ax])) * L[ax]
                d.append(dd)
                rsq = dd * dd if rsq is None else rsq + dd * dd
        rsq = jnp.where(mask, rsq, jnp.asarray(1e30, flt))

        if ntypes == 1:
            coef = {name: float(flat_tables[0, ci])
                    for ci, name in enumerate(COEF_NAMES)}
        else:
            tt = ti[:, :, None] * ntypes + tj[:, None, :]
            coef = {name: _select_small(flat_tables[:, ci], tt, rsq.shape,
                                        flt)
                    for ci, name in enumerate(COEF_NAMES)}

        qip = qi[:, :, None] if style.cfg.has_coul else 0.0
        qjp = qj[:, None, :] if style.cfg.has_coul else 0.0

        if has_special:
            match = sp_i[:, :, None, :] == aid_j[:, None, :, None]
            sb = jnp.sum(jnp.where(match, sp_c[:, :, None, :], 0), axis=-1)
            f_lj = _select_small(style.special_lj, sb, rsq.shape, flt)
            f_coul = _select_small(style.special_coul, sb, rsq.shape, flt)
        else:
            f_lj = f_coul = 1.0

        fscalar, evdwl, ecoul = pair_terms(
            style, rsq, coef, qip, qjp, f_lj, f_coul, eflag=eflag
        )
        fscalar = jnp.where(mask, fscalar, 0.0)

        fx = jnp.sum((fscalar * d[0]).astype(acc_dtype), axis=2)
        fy = jnp.sum((fscalar * d[1]).astype(acc_dtype), axis=2)
        fz = jnp.sum((fscalar * d[2]).astype(acc_dtype), axis=2)
        if eflag:
            ev = jnp.sum(jnp.where(mask, evdwl, 0.0).astype(acc_dtype))
            ec = jnp.sum(jnp.where(mask, ecoul, 0.0).astype(acc_dtype))
        else:
            ev = ec = jnp.zeros((), acc_dtype)
        if vflag:
            w = fscalar * 0.5
            vir = jnp.stack([
                jnp.sum((w * d[0] * d[0]).astype(acc_dtype)),
                jnp.sum((w * d[1] * d[1]).astype(acc_dtype)),
                jnp.sum((w * d[2] * d[2]).astype(acc_dtype)),
                jnp.sum((w * d[0] * d[1]).astype(acc_dtype)),
                jnp.sum((w * d[0] * d[2]).astype(acc_dtype)),
                jnp.sum((w * d[1] * d[2]).astype(acc_dtype)),
            ])
        else:
            vir = jnp.zeros((6,), acc_dtype)
        return fx, fy, fz, ev, ec, vir

    fx_t, fy_t, fz_t, ev_t, ec_t, vir_t = jax.lax.map(
        one_tile,
        (xi_t[0], xi_t[1], xi_t[2], xj_t[0], xj_t[1], xj_t[2],
         aid_i_t, aid_j_t, ti_t, tj_t, qi_t, qj_t, sp_i_t, sp_c_t,
         mi_t, mj_t),
    )
    fx = fx_t.reshape(nt * tile, cap)[:ncell].reshape(-1)
    fy = fy_t.reshape(nt * tile, cap)[:ncell].reshape(-1)
    fz = fz_t.reshape(nt * tile, cap)[:ncell].reshape(-1)
    half = jnp.asarray(0.5, acc_dtype)
    evdwl_t = half * jnp.sum(ev_t)
    ecoul_t = half * jnp.sum(ec_t)
    virial = jnp.sum(vir_t, axis=0)

    return CellPairResult(fx=fx, fy=fy, fz=fz, evdwl=evdwl_t, ecoul=ecoul_t,
                          virial=virial)


def half_offsets(reach_z: int = 1) -> np.ndarray:
    """(K, 3) self + lexicographically-positive cell offsets for the
    Newton half stencil: ox, oy in {-1, 0, 1}, oz in [-reach_z, reach_z].
    Self (0,0,0) is row 0 (the kernel's i<j dedup block).  K = 9r + 5.

    z-only refinement needs no corner pruning: the minimum box-to-box
    distance of any kept offset is (reach_z-1) * edge_z < cutneigh by
    construction (edge_z >= cutneigh / reach_z)."""
    offs = [(0, 0, 0)]
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in range(-reach_z, reach_z + 1):
                if (ox, oy, oz) > (0, 0, 0):
                    offs.append((ox, oy, oz))
    return np.asarray(offs, np.int64)


def half_stencil_tables(nc: tuple, offs: np.ndarray):
    """Static per-(cell, half-offset) tables for the Newton kernel.

    Returns (half (ncell, K) j-cell ids of cell + off, inv (ncell, K)
    i-cell ids of cell - off for reaction routing, shifts (ncell, K, 3)
    in {-1, 0, +1}: true j position = gathered position + s * L).  The
    shift replaces the per-pair minimum-image rounding (exact for
    nc >= 2*|off|+1 per axis: wrap is at most one box length, and any
    pair whose direct path exceeds the cutoff is masked while the
    wrapped image is provably outside the cutoff too).
    """
    ncx, ncy, ncz = nc
    ci, cj, ck = np.meshgrid(
        np.arange(ncx), np.arange(ncy), np.arange(ncz), indexing="ij")
    cells = np.stack([ci.reshape(-1), cj.reshape(-1), ck.reshape(-1)], -1)
    ncv = np.asarray(nc)
    K = offs.shape[0]
    ncell = cells.shape[0]
    half = np.zeros((ncell, K), np.int32)
    inv = np.zeros((ncell, K), np.int32)
    # float64: the shift*L product must round at the TARGET precision, not
    # f32 (an f32-rounded box length costs ~1e-6 force error in f64 runs)
    shifts = np.zeros((ncell, K, 3), np.float64)
    for k in range(K):
        tgt = cells + offs[k]
        shifts[:, k, :] = (tgt >= ncv).astype(np.float64) - (tgt < 0)
        w = np.mod(tgt, ncv)
        half[:, k] = (w[:, 0] * ncy + w[:, 1]) * ncz + w[:, 2]
        wi = np.mod(cells - offs[k], ncv)
        inv[:, k] = (wi[:, 0] * ncy + wi[:, 1]) * ncz + wi[:, 2]
    return half, inv, shifts


def compute_cell_tiles_newton(
    style: PairStyle,
    L,
    grid: CellGrid,
    planes: dict,
    *,
    eflag: bool = False,
    vflag: bool = False,
    acc_dtype=jnp.float32,
    slot_special_idx: Optional[jnp.ndarray] = None,
    slot_special_code: Optional[jnp.ndarray] = None,
    h_matrix: Optional[np.ndarray] = None,
    uniform_special=None,
) -> CellPairResult:
    """Half-stencil form of the dense kernel (Newton's 3rd law).

    Instead of evaluating all neighbor tiles per cell and keeping only
    the i-side force sum, evaluate K = self + the lexicographically
    positive offsets (14 at reach_z=1, 9r+5 in general — see
    half_offsets) and accumulate BOTH sides: f_i from the j-axis
    reduction, and the reaction forces -sum_i fs*d routed back to the
    j-cells through the static negated-offset table.  This is the
    reference's half neighbor list + Newton flag
    (pair_buck_intel.cpp:236-275 runs full lists; host LAMMPS defaults
    to `newton on` half lists) in dense-tile form — ~1.9x less pair
    physics for two cheap extra reductions and K-1 static row gathers.
    j coordinates are pre-shifted by the per-(cell, offset) periodic
    wrap (see half_stencil_tables), removing the per-pair minimum-image
    rounding entirely.  grid.reach_z > 1 runs the density-adaptive
    z-refined stencil (fewer candidates per atom at equal coverage).
    """
    ncell = grid.ncell
    cap = grid.cap
    n = grid.n_atoms
    flt = planes["x"].dtype
    L = [float(v) for v in np.asarray(L)]
    ntypes = style.tables.shape[0]
    has_special = (slot_special_idx is not None
                   and slot_special_idx.shape[1] > 0)
    # uniform-special fast path: planes["umol"] carries molecule ids and
    # ONE (f_lj, f_coul) applies to every same-molecule pair — a single
    # compare instead of the (tile, cap, K*cap, S) partner matching
    has_usp = uniform_special is not None and "umol" in planes
    if has_usp:
        has_special = False

    offs = half_offsets(grid.reach_z)
    K = offs.shape[0]
    half, inv_np, shifts = half_stencil_tables(grid.nc, offs)
    # cartesian shift per (cell, half-offset, axis): orthogonal boxes use
    # diag(L); a triclinic h mixes lamda shifts into all three axes
    # (cells are uniform in lamda space, so the {-1,0,+1} table is the
    # fractional shift — cart = h @ s_frac)
    h_cart = (np.diag(np.asarray(L, np.float64)) if h_matrix is None
              else np.asarray(h_matrix, np.float64))
    shift_cart = np.einsum("ckb,ab->cka", shifts, h_cart)

    # temporaries are (tile, cap, K*cap): half the full-stencil footprint.
    # The budget bounds device memory; bigger tiles mean fewer sequential
    # lax.map iterations
    tile = _cell_tile_size(cap, ncell, budget_bytes=5.4e8, stencil=K)
    nt = -(-ncell // tile)
    pad = nt * tile - ncell

    def cellv(p):
        return p.reshape(ncell, cap)

    half_j = jnp.asarray(half)

    def jv(p, shift_ax=None):
        a = p.reshape(ncell, cap)[half_j]                  # (ncell, K, cap)
        if shift_ax is not None:
            s = shift_cart[:, :, shift_ax]
            a = a + jnp.asarray(s, flt)[:, :, None]
        return a.reshape(ncell, K * cap)

    def tiled(a, fill=0):
        if pad:
            a = jnp.concatenate(
                [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a.reshape(nt, tile, *a.shape[1:])

    xi_t = [tiled(cellv(planes["x"])), tiled(cellv(planes["y"])),
            tiled(cellv(planes["z"]))]
    xj_t = [tiled(jv(planes["x"], 0)), tiled(jv(planes["y"], 1)),
            tiled(jv(planes["z"], 2))]
    aid_i_t = tiled(cellv(planes["aid"]), fill=n)
    aid_j_t = tiled(jv(planes["aid"]), fill=n)
    if ntypes > 1:
        ti_t = tiled(cellv(planes["typ"]))
        tj_t = tiled(jv(planes["typ"]))
    else:
        z = jnp.zeros((nt, tile, 0), jnp.int32)
        ti_t = tj_t = z
    if style.cfg.has_coul:
        qi_t = tiled(cellv(planes["q"]))
        qj_t = tiled(jv(planes["q"]))
    else:
        qi_t = qj_t = jnp.zeros((nt, tile, 0), flt)
    if has_special:
        sp_i_t = tiled(slot_special_idx.reshape(ncell, cap, -1), fill=-1)
        sp_c_t = tiled(
            slot_special_code.reshape(ncell, cap, -1).astype(jnp.int32))
    else:
        sp_i_t = sp_c_t = jnp.zeros((nt, tile, 0), jnp.int32)
    has_mol = "mol" in planes
    if has_mol:
        # same-molecule exclusion (fix rigid/small pair semantics)
        mi_t = tiled(cellv(planes["mol"]), fill=-1)
        mj_t = tiled(jv(planes["mol"]), fill=-2)
    else:
        mi_t = jnp.zeros((nt, tile, 0), jnp.int32)
        mj_t = jnp.zeros((nt, tile, 0), jnp.int32)
    if has_usp:
        um_i_t = tiled(cellv(planes["umol"]), fill=-1)
        um_j_t = tiled(jv(planes["umol"]), fill=-2)
    else:
        um_i_t = jnp.zeros((nt, tile, 0), jnp.int32)
        um_j_t = jnp.zeros((nt, tile, 0), jnp.int32)

    flat_tables = np.asarray(style.tables).reshape(ntypes * ntypes, -1)
    # static: which of the K*cap j-columns form the self block
    self_block = np.zeros((K * cap,), bool)
    self_block[:cap] = True
    self_block_j = jnp.asarray(self_block)

    def one_tile(args):
        (xi, yi, zi, xj, yj, zj, aid_i, aid_j, ti, tj, qi, qj,
         sp_i, sp_c, mi, mj, um_i, um_j) = args
        valid = (aid_i[:, :, None] < n) & (aid_j[:, None, :] < n)
        # self tile: count each pair once (i < j); cross tiles: all pairs
        dedup = jnp.where(self_block_j[None, None, :],
                          aid_i[:, :, None] < aid_j[:, None, :], True)
        mask = valid & dedup
        if has_mol:
            mask = mask & (mi[:, :, None] != mj[:, None, :])
        d = []
        rsq = None
        for ci, cj in ((xi, xj), (yi, yj), (zi, zj)):
            dd = ci[:, :, None] - cj[:, None, :]   # pre-shifted: no round
            d.append(dd)
            rsq = dd * dd if rsq is None else rsq + dd * dd
        rsq = jnp.where(mask, rsq, jnp.asarray(1e30, flt))

        if ntypes == 1:
            coef = {name: float(flat_tables[0, ci])
                    for ci, name in enumerate(COEF_NAMES)}
        else:
            tt = ti[:, :, None] * ntypes + tj[:, None, :]
            coef = {name: _select_small(flat_tables[:, ci], tt, rsq.shape,
                                        flt)
                    for ci, name in enumerate(COEF_NAMES)}

        qip = qi[:, :, None] if style.cfg.has_coul else 0.0
        qjp = qj[:, None, :] if style.cfg.has_coul else 0.0

        if has_usp:
            same = um_i[:, :, None] == um_j[:, None, :]
            one = jnp.asarray(1.0, flt)
            f_lj = jnp.where(same, jnp.asarray(uniform_special[0], flt),
                             one)
            f_coul = jnp.where(same, jnp.asarray(uniform_special[1], flt),
                               one)
        elif has_special:
            match = sp_i[:, :, None, :] == aid_j[:, None, :, None]
            sb = jnp.sum(jnp.where(match, sp_c[:, :, None, :], 0), axis=-1)
            f_lj = _select_small(style.special_lj, sb, rsq.shape, flt)
            f_coul = _select_small(style.special_coul, sb, rsq.shape, flt)
        else:
            f_lj = f_coul = 1.0

        fscalar, evdwl, ecoul = pair_terms(
            style, rsq, coef, qip, qjp, f_lj, f_coul, eflag=eflag
        )
        fscalar = jnp.where(mask, fscalar, 0.0)

        fd = [(fscalar * dd).astype(acc_dtype) for dd in d]
        fx = jnp.sum(fd[0], axis=2)
        fy = jnp.sum(fd[1], axis=2)
        fz = jnp.sum(fd[2], axis=2)
        # reaction forces for the j-cells (Newton): -sum over i
        gx = -jnp.sum(fd[0], axis=1)
        gy = -jnp.sum(fd[1], axis=1)
        gz = -jnp.sum(fd[2], axis=1)
        if eflag:
            ev = jnp.sum(jnp.where(mask, evdwl, 0.0).astype(acc_dtype))
            ec = jnp.sum(jnp.where(mask, ecoul, 0.0).astype(acc_dtype))
        else:
            ev = ec = jnp.zeros((), acc_dtype)
        if vflag:
            vir = jnp.stack([
                jnp.sum((fscalar * d[0] * d[0]).astype(acc_dtype)),
                jnp.sum((fscalar * d[1] * d[1]).astype(acc_dtype)),
                jnp.sum((fscalar * d[2] * d[2]).astype(acc_dtype)),
                jnp.sum((fscalar * d[0] * d[1]).astype(acc_dtype)),
                jnp.sum((fscalar * d[0] * d[2]).astype(acc_dtype)),
                jnp.sum((fscalar * d[1] * d[2]).astype(acc_dtype)),
            ])
        else:
            vir = jnp.zeros((6,), acc_dtype)
        return fx, fy, fz, gx, gy, gz, ev, ec, vir

    fx_t, fy_t, fz_t, gx_t, gy_t, gz_t, ev_t, ec_t, vir_t = jax.lax.map(
        one_tile,
        (xi_t[0], xi_t[1], xi_t[2], xj_t[0], xj_t[1], xj_t[2],
         aid_i_t, aid_j_t, ti_t, tj_t, qi_t, qj_t, sp_i_t, sp_c_t,
         mi_t, mj_t, um_i_t, um_j_t),
    )

    def uncell(a):   # (nt, tile, cap) -> (ncell, cap)
        return a.reshape(nt * tile, cap)[:ncell]

    fx = uncell(fx_t)
    fy = uncell(fy_t)
    fz = uncell(fz_t)
    g = [gx_t.reshape(nt * tile, K, cap)[:ncell],
         gy_t.reshape(nt * tile, K, cap)[:ncell],
         gz_t.reshape(nt * tile, K, cap)[:ncell]]
    # route reaction forces back: the contribution computed at i-cell
    # c - off_k (the negated-offset table) lands on j-cell c
    fx = fx + g[0][:, 0]
    fy = fy + g[1][:, 0]
    fz = fz + g[2][:, 0]
    for k in range(1, K):
        inv = jnp.asarray(inv_np[:, k])
        fx = fx + g[0][:, k][inv]
        fy = fy + g[1][:, k][inv]
        fz = fz + g[2][:, k][inv]

    return CellPairResult(
        fx=fx.reshape(-1), fy=fy.reshape(-1), fz=fz.reshape(-1),
        evdwl=jnp.sum(ev_t), ecoul=jnp.sum(ec_t),
        virial=jnp.sum(vir_t, axis=0),
    )


def slot_mol_gather(excl_mol_pad, aid, n: int):
    """Padded atom-order molecule table -> slot order (row n is the -1
    sentinel for empty slots).  Shared by both engines so the exclusion
    padding convention lives in one place."""
    return jnp.asarray(excl_mol_pad)[jnp.minimum(aid, n)]


def _state_planes(state: SlotState) -> dict:
    return dict(x=state.x, y=state.y, z=state.z, typ=state.typ,
                q=state.q, aid=state.aid)


def compute_cellpair(
    style: PairStyle,
    grid: CellGrid,
    box: Box,
    state: SlotState,
    *,
    eflag: bool = False,
    vflag: bool = False,
    acc_dtype=jnp.float32,
    slot_special_idx: Optional[jnp.ndarray] = None,   # (NS, S) atom ids
    slot_special_code: Optional[jnp.ndarray] = None,  # (NS, S) int8
    newton: bool = True,
    slot_mol: Optional[jnp.ndarray] = None,           # (NS,) mol ids >= 0
    uniform_special=None,                             # (f_lj, f_coul)
    slot_umol: Optional[jnp.ndarray] = None,          # (NS,) mol ids
) -> CellPairResult:
    """Single-device form: i == j == the full grid, periodic 27-table.

    newton=True uses the half-stencil kernel (~1.9x less pair physics);
    newton=False keeps the full 27-tile form (reference comparison and
    the slab engine's halo semantics).  Triclinic boxes run the Newton
    kernel (its static per-(cell, offset) shifts generalize to h @ s;
    the full kernel's per-axis rounding does not).

    slot_mol: optional per-slot molecule ids (>= 0; empty slots already
    masked by aid) — same-molecule pairs are fully excluded, the
    `neigh_modify exclude molecule/intra` contract fix rigid/small needs."""
    planes = _state_planes(state)
    if slot_mol is not None:
        planes["mol"] = slot_mol
    if uniform_special is not None and slot_umol is not None:
        planes["umol"] = slot_umol
    h = box.h_matrix if box.is_triclinic else None
    if grid.reach_z > 1 and not (newton or h is not None):
        raise NotImplementedError(
            "z-refined cell grids run the Newton half-stencil kernel only")
    if newton or h is not None:
        return compute_cell_tiles_newton(
            style, box.lengths, grid, planes,
            eflag=eflag, vflag=vflag, acc_dtype=acc_dtype,
            slot_special_idx=slot_special_idx,
            slot_special_code=slot_special_code,
            h_matrix=h,
            uniform_special=uniform_special,
        )
    return compute_cell_tiles(
        style, box.lengths, grid.n_atoms, grid.cap, grid.nbr_array(),
        planes, planes,
        eflag=eflag, vflag=vflag, acc_dtype=acc_dtype,
        slot_special_idx=slot_special_idx,
        slot_special_code=slot_special_code,
    )
