"""Slab-sharded cell-patch PPPM — the multi-chip k-space pipeline.

Distributes the CellPPPM pipeline (pppm_cells.py) over a 1-D device mesh
whose axis shards the cell grid's x direction (parallel/slab.py owns the
atom side).  This is the device-mesh analog of the reference's distributed
mesh machinery (SURVEY.md H4):

* mesh ghost-cell reduction  (``cg->reverse_comm(REVERSE_RHO)``,
  /root/reference/pppm_intel.cpp:185) -> deposition overhang planes summed into
  x-neighbors with ``lax.ppermute`` over ICI;
* E-field ghost fill (``cg->forward_comm(FORWARD_IK)``, pppm_intel.cpp:
  219-228) -> ppermute halo planes of the E-meshes before the patch gather;
* brick->pencil Remap + distributed FFT (pppm_intel.cpp:642-672, 835) ->
  ``lax.all_to_all`` transpose between a y/z-local FFT pass (x-sharded
  bricks) and an x-local pass (y-sharded pencils);
* ``MPI_Allreduce`` energy/virial (pppm_intel.cpp:260,273) -> ``lax.psum``.

Everything here runs INSIDE ``shard_map`` — functions take the local shard
and the mesh axis name.  Spectral constants (Green's function, k vectors)
arrive as sharded *arguments* (never closures: closed-over device arrays
poison compilation on this runtime, see core/box.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.precision import MATMUL
from ...neighbor.cell_slots import CellGrid, SlotState
from .pppm import PPPM
from .pppm_cells import (
    PatchSpec, make_patch_spec, _axis_weights, _ranges, _OFF3,
)


def _perm_right(D):
    """Send to the +x ring neighbor (receive from the left)."""
    return [(i, (i + 1) % D) for i in range(D)]


def _perm_left(D):
    return [(i, (i - 1) % D) for i in range(D)]


def patches_to_grid_slab(patches, ps: PatchSpec, nc_loc, dtype=None):
    """(ncell_loc, Px, Py, Pz) -> ((ncx_loc+2)*Sx, ny, nz) extended slab.

    x-overhang is NOT wrapped — it lands on the extra boundary planes for
    the caller to ppermute into the neighbors; y/z wrap locally (those axes
    are unsharded)."""
    ncx, ncy, ncz = nc_loc
    Sx, Sy, Sz = ps.S
    pat = patches.reshape(ncx, ncy, ncz, *ps.P)
    G = jnp.zeros((ncx + 2, Sx, ncy, Sy, ncz, Sz),
                  dtype or patches.dtype)
    for (ox, oy, oz) in _OFF3:
        psx, gsx = _ranges(ps, 0, ox)
        psy, gsy = _ranges(ps, 1, oy)
        psz, gsz = _ranges(ps, 2, oz)
        part = pat[:, :, :, psx, psy, psz]
        part = jnp.roll(part, (oy, oz), axis=(1, 2))
        G = G.at[1 + ox:1 + ox + ncx, gsx, :, gsy, :, gsz].add(
            jnp.moveaxis(part, (3, 4, 5), (1, 3, 5))
        )
    return G.reshape((ncx + 2) * Sx, ncy * Sy, ncz * Sz)


def grid_to_patches_slab(mesh_ext, ps: PatchSpec, nc_loc):
    """((ncx_loc+2)*Sx, ny, nz) extended slab -> (ncell_loc, Px, Py, Pz).

    Same strided-window extraction as pppm_cells.grid_to_patches; the x
    axis reads the halo-extended slab instead of wrapping (window of cell
    lx starts at ext index Sx + lx*Sx - lo_off)."""
    from .pppm_cells import _expand_axis

    ncx, ncy, ncz = nc_loc
    Sx = ps.S[0]
    a = _expand_axis(mesh_ext, 0, ncx, Sx, ps.P[0], ps.lo_off[0],
                     periodic=False, start=Sx - ps.lo_off[0])
    a = _expand_axis(a, 2, ncy, ps.S[1], ps.P[1], ps.lo_off[1])
    a = _expand_axis(a, 4, ncz, ps.S[2], ps.P[2], ps.lo_off[2])
    a = jnp.transpose(a, (0, 2, 4, 1, 3, 5))
    return a.reshape(ncx * ncy * ncz, *ps.P)


def fft3_slab(mesh_loc, axis: str, D: int, batch_dims: int = 0):
    """x-sharded brick (nx_loc, ny, nz) -> y-sharded half-spectrum pencils
    (nx, ny_loc, nz//2+1).  The all_to_all IS the reference's Remap.

    z uses the REAL transform so the whole pipeline shares the single-chip
    engine's rfftn convention bit-for-bit (transform order fft_x(fft_y(
    rfft_z)), matching jnp.fft.rfftn): the even-grid Nyquist planes of the
    non-Hermitian ik field project differently under real(c2c) vs irfft,
    a ~1e-5 relative force difference that would break cross-engine
    parity.

    batch_dims leading axes ride along (the dispersion pipeline batches
    its nch channel meshes through ONE all_to_all instead of nch)."""
    b = batch_dims
    h = jnp.fft.rfft(mesh_loc, axis=b + 2)
    h = jnp.fft.fft(h, axis=b + 1)
    if D > 1:
        h = jax.lax.all_to_all(h, axis, split_axis=b + 1,
                               concat_axis=b + 0, tiled=True)
    return jnp.fft.fft(h, axis=b + 0)


def ifft3_slab(spec, nz: int, axis: str, D: int, batch_dims: int = 0):
    """Inverse of fft3_slab: (nx, ny_loc, nz//2+1) -> real (nx_loc, ny, nz)
    (irfft along z, the jnp.fft.irfftn transform order)."""
    b = batch_dims
    t = jnp.fft.ifft(spec, axis=b + 0)
    if D > 1:
        t = jax.lax.all_to_all(t, axis, split_axis=b + 0,
                               concat_axis=b + 1, tiled=True)
    t = jnp.fft.ifft(t, axis=b + 1)
    return jnp.fft.irfft(t, n=nz, axis=b + 2)


class SlabCellPPPM:
    """Cell-patch PPPM over a 1-D slab mesh; plugs into the slab engine.

    ``spectral_consts()`` returns the host arrays the caller must place
    with the matching shardings (G: P(None, axis, None), ky: P(axis),
    kx/kz: replicated) and pass to ``compute_slots_local`` each step.
    """

    def __init__(self, pm: PPPM, grid: CellGrid, n_dev: int,
                 margin: int = 2, skin: Optional[float] = None):
        self.pm = pm
        self.grid = grid
        self.D = int(n_dev)
        self.ps = make_patch_spec(pm, grid, margin=margin, skin=skin)
        if grid.nc[0] % self.D:
            raise ValueError(
                f"cell grid x extent {grid.nc[0]} not divisible by "
                f"{self.D} devices")
        if pm.grid[1] % self.D:
            raise ValueError(
                f"pppm grid ny={pm.grid[1]} not divisible by {self.D} "
                "devices (pass multiple_of with lcm(ncy, n_dev))")
        self.ncx_loc = grid.nc[0] // self.D
        self.nc_loc = (self.ncx_loc, grid.nc[1], grid.nc[2])

    def spectral_consts(self) -> dict:
        """Host numpy spectral tables (z half-spectrum); caller shards."""
        pm = self.pm
        nzh = pm.grid[2] // 2 + 1
        from .pppm_cells import _half_weights

        return dict(G=pm.greensfn[..., :nzh], kx=pm.kx, ky=pm.ky,
                    kz=pm.kz[:nzh],
                    wz=_half_weights(pm.grid[2]))

    def shardings(self, mesh, axis: str = "x"):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return dict(
            G=NamedSharding(mesh, P(None, axis, None)),
            kx=NamedSharding(mesh, P()),
            ky=NamedSharding(mesh, P(axis)),
            kz=NamedSharding(mesh, P()),
            wz=NamedSharding(mesh, P()),
        )

    def in_specs(self, axis: str = "x"):
        from jax.sharding import PartitionSpec as P

        return dict(G=P(None, axis, None), kx=P(), ky=P(axis), kz=P(),
                    wz=P())

    # ---- the local (inside-shard_map) pipeline ----

    def _weights_local(self, state: SlotState, cell_off,
                       deriv: bool = False):
        """Per-axis (ncell_loc, cap, P) B-spline weights for local slots.

        cell_off: traced scalar — this device's first global x cell.
        deriv: also return the derivative weights (grid units, already
        scaled by -1/h — the drho_coeff analog for the ad path)."""
        pm, ps = self.pm, self.ps
        cap = self.grid.cap
        gl = dataclasses.replace(self.grid, nc=self.nc_loc)
        ncell = gl.ncell
        # x axis: static local cell table + traced global offset folded
        # into the grid coordinate (patch_lo stays static)
        xoff = cell_off.astype(state.x.dtype) * (ps.S[0] * pm.h[0])
        planes = (state.x - xoff, state.y, state.z)
        if not deriv:
            out = [_axis_weights(pm, ps, gl, planes[ax], ax)
                   for ax in range(3)]
            return tuple(w.reshape(ncell, cap, -1) for w in out)
        ws, dws = [], []
        for ax in range(3):
            w, dw = _axis_weights(pm, ps, gl, planes[ax], ax, deriv=True)
            ws.append(w.reshape(ncell, cap, -1))
            dws.append((dw * (-1.0 / pm.h[ax])).reshape(ncell, cap, -1))
        return tuple(ws), tuple(dws)

    def _tile_pads(self, ncell):
        tile = min(self.ps.cell_tile, ncell)
        nt = -(-ncell // tile)
        return tile, nt, nt * tile - ncell

    def compute_slots_local(self, state: SlotState, kc: dict,
                            eflag: bool, vflag: bool, axis: str = "x"):
        """Local shard of (fx, fy, fz, elong, virial); elong/virial are
        psum-completed (replicated).  state: local slot planes."""
        pm, ps, D = self.pm, self.ps, self.D
        grid_loc = self.nc_loc
        cap = self.grid.cap
        ncell = grid_loc[0] * grid_loc[1] * grid_loc[2]
        acc = pm.acc_dtype
        flt = state.x.dtype
        V = float(pm.volume)
        Sx = ps.S[0]
        dev = (jax.lax.axis_index(axis) if D > 1
               else jnp.zeros((), jnp.int32))
        cell_off = dev * self.ncx_loc

        qqrd2e = float(pm.qqrd2e)
        if pm.diff == "ad":
            (wx, wy, wz), (dwx, dwy, dwz) = self._weights_local(
                state, cell_off, deriv=True)
        else:
            wx, wy, wz = self._weights_local(state, cell_off)
        q2d = state.q.reshape(ncell, cap)

        # ---- deposition (make_rho + reverse_comm analog) ----
        tile, nt, pad = self._tile_pads(ncell)

        def padc(a):
            return jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

        qx_t = padc(wx * q2d[:, :, None]).reshape(nt, tile, cap, ps.P[0])
        wy_t = padc(wy).reshape(nt, tile, cap, ps.P[1])
        wz_t = padc(wz).reshape(nt, tile, cap, ps.P[2])

        def dep_tile(args):
            qxb, wyb, wzb = args
            wyz = jnp.einsum("tay,taz->tayz", wyb, wzb, precision=MATMUL)
            return jnp.einsum("tax,tayz->txyz", qxb, wyz, precision=MATMUL)

        pat = jax.lax.map(dep_tile, (qx_t, wy_t, wz_t))
        pat = pat.reshape(nt * tile, *ps.P)[:ncell]
        G_ext = patches_to_grid_slab(pat, ps, grid_loc)
        mesh = G_ext[Sx:-Sx]
        if D > 1:
            from_right = jax.lax.ppermute(G_ext[:Sx], axis, _perm_left(D))
            from_left = jax.lax.ppermute(G_ext[-Sx:], axis, _perm_right(D))
        else:
            from_right, from_left = G_ext[:Sx], G_ext[-Sx:]
        mesh = mesh.at[-Sx:].add(from_right).at[:Sx].add(from_left)

        # ---- pencil FFT + spectral solve (z half-spectrum) ----
        nz = pm.grid[2]
        rhat = fft3_slab(mesh.astype(acc), axis, D)  # (nx, ny_loc, nzh)
        G = kc["G"].astype(acc)
        phi_hat = G * rhat

        def allsum(v):
            return jax.lax.psum(v, axis) if D > 1 else v

        if eflag or vflag:
            s2 = jnp.real(rhat * jnp.conj(rhat))
            # wz doubles the interior z modes the half-spectrum folds away
            ek = G * s2 * kc["wz"].astype(acc)[None, None, :]
        if eflag:
            elong = allsum((0.5 / V) * jnp.sum(ek.astype(acc))) * qqrd2e
            elong = elong + pm.elong_self
        else:
            elong = jnp.zeros((), acc)

        kx = kc["kx"].astype(acc)[:, None, None]
        ky = kc["ky"].astype(acc)[None, :, None]
        kz = kc["kz"].astype(acc)[None, None, :]
        if vflag:
            ksq = kx * kx + ky * ky + kz * kz
            ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
            pref = 2.0 * (1.0 / ksq_safe + 0.25 / pm.g_ewald**2)
            c = (0.5 / V) * qqrd2e
            virial = allsum(jnp.stack([
                jnp.sum((ek * (1.0 - pref * kx * kx)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * ky * ky)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * kz * kz)).astype(acc)),
                jnp.sum((ek * (-pref * kx * ky)).astype(acc)),
                jnp.sum((ek * (-pref * kx * kz)).astype(acc)),
                jnp.sum((ek * (-pref * ky * kz)).astype(acc)),
            ])) * c
        else:
            virial = jnp.zeros((6,), acc)

        # ---- inverse pencil FFT(s), halo, patch gather ----
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        scale = (1.0 / V) * ngrid
        wx_t = padc(wx).reshape(nt, tile, cap, ps.P[0])

        def halo_patches(em):
            if D > 1:
                left_h = jax.lax.ppermute(em[-Sx:], axis, _perm_right(D))
                right_h = jax.lax.ppermute(em[:Sx], axis, _perm_left(D))
            else:
                left_h, right_h = em[-Sx:], em[:Sx]
            em_ext = jnp.concatenate([left_h, em, right_h], axis=0)
            ep = grid_to_patches_slab(em_ext, ps, grid_loc)
            return padc(ep).reshape(nt, tile, *ps.P)

        def gat_tile(args):
            wxb, wyb, wzb, eb = args
            t1 = jnp.einsum("tax,txyz->tayz", wxb, eb, precision=MATMUL)
            t2 = jnp.einsum("tay,tayz->taz", wyb, t1, precision=MATMUL)
            return jnp.einsum("taz,taz->ta", wzb, t2, precision=MATMUL)

        out = []
        if pm.diff == "ad":
            # ONE inverse FFT -> potential mesh; derivative-spline gather
            # + measured self-force series (the poisson_ad/fieldforce_ad
            # pair of /root/reference/pppm_intel.cpp:985-1054, :678-804
            # under the pencil decomposition)
            u = (ifft3_slab(phi_hat, nz, axis, D) * scale).astype(flt)
            ep_t = halo_patches(u)
            dwx_t = padc(dwx).reshape(nt, tile, cap, ps.P[0])
            dwy_t = padc(dwy).reshape(nt, tile, cap, ps.P[1])
            dwz_t = padc(dwz).reshape(nt, tile, cap, ps.P[2])
            triples = [(dwx_t, wy_t, wz_t), (wx_t, dwy_t, wz_t),
                       (wx_t, wy_t, dwz_t)]
            for (wa, wb, wc) in triples:
                f = jax.lax.map(gat_tile, (wa, wb, wc, ep_t))
                out.append(f.reshape(nt * tile, cap)[:ncell].reshape(-1))
            qf = (qqrd2e * state.q).astype(acc)
            fx = out[0].astype(acc) * qf
            fy = out[1].astype(acc) * qf
            fz = out[2].astype(acc) * qf
            if pm.sf_sine is not None:
                from .pppm import sf_axis_series

                q2 = (qqrd2e * state.q * state.q).astype(acc)
                sf = [sf_axis_series(pm, p, a2).astype(acc) * q2
                      for a2, p in enumerate((state.x, state.y, state.z))]
                fx, fy, fz = fx - sf[0], fy - sf[1], fz - sf[2]
            return fx, fy, fz, elong, virial

        for kax in (kx, ky, kz):
            ehat = (-1j) * kax * phi_hat
            em = (ifft3_slab(ehat, nz, axis, D) * scale).astype(flt)
            ep_t = halo_patches(em)
            f = jax.lax.map(gat_tile, (wx_t, wy_t, wz_t, ep_t))
            out.append(f.reshape(nt * tile, cap)[:ncell].reshape(-1))

        qf = (qqrd2e * state.q).astype(acc)
        return (out[0].astype(acc) * qf, out[1].astype(acc) * qf,
                out[2].astype(acc) * qf, elong, virial)


class SlabCellPPPMDisp(SlabCellPPPM):
    """Pencil-sharded dispersion PPPM over the slab mesh — every mixing
    rule through the channel decomposition of pppm_disp.py.

    The dispersion analog of SlabCellPPPM: per-channel patch deposition
    with ppermute overhang planes, ``all_to_all`` pencil FFTs on the
    ``_6`` mesh, the paired spectral solve chi = P S, and per-channel ik
    E-field gathers — the reference's dual-pipeline machinery
    (/root/reference/pppm_disp_intel.cpp:245-467: geometric one-channel,
    arithmetic 7-channel make_rho_a + poisson_2s pairs, no-mix nsplit)
    under the same GridComm/Remap contracts the Coulomb pencil implements
    (pppm_intel.cpp:185, 219-228, 642-672).  The k=0 and self-energy
    corrections depend only on composition (``elong_const``), so they are
    baked as host constants at construction; empty slots are masked by
    aid (their typ plane is 0, which would otherwise read a real B).
    """

    def __init__(self, pmd, grid: CellGrid, n_dev: int, typ,
                 margin: int = 2, skin: Optional[float] = None):
        super().__init__(pmd, grid, n_dev, margin=margin, skin=skin)
        A = np.asarray(pmd.A, np.float64)            # (nch, ntypes)
        Pm = np.asarray(pmd.P, np.float64)           # (nch, nch)
        t = np.asarray(typ, np.int64)
        a_atoms = A[:, t]                            # (nch, N)
        asum = a_atoms.sum(axis=1)
        self.e0 = float((0.5 / pmd.volume) * pmd.w0 * (asum @ Pm @ asum))
        self.e_self = float(
            pmd.g_ewald_6 ** 6 / 12.0
            * np.einsum("cn,cd,dn->", a_atoms, Pm, a_atoms))
        self.A = A
        self.Pm = Pm
        self.nch = A.shape[0]

    def spectral_consts(self) -> dict:
        out = super().spectral_consts()
        out["vfac"] = self.pm.vfac[..., :self.pm.grid[2] // 2 + 1]
        return out

    def shardings(self, mesh, axis: str = "x"):
        from jax.sharding import NamedSharding, PartitionSpec as P

        out = super().shardings(mesh, axis)
        out["vfac"] = NamedSharding(mesh, P(None, axis, None))
        return out

    def in_specs(self, axis: str = "x"):
        from jax.sharding import PartitionSpec as P

        out = super().in_specs(axis)
        out["vfac"] = P(None, axis, None)
        return out

    def compute_slots_local(self, state: SlotState, kc: dict,
                            eflag: bool, vflag: bool, axis: str = "x"):
        pm, ps, D = self.pm, self.ps, self.D
        grid_loc = self.nc_loc
        cap = self.grid.cap
        ncell = grid_loc[0] * grid_loc[1] * grid_loc[2]
        acc = pm.acc_dtype
        flt = state.x.dtype
        V = float(pm.volume)
        Sx = ps.S[0]
        n = self.grid.n_atoms
        dev = (jax.lax.axis_index(axis) if D > 1
               else jnp.zeros((), jnp.int32))
        cell_off = dev * self.ncx_loc

        wx, wy, wz_spl = self._weights_local(state, cell_off)
        # per-slot channel amplitudes; empty slots carry typ 0 -> aid mask
        amask = (state.aid < n).astype(flt)
        At = jnp.asarray(self.A, flt)
        a_slots = At[:, state.typ] * amask[None, :]   # (nch, ns_loc)

        tile, nt, pad = self._tile_pads(ncell)

        def padc(a):
            return jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a

        wy_t = padc(wy).reshape(nt, tile, cap, ps.P[1])
        wz_t = padc(wz_spl).reshape(nt, tile, cap, ps.P[2])

        def dep_tile(args):
            axb, wyb, wzb = args
            wyz = jnp.einsum("tay,taz->tayz", wyb, wzb, precision=MATMUL)
            return jnp.einsum("tax,tayz->txyz", axb, wyz, precision=MATMUL)

        # ---- per-channel deposition (make_rho_a analog); the overhang
        # halo and the pencil FFT run ONCE on the stacked channel axis,
        # so the collective count is mixing-rule independent ----
        g_exts = []
        for c in range(self.nch):
            a2d = a_slots[c].reshape(ncell, cap)
            ax_t = padc(wx * a2d[:, :, None]).reshape(
                nt, tile, cap, ps.P[0])
            pat = jax.lax.map(dep_tile, (ax_t, wy_t, wz_t))
            pat = pat.reshape(nt * tile, *ps.P)[:ncell]
            g_exts.append(patches_to_grid_slab(pat, ps, grid_loc))
        G_ext = jnp.stack(g_exts)                    # (nch, (ncx+2)Sx,...)
        mesh_c = G_ext[:, Sx:-Sx]
        if D > 1:
            from_right = jax.lax.ppermute(G_ext[:, :Sx], axis,
                                          _perm_left(D))
            from_left = jax.lax.ppermute(G_ext[:, -Sx:], axis,
                                         _perm_right(D))
        else:
            from_right, from_left = G_ext[:, :Sx], G_ext[:, -Sx:]
        mesh_c = mesh_c.at[:, -Sx:].add(from_right).at[:, :Sx].add(
            from_left)

        # ---- pencil FFTs + paired spectral solve ----
        nz = pm.grid[2]
        S = fft3_slab(mesh_c.astype(acc), axis, D, batch_dims=1)
        G = kc["G"].astype(acc)
        Pc = jnp.asarray(self.Pm, acc)
        chi = jnp.einsum("cd,dxyz->cxyz", Pc, S, precision=MATMUL)

        def allsum(v):
            return jax.lax.psum(v, axis) if D > 1 else v

        if eflag or vflag:
            s2 = jnp.sum(jnp.real(S * jnp.conj(chi)), axis=0)
            ek = G * s2 * kc["wz"].astype(acc)[None, None, :]
        if eflag:
            elong = (allsum((0.5 / V) * jnp.sum(ek.astype(acc)))
                     + self.e0 + self.e_self)
        else:
            elong = jnp.zeros((), acc)

        kx = kc["kx"].astype(acc)[:, None, None]
        ky = kc["ky"].astype(acc)[None, :, None]
        kz = kc["kz"].astype(acc)[None, None, :]
        if vflag:
            vf = kc["vfac"].astype(acc)
            c = 0.5 / V
            virial = allsum(jnp.stack([
                jnp.sum((ek * (1.0 + vf * kx * kx)).astype(acc)),
                jnp.sum((ek * (1.0 + vf * ky * ky)).astype(acc)),
                jnp.sum((ek * (1.0 + vf * kz * kz)).astype(acc)),
                jnp.sum((ek * (vf * kx * ky)).astype(acc)),
                jnp.sum((ek * (vf * kx * kz)).astype(acc)),
                jnp.sum((ek * (vf * ky * kz)).astype(acc)),
            ])) * c
            virial = virial + self.e0 * jnp.asarray(
                [1.0, 1.0, 1.0, 0.0, 0.0, 0.0], acc)
        else:
            virial = jnp.zeros((6,), acc)

        # ---- ik E-fields: per Cartesian axis, ALL channels ride one
        # inverse pencil FFT + one halo ppermute pair (vs 3*nch each) ----
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        scale = (1.0 / V) * ngrid
        wx_t = padc(wx).reshape(nt, tile, cap, ps.P[0])

        def gat_tile(args):
            wxb, wyb, wzb, eb = args
            t1 = jnp.einsum("tax,tcxyz->tcayz", wxb, eb, precision=MATMUL)
            t2 = jnp.einsum("tay,tcayz->tcaz", wyb, t1, precision=MATMUL)
            return jnp.einsum("taz,tcaz->tca", wzb, t2, precision=MATMUL)

        phi = G[None] * chi                          # (nch, nx, ny_loc, nzh)
        a_cs = a_slots.astype(acc)                   # (nch, ns_loc)
        fout = []
        for kax in (kx, ky, kz):
            ehat = (-1j) * kax[None] * phi
            em = (ifft3_slab(ehat, nz, axis, D, batch_dims=1)
                  * scale).astype(flt)               # (nch, nx_loc, ny, nz)
            if D > 1:
                left_h = jax.lax.ppermute(em[:, -Sx:], axis,
                                          _perm_right(D))
                right_h = jax.lax.ppermute(em[:, :Sx], axis,
                                           _perm_left(D))
            else:
                left_h, right_h = em[:, -Sx:], em[:, :Sx]
            em_ext = jnp.concatenate([left_h, em, right_h], axis=1)
            ep = jax.vmap(
                lambda m: grid_to_patches_slab(m, ps, grid_loc))(em_ext)
            ep_t = padc(jnp.moveaxis(ep, 0, 1)).reshape(
                nt, tile, self.nch, *ps.P)
            f = jax.lax.map(gat_tile, (wx_t, wy_t, wz_t, ep_t))
            f = jnp.moveaxis(f, 2, 0).reshape(        # (nch, nt*tile, cap)
                self.nch, nt * tile, cap)[:, :ncell].reshape(self.nch, -1)
            fout.append(jnp.einsum("cs,cs->s", f.astype(acc), a_cs,
                                   precision=MATMUL))
        return fout[0], fout[1], fout[2], elong, virial


class SlabCombinedKSpace:
    """Sum of slab-mesh k-space solvers behind the single kc protocol —
    the pppm/disp dual pipeline (Coulomb pencil + dispersion pencil) of
    /root/reference/pppm_disp_intel.cpp:183-243 + :245-467, each solver's
    spectral constants namespaced into one kc dict."""

    def __init__(self, solvers):
        self.solvers = list(solvers)

    def _ns(self, i, d):
        return {f"k{i}.{k}": v for k, v in d.items()}

    def spectral_consts(self) -> dict:
        out = {}
        for i, s in enumerate(self.solvers):
            out.update(self._ns(i, s.spectral_consts()))
        return out

    def shardings(self, mesh, axis: str = "x") -> dict:
        out = {}
        for i, s in enumerate(self.solvers):
            out.update(self._ns(i, s.shardings(mesh, axis)))
        return out

    def in_specs(self, axis: str = "x") -> dict:
        out = {}
        for i, s in enumerate(self.solvers):
            out.update(self._ns(i, s.in_specs(axis)))
        return out

    def compute_slots_local(self, state: SlotState, kc: dict,
                            eflag: bool, vflag: bool, axis: str = "x"):
        tot = None
        for i, s in enumerate(self.solvers):
            pre = f"k{i}."
            sub = {k[len(pre):]: v for k, v in kc.items()
                   if k.startswith(pre)}
            r = s.compute_slots_local(state, sub, eflag, vflag, axis=axis)
            tot = r if tot is None else tuple(a + b
                                              for a, b in zip(tot, r))
        return tot


class GatheredKSpace:
    """Slab-mesh adapter for long-range solvers WITHOUT a pencil pipeline
    (dispersion PPPM, Ewald, slab-corrected/ad coulomb PPPM): all_gather
    the sharded slot planes, run the single-device solver REPLICATED on
    every device, slice the local force rows back out.

    Rationale: the reference's dispersion workloads are small (in.hexane
    ~5k atoms; pppm_disp_intel.cpp:183-313 dual pipeline), so a
    replicated spectral solve costs less than a distributed one until N
    is far past their scale — and it reuses the exact single-device
    solver, so the slab run matches single-device physics bit-for-bit
    up to reduction order.  The coulomb production path stays on the
    scalable pencil pipeline (SlabCellPPPM)."""

    def __init__(self, solver, n_atoms: int, D: int, nslots: int):
        self.solver = solver     # PPPM / Ewald / BoundKSpace / Combined
        self.n_atoms = n_atoms
        self.D = D
        self.ns_loc = nslots // D

    # kc-constants protocol (nothing to shard)
    def spectral_consts(self) -> dict:
        return {}

    def shardings(self, mesh, axis: str = "x") -> dict:
        return {}

    def in_specs(self, axis: str = "x") -> dict:
        return {}

    def compute_slots_local(self, state: SlotState, kc: dict,
                            eflag: bool, vflag: bool, axis: str = "x"):
        def ag(p):
            if self.D > 1:
                return jax.lax.all_gather(p, axis, tiled=True)
            return p

        x, y, z = ag(state.x), ag(state.y), ag(state.z)
        q, aid = ag(state.q), ag(state.aid)
        xs = jnp.stack([x, y, z], -1)
        aidc = jnp.minimum(aid, self.n_atoms)
        if hasattr(self.solver, "compute_slot"):
            kr = self.solver.compute_slot(xs, aidc, q, eflag=eflag,
                                          vflag=vflag)
        else:
            kr = self.solver.compute(xs, q, eflag=eflag, vflag=vflag)
        if self.D > 1:
            d = jax.lax.axis_index(axis)
            f = jax.lax.dynamic_slice_in_dim(
                kr.f, d * self.ns_loc, self.ns_loc)
        else:
            f = kr.f
        # elong/virial computed identically everywhere -> replicated,
        # the SlabCellPPPM contract (no psum at the consumer)
        return (f[:, 0], f[:, 1], f[:, 2], kr.elong, kr.virial)

    # ---- traced-box form (slab NPT) ----

    def tables(self, boxL):
        """Box-baked tables rebuilt from the traced box once per cadence
        block — the PPPM::setup()-on-box-change contract (TracedPPPM);
        None for solvers whose traced form has no tables (Ewald)."""
        if hasattr(self.solver, "tables"):
            return self.solver.tables(boxL)
        return None

    def compute_slots_local_traced(self, state: SlotState, boxL, kc,
                                   eflag: bool, vflag: bool,
                                   axis: str = "x"):
        """``compute_slots_local`` under a TRACED box: gather the sharded
        planes, run the solver's ``compute_traced`` replicated (empty
        slots carry q == 0, depositing nothing), slice local force rows.
        """
        def ag(p):
            if self.D > 1:
                return jax.lax.all_gather(p, axis, tiled=True)
            return p

        xs = jnp.stack([ag(state.x), ag(state.y), ag(state.z)], -1)
        q = ag(state.q)
        kw = {"kc": kc} if kc is not None else {}
        if hasattr(self.solver, "compute_traced_slot"):
            # dispersion solvers bake atom-ordered channel charges:
            # gather through aid (clamped; pad row = zero charge)
            aidc = jnp.minimum(ag(state.aid), self.n_atoms)
            kr = self.solver.compute_traced_slot(
                xs, aidc, q, boxL, eflag=eflag, vflag=vflag, **kw)
        else:
            kr = self.solver.compute_traced(xs, q, boxL, eflag=eflag,
                                            vflag=vflag, **kw)
        if self.D > 1:
            d = jax.lax.axis_index(axis)
            f = jax.lax.dynamic_slice_in_dim(
                kr.f, d * self.ns_loc, self.ns_loc)
        else:
            f = kr.f
        return (f[:, 0], f[:, 1], f[:, 2], kr.elong, kr.virial)


class ShardedEwald:
    """SHARDED Ewald on the slab mesh — the structure-factor form
    distributes for free.

    Each device computes the PARTIAL structure factor over its local
    slots (S(k) = sum_i q_i e^{i k.x_i} is additive over any atom
    partition), one psum of the (2, K) partials completes S(k), and the
    force pass stays entirely local — the MPI_Allreduce-of-sfacrl/sfacim
    pattern of host LAMMPS' Ewald::compute, on ICI.  Per-device compute
    scales 1/D (the (N, K) matmuls shrink to (N_loc, K)); communication
    is 2K scalars per step vs GatheredKSpace's all_gather of every atom
    plane.  elong/virial derive from the completed S(k), so they come
    out replicated (the SlabCellPPPM contract: no psum at the consumer).
    Empty slots carry q = 0 and drop out of the sums.
    """

    def __init__(self, ew, D: int):
        self.ew = ew
        self.D = D

    # kc-constants protocol (the k tables are baked, nothing to shard)
    def spectral_consts(self) -> dict:
        return {}

    def shardings(self, mesh, axis: str = "x") -> dict:
        return {}

    def in_specs(self, axis: str = "x") -> dict:
        return {}

    def compute_slots_local(self, state: SlotState, kc: dict,
                            eflag: bool, vflag: bool, axis: str = "x"):
        from .ewald import sk_force_energy_virial

        ew = self.ew
        flt = state.x.dtype
        acc = ew.acc_dtype
        kv = jnp.asarray(ew.kvecs, flt)           # (K, 3)
        xs = jnp.stack([state.x, state.y, state.z], -1)
        q = state.q

        phase = jnp.matmul(xs, kv.T, precision=MATMUL)  # (NS_loc, K)
        c = jnp.cos(phase)
        s = jnp.sin(phase)
        s_re = jnp.sum((q[:, None] * c).astype(acc), axis=0)
        s_im = jnp.sum((q[:, None] * s).astype(acc), axis=0)
        if self.D > 1:
            # the one collective: complete S(k) (MPI_Allreduce
            # sfacrl/sfacim); everything else is ewald.py's shared
            # post-S(k) evaluation on local rows
            s_re = jax.lax.psum(s_re, axis)
            s_im = jax.lax.psum(s_im, axis)
        f, elong, virial = sk_force_energy_virial(ew, c, s, s_re, s_im,
                                                  q, eflag, vflag)
        return (f[:, 0], f[:, 1], f[:, 2], elong, virial)


# ---------------------------------------------------------------------------
# 2-D (x, y) pencil PPPM — the grid-parallel pipeline on a 2-axis mesh
# ---------------------------------------------------------------------------

def patches_to_grid_pencil2d(patches, ps: PatchSpec, nc_loc, dtype=None):
    """(ncell_loc, Px, Py, Pz) -> ((ncxl+2)Sx, (ncyl+2)Sy, nz) extended
    brick: x AND y overhangs land on boundary slabs for the caller to
    ppermute into neighbors; z wraps locally (unsharded axis)."""
    ncx, ncy, ncz = nc_loc
    Sx, Sy, Sz = ps.S
    pat = patches.reshape(ncx, ncy, ncz, *ps.P)
    G = jnp.zeros((ncx + 2, Sx, ncy + 2, Sy, ncz, Sz),
                  dtype or patches.dtype)
    for (ox, oy, oz) in _OFF3:
        psx, gsx = _ranges(ps, 0, ox)
        psy, gsy = _ranges(ps, 1, oy)
        psz, gsz = _ranges(ps, 2, oz)
        part = pat[:, :, :, psx, psy, psz]
        part = jnp.roll(part, oz, axis=2)
        G = G.at[1 + ox:1 + ox + ncx, gsx,
                 1 + oy:1 + oy + ncy, gsy, :, gsz].add(
            jnp.moveaxis(part, (3, 4, 5), (1, 3, 5)))
    return G.reshape((ncx + 2) * Sx, (ncy + 2) * Sy, ncz * Sz)


def grid_to_patches_pencil2d(mesh_ext, ps: PatchSpec, nc_loc):
    """((ncxl+2)Sx, (ncyl+2)Sy, nz) halo-extended brick ->
    (ncell_loc, Px, Py, Pz) per-cell patches (x/y read the halo)."""
    from .pppm_cells import _expand_axis

    ncx, ncy, ncz = nc_loc
    Sx, Sy = ps.S[0], ps.S[1]
    a = _expand_axis(mesh_ext, 0, ncx, Sx, ps.P[0], ps.lo_off[0],
                     periodic=False, start=Sx - ps.lo_off[0])
    a = _expand_axis(a, 2, ncy, Sy, ps.P[1], ps.lo_off[1],
                     periodic=False, start=Sy - ps.lo_off[1])
    a = _expand_axis(a, 4, ncz, ps.S[2], ps.P[2], ps.lo_off[2])
    a = jnp.transpose(a, (0, 2, 4, 1, 3, 5))
    return a.reshape(ncx * ncy * ncz, *ps.P)


def fft3_pencil2d(mesh_loc, Dx, Dy, ax_x, ax_y, nzh_pad):
    """(nxl, nyl, nz) real brick -> (nx, ny/Dx, nzh_pad/Dy) spectrum:
    rfft z (local), transpose over the y device axis (splitting the
    zero-padded half-spectrum — padded modes are exactly zero, so the
    divisibility constraint costs nothing), fft y, transpose over the x
    device axis (splitting ny), fft x.  The two all_to_alls ARE the
    reference's Remap at pod scale (2-D pencil decomposition)."""
    h = jnp.fft.rfft(mesh_loc, axis=2)
    pad = nzh_pad - h.shape[2]
    if pad:
        h = jnp.pad(h, ((0, 0), (0, 0), (0, pad)))
    if Dy > 1:
        h = jax.lax.all_to_all(h, ax_y, split_axis=2, concat_axis=1,
                               tiled=True)
    h = jnp.fft.fft(h, axis=1)
    if Dx > 1:
        h = jax.lax.all_to_all(h, ax_x, split_axis=1, concat_axis=0,
                               tiled=True)
    return jnp.fft.fft(h, axis=0)


def ifft3_pencil2d(spec, nz, nzh, Dx, Dy, ax_x, ax_y):
    """Inverse of fft3_pencil2d -> real (nxl, nyl, nz) brick."""
    t = jnp.fft.ifft(spec, axis=0)
    if Dx > 1:
        t = jax.lax.all_to_all(t, ax_x, split_axis=0, concat_axis=1,
                               tiled=True)
    t = jnp.fft.ifft(t, axis=1)
    if Dy > 1:
        t = jax.lax.all_to_all(t, ax_y, split_axis=1, concat_axis=2,
                               tiled=True)
    t = t[..., :nzh]
    return jnp.fft.irfft(t, n=nz, axis=2)


class Pencil2DCellPPPM:
    """Cell-patch PPPM over the 2-D (x, y) device grid — plugs into
    Pencil2DSimulation.  The full H4 contract at pod scale: 2-D brick
    deposition with two-hop ppermute overhang reduction (reverse_comm),
    the double-transpose pencil FFT (Remap), halo-filled patch gathers
    (forward_comm), psum scalars (MPI_Allreduce).  ik differentiation.
    """

    def __init__(self, pm: PPPM, grid: CellGrid, dims, margin: int = 1,
                 skin: Optional[float] = None):
        self.pm = pm
        self.grid = grid
        self.Dx, self.Dy = int(dims[0]), int(dims[1])
        self.ps = make_patch_spec(pm, grid, margin=margin, skin=skin)
        if grid.nc[0] % self.Dx or grid.nc[1] % self.Dy:
            raise ValueError(
                f"cell grid {grid.nc} not divisible by dims "
                f"({self.Dx}, {self.Dy})")
        if pm.grid[1] % self.Dx:
            raise ValueError(
                f"pppm ny={pm.grid[1]} not divisible by Dx={self.Dx} "
                "(the x transpose splits ny; pass multiple_of with "
                "lcm(ncy, Dx))")
        self.nc_loc = (grid.nc[0] // self.Dx, grid.nc[1] // self.Dy,
                       grid.nc[2])
        nzh = pm.grid[2] // 2 + 1
        self.nzh = nzh
        self.nzh_pad = -(-nzh // self.Dy) * self.Dy

    def spectral_consts(self) -> dict:
        pm = self.pm
        from .pppm_cells import _half_weights

        pad = self.nzh_pad - self.nzh
        G = pm.greensfn[..., :self.nzh]
        wz = _half_weights(pm.grid[2])
        if pad:
            # padded spectral rows are exactly zero; zero tables keep
            # the energy/virial sums untouched
            G = np.concatenate(
                [G, np.zeros(G.shape[:2] + (pad,), G.dtype)], axis=-1)
            wz = np.concatenate([wz, np.zeros(pad, wz.dtype)])
        return dict(G=G, kx=pm.kx, ky=pm.ky,
                    kz=np.concatenate([pm.kz[:self.nzh],
                                       np.zeros(pad)]),
                    wz=wz)

    def shardings(self, mesh, axis=("x", "y")):
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax_x, ax_y = axis
        return dict(
            G=NamedSharding(mesh, P(None, ax_x, ax_y)),
            kx=NamedSharding(mesh, P()),
            ky=NamedSharding(mesh, P(ax_x)),
            kz=NamedSharding(mesh, P(ax_y)),
            wz=NamedSharding(mesh, P(ax_y)),
        )

    def in_specs(self, axis=("x", "y")):
        from jax.sharding import PartitionSpec as P

        ax_x, ax_y = axis
        return dict(G=P(None, ax_x, ax_y), kx=P(), ky=P(ax_x),
                    kz=P(ax_y), wz=P(ax_y))

    def _weights_local(self, state: SlotState, off_x, off_y):
        pm, ps = self.pm, self.ps
        cap = self.grid.cap
        gl = dataclasses.replace(self.grid, nc=self.nc_loc)
        ncell = gl.ncell
        xoff = off_x.astype(state.x.dtype) * (ps.S[0] * pm.h[0])
        yoff = off_y.astype(state.y.dtype) * (ps.S[1] * pm.h[1])
        wx = _axis_weights(pm, ps, gl, state.x - xoff, 0)
        wy = _axis_weights(pm, ps, gl, state.y - yoff, 1)
        wz = _axis_weights(pm, ps, gl, state.z, 2)
        return (wx.reshape(ncell, cap, -1), wy.reshape(ncell, cap, -1),
                wz.reshape(ncell, cap, -1))

    def compute_slots_local(self, state: SlotState, kc: dict,
                            eflag: bool, vflag: bool, axis=("x", "y")):
        pm, ps = self.pm, self.ps
        ax_x, ax_y = axis
        Dx, Dy = self.Dx, self.Dy
        nc_loc = self.nc_loc
        cap = self.grid.cap
        ncell = nc_loc[0] * nc_loc[1] * nc_loc[2]
        acc = pm.acc_dtype
        flt = state.x.dtype
        V = float(pm.volume)
        Sx, Sy = ps.S[0], ps.S[1]
        off_x = jax.lax.axis_index(ax_x) * nc_loc[0]
        off_y = jax.lax.axis_index(ax_y) * nc_loc[1]

        qqrd2e = float(pm.qqrd2e)
        wx, wy, wz = self._weights_local(state, off_x, off_y)
        q2d = state.q.reshape(ncell, cap)

        # ---- deposition + two-hop overhang reduction ----
        tile = min(ps.cell_tile, ncell)
        nt = -(-ncell // tile)
        padc_n = nt * tile - ncell

        def padc(a):
            return jnp.concatenate(
                [a, jnp.zeros((padc_n,) + a.shape[1:], a.dtype)]) \
                if padc_n else a

        qx_t = padc(wx * q2d[:, :, None]).reshape(nt, tile, cap, ps.P[0])
        wy_t = padc(wy).reshape(nt, tile, cap, ps.P[1])
        wz_t = padc(wz).reshape(nt, tile, cap, ps.P[2])

        def dep_tile(args):
            qxb, wyb, wzb = args
            wyz = jnp.einsum("tay,taz->tayz", wyb, wzb, precision=MATMUL)
            return jnp.einsum("tax,tayz->txyz", qxb, wyz, precision=MATMUL)

        pat = jax.lax.map(dep_tile, (qx_t, wy_t, wz_t))
        pat = pat.reshape(nt * tile, *ps.P)[:ncell]
        G_ext = patches_to_grid_pencil2d(pat, ps, nc_loc)
        # x-reduce (full extended y rides along -> corners relay)
        mesh = G_ext[Sx:-Sx]
        if Dx > 1:
            from_right = jax.lax.ppermute(G_ext[:Sx], ax_x,
                                          _perm_left(Dx))
            from_left = jax.lax.ppermute(G_ext[-Sx:], ax_x,
                                         _perm_right(Dx))
        else:
            from_right, from_left = G_ext[:Sx], G_ext[-Sx:]
        mesh = mesh.at[-Sx:].add(from_right).at[:Sx].add(from_left)
        # y-reduce the x-reduced brick
        meshy = mesh[:, Sy:-Sy]
        if Dy > 1:
            from_high = jax.lax.ppermute(mesh[:, :Sy], ax_y,
                                         _perm_left(Dy))
            from_low = jax.lax.ppermute(mesh[:, -Sy:], ax_y,
                                        _perm_right(Dy))
        else:
            from_high, from_low = mesh[:, :Sy], mesh[:, -Sy:]
        mesh = meshy.at[:, -Sy:].add(from_high).at[:, :Sy].add(from_low)

        # ---- double-transpose pencil FFT + spectral solve ----
        nz = pm.grid[2]
        rhat = fft3_pencil2d(mesh.astype(acc), Dx, Dy, ax_x, ax_y,
                             self.nzh_pad)
        G = kc["G"].astype(acc)
        phi_hat = G * rhat

        def allsum(v):
            return jax.lax.psum(v, axis)

        if eflag or vflag:
            s2 = jnp.real(rhat * jnp.conj(rhat))
            ek = G * s2 * kc["wz"].astype(acc)[None, None, :]
        if eflag:
            elong = allsum((0.5 / V) * jnp.sum(ek.astype(acc))) * qqrd2e
            elong = elong + pm.elong_self
        else:
            elong = jnp.zeros((), acc)

        kx = kc["kx"].astype(acc)[:, None, None]
        ky = kc["ky"].astype(acc)[None, :, None]
        kz = kc["kz"].astype(acc)[None, None, :]
        if vflag:
            ksq = kx * kx + ky * ky + kz * kz
            ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
            pref = 2.0 * (1.0 / ksq_safe + 0.25 / pm.g_ewald**2)
            c = (0.5 / V) * qqrd2e
            virial = allsum(jnp.stack([
                jnp.sum((ek * (1.0 - pref * kx * kx)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * ky * ky)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * kz * kz)).astype(acc)),
                jnp.sum((ek * (-pref * kx * ky)).astype(acc)),
                jnp.sum((ek * (-pref * kx * kz)).astype(acc)),
                jnp.sum((ek * (-pref * ky * kz)).astype(acc)),
            ])) * c
        else:
            virial = jnp.zeros((6,), acc)

        # ---- ik E-fields, inverse FFT, two-hop halo, patch gather ----
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
        scale = (1.0 / V) * ngrid
        wx_t = padc(wx).reshape(nt, tile, cap, ps.P[0])
        out = []
        for kax in (kx, ky, kz):
            ehat = (-1j) * kax * phi_hat
            em = (ifft3_pencil2d(ehat, nz, self.nzh, Dx, Dy, ax_x, ax_y)
                  * scale).astype(flt)
            # y-extend, then x-extend the y-extended brick (corners ride)
            if Dy > 1:
                low_h = jax.lax.ppermute(em[:, -Sy:], ax_y,
                                         _perm_right(Dy))
                high_h = jax.lax.ppermute(em[:, :Sy], ax_y,
                                          _perm_left(Dy))
            else:
                low_h, high_h = em[:, -Sy:], em[:, :Sy]
            em = jnp.concatenate([low_h, em, high_h], axis=1)
            if Dx > 1:
                left_h = jax.lax.ppermute(em[-Sx:], ax_x, _perm_right(Dx))
                right_h = jax.lax.ppermute(em[:Sx], ax_x, _perm_left(Dx))
            else:
                left_h, right_h = em[-Sx:], em[:Sx]
            em_ext = jnp.concatenate([left_h, em, right_h], axis=0)
            ep = grid_to_patches_pencil2d(em_ext, ps, nc_loc)
            ep_t = padc(ep).reshape(nt, tile, *ps.P)

            def gat_tile(args):
                wxb, wyb, wzb, eb = args
                t1 = jnp.einsum("tax,txyz->tayz", wxb, eb, precision=MATMUL)
                t2 = jnp.einsum("tay,tayz->taz", wyb, t1, precision=MATMUL)
                return jnp.einsum("taz,taz->ta", wzb, t2, precision=MATMUL)

            f = jax.lax.map(gat_tile, (wx_t, wy_t, wz_t, ep_t))
            out.append(f.reshape(nt * tile, cap)[:ncell].reshape(-1))

        qf = (qqrd2e * state.q).astype(acc)
        return (out[0].astype(acc) * qf, out[1].astype(acc) * qf,
                out[2].astype(acc) * qf, elong, virial)
