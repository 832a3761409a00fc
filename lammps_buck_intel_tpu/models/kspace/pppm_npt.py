"""PPPM under a TRACED (variable) simulation box — the `fix npt` solvers.

Host LAMMPS runs PPPM under NPT by re-running ``PPPM::setup()`` whenever
the box changes (the setup contract behind /root/reference/
pppm_intel.cpp:67-98, and PPPMDisp's dual-grid analog behind
pppm_disp_intel.cpp:115-554): grid size, order and g_ewald stay fixed
from ``init()``; the box-dependent tables — Green's function, fkx/fky/
fkz, volume, self-energy background — are rebuilt at reneighbor cadence.

Equivalent here: rebuild those tables *inside the trace* from the
traced box lengths, once per neighbor-cadence block (not per step).  The
alias sums of the Hockney-Eastwood influence function factor into
box-INDEPENDENT B-spline transforms (sinc powers live in grid-index
space) and box-dependent wave vectors k = 2 pi m / L, so the traced
rebuild is a static 125-term (nalias=2) sum of cheap broadcasted
elementwise ops over the grid — XLA fuses it, no host round-trip, no
recompile (the box is an argument, never a constant).

Solvers:
* :class:`TracedPPPM` — Coulomb PPPM (ik AND ad, slab-corrected), the
  in.rhodo configuration (/root/reference/examples/in.rhodo:13,18-19).
* :class:`TracedPPPMDisp` — dispersion PPPM (any mixing rule via the
  channel formulation of pppm_disp.py; ik AND ad).  The kernel w(k) and
  the anisotropic virial factor are traced functions of |k| (erfc via
  jax.scipy.special), so `fix npt` + `kspace_style pppm/disp` keeps its
  k-space r^-6 term under dilation instead of silently dropping it.
* :func:`make_traced_kspace` — maps any deck solver (PPPM, BoundKSpace
  over PPPMDisp, CombinedKSpace) to its traced form, raising loudly for
  combinations with no variable-cell implementation.

All traced tables are built in the precision policy's accumulation dtype
(the reference's precision contract, pair_buck_intel.cpp:48-62): f64 on
x64 runs, f32 in single precision — never a literal float64 that would
silently truncate without x64.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ...core.precision import MATMUL
from .base import KSpaceResult, BoundKSpace, CombinedKSpace
from .pppm import (
    PPPM, _fold_idx, _np_axis_A, bspline_weights, stencil_offsets,
)
from .pppm_disp import PPPMDisp


def _alias_statics(grid, order: int, nalias: int):
    """Box-independent pieces of the Hockney-Eastwood influence function:
    per-axis folded harmonics ``m``, alias-shifted harmonics ``ms``
    ((S, n) per axis), squared spline transforms ``u2`` ((S, n) per
    axis), the squared denominator sum, and the k=0 mask."""
    def sinc(t):
        out = np.ones_like(t)
        m = t != 0
        out[m] = np.sin(t[m]) / t[m]
        return out

    shifts = range(-nalias, nalias + 1)
    m_fold = [_fold_idx(n).astype(np.float64) for n in grid]
    ms, u2 = [], []
    for n in grid:
        i = np.arange(n)
        i = np.where(i > n // 2, i - n, i).astype(np.float64)
        ms_ax, u2_ax = [], []
        for s in shifts:
            ms_ax.append(i + s * n)
            u2_ax.append(sinc(np.pi * (i + s * n) / n) ** (2 * order))
        ms.append(np.asarray(ms_ax))
        u2.append(np.asarray(u2_ax))
    dx = u2[0].sum(0)
    dy = u2[1].sum(0)
    dz = u2[2].sum(0)
    den = dx[:, None, None] * dy[None, :, None] * dz[None, None, :]
    kmask = np.ones(grid)
    kmask[0, 0, 0] = 0.0
    return m_fold, ms, u2, den * den, kmask


def _sf_statics(grid, order: int, nterms: int = 4, nsamp: int = 32):
    """Box-independent pieces of the ad self-force sine fit
    (pppm.py _sf_sine_fit with the box factors deferred): per-axis
    Re(A conj dA) self terms, mean |A|^2 factors, and the sine basis."""
    s = np.arange(nsamp) / nsamp + 1e3
    selfterm, mean2 = [], []
    for ax in range(3):
        a, da = _np_axis_A(grid[ax], s, order)
        selfterm.append(np.real(a * np.conj(da)))
        mean2.append(np.mean(np.abs(a) ** 2, axis=0))
    js = np.arange(1, nterms + 1)
    basis = np.sin(2.0 * np.pi * js[None, :] * (s % 1.0)[:, None])
    return selfterm, mean2, basis, nsamp


def _sf_refit_traced(G, L, grid, statics, acc):
    """Re-fit the (3, J) ad self-force sine series against a TRACED
    influence function G (see pppm.py _sf_sine_fit)."""
    selfterm, mean2, basis, nsamp = statics
    V = L[0] * L[1] * L[2]
    sf = []
    for ax in range(3):
        t0, t1 = [a for a in range(3) if a != ax]
        g1 = jnp.moveaxis(G, ax, 0)
        g1 = jnp.tensordot(g1, jnp.asarray(mean2[t1], acc),
                           axes=[[2], [0]], precision=MATMUL)
        g1 = jnp.tensordot(g1, jnp.asarray(mean2[t0], acc),
                           axes=[[1], [0]], precision=MATMUL)   # (n_ax,)
        h_ax = L[ax] / grid[ax]
        e_s = -jnp.matmul(jnp.asarray(selfterm[ax], acc), g1,
                          precision=MATMUL) / (V * h_ax)  # (S,)
        sf.append((2.0 / nsamp) * jnp.matmul(
            jnp.asarray(basis, acc).T, e_s, precision=MATMUL))
    return jnp.stack(sf)                                      # (3, J)


class TracedPPPM:
    """Coulomb PPPM whose box-baked tables are traced functions of boxL.

    Built from a ``setup_pppm`` result at the INITIAL box (which fixes
    grid, order and g_ewald exactly as ``PPPM::init()`` does); per-block
    tables come from :meth:`tables`, forces from :meth:`compute_traced`.
    """

    def __init__(self, pm: PPPM, center, nalias: int = 2):
        if not isinstance(pm, PPPM):
            raise NotImplementedError(
                f"TracedPPPM wraps a plain PPPM solver, got {type(pm)}")
        # triclinic: the mesh is uniform in lamda space and the wave
        # vectors come from the traced h^-T (fix_nh tilt-scale rules give
        # the tilts as functions of the traced lengths) — the
        # poisson_ik_triclinic generalization under a variable cell
        # (/root/reference/pppm_intel.cpp:153-157,878-881).  ik only
        # (setup_pppm already rejects triclinic ad/slab).
        self.triclinic = pm.recip is not None
        if self.triclinic and pm.slab is not None:
            # host parity: stock LAMMPS rejects the combination too
            # ("Cannot (yet) use PPPM with triclinic box and slab
            # correction", pppm.cpp init)
            raise NotImplementedError(
                "triclinic + slab correction (host LAMMPS rejects this "
                "combination as well)")
        self.pm = pm
        self.diff = pm.diff
        # kspace_modify slab <factor>: all k-space geometry below runs on
        # the z-EXTENDED box (traced L_eff = L * [1, 1, slab]); atoms keep
        # the real box origin.  The Yeh-Berkowitz dipole term is traced in
        # compute_traced (slab_correction with the traced extended volume).
        self.slab = None if pm.slab is None else float(pm.slab)
        self.grid = pm.grid
        self.order = pm.order
        self.g_ewald = float(pm.g_ewald)
        self.qqrd2e = float(pm.qqrd2e)
        self.qsum = float(pm.qsum)
        self.qsqsum = float(pm.qsqsum)
        self.acc_dtype = pm.acc_dtype
        self._center = np.asarray(center, np.float64)
        (self._m, self._ms, self._u2, self._den_sq,
         self._kmask) = _alias_statics(pm.grid, pm.order, nalias)
        self._nalias = nalias
        if self.diff == "ad":
            nterms = (np.asarray(pm.sf_sine).shape[1]
                      if pm.sf_sine is not None else 4)
            self._sf = _sf_statics(pm.grid, pm.order, nterms)

    def _L_eff(self, boxL):
        """Traced k-space box lengths (z extended under slab mode)."""
        acc = self.acc_dtype
        L = [boxL[ax].astype(acc) for ax in range(3)]
        if self.slab is not None:
            L[2] = L[2] * self.slab
        return L

    def _hinv_traced(self, boxL, tilt):
        """Traced upper-triangular h^-1 rows (Box.h_inv closed form)."""
        acc = self.acc_dtype
        lx, ly, lz = (boxL[a].astype(acc) for a in range(3))
        xy, xz, yz = (tilt[a].astype(acc) for a in range(3))
        zero = jnp.zeros_like(lx)
        return ((1.0 / lx, -xy / (lx * ly),
                 (xy * yz - ly * xz) / (lx * ly * lz)),
                (zero, 1.0 / ly, -yz / (ly * lz)),
                (zero, zero, 1.0 / lz))

    def _k_traced(self, boxL, tilt, mx, my, mz):
        """Cartesian k components for (broadcastable) harmonic numbers:
        k = 2 pi h^-T m.  Orthogonal boxes keep per-axis shapes."""
        acc = self.acc_dtype
        twopi = 2.0 * np.pi
        if not self.triclinic:
            L = self._L_eff(boxL)
            return (mx * (twopi / L[0]), my * (twopi / L[1]),
                    mz * (twopi / L[2]))
        hinv = self._hinv_traced(boxL, tilt)
        kx = twopi * hinv[0][0] * mx
        ky = twopi * (hinv[0][1] * mx + hinv[1][1] * my)
        kz = twopi * (hinv[0][2] * mx + hinv[1][2] * my
                      + hinv[2][2] * mz)
        return kx, ky, kz

    # ---- per-block tables ----

    def tables(self, boxL, tilt=None):
        """Traced box-dependent tables: call once per cadence block.

        Returns {"G": (nx,ny,nz)} plus, in ad mode, the re-fit self-force
        sine coefficients {"sf": (3, J)} — everything else (k vectors,
        volume, grid origin) is cheap enough to rebuild per force call.
        ``tilt``: traced (3,) [xy, xz, yz] for a variable triclinic cell
        (k = 2 pi h^-T m with the traced h)."""
        acc = self.acc_dtype
        g2 = self.g_ewald * self.g_ewald
        L = self._L_eff(boxL)
        mx = jnp.asarray(self._m[0], acc)[:, None, None]
        my = jnp.asarray(self._m[1], acc)[None, :, None]
        mz = jnp.asarray(self._m[2], acc)[None, None, :]
        kx, ky, kz = self._k_traced(boxL, tilt, mx, my, mz)
        ksq = kx * kx + ky * ky + kz * kz
        S = 2 * self._nalias + 1
        num = jnp.zeros(self.grid, acc)
        for sx in range(S):
            u2x = jnp.asarray(self._u2[0][sx], acc)[:, None, None]
            mxs = jnp.asarray(self._ms[0][sx], acc)[:, None, None]
            for sy in range(S):
                u2y = jnp.asarray(self._u2[1][sy], acc)[None, :, None]
                mys = jnp.asarray(self._ms[1][sy], acc)[None, :, None]
                for sz in range(S):
                    u2z = jnp.asarray(self._u2[2][sz], acc)[None, None, :]
                    mzs = jnp.asarray(self._ms[2][sz], acc)[None, None, :]
                    kmx, kmy, kmz = self._k_traced(boxL, tilt, mxs, mys,
                                                   mzs)
                    kmsq = kmx * kmx + kmy * kmy + kmz * kmz
                    safe = jnp.where(kmsq == 0.0, 1.0, kmsq)
                    g = jnp.where(
                        kmsq == 0.0, 0.0,
                        (4.0 * np.pi) / safe * jnp.exp(-0.25 * safe / g2))
                    kdot = kx * kmx + ky * kmy + kz * kmz
                    num = num + (u2x * u2y * u2z) * g * kdot
        ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
        G = num / (ksq_safe * jnp.asarray(self._den_sq, acc))
        G = G * jnp.asarray(self._kmask, acc)
        out = {"G": G.astype(acc)}
        if self.diff == "ad":
            out["sf"] = _sf_refit_traced(G, L, self.grid, self._sf, acc)
        return out

    # ---- force/energy pass ----

    def _weights(self, x, boxL, tilt=None, deriv: bool = False):
        # grid origin = real box lo; grid span = the (slab-extended)
        # k-space box, vacuum padding above.  Triclinic: uniform mesh in
        # LAMDA space (particle_map under x2lamda, pppm_intel.cpp:153).
        p = self.order
        lo = jnp.asarray(self._center, x.dtype) - 0.5 * boxL.astype(x.dtype)
        if self.triclinic:
            hinv = self._hinv_traced(boxL, tilt)
            dx = [x[:, c] - lo[c] for c in range(3)]
            out = []
            for ax, n in enumerate(self.grid):
                lam = None
                for c in range(ax, 3):    # upper triangular h^-1
                    t = hinv[ax][c].astype(x.dtype) * dx[c]
                    lam = t if lam is None else lam + t
                out.append(bspline_weights(lam * n, p, deriv=deriv))
            return out
        Leff = self._L_eff(boxL)
        out = []
        for ax, n in enumerate(self.grid):
            u = (x[:, ax] - lo[ax]) * (n / Leff[ax].astype(x.dtype))
            out.append(bspline_weights(u, p, deriv=deriv))
        return out

    def _stencil(self, bases):
        offs = jnp.asarray(stencil_offsets(self.order), jnp.int32)
        return [jnp.mod(bases[ax][:, None] + offs, n)
                for ax, n in enumerate(self.grid)]

    def compute_traced(self, x, q, boxL, eflag: bool = True,
                       vflag: bool = True, kc=None,
                       tilt=None) -> KSpaceResult:
        """Same contract as Ewald.compute_traced, plus optional ``kc``
        tables from :meth:`tables` (recomputed here when absent — pass
        them per block to amortize the influence-function rebuild) and
        ``tilt`` for a variable triclinic cell."""
        acc = self.acc_dtype
        nx, ny, nz = self.grid
        ngrid = nx * ny * nz
        qqrd2e = self.qqrd2e
        if kc is None:
            kc = self.tables(boxL, tilt)
        ad = self.diff == "ad"
        Leff = self._L_eff(boxL)
        V = (Leff[0] * Leff[1] * Leff[2]).astype(acc)

        # deposition (particle_map/make_rho under the traced box)
        wx_ = self._weights(x, boxL, tilt, deriv=ad)
        bases = [w[0] for w in wx_]
        ws = [w[1] for w in wx_]
        dws = [w[2] for w in wx_] if ad else None
        ix, iy, iz = self._stencil(bases)
        w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
              * ws[2][:, None, None, :]) * q[:, None, None, None]
        flat = ((ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
                + iz[:, None, None, :])
        mesh = jnp.zeros((ngrid,), x.dtype)
        mesh = mesh.at[flat.reshape(-1)].add(w3.reshape(-1))
        mesh = mesh.reshape(nx, ny, nz)

        rhat = jnp.fft.fftn(mesh.astype(acc))
        G = kc["G"].astype(acc)
        phi_hat = G * rhat

        mx = jnp.asarray(self._m[0], acc)[:, None, None]
        my = jnp.asarray(self._m[1], acc)[None, :, None]
        mz = jnp.asarray(self._m[2], acc)[None, None, :]
        kx, ky, kz = self._k_traced(boxL, tilt, mx, my, mz)

        if eflag or vflag:
            s2 = jnp.real(rhat * jnp.conj(rhat))
            ek = G * s2
        if eflag:
            elong = (0.5 / V) * jnp.sum(ek.astype(acc)) * qqrd2e
            g = self.g_ewald
            self_e = -g * self.qsqsum / math.sqrt(math.pi) * qqrd2e
            bg = -(math.pi / 2.0 * self.qsum**2 / (g * g)) * qqrd2e / V
            elong = elong + self_e + bg
        else:
            elong = jnp.zeros((), acc)

        if vflag:
            ksq = kx * kx + ky * ky + kz * kz
            ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
            pref = 2.0 * (1.0 / ksq_safe + 0.25 / self.g_ewald**2)
            c = (0.5 / V) * qqrd2e
            virial = jnp.stack([
                jnp.sum((ek * (1.0 - pref * kx * kx)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * ky * ky)).astype(acc)),
                jnp.sum((ek * (1.0 - pref * kz * kz)).astype(acc)),
                jnp.sum((ek * (-pref * kx * ky)).astype(acc)),
                jnp.sum((ek * (-pref * kx * kz)).astype(acc)),
                jnp.sum((ek * (-pref * ky * kz)).astype(acc)),
            ]) * c
        else:
            virial = jnp.zeros((6,), acc)

        flat2 = flat.reshape(x.shape[0], -1)
        if ad:
            # ONE inverse FFT -> potential mesh; forces from derivative
            # splines minus the re-fit self-force (poisson_ad /
            # fieldforce_ad, pppm_intel.cpp:985-1054, :678-804)
            u = jnp.real(jnp.fft.ifftn(phi_hat)) * (ngrid / V)
            uv = u.reshape(-1)[flat2]
            combos = ((dws[0], ws[1], ws[2]), (ws[0], dws[1], ws[2]),
                      (ws[0], ws[1], dws[2]))
            lo = (jnp.asarray(self._center, x.dtype)
                  - 0.5 * boxL.astype(x.dtype))
            f = []
            for ax, (aw, bw, cw) in enumerate(combos):
                w3d = (aw[:, :, None, None] * bw[:, None, :, None]
                       * cw[:, None, None, :]).reshape(x.shape[0], -1)
                h_ax = (Leff[ax] / self.grid[ax]).astype(acc)
                e_ax = -jnp.sum(w3d * uv, axis=1) * (1.0 / h_ax)
                # traced sf sine series (grid-unit fractional offset)
                ug = (x[:, ax] - lo[ax]) * (self.grid[ax]
                                            / Leff[ax].astype(x.dtype))
                sf = kc["sf"]
                e_self = jnp.zeros_like(e_ax)
                for j in range(sf.shape[1]):
                    e_self = e_self + sf[ax, j] * jnp.sin(
                        2.0 * jnp.pi * (j + 1) * ug).astype(acc)
                f.append(qqrd2e * q * e_ax - (qqrd2e * q * q) * e_self)
            fvec = jnp.stack(f, axis=-1).astype(acc)
        else:
            scale = 1.0 / V
            e_mesh = []
            for kax in (kx, ky, kz):
                ehat = (-1j) * kax.astype(phi_hat.dtype) * phi_hat
                e_mesh.append(jnp.real(jnp.fft.ifftn(ehat))
                              * (scale * ngrid))

            w3g = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
                   * ws[2][:, None, None, :]).reshape(x.shape[0], -1)
            f = []
            for em in e_mesh:
                ev = em.reshape(-1)[flat2]
                f.append(jnp.sum(w3g * ev, axis=1))
            fvec = jnp.stack(f, axis=-1).astype(acc)
            fvec = fvec * (qqrd2e * q[:, None]).astype(acc)
        if self.slab is not None:
            # traced Yeh-Berkowitz EW3DC dipole term (slabcorr(),
            # pppm_intel.cpp:305) on the extended volume
            zprd = Leff[2].astype(acc)
            z = x[:, 2].astype(acc)
            qa = q.astype(acc)
            dipole = jnp.sum(qa * z)
            dipole_r2 = jnp.sum(qa * z * z)
            two_pi = 2.0 * math.pi
            if eflag:
                elong = elong + (two_pi / V) * (
                    dipole * dipole - self.qsum * dipole_r2
                    - self.qsum**2 * zprd * zprd / 12.0) * qqrd2e
            ffact = -(2.0 * two_pi / V) * qqrd2e
            fvec = fvec.at[:, 2].add(ffact * qa * (dipole - self.qsum * z))
        return KSpaceResult(f=fvec, elong=elong, virial=virial)


class TracedPPPMDisp:
    """Dispersion PPPM (pppm/disp) under a traced box — any mixing rule.

    The PPPMDisp base-class setup contract (host LAMMPS re-setup on box
    change behind /root/reference/pppm_disp_intel.cpp:115-554) in traced
    form: the dispersion kernel w(k) and virial factor are evaluated
    inside the trace via jax erfc, the influence-function alias sum uses
    the shared box-independent spline statics, and the channel pipeline
    of pppm_disp.py runs under the traced geometry.  Inputs are per-atom
    CHANNEL charges (see :class:`TracedBoundKSpace` for the deck-facing
    adapter)."""

    def __init__(self, pm: PPPMDisp, center, nalias: int = 2):
        if not isinstance(pm, PPPMDisp):
            raise NotImplementedError(
                f"TracedPPPMDisp wraps a PPPMDisp solver, got {type(pm)}")
        self.pm = pm
        self.diff = pm.diff
        self.grid = pm.grid
        self.order = pm.order
        self.beta = float(pm.g_ewald_6)
        self.acc_dtype = pm.acc_dtype
        self.A = np.asarray(pm.A, np.float64)
        self.P = np.asarray(pm.P, np.float64)
        self._center = np.asarray(center, np.float64)
        (self._m, self._ms, self._u2, self._den_sq,
         self._kmask) = _alias_statics(pm.grid, pm.order, nalias)
        self._nalias = nalias
        if self.diff == "ad":
            nterms = (np.asarray(pm.sf_sine).shape[1]
                      if pm.sf_sine is not None else 4)
            self._sf = _sf_statics(pm.grid, pm.order, nterms)

    @property
    def w0(self) -> float:
        return -(math.pi**1.5 * self.beta**3 / 3.0)

    def _kernel_traced(self, kmsq):
        """w(k) = -(pi^1.5 b^3/3)[(1-2t^2)e^{-t^2} + 2 sqrt(pi) t^3
        erfc(t)], t = k/(2b) — finite at k = 0 (pppm_disp.py
        dispersion_kernel, traced)."""
        from jax.scipy.special import erfc

        t2 = kmsq / (4.0 * self.beta * self.beta)
        t = jnp.sqrt(t2)
        f = (1.0 - 2.0 * t2) * jnp.exp(-t2) \
            + 2.0 * math.sqrt(math.pi) * t * t2 * erfc(t)
        return -(math.pi**1.5 * self.beta**3 / 3.0) * f

    def _vfac_traced(self, ksq):
        """[d ln w/dk]/k for the anisotropic virial (pppm_disp.py
        dispersion_vfac, traced); 0 at k = 0."""
        from jax.scipy.special import erfc

        b = self.beta
        t2 = ksq / (4.0 * b * b)
        t = jnp.sqrt(t2)
        ec = erfc(t)
        f = (1.0 - 2.0 * t2) * jnp.exp(-t2) \
            + 2.0 * math.sqrt(math.pi) * t * t2 * ec
        fp = -6.0 * t * jnp.exp(-t2) + 6.0 * math.sqrt(math.pi) * t2 * ec
        k_safe = jnp.sqrt(jnp.where(ksq == 0.0, 1.0, ksq))
        return jnp.where(ksq == 0.0, 0.0, fp / (2.0 * b * f * k_safe))

    # ---- per-block tables ----

    def tables(self, boxL):
        """{"G6": influence fn} (+ {"sf"} in ad mode), traced from boxL."""
        acc = self.acc_dtype
        L = [boxL[ax].astype(acc) for ax in range(3)]
        twopi = 2.0 * np.pi
        k = [jnp.asarray(self._m[ax], acc) * (twopi / L[ax])
             for ax in range(3)]
        kx = k[0][:, None, None]
        ky = k[1][None, :, None]
        kz = k[2][None, None, :]
        ksq = kx * kx + ky * ky + kz * kz
        S = 2 * self._nalias + 1
        km = [jnp.asarray(self._ms[ax], acc) * (twopi / L[ax])
              for ax in range(3)]
        num = jnp.zeros(self.grid, acc)
        for sx in range(S):
            u2x = jnp.asarray(self._u2[0][sx], acc)[:, None, None]
            kmx = km[0][sx][:, None, None]
            for sy in range(S):
                u2y = jnp.asarray(self._u2[1][sy], acc)[None, :, None]
                kmy = km[1][sy][None, :, None]
                for sz in range(S):
                    u2z = jnp.asarray(self._u2[2][sz], acc)[None, None, :]
                    kmz = km[2][sz][None, None, :]
                    kmsq = kmx * kmx + kmy * kmy + kmz * kmz
                    g = self._kernel_traced(kmsq)
                    kdot = kx * kmx + ky * kmy + kz * kmz
                    num = num + (u2x * u2y * u2z) * g * kdot
        ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
        G = num / (ksq_safe * jnp.asarray(self._den_sq, acc))
        G = G * jnp.asarray(self._kmask, acc)
        out = {"G6": G.astype(acc)}
        if self.diff == "ad":
            out["sf"] = _sf_refit_traced(G, L, self.grid, self._sf, acc)
        return out

    # ---- force/energy pass ----

    def _weights(self, x, boxL, deriv: bool = False):
        p = self.order
        lo = jnp.asarray(self._center, x.dtype) - 0.5 * boxL.astype(x.dtype)
        out = []
        for ax, n in enumerate(self.grid):
            u = (x[:, ax] - lo[ax]) * (n / boxL[ax].astype(x.dtype))
            out.append(bspline_weights(u, p, deriv=deriv))
        return out

    def _stencil(self, bases):
        offs = jnp.asarray(stencil_offsets(self.order), jnp.int32)
        return [jnp.mod(bases[ax][:, None] + offs, n)
                for ax, n in enumerate(self.grid)]

    def compute_traced_channels(self, x, a_atoms, boxL,
                                eflag: bool = True, vflag: bool = True,
                                kc=None) -> KSpaceResult:
        """Channel pipeline (pppm_disp.py _disp_compute_multi) under the
        traced box: a_atoms (nch, N) per-atom channel charges."""
        acc = self.acc_dtype
        nx, ny, nz = self.grid
        nzh = nz // 2 + 1
        ngrid = nx * ny * nz
        nch = a_atoms.shape[0]
        Pm = jnp.asarray(self.P, acc)
        if kc is None:
            kc = self.tables(boxL)
        ad = self.diff == "ad"
        L = [boxL[ax].astype(acc) for ax in range(3)]
        V = (L[0] * L[1] * L[2]).astype(acc)

        wx_ = self._weights(x, boxL, deriv=ad)
        bases = [w[0] for w in wx_]
        ws = [w[1] for w in wx_]
        dws = [w[2] for w in wx_] if ad else None
        ix, iy, iz = self._stencil(bases)
        flat = ((ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
                + iz[:, None, None, :]).reshape(x.shape[0], -1)
        w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
              * ws[2][:, None, None, :]).reshape(x.shape[0], -1)
        meshes = []
        for c in range(nch):
            m = jnp.zeros((ngrid,), x.dtype)
            m = m.at[flat.reshape(-1)].add(
                (w3 * a_atoms[c][:, None]).reshape(-1))
            meshes.append(m.reshape(nx, ny, nz))
        meshes = jnp.stack(meshes)

        S = jnp.fft.rfftn(meshes.astype(acc), axes=(1, 2, 3))
        G = kc["G6"].astype(acc)[..., :nzh]
        chi = jnp.einsum("cd,dxyz->cxyz", Pm, S, precision=MATMUL)

        asum = jnp.sum(a_atoms.astype(acc), axis=1)
        e0 = (0.5 / V) * self.w0 * jnp.matmul(
            jnp.matmul(asum, Pm, precision=MATMUL), asum, precision=MATMUL)
        c6_self = jnp.einsum("cn,cd,dn->n", a_atoms.astype(acc), Pm,
                             a_atoms.astype(acc), precision=MATMUL)
        e_self = self.beta**6 / 12.0 * jnp.sum(c6_self)

        from .pppm_cells import _half_weights

        wz = jnp.asarray(_half_weights(nz), acc)[None, None, :]
        if eflag or vflag:
            s2 = jnp.sum(jnp.real(S * jnp.conj(chi)), axis=0)
            ek = G * s2 * wz
        if eflag:
            elong = (0.5 / V) * jnp.sum(ek.astype(acc)) + e0 + e_self
        else:
            elong = jnp.zeros((), acc)

        k = [jnp.asarray(self._m[ax], acc)
             * jnp.asarray(2.0 * np.pi, acc) / L[ax] for ax in range(3)]
        kx = k[0][:, None, None]
        ky = k[1][None, :, None]
        kz = k[2][:nzh][None, None, :]
        if vflag:
            ksq = kx * kx + ky * ky + kz * kz
            vf = self._vfac_traced(ksq)
            c = 0.5 / V
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

        phi = G[None] * chi
        scale = 1.0 / V
        if ad:
            u_fields = jnp.real(
                jnp.fft.irfftn(phi, s=self.grid, axes=(1, 2, 3))
            ) * (scale * ngrid)
            combos = ((dws[0], ws[1], ws[2]), (ws[0], dws[1], ws[2]),
                      (ws[0], ws[1], dws[2]))
            w3d = [
                (aw[:, :, None, None] * bw[:, None, :, None]
                 * cw[:, None, None, :]).reshape(x.shape[0], -1)
                for (aw, bw, cw) in combos
            ]
            lo = (jnp.asarray(self._center, x.dtype)
                  - 0.5 * boxL.astype(x.dtype))
            fvec = jnp.zeros((x.shape[0], 3), acc)
            for ci in range(nch):
                uv = u_fields[ci].reshape(-1)[flat]
                cols = [
                    -jnp.sum(w3d[ax] * uv, axis=1)
                    * (self.grid[ax] / L[ax]) for ax in range(3)
                ]
                fvec = fvec + (jnp.stack(cols, axis=-1).astype(acc)
                               * a_atoms[ci][:, None].astype(acc))
            # traced self-force series x the paired self-coupling c6_self
            sf = kc["sf"]
            e_self_f = []
            for ax in range(3):
                ug = (x[:, ax] - lo[ax]) * (self.grid[ax]
                                            / L[ax].astype(x.dtype))
                es = jnp.zeros((x.shape[0],), acc)
                for j in range(sf.shape[1]):
                    es = es + sf[ax, j] * jnp.sin(
                        2.0 * jnp.pi * (j + 1) * ug).astype(acc)
                e_self_f.append(es)
            fvec = fvec - (c6_self[:, None]
                           * jnp.stack(e_self_f, -1)).astype(acc)
            return KSpaceResult(f=fvec, elong=elong, virial=virial)

        ehat = jnp.stack([(-1j) * kax.astype(phi.dtype) * phi
                          for kax in (kx, ky, kz)], axis=1)  # (nch, 3, ..)
        e_fields = jnp.real(
            jnp.fft.irfftn(ehat, s=self.grid, axes=(2, 3, 4))
        ) * (scale * ngrid)
        fvec = jnp.zeros((x.shape[0], 3), acc)
        for ci in range(nch):
            cols = []
            for ax in range(3):
                ev = e_fields[ci, ax].reshape(-1)[flat]
                cols.append(jnp.sum(w3 * ev, axis=1))
            fvec = fvec + (jnp.stack(cols, axis=-1).astype(acc)
                           * a_atoms[ci][:, None].astype(acc))
        return KSpaceResult(f=fvec, elong=elong, virial=virial)


class TracedBoundKSpace:
    """Deck-facing adapter for :class:`TracedPPPMDisp` — the traced
    analog of base.BoundKSpace: bakes the per-atom dispersion charges
    (geometric B_i) or type ids (channel mixing) and exposes the
    runner's ``compute_traced(x, q, boxL)`` / ``tables`` protocol."""

    def __init__(self, solver: TracedPPPMDisp, per_atom, typed=False):
        self.solver = solver
        self.per_atom = np.asarray(per_atom)
        self.typed = typed
        self.acc_dtype = solver.acc_dtype

    def tables(self, boxL):
        return self.solver.tables(boxL)

    def _a_atoms(self, x):
        if self.typed:
            return jnp.asarray(self.solver.A, x.dtype)[:, self.per_atom]
        return jnp.asarray(self.per_atom, x.dtype)[None, :]

    def compute_traced(self, x, q, boxL, eflag=True, vflag=True, kc=None):
        return self.solver.compute_traced_channels(
            x, self._a_atoms(x), boxL, eflag=eflag, vflag=vflag, kc=kc)

    def compute_traced_slot(self, x, aid, q, boxL, eflag=True, vflag=True,
                            kc=None):
        """Slot-order form (slab NPT): aid clamped to N for empty slots;
        the zero pad row gives empty slots zero dispersion charge."""
        if self.typed:
            A = np.asarray(self.solver.A)
            af = A[:, self.per_atom]
            af = np.concatenate([af, np.zeros((af.shape[0], 1))], 1)
            a_slot = jnp.asarray(af, x.dtype)[:, aid]
        else:
            b = np.concatenate([self.per_atom, [0.0]])
            a_slot = jnp.asarray(b, x.dtype)[aid][None, :]
        return self.solver.compute_traced_channels(
            x, a_slot, boxL, eflag=eflag, vflag=vflag, kc=kc)


class TracedCombinedKSpace:
    """Traced analog of base.CombinedKSpace (coulomb PPPM + dispersion
    PPPM under one variable cell — the pppm/disp dual pipeline of
    pppm_disp_intel.cpp:183-313 with both grids re-baked per block)."""

    def __init__(self, solvers):
        self.solvers = solvers
        self.acc_dtype = solvers[0].acc_dtype

    def tables(self, boxL):
        return tuple(s.tables(boxL) if hasattr(s, "tables") else None
                     for s in self.solvers)

    def _sum(self, results):
        out = None
        for r in results:
            out = r if out is None else KSpaceResult(
                f=out.f + r.f, elong=out.elong + r.elong,
                virial=out.virial + r.virial)
        return out

    def compute_traced(self, x, q, boxL, eflag=True, vflag=True, kc=None):
        if kc is None:
            kc = self.tables(boxL)
        return self._sum([
            s.compute_traced(x, q, boxL, eflag=eflag, vflag=vflag,
                             kc=kc[i])
            for i, s in enumerate(self.solvers)])

    def compute_traced_slot(self, x, aid, q, boxL, eflag=True, vflag=True,
                            kc=None):
        if kc is None:
            kc = self.tables(boxL)
        res = []
        for i, s in enumerate(self.solvers):
            if hasattr(s, "compute_traced_slot"):
                res.append(s.compute_traced_slot(
                    x, aid, q, boxL, eflag=eflag, vflag=vflag, kc=kc[i]))
            else:
                res.append(s.compute_traced(
                    x, q, boxL, eflag=eflag, vflag=vflag, kc=kc[i]))
        return self._sum(res)


def make_traced_kspace(kspace, center, triclinic: bool = False):
    """Map a deck kspace solver to its traced (variable-cell) form.

    PPPM -> TracedPPPM; BoundKSpace(PPPMDisp) -> TracedBoundKSpace;
    CombinedKSpace -> TracedCombinedKSpace; solvers already exposing
    ``compute_traced`` (Ewald) pass through.  Raises NotImplementedError
    (loudly — never a silent physics substitution) for anything else."""
    if hasattr(kspace, "compute_traced"):
        return kspace
    if isinstance(kspace, PPPM):
        return TracedPPPM(kspace, center)
    if isinstance(kspace, BoundKSpace):
        if not isinstance(kspace.solver, PPPMDisp):
            raise NotImplementedError(
                f"fix npt: no variable-cell form for bound solver "
                f"{type(kspace.solver).__name__}")
        if triclinic:
            # host parity: stock LAMMPS' PPPMDisp rejects triclinic
            # boxes outright ("Cannot (yet) use PPPMDisp with triclinic
            # box", pppm_disp.cpp init) — there is no reference
            # semantics to trace
            raise NotImplementedError(
                "fix npt: pppm/disp on a TRICLINIC cell (host LAMMPS "
                "rejects triclinic pppm/disp as well)")
        return TracedBoundKSpace(
            TracedPPPMDisp(kspace.solver, center),
            kspace.per_atom, typed=kspace.typed)
    if isinstance(kspace, CombinedKSpace):
        return TracedCombinedKSpace(
            [make_traced_kspace(s, center, triclinic)
             for s in kspace.solvers])
    raise NotImplementedError(
        f"fix npt: no variable-cell form for kspace solver "
        f"{type(kspace).__name__}")
