"""Dispersion PPPM (``pppm/disp``) — long-range r^-6 mesh solver.

Re-design of the reference's pppm_disp_intel.{h,cpp} (C8 in
SURVEY.md §2).  All three mixing pipelines are implemented through ONE
channel formulation:

* geometric (``function[1]``, pppm_disp_intel.cpp:245-313): one density
  channel, C6_ij = B_i B_j;
* arithmetic (``function[2]``, :315-407): the Lorentz-Berthelot
  C6_ij = 4 sqrt(eps_i eps_j) ((sig_i+sig_j)/2)^6 expands binomially into
  SEVEN channels a_i^(m) = sqrt(C(6,m)) sqrt(eps_i) sig_i^m / 4 with the
  cross-pairing C6_ij = sum_m a_i^(m) a_j^(6-m) — the reference's 7
  density meshes and paired 2-in-1 poisson solves;
* none (``function[3]``, :409-467): an arbitrary per-type-pair C6 matrix
  eigendecomposes into nsplit signed channels C6 = sum_s lambda_s v^s v^sT.

Unified: channels A (nch, ntypes) + a tiny pairing matrix P (nch, nch):
    C6_ij = sum_{cc'} P_cc' A[c, t_i] A[c', t_j]
    E     = 1/(2V) sum_k G6(k) sum_{cc'} P_cc' Re[S_c conj(S_c')]
            + w(0) (Qc P Qc') / 2V + g6^6/12 sum_i C6_ii
    f_i   = sum_c A[c, t_i] * Efield[G6 * (P rho_hat)_c](x_i)

Physics (Karasawa-Goddard dispersion Ewald): the smooth long-range part of
-C6/r^6 after the (1 + u^2 + u^4/2) e^{-u^2} real-space damping (the same
splitting the ORDER6 pair kernels use) has the Fourier kernel

    w(k) = -(pi^{3/2} b^3 / 3) * [ (1 - 2 t^2) e^{-t^2}
                                   + 2 sqrt(pi) t^3 erfc(t) ],  t = k/(2 b)

finite at k = 0.  The virial is the full anisotropic tensor
    vir_ab = 1/(2V) sum_k ek (delta_ab + k_a k_b [d ln w/dk]/k)
           + delta_ab E_{k=0}
(d ln w/dk from f'(t) = -6 t e^{-t^2} + 6 sqrt(pi) t^2 erfc(t)), validated
against f64 box-rescale finite differences (tests/test_pppm_disp.py).
Everything is validated against an absolutely-convergent direct lattice
sum of -C6/r^6 — a stronger oracle than the reference ever had.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import erfc as sp_erfc

from ...core.box import Box
from ...core.precision import MATMUL
from .base import KSpaceResult
from . import pppm as _pppm


def dispersion_kernel(beta):
    """w(k) for the r^-6 Ewald splitting (see module docstring)."""

    def kern(kmsq):
        k = np.sqrt(kmsq)
        t = k / (2.0 * beta)
        f = (1.0 - 2.0 * t * t) * np.exp(-t * t) \
            + 2.0 * math.sqrt(math.pi) * t**3 * sp_erfc(t)
        return -(math.pi**1.5 * beta**3 / 3.0) * f

    return kern


def dispersion_vfac(beta, grid, L) -> np.ndarray:
    """(nx, ny, nz) static [d ln w/dk]/k for the anisotropic virial."""
    def axis_k(n, prd):
        m = np.arange(n)
        m = np.where(m > n // 2, m - n, m)
        return 2.0 * np.pi * m / prd

    kx = axis_k(grid[0], L[0])[:, None, None]
    ky = axis_k(grid[1], L[1])[None, :, None]
    kz = axis_k(grid[2], L[2])[None, None, :]
    k = np.sqrt(kx**2 + ky**2 + kz**2)
    t = k / (2.0 * beta)
    f = (1.0 - 2.0 * t * t) * np.exp(-t * t) \
        + 2.0 * math.sqrt(math.pi) * t**3 * sp_erfc(t)
    fp = -6.0 * t * np.exp(-t * t) \
        + 6.0 * math.sqrt(math.pi) * t * t * sp_erfc(t)
    # d ln w / dk = f'(t) / (2 beta f(t)); f < ~1 and > 0 everywhere
    k_safe = np.where(k == 0.0, 1.0, k)
    out = fp / (2.0 * beta * f * k_safe)
    out[k == 0.0] = 0.0  # k=0 term handled separately (E0 diag)
    return out


def solve_g6(cutoff: float, tol_rel: float = 1e-4) -> float:
    """Pick beta so the damped real-space tail retained at the cutoff is a
    tol_rel fraction of the bare 1/rc^6 (bisection on
    (1 + u^2 + u^4/2) e^{-u^2} = tol)."""
    lo_u, hi_u = 0.5, 10.0
    for _ in range(80):
        mid = 0.5 * (lo_u + hi_u)
        val = (1.0 + mid**2 + mid**4 / 2.0) * math.exp(-mid * mid)
        if val > tol_rel:
            lo_u = mid
        else:
            hi_u = mid
    return lo_u / cutoff


def mixing_channels(mix: str, *, B=None, epsilon=None, sigma=None,
                    C6=None):
    """(A (nch, ntypes), P (nch, nch)) for a mixing rule (see module doc).

    geometric: B (ntypes,); arithmetic: epsilon+sigma (ntypes,);
    none: C6 (ntypes, ntypes) symmetric — eigen-split into nsplit channels
    (the reference's function[3] nsplit, pppm_disp_intel.cpp:409-467)."""
    if mix == "geometric":
        A = np.asarray(B, np.float64)[None, :]
        P = np.ones((1, 1))
    elif mix == "arithmetic":
        eps = np.asarray(epsilon, np.float64)
        sig = np.asarray(sigma, np.float64)
        A = np.stack([
            0.25 * math.sqrt(math.comb(6, m)) * np.sqrt(eps) * sig**m
            for m in range(7)
        ])
        P = np.zeros((7, 7))
        for m in range(7):
            P[m, 6 - m] = 1.0
    elif mix == "none":
        C6 = np.asarray(C6, np.float64)
        lam, vec = np.linalg.eigh(0.5 * (C6 + C6.T))
        keep = np.abs(lam) > 1e-12 * max(np.abs(lam).max(), 1e-300)
        lam, vec = lam[keep], vec[:, keep]
        A = (vec * np.sqrt(np.abs(lam))[None, :]).T   # (nsplit, ntypes)
        P = np.diag(np.sign(lam))
    else:
        raise ValueError(f"unknown dispersion mixing {mix!r}")
    return A, P


@dataclasses.dataclass
class PPPMDisp:
    """Configured dispersion-PPPM solver (any mixing rule).

    A/P: the channel decomposition; B kept for the geometric fast path
    (B == A[0] there).
    """

    g_ewald_6: float
    grid: tuple[int, int, int]
    order: int
    greensfn: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    kz: np.ndarray
    B: np.ndarray
    volume: float
    box_lo: tuple[float, float, float]
    h: tuple[float, float, float]
    acc_dtype: object = jnp.float32
    mix: str = "geometric"
    A: Optional[np.ndarray] = None       # (nch, ntypes)
    P: Optional[np.ndarray] = None       # (nch, nch)
    vfac: Optional[np.ndarray] = None    # (nx, ny, nz) virial factor
    # differentiation mode — "ik" (3 inverse FFTs/channel) or "ad" (one
    # potential mesh/channel + derivative-spline gather + measured
    # self-force series), the poisson_2s_ad / fieldforce_a_ad dispatch of
    # /root/reference/pppm_disp_intel.cpp:193-241
    diff: str = "ik"
    sf_sine: Optional[np.ndarray] = None  # (3, J) ad self-field series

    @property
    def w0(self) -> float:
        return -(math.pi**1.5 * self.g_ewald_6**3 / 3.0)

    def elong_const(self, bsum: float, b2sum: float) -> float:
        """k=0 + self corrections (depend only on composition)."""
        return (0.5 / self.volume) * self.w0 * bsum**2 \
            + self.g_ewald_6**6 / 12.0 * b2sum

    def compute(self, x, b_per_atom, eflag: bool = True,
                vflag: bool = True) -> KSpaceResult:
        """Geometric fast path; b_per_atom: (N,) dispersion charges."""
        return _disp_compute_multi(
            self, x, b_per_atom[None, :], np.ones((1, 1)),
            eflag, vflag)

    def compute_typed(self, x, typ, eflag: bool = True,
                      vflag: bool = True) -> KSpaceResult:
        """General mixing path: per-atom channel charges from types."""
        a_atoms = jnp.asarray(self.A, x.dtype)[:, typ]   # (nch, N)
        return _disp_compute_multi(self, x, a_atoms, self.P, eflag, vflag)

    def compute_channels(self, x, a_atoms, P=None, eflag: bool = True,
                         vflag: bool = True) -> KSpaceResult:
        """Explicit channel-charge form: a_atoms (nch, M) — slot-order
        callers pad empty rows with zeros (BoundKSpace.compute_slot)."""
        P = self.P if P is None else P
        return _disp_compute_multi(self, x, a_atoms, P, eflag, vflag)

    def compute_peratom(self, x, typ=None, b_per_atom=None):
        """Per-atom dispersion energy/virial — the per-atom correction
        contract of /root/reference/pppm_disp_intel.cpp:512-537."""
        if b_per_atom is not None:
            a_atoms = b_per_atom[None, :]
            P = np.ones((1, 1))
        else:
            a_atoms = jnp.asarray(self.A, x.dtype)[:, typ]
            P = self.P
        return _disp_peratom_multi(self, x, a_atoms, P)


def setup_pppm_disp(
    box: Box,
    B_per_type,
    typ,
    cutoff: float,
    qqrd2e_unused: float = 1.0,
    tol_real: float = 1e-4,
    g_ewald_6: Optional[float] = None,
    grid: Optional[tuple[int, int, int]] = None,
    order: int = 5,
    acc_dtype=jnp.float32,
    mix: str = "geometric",
    epsilon=None,
    sigma=None,
    C6=None,
    diff: str = "ik",
    multiple_of: Optional[tuple[int, int, int]] = None,
    grid_min: Optional[tuple[int, int, int]] = None,
) -> PPPMDisp:
    L = np.asarray(box.lengths, np.float64)
    volume = float(np.prod(L))
    if g_ewald_6 is None:
        g_ewald_6 = solve_g6(cutoff, tol_real)
    if grid is None:
        # heuristic: resolve the Gaussian-ish w(k) decay — grid spacing
        # h <~ 1/(2 g6) resolves t = k_max/(2 b) ~ pi/(2 h b) >~ 3
        n = [max(int(math.ceil(L[ax] * g_ewald_6 * 2.2)), 2 * order)
             for ax in range(3)]
        grid = []
        for ax in range(3):
            v = n[ax]
            if grid_min is not None:
                v = max(v, grid_min[ax])
            if multiple_of is not None:
                # cell-aligned meshes (the patch/pencil pipelines): round
                # the per-cell point count up (setup_pppm's contract)
                m = multiple_of[ax]
                grid.append(m * (-(-v // m)))
            else:
                grid.append(_pppm._next_good(v))
        grid = tuple(grid)
    nx, ny, nz = grid

    def kvals(n, prd):
        m = np.arange(n)
        m = np.where(m > n // 2, m - n, m)
        return 2.0 * np.pi * m / prd

    greensfn = _pppm._greens_function(
        grid, L, g_ewald_6, order, kernel=dispersion_kernel(g_ewald_6)
    )
    if mix == "geometric":
        A, P = mixing_channels("geometric", B=B_per_type)
    else:
        A, P = mixing_channels(mix, B=B_per_type, epsilon=epsilon,
                               sigma=sigma, C6=C6)
    sf_sine = None
    if diff == "ad":
        # the measured self-force series is kernel-agnostic: it depends
        # only on (grid, L, greensfn, order)
        sf_sine = _pppm._sf_sine_fit(grid, L, greensfn, order)
    return PPPMDisp(
        g_ewald_6=float(g_ewald_6), grid=grid, order=order,
        greensfn=greensfn,
        kx=kvals(nx, L[0]), ky=kvals(ny, L[1]), kz=kvals(nz, L[2]),
        B=np.asarray(B_per_type, np.float64), volume=volume,
        box_lo=tuple(float(v) for v in np.asarray(box.lo)),
        h=tuple(float(L[i] / grid[i]) for i in range(3)),
        acc_dtype=acc_dtype, mix=mix, A=A, P=P,
        vfac=dispersion_vfac(g_ewald_6, grid, L),
        diff=diff, sf_sine=sf_sine,
    )


def _disp_compute_multi(pm: PPPMDisp, x, a_atoms, P, eflag: bool,
                        vflag: bool) -> KSpaceResult:
    """Channel pipeline: a_atoms (nch, N) per-atom channel charges,
    P (nch, nch) pairing.  The reference's make_rho_a 7-mesh deposit +
    poisson_2s paired solves (pppm_disp_intel.cpp:315-407) in batched
    spectral form."""
    acc = pm.acc_dtype
    nx, ny, nz = pm.grid
    nzh = nz // 2 + 1
    ngrid = nx * ny * nz
    V = float(pm.volume)
    nch = a_atoms.shape[0]
    Pm = np.asarray(P, np.float64)

    shim = _pppm.PPPM(
        g_ewald=pm.g_ewald_6, grid=pm.grid, order=pm.order,
        greensfn=pm.greensfn, kx=pm.kx, ky=pm.ky, kz=pm.kz,
        qsum=0.0, qsqsum=0.0, qqrd2e=1.0, volume=V,
        box_lo=pm.box_lo, h=pm.h, acc_dtype=acc,
    )
    meshes = jnp.stack([
        _pppm.deposit_rho(shim, x, a_atoms[c]) for c in range(nch)
    ])
    S = jnp.fft.rfftn(meshes.astype(acc), axes=(1, 2, 3))  # (nch, ...)
    G = jnp.asarray(pm.greensfn[..., :nzh], acc)
    chi = jnp.einsum("cd,dxyz->cxyz", jnp.asarray(Pm, acc), S,
                     precision=MATMUL)

    asum = jnp.sum(a_atoms.astype(acc), axis=1)            # (nch,)
    e0 = (0.5 / V) * pm.w0 * jnp.matmul(
        jnp.matmul(asum, jnp.asarray(Pm, acc), precision=MATMUL), asum,
        precision=MATMUL)
    c6_self = jnp.einsum(
        "cn,cd,dn->n", a_atoms.astype(acc), jnp.asarray(Pm, acc),
        a_atoms.astype(acc), precision=MATMUL)
    e_self = pm.g_ewald_6**6 / 12.0 * jnp.sum(c6_self)

    from .pppm_cells import _half_weights

    wz = jnp.asarray(_half_weights(nz), acc)[None, None, :]
    if eflag or vflag:
        # sum_cc' P Re[S_c conj(S_c')] = Re sum_c S_c conj(chi_c)
        s2 = jnp.sum(jnp.real(S * jnp.conj(chi)), axis=0)
        ek = G * s2 * wz
    if eflag:
        elong = (0.5 / V) * jnp.sum(ek.astype(acc)) + e0 + e_self
    else:
        elong = jnp.zeros((), acc)

    if vflag:
        kx = jnp.asarray(pm.kx, acc)[:, None, None]
        ky = jnp.asarray(pm.ky, acc)[None, :, None]
        kz = jnp.asarray(pm.kz[:nzh], acc)[None, None, :]
        vf = jnp.asarray(pm.vfac[..., :nzh], acc)
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

    phi = G[None] * chi                                   # (nch, ...)
    scale = 1.0 / V

    if pm.diff == "ad":
        # ONE potential mesh per channel + derivative-spline gather
        # minus the measured self-force (poisson_2s_ad/fieldforce_a_ad,
        # /root/reference/pppm_disp_intel.cpp:193-241)
        u_fields = jnp.real(
            jnp.fft.irfftn(phi, s=pm.grid, axes=(1, 2, 3))
        ) * (scale * ngrid)                               # (nch, grid)
        wx_ = _pppm._particle_weights(shim, x, deriv=True)
        bases = [w[0] for w in wx_]
        ws = [w[1] for w in wx_]
        dws = [w[2] for w in wx_]
        ix, iy, iz = _pppm._stencil_indices(shim, bases)
        flat = (
            (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
            + iz[:, None, None, :]
        ).reshape(x.shape[0], -1)
        combos = (
            (dws[0], ws[1], ws[2]),
            (ws[0], dws[1], ws[2]),
            (ws[0], ws[1], dws[2]),
        )
        w3d = [
            (aw[:, :, None, None] * bw[:, None, :, None]
             * cw[:, None, None, :]).reshape(x.shape[0], -1)
            for (aw, bw, cw) in combos
        ]
        fvec = jnp.zeros((x.shape[0], 3), acc)
        for ci in range(nch):
            uv = u_fields[ci].reshape(-1)[flat]
            cols = [
                -jnp.sum(w3d[ax] * uv, axis=1) * (1.0 / pm.h[ax])
                for ax in range(3)
            ]
            fvec = fvec + (jnp.stack(cols, axis=-1).astype(acc)
                           * a_atoms[ci][:, None].astype(acc))
        # self-force: the series depends only on the grid geometry; the
        # per-atom strength is the paired self-coupling sum_cc' P a a
        shim_sf = dataclasses.replace(shim, sf_sine=pm.sf_sine)
        e_self_f = jnp.stack(
            [_pppm.sf_axis_series(shim_sf, x[:, ax], ax)
             for ax in range(3)], axis=-1)
        fvec = fvec - (c6_self[:, None] * e_self_f).astype(acc)
        return KSpaceResult(f=fvec, elong=elong, virial=virial)

    # ik fields: one batched inverse real FFT over (nch, 3) spectral slabs
    kxv = jnp.asarray(pm.kx, acc)[:, None, None]
    kyv = jnp.asarray(pm.ky, acc)[None, :, None]
    kzv = jnp.asarray(pm.kz[:nzh], acc)[None, None, :]
    ehat = jnp.stack([(-1j) * kax * phi for kax in (kxv, kyv, kzv)],
                     axis=1)                              # (nch, 3, ...)
    e_fields = jnp.real(
        jnp.fft.irfftn(ehat, s=pm.grid, axes=(2, 3, 4))
    ) * (scale * ngrid)                                   # (nch, 3, grid)

    wx_ = _pppm._particle_weights(shim, x)
    bases = [w[0] for w in wx_]
    ws = [w[1] for w in wx_]
    ix, iy, iz = _pppm._stencil_indices(shim, bases)
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :]).reshape(x.shape[0], -1)
    flat = (
        (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
        + iz[:, None, None, :]
    ).reshape(x.shape[0], -1)

    fvec = jnp.zeros((x.shape[0], 3), acc)
    for ci in range(nch):
        cols = []
        for ax in range(3):
            ev = e_fields[ci, ax].reshape(-1)[flat]
            cols.append(jnp.sum(w3 * ev, axis=1))
        fvec = fvec + (jnp.stack(cols, axis=-1).astype(acc)
                       * a_atoms[ci][:, None].astype(acc))
    return KSpaceResult(f=fvec, elong=elong, virial=virial)


def _disp_peratom_multi(pm: PPPMDisp, x, a_atoms, P):
    """Per-atom dispersion energy and virial (eatom (N,), vatom (N, 6)).

    The eflag_atom/vflag_atom dispersion corrections of
    /root/reference/pppm_disp_intel.cpp:512-537: per-atom shares of the
    mesh sum plus the k=0 and self corrections, pinned EXACTLY to the
    global sums (sum eatom == elong, sum vatom == virial) by the Parseval
    + deposit identities the Coulomb compute_peratom uses."""
    acc = pm.acc_dtype
    nx, ny, nz = pm.grid
    nzh = nz // 2 + 1
    ngrid = nx * ny * nz
    V = float(pm.volume)
    nch = a_atoms.shape[0]
    Pm = np.asarray(P, np.float64)

    shim = _pppm.PPPM(
        g_ewald=pm.g_ewald_6, grid=pm.grid, order=pm.order,
        greensfn=pm.greensfn, kx=pm.kx, ky=pm.ky, kz=pm.kz,
        qsum=0.0, qsqsum=0.0, qqrd2e=1.0, volume=V,
        box_lo=pm.box_lo, h=pm.h, acc_dtype=acc,
    )
    meshes = jnp.stack([
        _pppm.deposit_rho(shim, x, a_atoms[c]) for c in range(nch)
    ])
    S = jnp.fft.rfftn(meshes.astype(acc), axes=(1, 2, 3))
    G = jnp.asarray(pm.greensfn[..., :nzh], acc)
    chi = jnp.einsum("cd,dxyz->cxyz", jnp.asarray(Pm, acc), S,
                     precision=MATMUL)
    phi = G[None] * chi

    wx_ = _pppm._particle_weights(shim, x)
    bases = [w[0] for w in wx_]
    ws = [w[1] for w in wx_]
    ix, iy, iz = _pppm._stencil_indices(shim, bases)
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :]).reshape(x.shape[0], -1)
    flat = (
        (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
        + iz[:, None, None, :]
    ).reshape(x.shape[0], -1)

    def interp(m):
        return jnp.sum(w3 * m.reshape(-1)[flat], axis=1)

    scale = ngrid / V
    asum = jnp.sum(a_atoms.astype(acc), axis=1)
    a_P_asum = jnp.einsum("cn,cd,d->n", a_atoms.astype(acc),
                          jnp.asarray(Pm, acc), asum, precision=MATMUL)
    c6_self = jnp.einsum("cn,cd,dn->n", a_atoms.astype(acc),
                         jnp.asarray(Pm, acc), a_atoms.astype(acc),
                         precision=MATMUL)

    eatom = jnp.zeros((x.shape[0],), acc)
    for ci in range(nch):
        u = jnp.real(jnp.fft.irfftn(phi[ci], s=pm.grid)) * scale
        eatom = eatom + 0.5 * a_atoms[ci].astype(acc) * interp(u)
    # k=0 share (0.5/V w0 a_i.P.asum sums to e0) + self correction
    eatom = eatom + (0.5 / V) * pm.w0 * a_P_asum \
        + pm.g_ewald_6**6 / 12.0 * c6_self
    eatom = eatom.astype(acc)

    kx = jnp.asarray(pm.kx, acc)[:, None, None]
    ky = jnp.asarray(pm.ky, acc)[None, :, None]
    kz = jnp.asarray(pm.kz[:nzh], acc)[None, None, :]
    vf = jnp.asarray(pm.vfac[..., :nzh], acc)
    comps = (
        1.0 + vf * kx * kx,
        1.0 + vf * ky * ky,
        1.0 + vf * kz * kz,
        vf * kx * ky,
        vf * kx * kz,
        vf * ky * kz,
    )
    vcols = []
    for ic, cfac in enumerate(comps):
        col = jnp.zeros((x.shape[0],), acc)
        for ci in range(nch):
            vm = jnp.real(
                jnp.fft.irfftn(cfac * phi[ci], s=pm.grid)) * scale
            col = col + 0.5 * a_atoms[ci].astype(acc) * interp(vm)
        if ic < 3:  # e0 is a pure diagonal (k=0) term
            col = col + (0.5 / V) * pm.w0 * a_P_asum
        vcols.append(col.astype(acc))
    return eatom, jnp.stack(vcols, axis=-1)
