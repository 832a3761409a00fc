"""PPPM (particle-particle particle-mesh) electrostatics solver.

Re-design of the reference's pppm_intel.{h,cpp} (C7 in
SURVEY.md §2): particle_map (:325-392), make_rho (:403-527), poisson_ik
(:811-976) and fieldforce_ik (:540-640), plus the host-LAMMPS setup
contract (H5: accuracy -> g_ewald/grid/order, B-spline coefficients,
optimal influence function, virial coefficients).

Design:
* Setup is host numpy (runs once): grid sizing from the Deserno-Holm ik
  error expansion, Hockney-Eastwood optimal influence function with
  brute-force aliasing sums (replaces the closed-form gf_denom polynomial —
  setup-time numerics, not worth the special casing).
* Compute is one jitted pipeline: B-spline weights by Cox-de-Boor recursion
  (branch-free, traced once), charge deposition as a scatter-add, 3D FFTs
  via XLA, spectral multiply, 3 inverse FFTs for the ik E-field, stencil
  gather-interpolation.  The per-thread density privatization of the
  reference (:420-527) is unnecessary — XLA owns the scatter.
* No FFT_SINGLE split: grid dtype follows the precision policy.

Validation: reciprocal energy/forces against the O(N^2 k-space) golden
Ewald sum (tests/test_pppm.py), the reference's own oracle strategy
(SURVEY.md §4).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...core.box import Box
from .base import (
    KSpaceResult, estimate_ik_error, rms_real, solve_g_ewald,
    two_charge_force,
)

_GOOD_SIZES = sorted(
    {2**a * 3**b * 5**c
     for a in range(1, 12) for b in range(6) for c in range(5)
     if 2**a * 3**b * 5**c <= 4096}
)


def _next_good(n: int) -> int:
    for g in _GOOD_SIZES:
        if g >= n:
            return g
    raise ValueError(f"grid size {n} too large")


def _fold_idx(n: int) -> np.ndarray:
    """FFT index -> signed harmonic number (m > n/2 wraps negative)."""
    m = np.arange(n)
    return np.where(m > n // 2, m - n, m)


def _cart_k(recip, ix, iy, iz):
    """Cartesian wave-vector components from (broadcastable) integer index
    arrays: k = recip @ (ix, iy, iz).  Zero matrix entries contribute no
    broadcast term, so orthogonal recips keep the per-axis shapes."""
    comps = []
    for row in range(3):
        acc = None
        for c, idx in zip(recip[row], (ix, iy, iz)):
            if c != 0.0:
                term = c * np.asarray(idx, np.float64)
                acc = term if acc is None else acc + term
        comps.append(np.zeros((1, 1, 1)) if acc is None else acc)
    return comps


def mspline(p: int, x):
    """Cardinal B-spline M_p on support (0, p), Cox-de Boor recursion."""
    if p == 1:
        return ((x >= 0) & (x < 1)).astype(x.dtype)
    return (x * mspline(p - 1, x) + (p - x) * mspline(p - 1, x - 1)) / (p - 1)


def dmspline(p: int, x):
    """d M_p / dx = M_{p-1}(x) - M_{p-1}(x - 1)."""
    return mspline(p - 1, x) - mspline(p - 1, x - 1)


@functools.lru_cache(maxsize=None)
def _mspline_piece_coeffs(p: int) -> tuple:
    """(p, p) ascending coefficients of M_p on [j, j+1) in t = x - j —
    the rho_coeff piecewise-polynomial form the reference evaluates by
    Horner (pppm_intel.cpp:476-488), derived host-side from the Cox-de
    Boor recursion (algebraically identical to :func:`mspline`)."""
    pieces = [np.array([1.0])]                   # M_1 on [0, 1)
    for q in range(2, p + 1):
        prev = pieces
        pieces = []
        for j in range(q):
            # M_q(j + t) = ((j+t) M_{q-1}(j+t) + (q-j-t) M_{q-1}(j-1+t))
            #              / (q - 1); both arguments share offset t
            poly = np.zeros(q)
            if j < q - 1:
                a = prev[j]
                poly[:len(a)] += j * a
                poly[1:len(a) + 1] += a
            if 0 <= j - 1 < q - 1:
                b = prev[j - 1]
                poly[:len(b)] += (q - j) * b
                poly[1:len(b) + 1] -= b
            pieces.append(poly / (q - 1))
    C = np.stack(pieces)                          # (p intervals, p coeffs)
    dC = C[:, 1:] * np.arange(1, p)[None, :]      # derivative pieces
    return (tuple(map(tuple, C)), tuple(map(tuple, dC)))


def _horner_piecewise(coeffs, ndeg: int, p: int, x):
    """Evaluate the piecewise polynomial at x: interval j = floor(x),
    t = x - j, Horner over per-degree interval-select chains (constant
    scalars — pure selects, no gathers).  0 outside [0, p)."""
    j = jnp.clip(jnp.floor(x), 0.0, p - 1)
    t = x - j
    ji = j.astype(jnp.int32)
    acc = None
    for d in range(ndeg - 1, -1, -1):
        c = jnp.full(x.shape, float(coeffs[0][d]), x.dtype)
        for r in range(1, p):
            c = jnp.where(ji == r, float(coeffs[r][d]), c)
        acc = c if acc is None else acc * t + c
    return jnp.where((x >= 0) & (x < p), acc, jnp.zeros_like(x))


def mspline_horner(p: int, x):
    """M_p by piecewise Horner — fewer operations than the Cox-de Boor
    recursion at order 7; bit-comparable (same
    polynomial, different evaluation order)."""
    if p == 1:
        return ((x >= 0) & (x < 1)).astype(x.dtype)
    C, _ = _mspline_piece_coeffs(p)
    return _horner_piecewise(C, p, p, x)


def dmspline_horner(p: int, x):
    """d M_p / dx by piecewise Horner (derivative pieces)."""
    if p <= 2:
        return dmspline(p, x)
    _, dC = _mspline_piece_coeffs(p)
    return _horner_piecewise(dC, p - 1, p, x)


def stencil_offsets(order: int) -> np.ndarray:
    if order % 2:
        return np.arange(-(order - 1) // 2, (order - 1) // 2 + 1)
    return np.arange(-(order // 2 - 1), order // 2 + 1)


def bspline_weights(u, order: int, deriv: bool = False):
    """Weights (and optionally derivatives d w/d u) of the `order` grid
    points covering fractional grid coordinate u.

    u: (...,) positions in grid units.  Returns (base (...,) int32,
    w (..., order)) with base + offsets the grid indices.
    """
    offs = stencil_offsets(order)
    if order % 2:
        base = jnp.round(u)
    else:
        base = jnp.floor(u)
    x = u[..., None] - (base[..., None] + offs)  # in (-p/2, p/2)
    arg = x + order / 2.0
    w = mspline_horner(order, arg)
    if deriv:
        dw = dmspline_horner(order, arg)
        return base.astype(jnp.int32), w, dw
    return base.astype(jnp.int32), w


@dataclasses.dataclass
class PPPM:
    """Configured PPPM solver for a fixed box / charge set / accuracy."""

    g_ewald: float
    grid: tuple[int, int, int]
    order: int
    greensfn: np.ndarray      # (nx, ny, nz) optimal influence, energy units
    kx: np.ndarray            # folded k components per axis
    ky: np.ndarray
    kz: np.ndarray
    qsum: float
    qsqsum: float
    qqrd2e: float
    volume: float
    box_lo: tuple[float, float, float]
    h: tuple[float, float, float]
    acc_dtype: object = jnp.float32
    accuracy_abs: float = 0.0
    # differentiation mode: "ik" (3 inverse FFTs of the spectral E-field)
    # or "ad" (1 inverse FFT -> potential mesh, derivative-spline gather
    # + self-force correction).  Ref /root/reference/pppm_intel.cpp:985-1054
    # (poisson_ad), :678-804 (fieldforce_ad).
    diff: str = "ik"
    # per-axis sine series of the ad self-force field (J terms), measured
    # at setup against THIS grid/Green fn (the sf_coeff analog, measured
    # instead of the alias-sum closed form)
    sf_sine: Optional[np.ndarray] = None
    # 2d-slab mode (kspace_modify slab <factor>; the slabflag==1 slabcorr
    # of /root/reference/pppm_intel.cpp:305): the k-space box is extended
    # by `slab` along z (vacuum padding) and the Yeh-Berkowitz EW3DC
    # dipole term removes the inter-slab coupling.  grid/h/volume/kz in
    # this object are all EXTENDED-box quantities when slab is set.
    slab: Optional[float] = None
    # triclinic cell (the poisson_ik_triclinic / lamda-transform machinery
    # of /root/reference/pppm_intel.cpp:153-157,878-881): recip = 2 pi H^-T
    # (lower triangular) and hinv = H^-1; None for orthogonal.  The mesh is
    # uniform in lamda space; cartesian wave vectors come from `recip`.
    recip: Optional[np.ndarray] = None
    hinv: Optional[np.ndarray] = None

    def k3(self, nzh: Optional[int] = None):
        """Broadcastable cartesian wave-vector component arrays (host numpy):
        orthogonal -> ((nx,1,1), (1,ny,1), (1,1,nz)); triclinic ->
        ((nx,1,1), (nx,ny,1), (nx,ny,nz')) from k = recip @ m.
        nzh: slice the z (fastest FFT) axis to the rfft half space."""
        if self.recip is None:
            kzv = self.kz if nzh is None else self.kz[:nzh]
            return (np.asarray(self.kx)[:, None, None],
                    np.asarray(self.ky)[None, :, None],
                    np.asarray(kzv)[None, None, :])
        nx, ny, nz = self.grid
        mx = _fold_idx(nx)[:, None, None]
        my = _fold_idx(ny)[None, :, None]
        mzf = _fold_idx(nz)
        mz = (mzf if nzh is None else mzf[:nzh])[None, None, :]
        return tuple(_cart_k(self.recip, mx, my, mz))

    @property
    def elong_self(self) -> float:
        g = self.g_ewald
        e = -g * self.qsqsum / math.sqrt(math.pi)
        e -= math.pi / 2.0 * self.qsum**2 / (g * g * self.volume)
        return e * self.qqrd2e

    def compute(self, x, q, eflag: bool = True, vflag: bool = True):
        if self.diff == "ad":
            return _pppm_compute_ad(self, x, q, eflag, vflag)
        return _pppm_compute(self, x, q, eflag, vflag)


def setup_pppm(
    box: Box,
    q,
    cutoff: float,
    accuracy_rel: float,
    qqrd2e: float,
    order: int = 5,
    g_ewald: Optional[float] = None,
    grid: Optional[tuple[int, int, int]] = None,
    acc_dtype=jnp.float32,
    multiple_of: Optional[tuple[int, int, int]] = None,
    grid_min: Optional[tuple[int, int, int]] = None,
    diff: str = "ik",
    slab: Optional[float] = None,
) -> PPPM:
    q = np.asarray(q, np.float64)
    natoms = len(q)
    qsum = float(q.sum())
    qsqsum = float((q * q).sum())
    L = np.asarray(box.lengths, np.float64)
    triclinic = bool(getattr(box, "is_triclinic", False))
    if triclinic:
        if slab is not None:
            raise NotImplementedError("slab correction requires an "
                                      "orthogonal box (as in LAMMPS)")
        if diff == "ad":
            raise NotImplementedError(
                "triclinic PPPM uses ik differentiation (the reference "
                "ships only poisson_ik_triclinic, pppm_intel.cpp:878)")
    if slab is not None:
        if slab < 2.0:
            raise ValueError("slab factor must be >= 2 (vacuum padding)")
        L = L.copy()
        L[2] *= slab  # all k-space geometry below uses the extended box
    volume = float(np.prod(L)) if not triclinic else box.volume
    # per-axis resolution scale: perpendicular face widths (== L when
    # orthogonal) — the spacing h below is then a worst-case spacing
    W = L if not triclinic else np.asarray(box.perp_widths, np.float64)
    recip = None if not triclinic else 2.0 * np.pi * box.h_inv.T
    hinv = None if not triclinic else box.h_inv
    q2 = qsqsum * qqrd2e
    accuracy = accuracy_rel * two_charge_force(qqrd2e)
    if g_ewald is None:
        g_ewald = solve_g_ewald(accuracy, cutoff, natoms, volume, q2)

    if grid is None:
        grid = []
        for ax in range(3):
            n = 2
            while (
                estimate_ik_error(W[ax] / n, W[ax], natoms, order, g_ewald,
                                  q2) > accuracy
            ):
                n += 1
                if n > 4096:
                    raise RuntimeError("pppm grid blew up")
            n = max(n, 2 * order)
            if grid_min is not None:
                n = max(n, grid_min[ax])
            if multiple_of is not None:
                # cell-aligned grids (pppm_cells patch pipeline): round the
                # per-cell point count up, keep >= the accuracy-driven size
                m = multiple_of[ax]
                s = -(-n // m)
                grid.append(m * s)
            else:
                grid.append(_next_good(n))
        grid = tuple(grid)
    nx, ny, nz = grid

    # folded wave numbers per FFT index (orthogonal per-axis components;
    # triclinic paths go through PPPM.k3() / recip instead)
    def kvals(n, prd):
        return 2.0 * np.pi * _fold_idx(n) / prd

    kxv, kyv, kzv = kvals(nx, L[0]), kvals(ny, L[1]), kvals(nz, L[2])

    greensfn = _greens_function(grid, L, g_ewald, order, recip=recip)

    sf_sine = None
    if diff == "ad":
        sf_sine = _sf_sine_fit(grid, L, greensfn, order)

    return PPPM(
        g_ewald=float(g_ewald), grid=grid, order=order, greensfn=greensfn,
        kx=kxv, ky=kyv, kz=kzv, qsum=qsum, qsqsum=qsqsum, qqrd2e=qqrd2e,
        volume=volume, box_lo=tuple(float(v) for v in np.asarray(box.lo)),
        h=tuple(float(W[i] / grid[i]) for i in range(3)),
        acc_dtype=acc_dtype, accuracy_abs=float(accuracy),
        diff=diff, sf_sine=sf_sine, slab=slab, recip=recip, hinv=hinv,
    )


def slab_correction(pm: PPPM, x, q, eflag: bool):
    """Yeh-Berkowitz EW3DC dipole term (host-LAMMPS slabcorr(), called at
    /root/reference/pppm_intel.cpp:305): energy + z-forces removing the
    spurious inter-slab coupling of the extended-box periodic solve.
    Returns (e_slab, fz (N,))."""
    acc = pm.acc_dtype
    V = float(pm.volume)                    # extended volume
    zprd = pm.h[2] * pm.grid[2]             # extended z length
    qqrd2e = float(pm.qqrd2e)
    z = x[:, 2].astype(acc)
    qa = q.astype(acc)
    dipole = jnp.sum(qa * z)
    dipole_r2 = jnp.sum(qa * z * z)
    qsum = pm.qsum
    two_pi = 2.0 * math.pi
    if eflag:
        e = (two_pi / V) * (dipole * dipole - qsum * dipole_r2
                            - qsum * qsum * zprd * zprd / 12.0) * qqrd2e
    else:
        e = jnp.zeros((), acc)
    ffact = -(2.0 * two_pi / V) * qqrd2e
    fz = ffact * qa * (dipole - qsum * z)
    return e, fz


def coulomb_kernel(g_ewald):
    """hat g(k) = 4 pi / k^2 * exp(-k^2 / 4 g^2), 0 at k = 0."""

    def kern(kmsq):
        safe = np.where(kmsq == 0.0, 1.0, kmsq)
        g = 4.0 * np.pi / safe * np.exp(-kmsq / (4.0 * g_ewald**2))
        return np.where(kmsq == 0.0, 0.0, g)

    return kern


def _greens_function(grid, L, g_ewald, order, nalias: int = 2,
                     kernel=None, recip=None) -> np.ndarray:
    """Hockney-Eastwood optimal influence function for ik differentiation.

    G(k) = [ sum_m U^2(k_m) hat-g(k_m) (k . k_m) ]
           / ( |k|^2 [ sum_m U^2(k_m) ]^2 )
    with U(k_m) = prod_axis sinc(pi (m_ax + n_ax N_ax) / N_ax)^order (the
    B-spline deposit transform lives in grid-index space, so it is
    tilt-independent), the alias sum over reciprocal-supercell shifts
    |n| <= nalias, and hat-g the pair kernel (Coulomb 4pi/k^2 e^{-k^2/4g^2}
    by default; dispersion uses its own — see pppm_disp.py).  k = 0 entry
    is zeroed.  recip: 2 pi H^-T for a triclinic cell (None -> orthogonal
    diag(2 pi / L)); this is the poisson_ik_triclinic generalization
    (/root/reference/pppm_intel.cpp:878-881).
    """
    if kernel is None:
        kernel = coulomb_kernel(g_ewald)
    nx, ny, nz = grid
    if recip is None:
        recip = np.diag(2.0 * np.pi / np.asarray(L, np.float64))

    ix = _fold_idx(nx)[:, None, None]
    iy = _fold_idx(ny)[None, :, None]
    iz = _fold_idx(nz)[None, None, :]
    kx, ky, kz = _cart_k(recip, ix, iy, iz)

    def sinc(t):
        out = np.ones_like(t)
        nzm = t != 0
        out[nzm] = np.sin(t[nzm]) / t[nzm]
        return out

    ksq = kx**2 + ky**2 + kz**2
    num = np.zeros((nx, ny, nz))
    den = np.zeros((nx, ny, nz))
    shifts = range(-nalias, nalias + 1)
    for sx in shifts:
        ux = sinc(np.pi * (ix + sx * nx) / nx) ** order
        for sy in shifts:
            uy = sinc(np.pi * (iy + sy * ny) / ny) ** order
            for sz in shifts:
                uz = sinc(np.pi * (iz + sz * nz) / nz) ** order
                kmx, kmy, kmz = _cart_k(
                    recip, ix + sx * nx, iy + sy * ny, iz + sz * nz)
                u2 = (ux * uy * uz) ** 2
                kmsq = kmx**2 + kmy**2 + kmz**2
                g = kernel(kmsq)
                kdot = kx * kmx + ky * kmy + kz * kmz
                num += u2 * g * kdot
                den += u2
    ksq_safe = np.where(ksq == 0.0, 1.0, ksq)
    G = num / (ksq_safe * den * den)
    G[0, 0, 0] = 0.0
    return G


def _np_axis_A(n_grid: int, s: np.ndarray, order: int):
    """Numpy: per-axis DFT factors of a B-spline point deposit.

    A(k, s) = sum_g w_g(s) exp(-2 pi i k g / n); also dA/ds (grid units).
    s: (S,) absolute positions in grid units."""
    offs = stencil_offsets(order).astype(np.float64)
    base = np.round(s) if order % 2 else np.floor(s)
    g = base[:, None] + offs[None, :]                   # (S, p)
    arg = (s[:, None] - g) + order / 2.0
    w = mspline(order, arg)
    dw = dmspline(order, arg)
    k = np.arange(n_grid)
    phase = np.exp(-2j * np.pi * k[None, None, :] * g[:, :, None] / n_grid)
    A = np.einsum("sp,spk->sk", w, phase)
    dA = np.einsum("sp,spk->sk", dw, phase)
    return A, dA


def _sf_sine_fit(grid, L, greensfn, order, nterms: int = 4,
                 nsamp: int = 32) -> np.ndarray:
    """Measured ad self-force correction (the sf_coeff analog,
    /root/reference/pppm_intel.cpp:783-798 uses a 2-term sine series from
    host-LAMMPS alias sums; here the series is FIT to the actual
    self-field of THIS grid + influence function).

    The ad force differentiates only the interpolation weights, so a
    charge exerts a spurious force on itself that is periodic in its
    fractional grid offset.  Per axis (others averaged):
      Eself_ax(s) = -(1/(V h_ax)) sum_k G(k) Re(A_ax conj(dA_ax))(k_ax, s)
                    * <|A_b|^2>(k_b) * <|A_c|^2>(k_c)
    Returns (3, nterms) sine coefficients of Eself per unit q^2
    (energy-units field; caller multiplies qqrd2e * q_i^2)."""
    V = float(np.prod(L))
    s = np.arange(nsamp) / nsamp + 1e3  # offset irrelevant (periodic)
    A = []
    dA = []
    m = []
    for ax in range(3):
        a, da = _np_axis_A(grid[ax], s, order)
        A.append(a)
        dA.append(da)
        m.append(np.mean(np.abs(a) ** 2, axis=0))
    out = np.zeros((3, nterms))
    js = np.arange(1, nterms + 1)
    sin_basis = np.sin(2.0 * np.pi * js[None, :] * (s % 1.0)[:, None])
    for ax in range(3):
        h_ax = L[ax] / grid[ax]
        self_term = np.real(A[ax] * np.conj(dA[ax]))      # (S, k_ax)
        axes = "xyz"
        sub = f"s{axes[ax]},{axes[(ax+1)%3]},{axes[(ax+2)%3]},xyz->s"
        e_s = -np.einsum(
            sub, self_term, m[(ax + 1) % 3], m[(ax + 2) % 3], greensfn
        ) / (V * h_ax)
        out[ax] = 2.0 / nsamp * (sin_basis * e_s[:, None]).sum(axis=0)
    return out


def sf_axis_series(pm: PPPM, coord, ax: int):
    """Per-axis ad self-field sine series at 1-D coordinates — the single
    home of the sf_sine evaluation (used by the atom-ordered
    sf_correction here and the slot-plane CellPPPM ad path)."""
    sf = np.asarray(pm.sf_sine)
    u = (coord - pm.box_lo[ax]) * (1.0 / pm.h[ax])
    acc = 0.0
    for j in range(sf.shape[1]):
        acc = acc + float(sf[ax, j]) * jnp.sin(2.0 * jnp.pi * (j + 1) * u)
    return acc


def sf_correction(pm: PPPM, x, q):
    """(N, 3) ad self-force (energy units; includes qqrd2e)."""
    e_self = jnp.stack(
        [sf_axis_series(pm, x[:, ax], ax) for ax in range(3)], axis=-1)
    return (pm.qqrd2e * q * q)[:, None] * e_self


def _particle_weights(pm: PPPM, x, deriv: bool = False):
    """Per-axis grid bases + B-spline weight stacks for all atoms.

    Triclinic: the mesh is uniform in lamda space (particle_map under the
    x2lamda transform, /root/reference/pppm_intel.cpp:153-157), so the grid
    coordinate is u_ax = lamda_ax * n_ax via hinv."""
    p = pm.order
    out = []
    if pm.hinv is not None:
        hinv = pm.hinv
        lo = pm.box_lo
        dx = [x[:, ax] - lo[ax] for ax in range(3)]
        for ax, n in enumerate(pm.grid):
            s = None
            for col in range(3):
                c = float(hinv[ax, col])
                if c != 0.0:
                    t = c * dx[col]
                    s = t if s is None else s + t
            out.append(bspline_weights(s * n, p, deriv=deriv))
        return out
    for ax, (n, lo, h) in enumerate(
        zip(pm.grid, pm.box_lo, pm.h)
    ):
        u = (x[:, ax] - lo) / h
        out.append(bspline_weights(u, p, deriv=deriv))
    return out


def _stencil_indices(pm: PPPM, bases):
    """(N, p) wrapped grid indices per axis."""
    p = pm.order
    offs = jnp.asarray(stencil_offsets(p), jnp.int32)
    idx = []
    for ax, n in enumerate(pm.grid):
        i = jnp.mod(bases[ax][:, None] + offs, n)
        idx.append(i)
    return idx


def deposit_rho(pm: PPPM, x, q):
    """Charge assignment: mesh[j] = sum_a q_a w3d (sum mesh == sum q)."""
    nx, ny, nz = pm.grid
    wx_ = _particle_weights(pm, x)
    bases = [w[0] for w in wx_]
    ws = [w[1] for w in wx_]
    ix, iy, iz = _stencil_indices(pm, bases)
    p = pm.order
    # (N, p, p, p) values and flat indices
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :]) * q[:, None, None, None]
    flat = (
        (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
        + iz[:, None, None, :]
    )
    mesh = jnp.zeros((nx * ny * nz,), x.dtype)
    mesh = mesh.at[flat.reshape(-1)].add(w3.reshape(-1))
    return mesh.reshape(nx, ny, nz)


def _pppm_compute(pm: PPPM, x, q, eflag: bool, vflag: bool) -> KSpaceResult:
    flt = x.dtype
    acc = pm.acc_dtype
    nx, ny, nz = pm.grid
    ngrid = nx * ny * nz
    qqrd2e = float(pm.qqrd2e)
    V = float(pm.volume)

    mesh = deposit_rho(pm, x, q)
    rhat = jnp.fft.fftn(mesh.astype(acc))

    G = jnp.asarray(pm.greensfn, acc)
    # energy: E = 1/(2V) sum_k G_k |rho_hat|^2  (G includes its 4pi/k^2;
    # k=0 excluded via G=0)
    phi_hat = G * rhat

    if eflag or vflag:
        s2 = jnp.real(rhat * jnp.conj(rhat))
        ek = G * s2  # (nx,ny,nz) per-k energy density (x 2pi/V)
    if eflag:
        elong = (0.5 / V) * jnp.sum(ek.astype(acc)) * qqrd2e
        elong = elong + pm.elong_self
    else:
        elong = jnp.zeros((), acc)

    kx3, ky3, kz3 = pm.k3()
    kx = jnp.asarray(kx3, acc)
    ky = jnp.asarray(ky3, acc)
    kz = jnp.asarray(kz3, acc)

    if vflag:
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
    else:
        virial = jnp.zeros((6,), acc)

    # ik E-field: E_ax(r) = (1/V) sum_k (-i k_ax) G rho_hat e^{ikr};
    # sum_k X e^{ikr} == ngrid * ifftn(X).
    scale = 1.0 / V
    e_mesh = []
    for kax in (kx, ky, kz):
        ehat = (-1j) * kax * phi_hat
        e_mesh.append(jnp.real(jnp.fft.ifftn(ehat)) * (scale * ngrid))

    # gather-interpolate E at atom positions
    wx_ = _particle_weights(pm, x)
    bases = [w[0] for w in wx_]
    ws = [w[1] for w in wx_]
    ix, iy, iz = _stencil_indices(pm, bases)
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :])
    flat = (
        (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
        + iz[:, None, None, :]
    ).reshape(x.shape[0], -1)
    f = []
    for em in e_mesh:
        ev = em.reshape(-1)[flat]                    # (N, p^3)
        f.append(jnp.sum(w3.reshape(x.shape[0], -1) * ev, axis=1))
    fvec = jnp.stack(f, axis=-1).astype(acc)
    fvec = fvec * (qqrd2e * q[:, None]).astype(acc)

    if pm.slab is not None:
        e_slab, fz = slab_correction(pm, x, q, eflag)
        elong = elong + e_slab
        fvec = fvec.at[:, 2].add(fz)

    return KSpaceResult(f=fvec, elong=elong, virial=virial)


def compute_peratom(pm: PPPM, x, q):
    """Per-atom k-space energy and virial (the eflag_atom/vflag_atom
    contract of /root/reference/pppm_intel.cpp:224-252 poisson_peratom +
    host fieldforce_peratom).

    eatom_i = q_i phi(x_i)/2 + per-atom self/background corrections;
    vatom_i interpolates six virial meshes v_c = F^-1[pref_c G rho_hat].
    Both pin EXACTLY to the global sums (Parseval + the deposit identity
    sum_i q_i w_g(x_i) = mesh_g): sum eatom == elong, sum vatom == virial.
    Returns (eatom (N,), vatom (N, 6)) in energy units (qqrd2e applied)."""
    acc = pm.acc_dtype
    nx, ny, nz = pm.grid
    ngrid = nx * ny * nz
    nzh = nz // 2 + 1
    qqrd2e = float(pm.qqrd2e)
    V = float(pm.volume)

    mesh = deposit_rho(pm, x, q)
    rhat = jnp.fft.rfftn(mesh.astype(acc))
    G = jnp.asarray(pm.greensfn[..., :nzh], acc)
    phi_hat = G * rhat

    # interpolation weights (shared by all seven meshes)
    wx_ = _particle_weights(pm, x)
    bases = [w[0] for w in wx_]
    ws = [w[1] for w in wx_]
    ix, iy, iz = _stencil_indices(pm, bases)
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :]).reshape(x.shape[0], -1)
    flat = (
        (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
        + iz[:, None, None, :]
    ).reshape(x.shape[0], -1)

    def interp(m):
        return jnp.sum(w3 * m.reshape(-1)[flat], axis=1)

    scale = ngrid / V
    u = jnp.real(jnp.fft.irfftn(phi_hat, s=pm.grid)) * scale
    g = pm.g_ewald
    eatom = 0.5 * q * interp(u)
    eatom = eatom - g / math.sqrt(math.pi) * q * q \
        - math.pi / (2.0 * g * g * V) * q * pm.qsum
    eatom = (qqrd2e * eatom).astype(acc)

    kx3, ky3, kz3 = pm.k3(nzh)
    kx = jnp.asarray(kx3, acc)
    ky = jnp.asarray(ky3, acc)
    kz = jnp.asarray(kz3, acc)
    ksq = kx * kx + ky * ky + kz * kz
    ksq_safe = jnp.where(ksq == 0.0, 1.0, ksq)
    pref = 2.0 * (1.0 / ksq_safe + 0.25 / (g * g))
    comps = (
        1.0 - pref * kx * kx,
        1.0 - pref * ky * ky,
        1.0 - pref * kz * kz,
        -pref * kx * ky,
        -pref * kx * kz,
        -pref * ky * kz,
    )
    vcols = []
    for c in comps:
        vm = jnp.real(jnp.fft.irfftn(c * phi_hat, s=pm.grid)) * scale
        vcols.append((0.5 * qqrd2e * q * interp(vm)).astype(acc))
    return eatom, jnp.stack(vcols, axis=-1)


def _pppm_compute_ad(pm: PPPM, x, q, eflag: bool, vflag: bool
                     ) -> KSpaceResult:
    """ad differentiation: ONE inverse FFT -> potential mesh, forces from
    derivative-spline interpolation minus the measured self-force
    (poisson_ad /root/reference/pppm_intel.cpp:985-1054, fieldforce_ad :678-804)."""
    acc = pm.acc_dtype
    nx, ny, nz = pm.grid
    ngrid = nx * ny * nz
    qqrd2e = float(pm.qqrd2e)
    V = float(pm.volume)

    mesh = deposit_rho(pm, x, q)
    rhat = jnp.fft.fftn(mesh.astype(acc))
    G = jnp.asarray(pm.greensfn, acc)
    phi_hat = G * rhat

    if eflag or vflag:
        s2 = jnp.real(rhat * jnp.conj(rhat))
        ek = G * s2
    if eflag:
        elong = (0.5 / V) * jnp.sum(ek.astype(acc)) * qqrd2e
        elong = elong + pm.elong_self
    else:
        elong = jnp.zeros((), acc)
    if vflag:
        kx = jnp.asarray(pm.kx, acc)[:, None, None]
        ky = jnp.asarray(pm.ky, acc)[None, :, None]
        kz = jnp.asarray(pm.kz, acc)[None, None, :]
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
    else:
        virial = jnp.zeros((6,), acc)

    # potential mesh (u_brick): phi(r_g) = (1/V) sum_k G rho_hat e^{ikr}
    u = jnp.real(jnp.fft.ifftn(phi_hat)) * (ngrid / V)

    wx_ = _particle_weights(pm, x, deriv=True)
    bases = [w[0] for w in wx_]
    ws = [w[1] for w in wx_]
    dws = [w[2] for w in wx_]
    ix, iy, iz = _stencil_indices(pm, bases)
    flat = (
        (ix[:, :, None, None] * ny + iy[:, None, :, None]) * nz
        + iz[:, None, None, :]
    ).reshape(x.shape[0], -1)
    uv = u.reshape(-1)[flat]                          # (N, p^3)
    combos = (
        (dws[0], ws[1], ws[2]),
        (ws[0], dws[1], ws[2]),
        (ws[0], ws[1], dws[2]),
    )
    f = []
    for ax, (ax_w, ay_w, az_w) in enumerate(combos):
        w3 = (ax_w[:, :, None, None] * ay_w[:, None, :, None]
              * az_w[:, None, None, :]).reshape(x.shape[0], -1)
        e_ax = -jnp.sum(w3 * uv, axis=1) * (1.0 / pm.h[ax])
        f.append(e_ax)
    fvec = jnp.stack(f, axis=-1).astype(acc)
    fvec = fvec * (qqrd2e * q[:, None]).astype(acc)
    fvec = fvec - sf_correction(pm, x, q).astype(acc)
    if pm.slab is not None:
        e_slab, fz = slab_correction(pm, x, q, eflag)
        elong = elong + e_slab
        fvec = fvec.at[:, 2].add(fz)
    return KSpaceResult(f=fvec, elong=elong, virial=virial)
