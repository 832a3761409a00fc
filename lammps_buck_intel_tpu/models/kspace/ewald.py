"""Plain Ewald reciprocal-space solver (``kspace_style ewald``).

Required by examples/in.buck_coul_long:13 (``kspace_style ewald 1e-6``).
Host-LAMMPS contract (SURVEY.md H5); no fork-specific kernel exists — this is
a from-scratch formulation.

Design: the structure factor S(k) = sum_i q_i e^{i k.x_i} is a pair of
(N, K) <- (N, 3) @ (3, K) **matmuls** followed by cos/sin and a reduction,
and the force pass is the transposed (N, K) @ (K, 3) matmul — dense matrix
products, no per-k loops.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ...core.box import Box
from ...core.precision import MATMUL
from .base import (
    KSpaceResult, solve_g_ewald, rms_kspace_ewald, two_charge_force,
)


@dataclasses.dataclass
class Ewald:
    """Configured Ewald solver for a fixed box + charge set.

    kvecs: (K, 3) wave vectors (full +/- space, k != 0), host numpy.
    ug: (K,) energy prefactors  (2 pi / V) exp(-k^2/4g^2)/k^2.
    vg:  (K, 6) virial prefactors.
    """

    g_ewald: float
    kvecs: np.ndarray
    ug: np.ndarray
    qsum: float
    qsqsum: float
    qqrd2e: float
    volume: float
    kmax: tuple[int, int, int]
    acc_dtype: object = jnp.float32
    mvecs: np.ndarray = None   # (K, 3) integer k triples (traced-box path)

    def compute(self, x, q, eflag: bool = True, vflag: bool = True):
        return _ewald_compute(self, x, q, eflag, vflag)

    def compute_traced(self, x, q, L, eflag: bool = True,
                       vflag: bool = True, tilt=None):
        """Variable-cell form (NPT): k = 2 pi m / L with L a traced (3,)
        array; prefactors recomputed from the traced volume.  The integer
        k-set is fixed at setup (resized only on re-setup, matching
        LAMMPS' kspace setup-on-box-change cadence for modest dilations).
        tilt: optional traced (3,) [xy, xz, yz] for a variable TRICLINIC
        cell — k = 2 pi h^-T m with the traced upper-triangular h.
        """
        return _ewald_compute_traced(self, x, q, L, eflag, vflag,
                                     tilt=tilt)

    @property
    def elong_self(self) -> float:
        """Self + neutralizing-background energy corrections."""
        g = self.g_ewald
        e = -g * self.qsqsum / math.sqrt(math.pi)
        e -= math.pi / 2.0 * self.qsum**2 / (g * g * self.volume)
        return e * self.qqrd2e


def setup_ewald(
    box: Box,
    q,
    cutoff: float,
    accuracy_rel: float,
    qqrd2e: float,
    g_ewald: float = None,
    acc_dtype=jnp.float32,
) -> Ewald:
    q = np.asarray(q, np.float64)
    natoms = len(q)
    qsum = float(q.sum())
    qsqsum = float((q * q).sum())
    L = np.asarray(box.lengths, np.float64)
    volume = box.volume
    # reciprocal basis: k(m) = recip @ m = 2 pi H^-T m.  For a tilted cell
    # |2 pi H^-T e_a| = 2 pi / W_a with W the perpendicular face widths, so
    # the per-axis kmax estimate runs on W (== L when orthogonal).
    recip = 2.0 * math.pi * box.h_inv.T
    W = np.asarray(box.perp_widths, np.float64)
    q2 = qsqsum * qqrd2e
    accuracy = accuracy_rel * two_charge_force(qqrd2e)
    if g_ewald is None:
        g_ewald = solve_g_ewald(accuracy, cutoff, natoms, volume, q2)

    kmax = []
    for ax in range(3):
        km = 1
        while rms_kspace_ewald(km, W[ax], natoms, g_ewald, q2) > accuracy:
            km += 1
            if km > 200:
                raise RuntimeError("ewald kmax blew up; check accuracy/box")
        kmax.append(km)
    kxm, kym, kzm = kmax

    gsqmx = max(
        (2 * math.pi * kxm / W[0]) ** 2,
        (2 * math.pi * kym / W[1]) ** 2,
        (2 * math.pi * kzm / W[2]) ** 2,
    ) * 1.00001

    ks = []
    ms = []
    for nx in range(-kxm, kxm + 1):
        for ny in range(-kym, kym + 1):
            for nz in range(-kzm, kzm + 1):
                if nx == ny == nz == 0:
                    continue
                k = recip @ np.array([nx, ny, nz], np.float64)
                if float(k @ k) <= gsqmx:
                    ks.append(k)
                    ms.append((nx, ny, nz))
    kvecs = np.asarray(ks)
    mvecs = np.asarray(ms, np.int32)
    ksq = np.sum(kvecs**2, axis=1)
    ug = (2.0 * math.pi / volume) * np.exp(-ksq / (4.0 * g_ewald**2)) / ksq

    return Ewald(
        g_ewald=float(g_ewald), kvecs=kvecs, ug=ug, qsum=qsum,
        qsqsum=qsqsum, qqrd2e=qqrd2e, volume=volume,
        kmax=(kxm, kym, kzm), acc_dtype=acc_dtype, mvecs=mvecs,
    )


def sk_force_energy_virial(ew: Ewald, c, s, s_re, s_im, q,
                           eflag: bool, vflag: bool):
    """Everything downstream of the COMPLETED structure factor: forces
    on the atoms behind (c, s), total energy and virial from (s_re,
    s_im).  Shared by the single-device solver and the mesh-sharded
    form (pppm_slab.ShardedEwald completes S(k) with a psum first).
    s_re/s_im arrive in acc dtype; returns (f (N,3) acc, elong, virial).
    """
    flt = c.dtype
    acc = ew.acc_dtype
    kv = jnp.asarray(ew.kvecs, flt)
    ug = jnp.asarray(ew.ug, flt)
    s_re_f = s_re.astype(flt)
    s_im_f = s_im.astype(flt)

    # F_i = qqrd2e * q_i * sum_k 2 ug_k k (sin_i Re - cos_i Im)
    w = 2.0 * ug
    coef = s * s_re_f[None, :] - c * s_im_f[None, :]      # (N, K)
    f = jnp.matmul(coef * w[None, :], kv, precision=MATMUL)  # (N, 3)
    f = (float(ew.qqrd2e) * q[:, None] * f).astype(acc)

    if eflag:
        sk2 = (s_re * s_re + s_im * s_im).astype(acc)
        elong = jnp.sum(jnp.asarray(ew.ug, acc) * sk2) * ew.qqrd2e
        elong = elong + ew.elong_self
    else:
        elong = jnp.zeros((), acc)

    if vflag:
        g2 = ew.g_ewald**2
        kxv = jnp.asarray(ew.kvecs[:, 0], acc)
        kyv = jnp.asarray(ew.kvecs[:, 1], acc)
        kzv = jnp.asarray(ew.kvecs[:, 2], acc)
        ksq = kxv * kxv + kyv * kyv + kzv * kzv
        pref = 2.0 * (1.0 / ksq + 0.25 / g2)
        sk2f = (s_re * s_re + s_im * s_im).astype(acc)
        uk = jnp.asarray(ew.ug, acc) * sk2f * float(ew.qqrd2e)
        virial = jnp.stack([
            jnp.sum(uk * (1.0 - pref * kxv * kxv)),
            jnp.sum(uk * (1.0 - pref * kyv * kyv)),
            jnp.sum(uk * (1.0 - pref * kzv * kzv)),
            jnp.sum(uk * (-pref * kxv * kyv)),
            jnp.sum(uk * (-pref * kxv * kzv)),
            jnp.sum(uk * (-pref * kyv * kzv)),
        ])
    else:
        virial = jnp.zeros((6,), acc)
    return f, elong, virial


def _ewald_compute(ew: Ewald, x, q, eflag: bool, vflag: bool) -> KSpaceResult:
    flt = x.dtype
    acc = ew.acc_dtype
    kv = jnp.asarray(ew.kvecs, flt)          # (K, 3)

    phase = jnp.matmul(x, kv.T, precision=MATMUL)   # (N, K)
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    s_re = jnp.sum((q[:, None] * c).astype(acc), axis=0)  # (K,)
    s_im = jnp.sum((q[:, None] * s).astype(acc), axis=0)
    f, elong, virial = sk_force_energy_virial(ew, c, s, s_re, s_im, q,
                                              eflag, vflag)
    return KSpaceResult(f=f, elong=elong, virial=virial)


def _ewald_compute_traced(ew: Ewald, x, q, L, eflag: bool,
                          vflag: bool, tilt=None) -> KSpaceResult:
    """Traced-box Ewald (see Ewald.compute_traced)."""
    flt = x.dtype
    acc = ew.acc_dtype
    m = jnp.asarray(ew.mvecs, flt)                       # (K, 3)
    if tilt is None:
        kv = (2.0 * math.pi) * m / L[None, :].astype(flt)  # traced (K, 3)
    else:
        # k = 2 pi h^-T m  ==  2 pi m @ h_inv (Box.h_inv's closed form,
        # traced entries)
        lx, ly, lz = L[0], L[1], L[2]
        xy, xz, yz = tilt[0], tilt[1], tilt[2]
        hinv = jnp.stack([
            jnp.stack([1.0 / lx, -xy / (lx * ly),
                       (xy * yz - ly * xz) / (lx * ly * lz)]),
            jnp.stack([jnp.zeros_like(lx), 1.0 / ly, -yz / (ly * lz)]),
            jnp.stack([jnp.zeros_like(lx), jnp.zeros_like(lx), 1.0 / lz]),
        ]).astype(flt)
        kv = (2.0 * math.pi) * jnp.matmul(m, hinv, precision=MATMUL)
    ksq = jnp.sum(kv * kv, axis=1)
    vol = (L[0] * L[1] * L[2]).astype(flt)
    g2 = ew.g_ewald**2
    ug = (2.0 * math.pi) / vol * jnp.exp(-ksq / (4.0 * g2)) / ksq

    phase = jnp.matmul(x, kv.T, precision=MATMUL)
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    s_re = jnp.sum((q[:, None] * c).astype(acc), axis=0).astype(flt)
    s_im = jnp.sum((q[:, None] * s).astype(acc), axis=0).astype(flt)

    coef = s * s_re[None, :] - c * s_im[None, :]
    f = jnp.matmul(coef * (2.0 * ug)[None, :], kv, precision=MATMUL)
    f = (float(ew.qqrd2e) * q[:, None] * f).astype(acc)

    sk2 = (s_re * s_re + s_im * s_im)
    uk = ug * sk2 * float(ew.qqrd2e)
    if eflag:
        g = ew.g_ewald
        e_self = -g * ew.qsqsum / math.sqrt(math.pi) \
            - math.pi / 2.0 * ew.qsum**2 / (g * g * vol)
        elong = (jnp.sum(uk.astype(acc))
                 + ew.qqrd2e * e_self).astype(acc)
    else:
        elong = jnp.zeros((), acc)
    if vflag:
        kx, ky, kz = kv[:, 0], kv[:, 1], kv[:, 2]
        pref = 2.0 * (1.0 / ksq + 0.25 / g2)
        virial = jnp.stack([
            jnp.sum((uk * (1.0 - pref * kx * kx)).astype(acc)),
            jnp.sum((uk * (1.0 - pref * ky * ky)).astype(acc)),
            jnp.sum((uk * (1.0 - pref * kz * kz)).astype(acc)),
            jnp.sum((uk * (-pref * kx * ky)).astype(acc)),
            jnp.sum((uk * (-pref * kx * kz)).astype(acc)),
            jnp.sum((uk * (-pref * ky * kz)).astype(acc)),
        ])
    else:
        virial = jnp.zeros((6,), acc)
    return KSpaceResult(f=f, elong=elong, virial=virial)


def ewald_compute_peratom(ew: Ewald, x, q):
    """Per-atom k-space energy and virial for the Ewald solver (the
    eflag_atom/vflag_atom contract of stock ewald.cpp eatom/vatom):

    eatom_i = qqrd2e [ q_i sum_k ug_k (cos_i Re_k + sin_i Im_k)
                       - g/sqrt(pi) q_i^2 - pi/(2 g^2 V) q_i qsum ]
    vatom_i,c = qqrd2e q_i sum_k ug_k vfac_c(k) (cos_i Re_k + sin_i Im_k)

    with vfac the same (1 - pref k_a k_b) / (-pref k_a k_b) factors as
    the global virial, so both PIN exactly to the global sums
    (sum_i q_i cos_i = Re_k completes |S(k)|^2).  Returns
    (eatom (N,), vatom (N, 6)) in energy units."""
    flt = x.dtype
    acc = ew.acc_dtype
    kv = jnp.asarray(ew.kvecs, flt)
    ug = jnp.asarray(ew.ug, flt)
    phase = jnp.matmul(x, kv.T, precision=MATMUL)
    c = jnp.cos(phase)
    s = jnp.sin(phase)
    s_re = jnp.sum((q[:, None] * c).astype(acc), axis=0).astype(flt)
    s_im = jnp.sum((q[:, None] * s).astype(acc), axis=0).astype(flt)
    share = c * s_re[None, :] + s * s_im[None, :]         # (N, K)

    g = ew.g_ewald
    V = float(ew.volume)
    qq = float(ew.qqrd2e)
    qa = q.astype(acc)
    eatom = (qa * jnp.matmul(share, ug, precision=MATMUL).astype(acc)
             - g / math.sqrt(math.pi) * qa * qa
             - math.pi / (2.0 * g * g * V) * qa * ew.qsum) * qq

    kx, ky, kz = kv[:, 0], kv[:, 1], kv[:, 2]
    ksq = kx * kx + ky * ky + kz * kz
    pref = 2.0 * (1.0 / ksq + 0.25 / (g * g))
    cols = []
    for fac in (1.0 - pref * kx * kx, 1.0 - pref * ky * ky,
                1.0 - pref * kz * kz, -pref * kx * ky,
                -pref * kx * kz, -pref * ky * kz):
        cols.append((qa * jnp.matmul(share, ug * fac, precision=MATMUL)
                     .astype(acc)) * qq)
    return eatom.astype(acc), jnp.stack(cols, axis=-1)
