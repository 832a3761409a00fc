"""CHARMM bonded terms: angle charmm (Urey-Bradley), dihedral charmm
(with baked 1-4 pair terms), improper harmonic.

Host-LAMMPS contract for the in.rhodo deck
(/root/reference/examples/in.rhodo:6-10):
  angle_style  charmm    E = K (th - th0)^2 + K_ub (r13 - r_ub)^2
  dihedral_style charmm  E = K [1 + cos(n phi - d)]  (+ weighted 1-4 pair)
  improper_style harmonic E = K (chi - chi0)^2

Design choices:
* Dihedral/improper forces come from AUTODIFF of the displacement-vector
  energy (jax.grad over the three min-imaged bond vectors) — exact
  gradients with none of the 40-line hand-derived chain rules of
  dihedral_charmm.cpp, and the virial falls out as sum_k b_k (x) (-g_k).
* The CHARMM 1-4 terms are BAKED per dihedral at build time (types and
  charges are static data): a12 = w 4 eps14 sig14^12, a6 = w 4 eps14
  sig14^6, qq = w qqrd2e q_i q_l.  At runtime the 1-4 pass is three
  fused elementwise ops on r14 = b1 - b2 - b3.
* Angles with Urey-Bradley add one harmonic-bond term on (i, k).

The phase d is restricted in CHARMM files to 0/180 degrees, which makes
cos(n phi - d) independent of the sign convention of phi.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def bake_charmm_14(dihedrals, dihedral_coeffs, typ, q, eps14, sig14,
                   qqrd2e: float) -> np.ndarray:
    """Per-dihedral (Nd, 3) [a12, a6, qq] 1-4 coefficients.

    dihedral_coeffs: (Td, 4) [K, n, d_deg, weight]; eps14/sig14: (T,)
    per-type 1-4 LJ parameters (CHARMM arithmetic mixing).  weight == 0
    rows bake to zeros (no 1-4 term)."""
    if len(dihedrals) == 0:
        return np.zeros((0, 3))
    dt = dihedrals[:, 0]
    w = np.asarray(dihedral_coeffs)[dt, 3]
    ti = np.asarray(typ)[dihedrals[:, 1]]
    tl = np.asarray(typ)[dihedrals[:, 4]]
    eps = np.sqrt(np.asarray(eps14)[ti] * np.asarray(eps14)[tl])
    sig = 0.5 * (np.asarray(sig14)[ti] + np.asarray(sig14)[tl])
    s6 = sig**6
    a12 = w * 4.0 * eps * s6 * s6
    a6 = w * 4.0 * eps * s6
    qq = w * qqrd2e * np.asarray(q)[dihedrals[:, 1]] \
        * np.asarray(q)[dihedrals[:, 4]]
    return np.stack([a12, a6, qq], axis=-1)


def _dihedral_energy_terms(b1, b2, b3, K, n_i, d_cos, a12, a6, qq):
    """Scalar energies per dihedral from min-imaged bond vectors.

    Returns (edihed_i, e14lj_i, e14coul_i) per-dihedral arrays; designed
    to be jax.grad-ed w.r.t. (b1, b2, b3)."""
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    b2n = jnp.sqrt(jnp.maximum(jnp.sum(b2 * b2, -1), 1e-12))
    cosval = jnp.sum(n1 * n2, -1)
    sinval = jnp.sum(jnp.cross(n1, n2) * b2, -1) / b2n
    # cos(n phi), sin(n phi) by complex power over the UNnormalized pair
    # (common magnitude cancels in the normalized result)
    norm = jnp.sqrt(jnp.maximum(cosval**2 + sinval**2, 1e-20))
    c = cosval / norm
    s = sinval / norm
    cn, sn = jnp.ones_like(c), jnp.zeros_like(s)
    nmax = int(np.max(n_i)) if len(n_i) else 1
    cos_n = jnp.zeros_like(c)
    for k in range(1, nmax + 1):
        cn, sn = cn * c - sn * s, cn * s + sn * c
        cos_n = jnp.where(jnp.asarray(n_i) == k, cn, cos_n)
    edihed = K * (1.0 + cos_n * d_cos)
    # 1-4 pair (weight baked into a12/a6/qq; zero when weightflag off)
    r14 = b1 - b2 - b3
    rsq = jnp.maximum(jnp.sum(r14 * r14, -1), 1e-12)
    r6inv = 1.0 / (rsq * rsq * rsq)
    e14lj = r6inv * (a12 * r6inv - a6)
    e14c = qq / jnp.sqrt(rsq)
    return edihed, e14lj, e14c


def _improper_energy(b1, b2, b3, K, chi0):
    """improper_harmonic.cpp angle: chi between planes (1,2,3)/(2,3,4)
    about the 2-3 axis, E = K (chi - chi0)^2."""
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    nn = jnp.sqrt(jnp.maximum(
        jnp.sum(n1 * n1, -1) * jnp.sum(n2 * n2, -1), 1e-20))
    c = jnp.clip(jnp.sum(n1 * n2, -1) / nn, -1.0 + 1e-7, 1.0 - 1e-7)
    chi = jnp.arccos(c)
    dchi = chi - chi0
    return K * dchi * dchi


def _minimg3(d, L):
    # L: per-axis lengths — core.box.axis_lengths output of python floats
    # (host box, baked) or traced scalars (NPT variable cell) — OR a
    # triclinic Box (shared greedy z->y->x reduction)
    if hasattr(L, "is_triclinic"):
        from ...core.box import minimum_image

        return minimum_image(d, L)
    out = []
    for ax in range(3):
        dd = d[:, ax]
        La = float(L[ax]) if isinstance(L, np.ndarray) else L[ax]
        out.append(dd - jnp.round(dd * (1.0 / La)) * La)
    return jnp.stack(out, axis=-1)


def dihedral_charmm_forces(x, L, dihedrals, coeffs, d14, idx=None,
                           acc_dtype=jnp.float32, eweight=None):
    """Forces/energies for all dihedrals.  Returns (f_update (N,3) add,
    edihed, e14lj, e14coul, virial (6,)).  idx: optional traced (Nd, 4)
    slot overrides.  eweight: optional (Nd,) 0/1 per-term energy+virial
    weights (multi-device ownership; see compute_bonded)."""
    dt = dihedrals[:, 0]
    if idx is None:
        i1 = jnp.asarray(dihedrals[:, 1])
        i2 = jnp.asarray(dihedrals[:, 2])
        i3 = jnp.asarray(dihedrals[:, 3])
        i4 = jnp.asarray(dihedrals[:, 4])
    else:
        i1, i2, i3, i4 = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    flt = x.dtype
    K = jnp.asarray(coeffs[dt, 0], flt)
    n_i = np.asarray(coeffs[dt, 1], np.int32)
    d_cos = jnp.asarray(np.cos(np.deg2rad(coeffs[dt, 2])), flt)
    if len(d14):
        # d14 rows align with dihedral rows (baked per dihedral)
        a12 = jnp.asarray(d14[:, 0], flt)
        a6 = jnp.asarray(d14[:, 1], flt)
        qq = jnp.asarray(d14[:, 2], flt)
    else:
        a12 = a6 = qq = jnp.zeros((len(dt),), flt)

    b1 = _minimg3(x[i1] - x[i2], L)
    b2 = _minimg3(x[i3] - x[i2], L)
    b3 = _minimg3(x[i4] - x[i3], L)

    def etot(b1, b2, b3):
        ed, elj, ec = _dihedral_energy_terms(b1, b2, b3, K, n_i, d_cos,
                                             a12, a6, qq)
        return jnp.sum((ed + elj + ec).astype(acc_dtype))

    (g1, g2, g3) = jax.grad(etot, argnums=(0, 1, 2))(b1, b2, b3)
    ed, elj, ec = _dihedral_energy_terms(b1, b2, b3, K, n_i, d_cos,
                                         a12, a6, qq)
    # mapping b1 = x1-x2, b2 = x3-x2, b3 = x4-x3  =>  f_i = -dE/dx_i:
    f1 = -g1
    f2 = g1 + g2
    f3 = g3 - g2
    f4 = -g3

    wv = 1.0 if eweight is None else eweight
    if eweight is not None:
        ed, elj, ec = ed * eweight, elj * eweight, ec * eweight
    virial = jnp.stack([
        jnp.sum((wv * (-b1[:, 0] * g1[:, 0] - b2[:, 0] * g2[:, 0]
                 - b3[:, 0] * g3[:, 0])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 1] * g1[:, 1] - b2[:, 1] * g2[:, 1]
                 - b3[:, 1] * g3[:, 1])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 2] * g1[:, 2] - b2[:, 2] * g2[:, 2]
                 - b3[:, 2] * g3[:, 2])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 0] * g1[:, 1] - b2[:, 0] * g2[:, 1]
                 - b3[:, 0] * g3[:, 1])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 0] * g1[:, 2] - b2[:, 0] * g2[:, 2]
                 - b3[:, 0] * g3[:, 2])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 1] * g1[:, 2] - b2[:, 1] * g2[:, 2]
                 - b3[:, 1] * g3[:, 2])).astype(acc_dtype)),
    ])
    updates = dict(
        i=(i1, f1), j=(i2, f2), k=(i3, f3), l=(i4, f4),
    )
    return (updates,
            jnp.sum(ed.astype(acc_dtype)),
            jnp.sum(elj.astype(acc_dtype)),
            jnp.sum(ec.astype(acc_dtype)),
            virial)


def improper_harmonic_forces(x, L, impropers, coeffs, idx=None,
                             acc_dtype=jnp.float32, eweight=None):
    """Forces/energy for harmonic impropers; same contract as dihedrals."""
    it = impropers[:, 0]
    if idx is None:
        i1 = jnp.asarray(impropers[:, 1])
        i2 = jnp.asarray(impropers[:, 2])
        i3 = jnp.asarray(impropers[:, 3])
        i4 = jnp.asarray(impropers[:, 4])
    else:
        i1, i2, i3, i4 = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    flt = x.dtype
    K = jnp.asarray(coeffs[it, 0], flt)
    chi0 = jnp.asarray(np.deg2rad(coeffs[it, 1]), flt)

    b1 = _minimg3(x[i1] - x[i2], L)
    b2 = _minimg3(x[i3] - x[i2], L)
    b3 = _minimg3(x[i4] - x[i3], L)

    def etot(b1, b2, b3):
        return jnp.sum(_improper_energy(b1, b2, b3, K, chi0)
                       .astype(acc_dtype))

    g1, g2, g3 = jax.grad(etot, argnums=(0, 1, 2))(b1, b2, b3)
    e = _improper_energy(b1, b2, b3, K, chi0)
    f1 = -g1
    f2 = g1 + g2
    f3 = g3 - g2
    f4 = -g3
    wv = 1.0 if eweight is None else eweight
    if eweight is not None:
        e = e * eweight
    virial = jnp.stack([
        jnp.sum((wv * (-b1[:, 0] * g1[:, 0] - b2[:, 0] * g2[:, 0]
                 - b3[:, 0] * g3[:, 0])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 1] * g1[:, 1] - b2[:, 1] * g2[:, 1]
                 - b3[:, 1] * g3[:, 1])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 2] * g1[:, 2] - b2[:, 2] * g2[:, 2]
                 - b3[:, 2] * g3[:, 2])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 0] * g1[:, 1] - b2[:, 0] * g2[:, 1]
                 - b3[:, 0] * g3[:, 1])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 0] * g1[:, 2] - b2[:, 0] * g2[:, 2]
                 - b3[:, 0] * g3[:, 2])).astype(acc_dtype)),
        jnp.sum((wv * (-b1[:, 1] * g1[:, 2] - b2[:, 1] * g2[:, 2]
                 - b3[:, 1] * g3[:, 2])).astype(acc_dtype)),
    ])
    updates = dict(i=(i1, f1), j=(i2, f2), k=(i3, f3), l=(i4, f4))
    return updates, jnp.sum(e.astype(acc_dtype)), virial
