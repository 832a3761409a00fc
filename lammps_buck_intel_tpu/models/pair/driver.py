"""Pair force pass: gather -> per-pair terms -> row-sum.

The re-design of the reference's ``eval`` hot loop
(/root/reference/pair_buck_intel.cpp:127-365): with a full neighbor list the
scatter to j (``f[j] -=``, :290-294) disappears; forces are a pure gather +
masked row reduction, energies/virial use the 0.5 double-count convention
(:296-301).  Per-thread force slabs and the add_result_array reduction
(SURVEY.md H1) are unnecessary — XLA owns the parallelism.

Layout rules:
* All hot (N, K) pair arrays are **component SoA**: three (N, K) planes
  instead of one (N, K, 3) array, which keeps every elementwise pass on a
  wide minor axis.  The reference's AoSoA repack (intel_buffers.h:185-203)
  becomes "three (N, K) planes" here.
* Per-pair coefficients come from an unrolled select chain over the flat
  (T*T) type-pair table when T is small (every deck: T <= 3) instead of a
  gather from a tiny table.  Large T falls back to a real gather.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ...core.box import Box
from ...neighbor.neighbor_list import NeighborList
from .styles import PairStyle, pair_terms, COEF_NAMES


class PairResult(NamedTuple):
    f: jnp.ndarray        # (N, 3) forces, acc dtype
    evdwl: jnp.ndarray    # () scalar
    ecoul: jnp.ndarray    # ()
    virial: jnp.ndarray   # (6,) xx yy zz xy xz yz


def _select_small(table_1d: np.ndarray, key, shape, dtype):
    """Unrolled select: out[p] = table_1d[key[p]] for a tiny host table.

    Pure selects over baked python-float constants — avoids both
    tiny-table gathers and device-scalar broadcasts (see PairStyle note).
    """
    vals = [float(v) for v in np.asarray(table_1d)]
    if all(v == vals[0] for v in vals):
        return vals[0]
    acc = jnp.full(shape, vals[0], dtype)
    for c in range(1, len(vals)):
        acc = jnp.where(key == c, vals[c], acc)
    return acc


def gather_coefs(tables: np.ndarray, ti, tj, key_like) -> dict:
    """(T,T,NCOEF) host tables + type indices -> per-pair coef planes.

    Small T: python-float constants / unrolled select chains (baked).
    Large T: device gather fallback.
    """
    ntypes = tables.shape[0]
    flat = np.asarray(tables).reshape(ntypes * ntypes, tables.shape[-1])
    cols = {}
    if ntypes * ntypes <= 16:
        tt = None if ntypes == 1 else ti * ntypes + tj
        for ci, name in enumerate(COEF_NAMES):
            col = flat[:, ci]
            if ntypes == 1:
                cols[name] = float(col[0])
            else:
                cols[name] = _select_small(col, tt, key_like.shape,
                                           key_like.dtype)
    else:
        g = jnp.asarray(flat, key_like.dtype)[ti * ntypes + tj]
        for ci, name in enumerate(COEF_NAMES):
            cols[name] = g[..., ci]
    return cols


def compute_pair(
    style: PairStyle,
    x: jnp.ndarray,
    typ: jnp.ndarray,
    q: jnp.ndarray,
    box: Box,
    nlist: NeighborList,
    *,
    eflag: bool = True,
    vflag: bool = True,
    acc_dtype=jnp.float32,
    src: Optional[tuple] = None,
    use_special: bool = True,
) -> PairResult:
    """Compute forces on the i-rows of `x` from neighbors indexed by `nlist`.

    src: optional (x_src, typ_src, q_src) that neighbor indices point into;
    defaults to (x, typ, q).  Under SPMD the i-rows are the local shard while
    src is the all-gathered global array (SURVEY.md §2.3 spatial/data
    parallel row).
    use_special: statically disable special-bond factor handling (systems
    without bonded topology).
    """
    x_src, typ_src, q_src = src if src is not None else (x, typ, q)
    n_src = x_src.shape[0]
    ntypes = style.tables.shape[0]
    flt = x.dtype
    # typ/q may arrive as host numpy (safe closure constants); traced
    # indexing below needs jnp views.
    if isinstance(typ_src, np.ndarray):
        typ_src = jnp.asarray(typ_src)
    if isinstance(q_src, np.ndarray):
        q_src = jnp.asarray(q_src, flt)
    if isinstance(q, np.ndarray):
        q = jnp.asarray(q, flt)
    if isinstance(typ, np.ndarray):
        typ = jnp.asarray(typ)

    j = nlist.idx                       # (N, K)
    mask = j < n_src
    j_safe = jnp.minimum(j, n_src - 1)

    # component-SoA displacement with minimum image.  Box constants are
    # baked python-float literals for a host box, traced scalars for the
    # NPT variable-cell path (core.box.axis_lengths); triclinic boxes go
    # through the greedy plane reduction.
    from ...core.box import minimum_image_planes

    d = list(minimum_image_planes(
        *(x[:, ax][:, None] - x_src[:, ax][j_safe] for ax in range(3)),
        box))
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    # push masked slots out of every cutoff
    rsq = jnp.where(mask, rsq, jnp.asarray(1e30, flt))

    ti = typ[:, None]
    if ntypes == 1:
        tj = jnp.zeros((), jnp.int32)
    else:
        tj = typ_src[j_safe]
    coef = gather_coefs(style.tables, ti, tj, rsq)

    if style.cfg.has_coul:
        qi = q[:, None]
        qj = q_src[j_safe]
    else:
        qi = qj = 0.0

    if use_special:
        sb = nlist.sb.astype(jnp.int32)
        f_lj = _select_small(style.special_lj, sb, rsq.shape, flt)
        f_coul = _select_small(style.special_coul, sb, rsq.shape, flt)
    else:
        f_lj = f_coul = 1.0

    fscalar, evdwl, ecoul = pair_terms(
        style, rsq, coef, qi, qj, f_lj, f_coul, eflag=eflag
    )
    fscalar = jnp.where(mask, fscalar, 0.0)

    fcomp = [jnp.sum((fscalar * dd).astype(acc_dtype), axis=1) for dd in d]
    f = jnp.stack(fcomp, axis=-1)       # (N, 3)

    if eflag:
        half = jnp.asarray(0.5, acc_dtype)
        evdwl_tot = half * jnp.sum(jnp.where(mask, evdwl, 0.0).astype(acc_dtype))
        ecoul_tot = half * jnp.sum(jnp.where(mask, ecoul, 0.0).astype(acc_dtype))
    else:
        evdwl_tot = ecoul_tot = jnp.zeros((), acc_dtype)

    if vflag:
        # virial_ab = 0.5 * sum_pairs f_a * r_b (double-count halved)
        w = fscalar * 0.5
        virial = jnp.stack([
            jnp.sum((w * d[0] * d[0]).astype(acc_dtype)),
            jnp.sum((w * d[1] * d[1]).astype(acc_dtype)),
            jnp.sum((w * d[2] * d[2]).astype(acc_dtype)),
            jnp.sum((w * d[0] * d[1]).astype(acc_dtype)),
            jnp.sum((w * d[0] * d[2]).astype(acc_dtype)),
            jnp.sum((w * d[1] * d[2]).astype(acc_dtype)),
        ])
    else:
        virial = jnp.zeros((6,), acc_dtype)

    return PairResult(f=f, evdwl=evdwl_tot, ecoul=ecoul_tot, virial=virial)


def pair_energy_fn(style: PairStyle, typ, q, box, nlist, acc_dtype=jnp.float32):
    """Energy-only closure over positions — for autodiff force checks."""

    def e(x):
        r = compute_pair(style, x, typ, q, box, nlist, eflag=True, vflag=False,
                         acc_dtype=acc_dtype)
        return r.evdwl + r.ecoul

    return e


def compute_pair_peratom(
    style: PairStyle,
    x, typ, q, box, nlist,
    *,
    acc_dtype=jnp.float32,
    use_special: bool = True,
):
    """Per-atom pair energy and virial (the eflag_atom/vflag_atom contract,
    pair_buck_intel.cpp:303-322): each atom receives half of every pair term
    it participates in.  Returns (eatom (N,), vatom (N, 6))."""
    x_src, typ_src, q_src = x, typ, q
    n_src = x_src.shape[0]
    ntypes = style.tables.shape[0]
    flt = x.dtype
    if isinstance(typ, np.ndarray):
        typ = jnp.asarray(typ)
        typ_src = typ
    if isinstance(q, np.ndarray):
        q = jnp.asarray(q, flt)
        q_src = q

    j = nlist.idx
    mask = j < n_src
    j_safe = jnp.minimum(j, n_src - 1)
    from ...core.box import minimum_image_planes

    d = list(minimum_image_planes(
        *(x[:, ax][:, None] - x_src[:, ax][j_safe] for ax in range(3)),
        box))
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rsq = jnp.where(mask, rsq, jnp.asarray(1e30, flt))
    ti = typ[:, None]
    tj = typ_src[j_safe] if ntypes > 1 else jnp.zeros((), jnp.int32)
    coef = gather_coefs(style.tables, ti, tj, rsq)
    if style.cfg.has_coul:
        qi, qj = q[:, None], q_src[j_safe]
    else:
        qi = qj = 0.0
    if use_special:
        sb = nlist.sb.astype(jnp.int32)
        f_lj = _select_small(style.special_lj, sb, rsq.shape, flt)
        f_coul = _select_small(style.special_coul, sb, rsq.shape, flt)
    else:
        f_lj = f_coul = 1.0
    fscalar, evdwl, ecoul = pair_terms(style, rsq, coef, qi, qj, f_lj,
                                       f_coul, eflag=True)
    half = jnp.asarray(0.5, acc_dtype)
    epair = jnp.where(mask, evdwl + ecoul, 0.0).astype(acc_dtype)
    eatom = half * jnp.sum(epair, axis=1)
    w = jnp.where(mask, fscalar, 0.0) * 0.5
    vatom = jnp.stack([
        jnp.sum((w * d[0] * d[0]).astype(acc_dtype), axis=1),
        jnp.sum((w * d[1] * d[1]).astype(acc_dtype), axis=1),
        jnp.sum((w * d[2] * d[2]).astype(acc_dtype), axis=1),
        jnp.sum((w * d[0] * d[1]).astype(acc_dtype), axis=1),
        jnp.sum((w * d[0] * d[2]).astype(acc_dtype), axis=1),
        jnp.sum((w * d[1] * d[2]).astype(acc_dtype), axis=1),
    ], axis=-1)
    return eatom, vatom
