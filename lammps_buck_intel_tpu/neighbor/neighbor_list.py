"""Fixed-shape neighbor lists — replacement for LAMMPS binned lists.

Reference contract (SURVEY.md H2): binned O(N) half lists with skin distance,
rebuild triggers, and special-bond bits packed in index high bits, consumed at
/root/reference/pair_buck_intel.cpp:142-144,246-247,279-280 and sized by
``get_max_nbors`` (/root/reference/intel_buffers.h:124-128).

Redesign (SURVEY.md §7.1):

* **Full** lists (every pair stored from both sides).  The force pass becomes
  a pure gather + row-sum — no ``f[j] -=`` scatter, no Newton half-list
  bookkeeping.  Energy/virial use the 0.5 double-count convention the
  reference already applies on its shared-pair path
  (pair_buck_intel.cpp:296-301).
* **Static capacity**: the list is a padded ``(N, K)`` int32 array plus
  validity derived from a sentinel index ``N``.  ``K`` and the cell capacity
  are static (jit shapes); overflow sets a flag and the host rebuilds with a
  larger quantized capacity — the analog of the reference's offload overflow
  flag (SURVEY.md §5.3).
* **Special bonds are data, not bits**: a parallel ``(N, K)`` int8 array of
  special-bond codes (0 none, 1/2/3 = 1-2/1-3/1-4) replaces the SBBITS
  encoding.  All special pairs stay in the list; factor handling lives in the
  pair kernels (subtractive for long-range Coulomb).
* Two build paths: a binned cell-list build (``lax.map`` over atom tiles to
  bound the candidate-buffer footprint) and a dense O(N^2) build for small
  systems / golden tests.  Both are jit-compiled pure functions.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.box import Box, minimum_image, to_lamda


class NeighborList(NamedTuple):
    """idx: (N, K) neighbor indices, sentinel N for padding.
    sb:  (N, K) int8 special-bond code (0 = plain pair).
    nnei: (N,) valid neighbor count.
    x0:  (N, 3) positions at build time (displacement trigger).
    overflow: () bool — any capacity exceeded; rebuild with a larger spec.
    """

    idx: jnp.ndarray
    sb: jnp.ndarray
    nnei: jnp.ndarray
    x0: jnp.ndarray
    overflow: jnp.ndarray

    @property
    def kmax(self) -> int:
        return self.idx.shape[1]


@dataclasses.dataclass(frozen=True)
class NeighborSpec:
    """Static (hashable) build configuration — jit recompiles per spec.

    cutneigh: interaction cutoff + skin.
    kmax: neighbor capacity per atom (padded).
    nc: cells per axis (cell list) or None for the dense path.
    cell_cap: max atoms per cell.
    tile: atom tile size for the candidate loop.
    """

    cutneigh: float
    kmax: int
    nc: Optional[tuple[int, int, int]]
    cell_cap: int
    tile: int
    dtype: str = "float32"

    @property
    def dense(self) -> bool:
        return self.nc is None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_spec(
    n_atoms: int,
    box_lengths,
    cutneigh: float,
    kmax: Optional[int] = None,
    dense: Optional[bool] = None,
    safety: float = 1.45,
    perp_widths=None,
) -> NeighborSpec:
    """Host-side capacity sizing (the ``get_max_nbors`` analog).

    Capacities are rounded up in quantized steps so overflow-triggered
    rebuilds don't thrash recompilation (SURVEY.md §7.3).

    perp_widths: (3,) perpendicular face distances for a triclinic cell
    (Box.perp_widths); cells are sized so each lamda-slab is >= cutneigh
    thick, keeping the 27-stencil exact for tilted cells.  Defaults to
    box_lengths (orthogonal).
    """
    L = np.asarray(box_lengths, dtype=np.float64)
    W = L if perp_widths is None else np.asarray(perp_widths, np.float64)
    if float(min(W)) < 2.0 * cutneigh and perp_widths is not None:
        # the greedy triclinic minimum image (core/box.py) requires
        # cutneigh < half the minimum face distance
        raise ValueError(
            f"cutoff+skin {cutneigh} exceeds half the minimum perpendicular "
            f"box width {float(min(W)) / 2.0}")
    vol = float(np.prod(L))
    density = n_atoms / vol
    nc = tuple(int(max(1, np.floor(w / cutneigh))) for w in W)
    use_dense = dense if dense is not None else (n_atoms <= 512)
    if min(nc) < 3:
        # fewer than 3 cells per axis makes the 27-cell stencil revisit the
        # same cell through periodic wraparound (duplicate pairs) — the
        # binned path is invalid regardless of what the caller asked for.
        use_dense = True

    if kmax is None:
        expect = density * (4.0 / 3.0) * math.pi * cutneigh**3
        kmax = _round_up(max(8, int(expect * safety) + 4), 8)
    kmax = min(kmax, n_atoms)

    if use_dense:
        return NeighborSpec(
            cutneigh=float(cutneigh), kmax=int(kmax), nc=None, cell_cap=0,
            tile=0,
        )

    cell_vol = vol / float(np.prod(nc))
    cell_cap = _round_up(max(4, int(density * cell_vol * safety) + 4), 4)
    # tile size bounds the (tile, 27*cell_cap) candidate buffer to ~32MB
    cand = 27 * cell_cap
    tile = max(256, min(4096, _round_up(int(2.0e6 / cand), 256)))
    tile = min(tile, _round_up(n_atoms, 256))
    return NeighborSpec(
        cutneigh=float(cutneigh), kmax=int(kmax), nc=nc,
        cell_cap=int(cell_cap), tile=int(tile),
    )


def grow(spec: NeighborSpec, observed_max: Optional[int] = None) -> NeighborSpec:
    """Overflow response: bump capacities (quantized to limit recompiles).

    When the overflowing build reports its observed max neighbor count, jump
    straight past it; otherwise grow ~25%.
    """
    target = int(spec.kmax * 1.25) + 8
    if observed_max is not None:
        target = max(target, int(observed_max * 1.1) + 8)
    return dataclasses.replace(
        spec,
        kmax=_round_up(target, 8),
        cell_cap=_round_up(int(spec.cell_cap * 1.25) + 4, 4) if spec.cell_cap else 0,
    )


# 27-cell stencil, static.
_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)


def _special_codes(idx, special_idx, special_code):
    """(..., K) idx x (..., S) specials -> (..., K) int8 codes."""
    if special_idx.shape[-1] == 0:
        return jnp.zeros(idx.shape, jnp.int8)
    match = idx[..., :, None] == special_idx[..., None, :]  # (..., K, S)
    codes = jnp.sum(
        jnp.where(match, special_code[..., None, :].astype(jnp.int32), 0),
        axis=-1,
    )
    return codes.astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("spec",))
def build_dense(x, box: Box, spec: NeighborSpec, special_idx, special_code,
                mol=None):
    """O(N^2) masked build — small systems and golden tests.

    mol: optional (N,) molecule ids; same-molecule pairs are excluded
    (LAMMPS ``neigh_modify exclude molecule/intra``)."""
    n = x.shape[0]
    k = min(spec.kmax, n)
    delta = minimum_image(x[:, None, :] - x[None, :, :], box)
    rsq = jnp.sum(delta * delta, axis=-1)
    cutsq = jnp.asarray(spec.cutneigh**2, rsq.dtype)
    eye = jnp.eye(n, dtype=bool)
    valid = (rsq <= cutsq) & ~eye
    if mol is not None:
        valid = valid & (mol[:, None] != mol[None, :])
    key = jnp.where(valid, rsq, jnp.inf)
    neg, pos = jax.lax.top_k(-key, k)
    ok = neg > -jnp.inf
    idx = jnp.where(ok, pos, n).astype(jnp.int32)
    nnei = jnp.sum(valid, axis=1).astype(jnp.int32)
    overflow = jnp.any(nnei > k)
    sb = _special_codes(idx, special_idx, special_code)
    return NeighborList(idx=idx, sb=sb, nnei=nnei, x0=x, overflow=overflow)


@functools.partial(jax.jit, static_argnames=("spec",))
def build_cell(x, box: Box, spec: NeighborSpec, special_idx, special_code,
               mol=None):
    """Binned build: cell assignment -> sorted scatter into (ncell, cap)
    slots -> per-tile 27-cell candidate gather -> top_k prune to (N, K).

    Periodic in all three axes (every shipped deck is).  Requires >=3 cells
    per axis (make_spec falls back to dense otherwise, avoiding duplicate
    candidate cells from periodic wraparound).
    """
    n = x.shape[0]
    ncx, ncy, ncz = spec.nc
    ncell = ncx * ncy * ncz
    cap = spec.cell_cap
    k = spec.kmax
    nc_arr = jnp.asarray(spec.nc, jnp.int32)

    s = to_lamda(x, box)
    s = s - jnp.floor(s)  # fold into [0,1)
    ci = jnp.clip((s * nc_arr).astype(jnp.int32), 0, nc_arr - 1)  # (N,3)
    cid = (ci[:, 0] * ncy + ci[:, 1]) * ncz + ci[:, 2]

    order = jnp.argsort(cid)  # stable
    cid_sorted = cid[order]
    starts = jnp.searchsorted(cid_sorted, jnp.arange(ncell, dtype=cid.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[cid_sorted].astype(jnp.int32)
    slot_ok = rank < cap
    cell_overflow = jnp.any(~slot_ok)
    flat = jnp.where(slot_ok, cid_sorted * cap + rank, ncell * cap)
    cells = jnp.full((ncell * cap + 1,), n, jnp.int32)
    cells = cells.at[flat].set(order.astype(jnp.int32), mode="drop")
    cells = cells[: ncell * cap]

    x_pad = jnp.concatenate([x, jnp.zeros((1, 3), x.dtype)], axis=0)
    mol_pad = None
    if mol is not None:
        mol_pad = jnp.concatenate([mol, -jnp.ones((1,), mol.dtype)])
    offsets = jnp.asarray(_OFFSETS)  # (27,3)
    cutsq = jnp.asarray(spec.cutneigh**2, x.dtype)

    n_pad = _round_up(n, spec.tile)
    pad = n_pad - n
    ci_p = jnp.concatenate([ci, jnp.zeros((pad, 3), ci.dtype)])
    xi_p = jnp.concatenate([x, jnp.zeros((pad, 3), x.dtype)])
    ai_p = jnp.concatenate(
        [jnp.arange(n, dtype=jnp.int32), jnp.full((pad,), n, jnp.int32)]
    )
    ntile = n_pad // spec.tile
    ci_t = ci_p.reshape(ntile, spec.tile, 3)
    xi_t = xi_p.reshape(ntile, spec.tile, 3)
    ai_t = ai_p.reshape(ntile, spec.tile)
    if mol is not None:
        mi_p = jnp.concatenate([mol, -jnp.ones((pad,), mol.dtype)])
        mi_t = mi_p.reshape(ntile, spec.tile)
    else:
        mi_t = jnp.zeros((ntile, spec.tile), jnp.int32)

    def one_tile(args):
        ci_b, xi_b, ai_b, mi_b = args  # (T,3), (T,3), (T,), (T,)
        nbc = jnp.mod(ci_b[:, None, :] + offsets[None, :, :], nc_arr)  # (T,27,3)
        nbid = (nbc[..., 0] * ncy + nbc[..., 1]) * ncz + nbc[..., 2]  # (T,27)
        base = nbid[..., None] * cap + jnp.arange(cap, dtype=jnp.int32)
        cand = cells[base.reshape(ci_b.shape[0], -1)]  # (T, 27*cap)
        xj = x_pad[cand]
        delta = minimum_image(xi_b[:, None, :] - xj, box)
        rsq = jnp.sum(delta * delta, axis=-1)
        valid = (cand != n) & (cand != ai_b[:, None]) & (rsq <= cutsq)
        if mol is not None:
            valid = valid & (mol_pad[cand] != mi_b[:, None])
        key = jnp.where(valid, rsq, jnp.inf)
        neg, pos = jax.lax.top_k(-key, k)
        ok = neg > -jnp.inf
        idx_b = jnp.where(ok, jnp.take_along_axis(cand, pos, axis=1), n)
        nnei_b = jnp.sum(valid, axis=1).astype(jnp.int32)
        return idx_b.astype(jnp.int32), nnei_b

    idx_t, nnei_t = jax.lax.map(one_tile, (ci_t, xi_t, ai_t, mi_t))
    idx = idx_t.reshape(n_pad, k)[:n]
    nnei = nnei_t.reshape(n_pad)[:n]
    overflow = cell_overflow | jnp.any(nnei > k)
    sb = _special_codes(idx, special_idx, special_code)
    return NeighborList(idx=idx, sb=sb, nnei=nnei, x0=x, overflow=overflow)


def build(x, box: Box, spec: NeighborSpec, special_idx=None,
          special_code=None, mol=None):
    n = x.shape[0]
    if special_idx is None:
        special_idx = jnp.zeros((n, 0), jnp.int32)
        special_code = jnp.zeros((n, 0), jnp.int8)
    if spec.dense:
        return build_dense(x, box, spec, special_idx, special_code, mol)
    return build_cell(x, box, spec, special_idx, special_code, mol)


@jax.jit
def needs_rebuild(x, box: Box, nlist: NeighborList, half_skin_sq) -> jnp.ndarray:
    """``neigh_modify check yes`` trigger: any atom moved > skin/2 since the
    last build (conservative standard criterion)."""
    delta = minimum_image(x - nlist.x0, box)
    dsq = jnp.sum(delta * delta, axis=-1)
    return jnp.max(dsq) > half_skin_sq


def build_with_retry(x, box, spec, special_idx=None, special_code=None,
                     mol=None, max_retries: int = 5):
    """Host-side overflow loop: grow capacities until the build fits."""
    for _ in range(max_retries):
        nl = build(x, box, spec, special_idx, special_code, mol)
        if not bool(jax.device_get(nl.overflow)):
            return nl, spec
        spec = grow(spec, observed_max=int(jax.device_get(nl.nnei.max())))
    raise RuntimeError(
        "neighbor list overflow persists after retries; pathological density?"
    )
