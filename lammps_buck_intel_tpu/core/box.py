"""Simulation box + periodic boundary conditions.

Covers the host-LAMMPS ``Domain`` contract the reference relies on
(SURVEY.md H3): orthogonal periodic boxes, coordinate wrapping with image
flags, and minimum-image displacement.  Triclinic (lamda-coordinate) support
mirrors the hooks at /root/reference/pppm_intel.cpp:153-157 and is provided
for the kspace grid mapping; the shipped decks are all orthogonal.

Design note: on a single device we never materialise ghost atoms.
With wrapped coordinates and cutoff < L/2 the minimum-image convention is an
exact replacement for LAMMPS' ghost-atom machinery, and it keeps every array
a fixed (N, ...) shape — no halo padding, no comm.  Multi-chip halo exchange
lives in ``parallel/``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class Box(NamedTuple):
    """Periodic simulation box — orthogonal or (restricted) triclinic.

    lo, hi: (3,) box bounds — **host numpy**, never device arrays.
    periodic: (3,) bool — per-axis periodicity (decks are fully periodic).
    tilt: None (orthogonal) or (3,) host numpy [xy, xz, yz] tilt factors,
      the LAMMPS triclinic convention (cell vectors a = (lx,0,0),
      b = (xy,ly,0), c = (xz,yz,lz); the lamda-transform hooks of
      /root/reference/pppm_intel.cpp:153-157).  LAMMPS' tilt restriction
      (|xy|,|xz| <= lx/2, |yz| <= ly/2) is assumed; ``make_box`` enforces it.

    The box is kept host-side so that its constants are baked into the
    program at trace time instead of broadcast from 0-d *device* scalars
    into (N, K) elementwise math — the analog of the reference baking
    cutoffs into its template instantiations.  Tilt factors are likewise host
    floats baked at trace time; the traced-box (NPT) path stays orthogonal.
    """

    lo: np.ndarray
    hi: np.ndarray
    periodic: np.ndarray
    tilt: np.ndarray = None

    @property
    def lengths(self) -> np.ndarray:
        return self.hi - self.lo

    @property
    def volume(self) -> float:
        # det(h) of the upper-triangular cell matrix == prod(lengths),
        # tilted or not
        L = self.lengths
        return float(L[0] * L[1] * L[2])

    @property
    def is_triclinic(self) -> bool:
        # tilt is None for every orthogonal box (make_box normalizes
        # zero tilt to None), so this is a STATIC branch even when the box
        # itself is traced through jit (pytree: a None field has no leaf)
        return self.tilt is not None

    @property
    def h_matrix(self) -> np.ndarray:
        """(3,3) upper-triangular cell matrix: x = lo + h @ lamda."""
        lx, ly, lz = (float(v) for v in self.lengths)
        xy, xz, yz = ((0.0, 0.0, 0.0) if self.tilt is None
                      else (float(v) for v in self.tilt))
        return np.array([[lx, xy, xz], [0.0, ly, yz], [0.0, 0.0, lz]])

    @property
    def h_inv(self) -> np.ndarray:
        """(3,3) upper-triangular inverse cell matrix (lamda = h_inv @ dx)."""
        lx, ly, lz = (float(v) for v in self.lengths)
        xy, xz, yz = ((0.0, 0.0, 0.0) if self.tilt is None
                      else (float(v) for v in self.tilt))
        return np.array([
            [1.0 / lx, -xy / (lx * ly), (xy * yz - ly * xz) / (lx * ly * lz)],
            [0.0, 1.0 / ly, -yz / (ly * lz)],
            [0.0, 0.0, 1.0 / lz],
        ])

    @property
    def perp_widths(self) -> np.ndarray:
        """(3,) perpendicular distances between opposite cell faces — the
        lengths that bound interaction cutoffs and cell-list sizing for a
        tilted cell (equal to ``lengths`` when orthogonal)."""
        h = self.h_matrix
        a, b, c = h[:, 0], h[:, 1], h[:, 2]
        V = abs(float(np.linalg.det(h)))
        return np.array([
            V / np.linalg.norm(np.cross(b, c)),
            V / np.linalg.norm(np.cross(c, a)),
            V / np.linalg.norm(np.cross(a, b)),
        ])


def make_box(lo, hi, periodic=(True, True, True), dtype=None,
             tilt=None) -> Box:
    dt = np.float64 if dtype is None else np.dtype(dtype)
    t = None
    if tilt is not None:
        t = np.asarray(tilt, dtype=np.float64)
        if np.all(t == 0.0):
            t = None
    if t is not None:
        L = np.asarray(hi, np.float64) - np.asarray(lo, np.float64)
        xy, xz, yz = (abs(float(v)) for v in t)
        if xy > 0.5 * L[0] + 1e-9 or xz > 0.5 * L[0] + 1e-9 \
                or yz > 0.5 * L[1] + 1e-9:
            raise ValueError(
                f"tilt {tuple(t)} violates the LAMMPS restriction "
                f"(|xy|,|xz| <= lx/2, |yz| <= ly/2) for box {tuple(L)}")
    return Box(
        lo=np.asarray(lo, dtype=dt),
        hi=np.asarray(hi, dtype=dt),
        periodic=np.asarray(periodic, dtype=bool),
        tilt=t,
    )


def _tri_consts(box: Box):
    """(lx, ly, lz, xy, xz, yz) as python floats for a host box (baked
    literals) or traced 0-d scalars for a traced box."""
    L, T = box.lengths, box.tilt
    if isinstance(L, np.ndarray) and isinstance(T, np.ndarray):
        return (float(L[0]), float(L[1]), float(L[2]),
                float(T[0]), float(T[1]), float(T[2]))
    return (L[0], L[1], L[2], T[0], T[1], T[2])


def minimum_image(delta: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Minimum-image displacement.

    delta: (..., 3) raw displacements x_i - x_j of wrapped coordinates.
    Orthogonal: exact when every interaction cutoff < min(L)/2.  Triclinic:
    the standard greedy z->y->x reduction over the upper-triangular cell
    (LAMMPS ``Domain::minimum_image`` for restricted tilts) — exact for all
    separations below half the minimum perpendicular width, which the
    neighbor spec enforces against the cutoff.
    """
    if box.is_triclinic:
        dx, dy, dz = minimum_image_planes(
            delta[..., 0], delta[..., 1], delta[..., 2], box)
        return jnp.stack([dx, dy, dz], axis=-1)
    L = box.lengths.astype(delta.dtype)
    shift = jnp.round(delta / L) * L
    shift = jnp.where(box.periodic, shift, jnp.zeros_like(shift))
    return delta - shift


def minimum_image_planes(dx, dy, dz, box: Box):
    """Component-plane (SoA) form of ``minimum_image`` for hot paths that
    keep coordinates as separate planes (models/pair/driver.py).  Box
    constants come in as baked floats (host box) or traced scalars
    (variable-cell path; orthogonal only)."""
    if box.is_triclinic:
        lx, ly, lz, xy, xz, yz = _tri_consts(box)
        n3 = jnp.round(dz * (1.0 / lz))
        dx = dx - n3 * xz
        dy = dy - n3 * yz
        dz = dz - n3 * lz
        n2 = jnp.round(dy * (1.0 / ly))
        dx = dx - n2 * xy
        dy = dy - n2 * ly
        n1 = jnp.round(dx * (1.0 / lx))
        dx = dx - n1 * lx
        return dx, dy, dz
    L = axis_lengths(box)
    return tuple(
        dd - jnp.round(dd * (1.0 / La)) * La
        for dd, La in zip((dx, dy, dz), L)
    )


def wrap(x: jnp.ndarray, image: jnp.ndarray, box: Box):
    """Wrap coordinates into the box, updating image flags.

    Mirrors LAMMPS ``Domain::pbc`` semantics (image flags count how many box
    lengths the unwrapped coordinate is offset — data.spce:22-34 carries these
    columns and the checkpoint writer must round-trip them).  Triclinic: the
    flags count **cell vectors** (x_unwrapped = x + h @ image), and wrapping
    happens in lamda space.
    Returns (x_wrapped, image_updated).
    """
    if box.is_triclinic:
        lx, ly, lz, xy, xz, yz = _tri_consts(box)
        s = to_lamda(x, box)
        n = jnp.floor(s)
        n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
        x_w = x - jnp.stack([
            n0 * lx + n1 * xy + n2 * xz,
            n1 * ly + n2 * yz,
            n2 * lz,
        ], axis=-1)
        return x_w, image + n.astype(image.dtype)
    L = box.lengths.astype(x.dtype)
    rel = (x - box.lo) / L
    n = jnp.floor(rel)
    n = jnp.where(box.periodic, n, jnp.zeros_like(n))
    x_w = x - n * L
    return x_w, image + n.astype(image.dtype)


def unwrap(x: jnp.ndarray, image: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Reconstruct unwrapped coordinates from wrapped x + image flags."""
    if box.is_triclinic:
        lx, ly, lz, xy, xz, yz = _tri_consts(box)
        n = image.astype(x.dtype)
        n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
        return x + jnp.stack([
            n0 * lx + n1 * xy + n2 * xz,
            n1 * ly + n2 * yz,
            n2 * lz,
        ], axis=-1)
    L = box.lengths.astype(x.dtype)
    return x + image.astype(x.dtype) * L


def to_lamda(x: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Box -> fractional ("lamda") coordinates in [0,1) (the x2lamda analog
    behind /root/reference/pppm_intel.cpp:153-157)."""
    if box.is_triclinic:
        lx, ly, lz, xy, xz, yz = _tri_consts(box)
        lo = box.lo
        dx = x[..., 0] - lo[0]
        dy = x[..., 1] - lo[1]
        dz = x[..., 2] - lo[2]
        sz = dz * (1.0 / lz)
        sy = (dy - yz * sz) * (1.0 / ly)
        sx = (dx - xy * sy - xz * sz) * (1.0 / lx)
        return jnp.stack([sx, sy, sz], axis=-1)
    return (x - box.lo) / box.lengths.astype(x.dtype)


def from_lamda(s: jnp.ndarray, box: Box) -> jnp.ndarray:
    if box.is_triclinic:
        lx, ly, lz, xy, xz, yz = _tri_consts(box)
        lo = box.lo
        sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
        return jnp.stack([
            lo[0] + sx * lx + sy * xy + sz * xz,
            lo[1] + sy * ly + sz * yz,
            lo[2] + sz * lz,
        ], axis=-1)
    return box.lo + s * box.lengths.astype(s.dtype)


def axis_lengths(box: Box):
    """Per-axis lengths as 3 scalars: python floats for a host box (baked
    into the compiled program — the measured-fast contract above) or traced
    0-d arrays for a traced box (the NPT/variable-cell path, where lo/hi
    are jnp arrays threaded through jit as arguments, NOT closures)."""
    L = box.lengths
    if isinstance(L, np.ndarray):
        return [float(v) for v in L]
    return [L[0], L[1], L[2]]
