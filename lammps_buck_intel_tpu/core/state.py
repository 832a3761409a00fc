"""Simulation state pytree + static topology.

Replacement for the reference's data-layout engine
(``IntelBuffers``, /root/reference/intel_buffers.h): instead of AoS->AoSoA
packing (``thr_pack``, intel_buffers.h:185-203) and per-thread force slabs
(intel_buffers.h:49-54), state lives as device-resident SoA ``jnp.ndarray``s
inside one functional pytree that flows through the jitted step.

``System`` is the dynamic state (differentiable / integrated).
``Topology`` is static per run (bond graph, special-bond exclusion lists) and
is baked into the neighbor build as fixed-shape padded arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp

from .box import Box


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class System:
    """Dynamic per-atom state.

    x:     (N, 3) wrapped positions.
    v:     (N, 3) velocities.
    q:     (N,) charges (zeros when atom style has none).
    type:  (N,) int32 atom type, 0-based internally (LAMMPS types are 1-based;
           IO converts).
    image: (N, 3) int32 periodic image flags (data.spce:22-34 columns).
    box:   orthogonal periodic box.
    mass:  (ntypes,) per-type mass (FixNVEIntel's per-DOF dtfm generalisation,
           fix_nve_intel.cpp:129-194, is reconstructed from this + type).
    molecule: (N,) int32 molecule ids (0 when atom style has none).
    """

    x: jnp.ndarray
    v: jnp.ndarray
    q: jnp.ndarray
    type: jnp.ndarray
    image: jnp.ndarray
    box: Box
    mass: jnp.ndarray
    molecule: jnp.ndarray

    @property
    def n_atoms(self) -> int:
        return self.x.shape[0]

    @property
    def n_types(self) -> int:
        return self.mass.shape[0]


def make_system(
    x,
    box: Box,
    type=None,
    v=None,
    q=None,
    image=None,
    mass=None,
    molecule=None,
    dtype=jnp.float32,
) -> System:
    x = jnp.asarray(x, dtype=dtype)
    n = x.shape[0]
    if type is None:
        type = jnp.zeros((n,), jnp.int32)
    else:
        type = jnp.asarray(type, jnp.int32)
    ntypes = int(np.asarray(jax.device_get(type)).max()) + 1 if n else 1
    if v is None:
        v = jnp.zeros_like(x)
    else:
        v = jnp.asarray(v, dtype=dtype)
    if q is None:
        q = jnp.zeros((n,), dtype=dtype)
    else:
        q = jnp.asarray(q, dtype=dtype)
    if image is None:
        image = jnp.zeros((n, 3), jnp.int32)
    else:
        image = jnp.asarray(image, jnp.int32)
    if mass is None:
        mass = jnp.ones((ntypes,), dtype=dtype)
    else:
        mass = jnp.asarray(mass, dtype=dtype)
    if molecule is None:
        molecule = jnp.zeros((n,), jnp.int32)
    else:
        molecule = jnp.asarray(molecule, jnp.int32)
    return System(x=x, v=v, q=q, type=type, image=image, box=box, mass=mass,
                  molecule=molecule)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static bonded topology (host-side numpy; never traced).

    bonds/angles/dihedrals/impropers: (M, 1+k) int arrays [type, atoms...],
    all 0-based.  ``special`` is the derived per-atom exclusion table used to
    tag neighbor-list entries with their special-bond index, the analog of
    the SBBITS encoding consumed at pair_buck_intel.cpp:279-280:
      special_idx:  (N, S) int32 partner indices, padded with -1.
      special_code: (N, S) int8 in {1: 1-2, 2: 1-3, 3: 1-4}.
    """

    bonds: np.ndarray
    angles: np.ndarray
    dihedrals: np.ndarray
    impropers: np.ndarray
    special_idx: np.ndarray
    special_code: np.ndarray

    @property
    def has_special(self) -> bool:
        return self.special_idx.shape[1] > 0


def _empty(k: int) -> np.ndarray:
    return np.zeros((0, k), dtype=np.int32)


def build_topology(
    n_atoms: int,
    bonds=None,
    angles=None,
    dihedrals=None,
    impropers=None,
) -> Topology:
    """Derive 1-2/1-3/1-4 special-bond partner lists from the bond graph.

    Follows LAMMPS ``Special`` semantics: 1-2 partners are bonded neighbors,
    1-3 are neighbors-of-neighbors not already 1-2/self, 1-4 are three hops
    out not already closer.
    """
    bonds = _empty(3) if bonds is None else np.asarray(bonds, np.int32)
    angles = _empty(4) if angles is None else np.asarray(angles, np.int32)
    dihedrals = _empty(5) if dihedrals is None else np.asarray(dihedrals, np.int32)
    impropers = _empty(5) if impropers is None else np.asarray(impropers, np.int32)

    adj = [set() for _ in range(n_atoms)]
    for _, i, j in bonds:
        adj[i].add(int(j))
        adj[j].add(int(i))

    one2 = [set(a) for a in adj]
    one3 = []
    one4 = []
    for i in range(n_atoms):
        s2 = one2[i]
        s3 = set()
        for j in s2:
            s3 |= one2[j]
        s3 -= s2
        s3.discard(i)
        s4 = set()
        for j in s3:
            s4 |= one2[j]
        s4 -= s2 | s3
        s4.discard(i)
        one3.append(s3)
        one4.append(s4)

    smax = max([len(a | b | c) for a, b, c in zip(one2, one3, one4)] + [0])
    special_idx = np.full((n_atoms, smax), -1, dtype=np.int32)
    special_code = np.zeros((n_atoms, smax), dtype=np.int8)
    for i in range(n_atoms):
        col = 0
        for code, group in ((1, one2[i]), (2, one3[i]), (3, one4[i])):
            for j in sorted(group):
                special_idx[i, col] = j
                special_code[i, col] = code
                col += 1

    return Topology(
        bonds=bonds,
        angles=angles,
        dihedrals=dihedrals,
        impropers=impropers,
        special_idx=special_idx,
        special_code=special_code,
    )


EMPTY_TOPOLOGY = build_topology(0)


def empty_topology(n_atoms: int) -> Topology:
    t = build_topology(0)
    return Topology(
        bonds=t.bonds,
        angles=t.angles,
        dihedrals=t.dihedrals,
        impropers=t.impropers,
        special_idx=np.full((n_atoms, 0), -1, np.int32),
        special_code=np.zeros((n_atoms, 0), np.int8),
    )
