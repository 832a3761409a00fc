"""SHAKE/RATTLE holonomic distance constraints (``fix shake``).

Host-LAMMPS contract (SURVEY.md H7): examples/in.spce:29
``fix 1 all shake 0.0001 20 0 b 1 a 1`` — constrain bond type 1 (O-H) and
angle type 1 (H-O-H, converted to an equivalent H..H distance) so rigid
SPC/E water runs at dt = 2 fs.

Formulation (classic SHAKE + RATTLE rather than LAMMPS' constraint-force
variant — same constraint manifold, simpler functionally):
  * after the Verlet drift, iterate position corrections along the OLD bond
    directions until |r|^2 == d^2 (fixed iteration count under jit, the
    deck's max-iter knob);  velocities receive the matching correction.
  * after the final half-kick, RATTLE projects out the velocity component
    along each constraint.

Constrained DOF reduce the temperature denominator (handled by the runner).
All constraint work is scatter-adds over the constraint list — tiny next to
the pair pass.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import MATMUL


@dataclasses.dataclass(frozen=True)
class ShakeConstraints:
    """pairs: (Nc, 2) int32 atom indices; d2: (Nc,) squared target lengths;
    invm: (N,) 1/mass per atom (host numpy, baked).
    n_independent: independent constraint count for DOF bookkeeping (equals
    len(pairs) for SHAKE bonds; less when redundant all-pair rigidifying
    constraints are used — see make_rigid_from_molecules)."""

    pairs: np.ndarray
    d2: np.ndarray
    invm: np.ndarray
    iters: int = 20
    n_independent: int = -1
    # Jacobi under-relaxation: all constraints update in parallel (unlike
    # serial Gauss-Seidel SHAKE); strongly coupled constraint sets (rigid
    # bodies) need omega < 2/coupling to converge.
    omega: float = 1.0

    @property
    def n_constraints(self) -> int:
        return self.n_independent if self.n_independent >= 0 else len(self.pairs)


def make_shake(
    bonds: np.ndarray,
    bond_coeffs: np.ndarray,
    angles: np.ndarray,
    angle_coeffs: np.ndarray,
    mass_per_atom: np.ndarray,
    bond_types=(0,),
    angle_types=(0,),
    iters: int = 20,
) -> ShakeConstraints:
    """Build the constraint list from topology (``b ... a ...`` syntax).

    An angle constraint i-j-k (j central) becomes the fixed i..k distance
    by the law of cosines over the ACTUAL wing-bond rest lengths
    (r_ij^2 + r_jk^2 - 2 r_ij r_jk cos theta0); for equal wings this is the
    familiar 2 r0 sin(theta0/2) (SPC/E H..H)."""
    pairs = []
    d2 = []
    r0_of_bond_type = {int(t): float(bond_coeffs[int(t), 1])
                       for t in range(len(bond_coeffs))}
    bond_arr = np.asarray(bonds, np.int64)
    # (i, j) sorted pair -> bond type, for angle wing-bond lookup
    type_of_pair = {
        (min(int(i), int(j)), max(int(i), int(j))): int(bt)
        for bt, i, j in bond_arr
    }

    def _wing_r0(a: int, b: int) -> float:
        bt = type_of_pair.get((min(a, b), max(a, b)))
        if bt is None or bt not in r0_of_bond_type:
            raise ValueError(
                f"shake angle constraint references wing bond ({a},{b}) "
                "with no bond entry/coefficients in the topology"
            )
        return r0_of_bond_type[bt]

    for bt, i, j in bond_arr:
        if int(bt) in bond_types:
            pairs.append((i, j))
            d2.append(r0_of_bond_type[int(bt)] ** 2)
    for row in np.asarray(angles, np.int64):
        at, i, j, k = row
        if int(at) in angle_types:
            th0 = math.radians(float(angle_coeffs[int(at), 1]))
            ri = _wing_r0(int(j), int(i))
            rk = _wing_r0(int(j), int(k))
            dd = ri * ri + rk * rk - 2.0 * ri * rk * math.cos(th0)
            pairs.append((i, k))
            d2.append(dd)
    if not pairs:
        raise ValueError(
            "fix shake selected no constraints: check the b/a type lists "
            "or the m mass list against the topology")
    return ShakeConstraints(
        pairs=np.asarray(pairs, np.int32),
        d2=np.asarray(d2, np.float64),
        invm=(1.0 / np.asarray(mass_per_atom, np.float64)),
        iters=iters,
    )


def _tri6(L) -> bool:
    """(lx, ly, lz, xy, xz, yz) 6-sequence — the traced-triclinic form
    the NPT engine passes (tilts derive from the traced lengths via the
    fix_nh scalexy/scalexz/scaleyz rules)."""
    return isinstance(L, (tuple, list)) and len(L) == 6


def _minimg_cols(d, L):
    # L: per-axis lengths (host numpy -> baked floats; traced (3,) on the
    # NPT path), a triclinic Box (greedy z->y->x tilt reduction), or a
    # traced (lx, ly, lz, xy, xz, yz) 6-sequence (triclinic NPT)
    if hasattr(L, "is_triclinic"):
        from ..core.box import minimum_image

        return minimum_image(d, L)
    if _tri6(L):
        dx, dy, dz = _minimg_planes(d[:, 0], d[:, 1], d[:, 2], L)
        return jnp.stack([dx, dy, dz], axis=-1)
    out = []
    for ax in range(3):
        La = float(L[ax]) if isinstance(L, np.ndarray) else L[ax]
        out.append(d[:, ax] - jnp.round(d[:, ax] * (1.0 / La)) * La)
    return jnp.stack(out, axis=-1)


def _minimg_planes(dx, dy, dz, L):
    """Component-plane minimum image (same L contract as _minimg_cols)."""
    if hasattr(L, "is_triclinic"):
        from ..core.box import minimum_image_planes

        return minimum_image_planes(dx, dy, dz, L)
    if _tri6(L):
        lx, ly, lz, xy, xz, yz = L
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
    out = []
    for dd, ax in ((dx, 0), (dy, 1), (dz, 2)):
        La = float(L[ax]) if isinstance(L, np.ndarray) else L[ax]
        out.append(dd - jnp.round(dd * (1.0 / La)) * La)
    return tuple(out)


def shake_positions(sc: ShakeConstraints, x_old, x_new, v, dt: float, L,
                    pairs=None, virial_factor=None, vweights=None):
    """Iteratively correct x_new (and v) so constraints hold.

    x_old: positions at the start of the step (reference directions).
    pairs: optional traced (Nc, 2) index override (slot-layout engines remap
    atom ids to slots per rebin).
    virial_factor: when set (1 / (dtv * dtf), fix-NPT coupling), also
    returns the (6,) constraint virial: the accumulated Lagrange
    multipliers define the equivalent constraint pair force
    f_c = -lam_tot * r_old * virial_factor, tallied as sum r (x) f — the
    fix_shake.cpp virial contribution the barostat pressure needs.
    vweights: optional (Nc,) per-constraint virial weights (slab engine:
    1 where this device OWNS the constraint's first atom, else 0 —
    boundary molecules are solved identically on BOTH owners, so the
    psum'd virial would double-count without the ownership mask).
    Returns (x_new, v) or (x_new, v, virial).
    """
    idxp = sc.pairs if pairs is None else pairs
    i = jnp.asarray(idxp[:, 0]) if pairs is None else pairs[:, 0]
    j = jnp.asarray(idxp[:, 1]) if pairs is None else pairs[:, 1]
    d2 = jnp.asarray(sc.d2, x_new.dtype)
    mi = jnp.asarray(sc.invm[sc.pairs[:, 0]], x_new.dtype)[:, None]
    mj = jnp.asarray(sc.invm[sc.pairs[:, 1]], x_new.dtype)[:, None]
    r_old = _minimg_cols(x_old[i] - x_old[j], L)   # reference directions

    omega = float(sc.omega)

    def body(k, carry):
        xn, lam_tot = carry
        r_new = _minimg_cols(xn[i] - xn[j], L)
        diff = jnp.sum(r_new * r_new, axis=1) - d2
        denom = 2.0 * jnp.sum(r_new * r_old, axis=1) * (
            mi[:, 0] + mj[:, 0]
        )
        lam = diff / jnp.where(jnp.abs(denom) > 1e-12, denom,
                               jnp.sign(denom) * 1e-12 + 1e-12)
        corr = (omega * lam)[:, None] * r_old
        xn = xn.at[i].add(-mi * corr)
        xn = xn.at[j].add(mj * corr)
        return xn, lam_tot + omega * lam

    lam0 = jnp.zeros(r_old.shape[0], x_new.dtype)
    x_fix, lam_tot = jax.lax.fori_loop(0, sc.iters, body, (x_new, lam0))
    v = v + (x_fix - x_new) / dt
    if virial_factor is None:
        return x_fix, v
    w = (-lam_tot * virial_factor)[:, None] * r_old     # pair force on i
    if vweights is not None:
        w = w * vweights.astype(w.dtype)[:, None]
    virial = jnp.stack([
        jnp.sum(r_old[:, 0] * w[:, 0]),
        jnp.sum(r_old[:, 1] * w[:, 1]),
        jnp.sum(r_old[:, 2] * w[:, 2]),
        jnp.sum(r_old[:, 0] * w[:, 1]),
        jnp.sum(r_old[:, 0] * w[:, 2]),
        jnp.sum(r_old[:, 1] * w[:, 2]),
    ])
    return x_fix, v, virial


def shake_virial(sc: ShakeConstraints, x, v, f, ftm2v: float, L,
                 pairs=None, vweights=None, acc_dtype=jnp.float64):
    """Instantaneous SHAKE constraint virial (6,) — the fix_shake.cpp
    pressure-tally contract (host LAMMPS folds the constraint forces
    into the thermo virial; without them the pressure of constrained
    water is wrong by the internal-flexure term).

    The holonomic constraint |r_ij|^2 = d^2 implies, at every instant,
    (d/dt)^2 |r_ij|^2 / 2 = |v_ij|^2 + r_ij . a_ij = 0.  With
    unconstrained accelerations a0 = ftm2v f/m plus the unknown
    constraint pair forces f_c(i) = -lam_c r_c, the multipliers satisfy
    a coupled linear system (constraints share atoms within a cluster);
    it is SOR-iterated here exactly like the SHAKE position solve (same
    omega/iteration budget).  Virial = sum_c w_c r_c (x) (-lam_c r_c) —
    the continuous-time limit of LAMMPS' discrete multipliers (agrees
    to O(dt^2)).

    x/v/f: (M, 3) arrays in any layout ``pairs`` indexes into (atom
    order, slot planes, or the slab's halo-extended rows); masses always
    come from the STATIC atom-order constraint list, like
    shake_positions.  vweights: optional per-constraint tally weights
    (slab ownership: 1 where this device owns the constraint's first
    atom — boundary molecules are solved on both owners)."""
    idxp = sc.pairs if pairs is None else pairs
    i = jnp.asarray(idxp[:, 0]) if pairs is None else pairs[:, 0]
    j = jnp.asarray(idxp[:, 1]) if pairs is None else pairs[:, 1]
    invm_i = jnp.asarray(sc.invm[sc.pairs[:, 0]], x.dtype)
    invm_j = jnp.asarray(sc.invm[sc.pairs[:, 1]], x.dtype)
    r = _minimg_cols(x[i] - x[j], L)
    dv = v[i] - v[j]
    fx = f.astype(x.dtype)
    base = (jnp.sum(dv * dv, axis=1)
            + ftm2v * jnp.sum(r * (fx[i] * invm_i[:, None]
                                   - fx[j] * invm_j[:, None]), axis=1))
    denom = ftm2v * jnp.sum(r * r, axis=1) * (invm_i + invm_j)
    denom = jnp.maximum(denom, 1e-30)
    omega = float(sc.omega)
    m_rows = x.shape[0]

    def body(k, g):
        # feedback: acceleration the CURRENT multipliers impose on every
        # row (two constraints couple iff they touch the same row)
        corr = g[:, None] * r
        acc = jnp.zeros((m_rows, 3), x.dtype)
        acc = acc.at[i].add(-invm_i[:, None] * corr)
        acc = acc.at[j].add(invm_j[:, None] * corr)
        res = base + ftm2v * jnp.sum(r * (acc[i] - acc[j]), axis=1)
        return g + omega * res / denom

    lam = jax.lax.fori_loop(0, sc.iters, body,
                            jnp.zeros(r.shape[0], x.dtype))
    w = (-lam)[:, None] * r                     # pair force on i
    if vweights is not None:
        w = w * vweights.astype(w.dtype)[:, None]
    acc = acc_dtype
    return jnp.stack([
        jnp.sum((r[:, 0] * w[:, 0]).astype(acc)),
        jnp.sum((r[:, 1] * w[:, 1]).astype(acc)),
        jnp.sum((r[:, 2] * w[:, 2]).astype(acc)),
        jnp.sum((r[:, 0] * w[:, 1]).astype(acc)),
        jnp.sum((r[:, 0] * w[:, 2]).astype(acc)),
        jnp.sum((r[:, 1] * w[:, 2]).astype(acc)),
    ])


@dataclasses.dataclass(frozen=True)
class ShakeClusters:
    """Constraint connectivity regrouped into per-cluster dense form.

    The scatter-form solvers above update the GLOBAL position array
    twice per iteration (40 scatter-adds per step at 20 iters).
    Constraints only couple within a cluster (a water, a shake'd
    methyl, a rigidified molecule), so this form gathers each
    cluster's atoms once into per-component (A, M) locals — cluster
    index M on the minor axis (see _lanes_last) — iterates with
    STATIC +-1/∓invm contraction tensors (pure elementwise work), and
    scatters the net correction back once.  Same Jacobi
    under-relaxation, same iteration budget — identical math to
    shake_positions / rattle_velocities up to f32 reassociation.

    atoms: (M, A) atom ids, -1 pad.  pi/pj: (M, C) local indices.
    d2: (M, C) targets (pad 1).  cmask/amask: validity.  w_upd:
    (M, C, A) update matrix (-invm_i at pi, +invm_j at pj).
    invm_sum: (M, C) invm_i + invm_j (pad 1).  corig: (M, C) original
    constraint index (pad 0) for per-constraint weight gathers."""

    atoms: np.ndarray
    pi: np.ndarray
    pj: np.ndarray
    d2: np.ndarray
    cmask: np.ndarray
    amask: np.ndarray
    w_upd: np.ndarray
    invm_sum: np.ndarray
    corig: np.ndarray

    def rows_np(self, pad_row: int) -> np.ndarray:
        """(M, A) static row indices with pads mapped to pad_row."""
        return np.where(self.atoms >= 0, self.atoms, pad_row)


def make_clusters(sc: ShakeConstraints) -> ShakeClusters:
    """Group constraints into connected components (union-find)."""
    pairs = np.asarray(sc.pairs, np.int64)
    parent: dict = {}

    def find(a):
        r = a
        while parent.setdefault(r, r) != r:
            r = parent[r]
        while parent[a] != r:
            parent[a], a = r, parent[a]
        return r

    for i, j in pairs:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[rj] = ri
    comp: dict = {}
    for c, (i, j) in enumerate(pairs):
        comp.setdefault(find(int(i)), []).append(c)
    clusters = list(comp.values())
    M = len(clusters)
    A = max(len({int(a) for c in cl for a in pairs[c]}) for cl in clusters)
    C = max(len(cl) for cl in clusters)
    atoms = np.full((M, A), -1, np.int32)
    pi = np.zeros((M, C), np.int32)
    pj = np.zeros((M, C), np.int32)
    d2 = np.ones((M, C), np.float64)
    cmask = np.zeros((M, C), np.float64)
    amask = np.zeros((M, A), np.float64)
    w_upd = np.zeros((M, C, A), np.float64)
    invm_sum = np.ones((M, C), np.float64)
    corig = np.zeros((M, C), np.int64)
    d2_all = np.asarray(sc.d2, np.float64)
    invm = np.asarray(sc.invm, np.float64)
    for m, cl in enumerate(clusters):
        local: dict = {}
        for c in cl:
            for a in (int(pairs[c, 0]), int(pairs[c, 1])):
                if a not in local:
                    local[a] = len(local)
        for a, la in local.items():
            atoms[m, la] = a
            amask[m, la] = 1.0
        for k, c in enumerate(cl):
            ia, ja = int(pairs[c, 0]), int(pairs[c, 1])
            li, lj = local[ia], local[ja]
            pi[m, k] = li
            pj[m, k] = lj
            d2[m, k] = d2_all[c]
            cmask[m, k] = 1.0
            corig[m, k] = c
            w_upd[m, k, li] = -invm[ia]
            w_upd[m, k, lj] = invm[ja]
            invm_sum[m, k] = invm[ia] + invm[ja]
    return ShakeClusters(atoms=atoms, pi=pi, pj=pj, d2=d2, cmask=cmask,
                         amask=amask, w_upd=w_upd, invm_sum=invm_sum,
                         corig=corig)


def _lanes_last(cl: ShakeClusters):
    """Static solver tensors in lanes-last (M-minor) layout.

    The cluster axis M (one entry per molecule) lives on the wide minor
    dimension instead of a size-3 component axis.  Returns
    (D, WT, d2T, cmaskT, invmsT, amaskT): D (C, A, M) is the +-1 one-hot
    difference tensor (r_c = sum_a D[c,a] x[a] = x_i - x_j), WT (C, A, M)
    the transposed -+invm update weights; the rest are plain transposes.
    Host numpy — baked as literal constants per trace."""
    M, C = cl.pi.shape
    A = cl.atoms.shape[1]
    D = np.zeros((C, A, M), np.float64)
    m_idx = np.arange(M)
    for c in range(C):
        np.add.at(D[c], (cl.pi[:, c], m_idx), cl.cmask[:, c])
        np.add.at(D[c], (cl.pj[:, c], m_idx), -cl.cmask[:, c])
    WT = np.ascontiguousarray(cl.w_upd.transpose(1, 2, 0))
    # constraint-space coupling K[c,d] = sum_a D[c,a] W[d,a]: how the
    # unit-multiplier update of constraint d moves constraint c's
    # difference vector.  Static & symmetric; the exact solvers below
    # work entirely in (C, M) space through it.  K_cc = -invm_sum.
    K = np.einsum("cam,dam->cdm", D, WT)
    return (D, WT, np.ascontiguousarray(cl.d2.T),
            np.ascontiguousarray(cl.cmask.T),
            np.ascontiguousarray(cl.invm_sum.T),
            np.ascontiguousarray(cl.amask.T), K)


def _cdot3(a3, b3):
    return a3[0] * b3[0] + a3[1] * b3[1] + a3[2] * b3[2]


def _solve_small(J, F, cmaskT):
    """Batched exact solve of the (C, C) per-cluster system on the lanes.

    J: (C, C, M), F: (C, M) — solves J x = F independently per cluster m
    with unrolled, unpivoted Gaussian elimination (C is tiny: 1-3 for
    SHAKE'd waters/CH bonds, up to 3A-6 for shake-rigidified molecules;
    J is built from the symmetric coupling K with a dominant
    -invm_sum*(r.r) diagonal, so pivoting is unnecessary).  Inactive
    (padded) constraints get identity rows/columns so their x is 0."""
    C = F.shape[0]
    A = [[J[i, d] * (cmaskT[i] * cmaskT[d]) for d in range(C)]
         for i in range(C)]
    for i in range(C):
        A[i][i] = jnp.where(cmaskT[i] > 0, A[i][i],
                            jnp.ones_like(A[i][i]))
    b = [F[i] * cmaskT[i] for i in range(C)]
    for k in range(C):
        piv = A[k][k]
        piv = jnp.where(jnp.abs(piv) > 1e-12, piv,
                        jnp.where(piv < 0, -1e-12, 1e-12))
        inv = 1.0 / piv
        A[k][k] = piv
        for i in range(k + 1, C):
            f = A[i][k] * inv
            for j in range(k + 1, C):
                A[i][j] = A[i][j] - f * A[k][j]
            b[i] = b[i] - f * b[k]
    x = [None] * C
    for k in reversed(range(C)):
        s = b[k]
        for j in range(k + 1, C):
            s = s - A[k][j] * x[j]
        x[k] = s / A[k][k]
    return jnp.stack(x)


def shake_positions_clustered(sc: ShakeConstraints, cl: ShakeClusters,
                              xs_old, xs_new, vs, dt: float, L, rows,
                              virial_factor=None, vweights=None,
                              return_r: bool = False):
    """Cluster-dense SHAKE in lanes-last layout (see _lanes_last).

    xs_old/xs_new/vs: (x, y, z) component-plane TUPLES, each (nrows,).
    rows: (M, A) row indices into the planes (static np for atom-order
    engines, traced for slot layouts; pads must map to a valid row —
    their corrections are masked to zero — or out of range — the
    final scatter uses mode="drop").
    Returns ((x,y,z), (vx,vy,vz)[, virial]).

    Solver: NEWTON in constraint space.  The correction is parametrized
    as dx_a = sum_c lam_c W_ac r_old_c, so each constraint's difference
    vector moves as rn_c(lam) = rn_c(0) + sum_d lam_d K_cd ro_d with the
    STATIC coupling K — the whole iteration lives in (C, M) space (no
    A-space updates in the loop), and the (C, C) Jacobian
    J_cd = 2 (rn_c . ro_d) K_cd is solved EXACTLY per cluster
    (_solve_small).  Quadratic convergence: 3-4 iterations reach f32
    fixed point where the old Jacobi/SOR form (diagonal-only Newton)
    needed 20-30.  Same multipliers, same manifold — the two forms agree
    to solver tolerance."""
    flt = xs_new[0].dtype
    Dn, WTn, d2n, cmn, imn, amn, Kn = _lanes_last(cl)
    D = jnp.asarray(Dn, flt)
    WT = jnp.asarray(WTn, flt)
    d2T = jnp.asarray(d2n, flt)
    cmaskT = jnp.asarray(cmn, flt)
    amaskT = jnp.asarray(amn, flt)
    K = jnp.asarray(Kn, flt)
    rowsT = rows.T                                       # (A, M)

    def rvec(a3):
        # 3 x (A, M) locals -> 3 x (C, M) constraint diffs x_i - x_j
        return [jnp.einsum("cam,am->cm", D, comp, precision=MATMUL)
                for comp in a3]

    xo_l = [p[rowsT] for p in xs_old]
    ro = jnp.stack(_minimg_planes(*rvec(xo_l), L))       # (3, C, M)
    rn = jnp.stack(_minimg_planes(
        *rvec([p[rowsT] for p in xs_new]), L))           # (3, C, M)

    lam = jnp.zeros(d2T.shape, flt)
    for _ in range(min(int(sc.iters), 4)):
        F = (jnp.sum(rn * rn, 0) - d2T) * cmaskT
        # 4-index products as broadcast-multiply-reduce, NOT einsum: the
        # "xcm,xdm->cdm" contraction lowers to batched 3x3 dots whose
        # batch-minor transposes measured ~6.5 ms/iter at SPC/E scale
        B = jnp.sum(rn[:, :, None, :] * ro[:, None, :, :], 0)  # (C,D,M)
        dlam = _solve_small(2.0 * B * K, -F, cmaskT)
        lam = lam + dlam
        rn = rn + jnp.sum(K[None] * (dlam * ro)[:, None, :, :], 2)

    dx = jnp.sum(WT[None] * (lam[None] * ro)[:, :, None, :], 1) * amaskT
    flat_rows = rows.reshape(-1)                         # M-major
    x_fix, v_out = [], []
    for c in range(3):
        xf = xs_new[c].at[flat_rows].add(
            dx[c].T.reshape(-1), mode="drop")
        x_fix.append(xf)
        v_out.append(vs[c] + (xf - xs_new[c]) / dt)
    if return_r:
        # the solver's rn IS the corrected bond-vector set (tracked in
        # constraint space) — hand it to RATTLE so the velocity pass
        # skips its 3 position-plane gathers (scalar-bound, measured
        # ~2.2 ms/plane at SPC/E scale)
        if virial_factor is None:
            return tuple(x_fix), tuple(v_out), rn
    if virial_factor is None:
        return tuple(x_fix), tuple(v_out)
    wc = -lam * virial_factor * cmaskT                   # pair force on i
    if vweights is not None:
        wc = wc * vweights[jnp.asarray(cl.corig)].T.astype(flt)
    w = wc[None] * ro
    virial = jnp.stack([
        jnp.sum(ro[0] * w[0]), jnp.sum(ro[1] * w[1]), jnp.sum(ro[2] * w[2]),
        jnp.sum(ro[0] * w[1]), jnp.sum(ro[0] * w[2]), jnp.sum(ro[1] * w[2]),
    ])
    return tuple(x_fix), tuple(v_out), virial


def rattle_velocities_clustered(sc: ShakeConstraints, cl: ShakeClusters,
                                xs, vs, L, rows, iters: int = None,
                                r_pre=None):
    """Cluster-dense RATTLE in lanes-last layout (see _lanes_last).

    xs/vs: (x, y, z) / (vx, vy, vz) component-plane tuples; returns the
    corrected (vx, vy, vz) tuple.

    RATTLE's velocity projection is LINEAR in the multipliers — the
    (C, C) system (r_c.r_d) K_cd mu_d = -r_c.dv_c is solved EXACTLY per
    cluster in one shot (`iters` is accepted for signature compatibility
    and ignored; the old Jacobi form needed 20-30 sweeps for the same
    answer)."""
    del iters
    flt = vs[0].dtype
    Dn, WTn, d2n, cmn, imn, amn, Kn = _lanes_last(cl)
    D = jnp.asarray(Dn, flt)
    WT = jnp.asarray(WTn, flt)
    cmaskT = jnp.asarray(cmn, flt)
    amaskT = jnp.asarray(amn, flt)
    K = jnp.asarray(Kn, flt)
    rowsT = rows.T

    def rvec(a3):
        return [jnp.einsum("cam,am->cm", D, comp, precision=MATMUL)
                for comp in a3]

    r = (r_pre if r_pre is not None else
         jnp.stack(_minimg_planes(*rvec([p[rowsT] for p in xs]), L)))
    dv0 = jnp.stack(rvec([p[rowsT] for p in vs]))        # (3, C, M)
    B = jnp.sum(r[:, :, None, :] * r[:, None, :, :], 0)  # (C, D, M)
    mu = _solve_small(B * K, -jnp.sum(r * dv0, 0), cmaskT)
    dv = jnp.sum(WT[None] * (mu[None] * r)[:, :, None, :], 1) * amaskT
    flat_rows = rows.reshape(-1)
    return tuple(
        vs[c].at[flat_rows].add(dv[c].T.reshape(-1), mode="drop")
        for c in range(3))


def shake_virial_clustered(sc: ShakeConstraints, cl: ShakeClusters,
                           xs, vs, fs, ftm2v: float, L, rows,
                           vweights=None, acc_dtype=jnp.float64):
    """Cluster-dense form of shake_virial (same instantaneous-multiplier
    math; see shake_virial's docstring for the physics contract), in the
    lanes-last layout (_lanes_last).

    Unlike the scatter form, this is safe for shard-local layouts where
    absent clusters map past the end of the planes (slab halo rows): the
    clamped gather lands every absent-cluster atom on the SAME row, so
    r = 0 and the multiplier feedback stays exactly zero — the scatter
    form instead piles all absent constraints onto two shared dummy
    rows, whose artificial mega-cluster diverges (overflows f32 within
    the iteration budget, nan-poisoning the psum'd virial).

    xs/vs/fs: (x, y, z) component-plane tuples; rows: (M, A) row indices
    (pads/absent may be any value — clamped).  vweights: optional
    per-ORIGINAL-constraint tally weights, gathered through cl.corig
    (slab ownership).

    The instantaneous-multiplier system is LINEAR — solved exactly per
    cluster (_solve_small), replacing the old iteration sweeps.  Absent
    clusters (r = 0, base = 0) still yield exactly-zero multipliers: the
    guarded pivots give 0/eps = 0."""
    flt = xs[0].dtype
    Dn, WTn, d2n, cmn, imn, _amn, Kn = _lanes_last(cl)
    D = jnp.asarray(Dn, flt)
    cmaskT = jnp.asarray(cmn, flt)
    K = jnp.asarray(Kn, flt)
    # per-local-atom inverse masses from the static constraint list
    invm_a = np.where(cl.atoms >= 0,
                      np.asarray(sc.invm, np.float64)[np.maximum(
                          cl.atoms, 0)], 0.0)
    invm_aT = jnp.asarray(invm_a.T, flt)                 # (A, M)
    rowsT = rows.T

    def rvec(a3):
        return [jnp.einsum("cam,am->cm", D, comp, precision=MATMUL)
                for comp in a3]

    r = jnp.stack(_minimg_planes(*rvec([p[rowsT] for p in xs]), L))
    dv = jnp.stack(rvec([p[rowsT] for p in vs]))
    da0 = jnp.stack(rvec(
        [ftm2v * invm_aT * p[rowsT].astype(flt) for p in fs]))
    base = jnp.sum(dv * dv + r * da0, 0)
    B = jnp.sum(r[:, :, None, :] * r[:, None, :, :], 0)  # (C, D, M)
    lam = _solve_small(ftm2v * B * K, -base, cmaskT)
    wc = -lam * cmaskT
    if vweights is not None:
        wc = wc * vweights[jnp.asarray(cl.corig)].T.astype(flt)
    w = wc[None] * r                                     # pair force on i
    acc = acc_dtype
    return jnp.stack([
        jnp.sum((r[0] * w[0]).astype(acc)),
        jnp.sum((r[1] * w[1]).astype(acc)),
        jnp.sum((r[2] * w[2]).astype(acc)),
        jnp.sum((r[0] * w[1]).astype(acc)),
        jnp.sum((r[0] * w[2]).astype(acc)),
        jnp.sum((r[1] * w[2]).astype(acc)),
    ])


def rattle_velocities(sc: ShakeConstraints, x, v, L, iters: int = None,
                      pairs=None):
    """Project out velocity components along constraints."""
    i = jnp.asarray(sc.pairs[:, 0]) if pairs is None else pairs[:, 0]
    j = jnp.asarray(sc.pairs[:, 1]) if pairs is None else pairs[:, 1]
    d2 = jnp.asarray(sc.d2, x.dtype)
    mi = jnp.asarray(sc.invm[sc.pairs[:, 0]], x.dtype)[:, None]
    mj = jnp.asarray(sc.invm[sc.pairs[:, 1]], x.dtype)[:, None]
    r = _minimg_cols(x[i] - x[j], L)
    it = sc.iters if iters is None else iters
    omega = float(sc.omega)

    def body(k, vv):
        dv = vv[i] - vv[j]
        lam = jnp.sum(r * dv, axis=1) / (d2 * (mi[:, 0] + mj[:, 0]))
        corr = (omega * lam)[:, None] * r
        vv = vv.at[i].add(-mi * corr)
        vv = vv.at[j].add(mj * corr)
        return vv

    return jax.lax.fori_loop(0, it, body, v)


def max_violation(sc: ShakeConstraints, x, L):
    """Diagnostic: max |r^2/d^2 - 1| over constraints."""
    i = sc.pairs[:, 0]
    j = sc.pairs[:, 1]
    r = _minimg_cols(x[i] - x[j], L)
    rsq = jnp.sum(r * r, axis=1)
    return jnp.max(jnp.abs(rsq / jnp.asarray(sc.d2, x.dtype) - 1.0))


def make_rigid_from_molecules(
    x: np.ndarray,
    molecule: np.ndarray,
    mass_per_atom: np.ndarray,
    L,
    iters: int = 200,
    max_body: int = 16,
    omega: float = 0.25,
) -> ShakeConstraints:
    """``fix rigid/small molecule`` via redundant distance constraints.

    Every intra-molecular pair distance is frozen at the initial geometry;
    for a non-degenerate body this pins the rigid-body manifold exactly
    (same configuration space as quaternion rigid dynamics, integrated here
    by SHAKE/RATTLE).  Independent constraints per body: 3 n - 6 (n >= 3,
    non-collinear), so DOF = 6 per body, matching LAMMPS temperature
    bookkeeping.
    """
    x = np.asarray(x, np.float64)
    L = np.asarray(L, np.float64)
    mol = np.asarray(molecule)
    pairs = []
    d2 = []
    n_indep = 0
    for m in np.unique(mol):
        idx = np.nonzero(mol == m)[0]
        nb = len(idx)
        if nb < 2:
            continue
        if nb > max_body:
            raise ValueError(
                f"molecule {m} has {nb} atoms > max_body={max_body}; "
                "all-pair rigidification scales quadratically"
            )
        for a in range(nb):
            for b in range(a + 1, nb):
                i, j = idx[a], idx[b]
                d = x[i] - x[j]
                d -= np.round(d / L) * L
                pairs.append((i, j))
                d2.append(float(d @ d))
        n_indep += (1 if nb == 2 else max(3 * nb - 6, 1))
    return ShakeConstraints(
        pairs=np.asarray(pairs, np.int32),
        d2=np.asarray(d2, np.float64),
        invm=(1.0 / np.asarray(mass_per_atom, np.float64)),
        iters=iters,
        n_independent=n_indep,
        omega=omega,
    )
