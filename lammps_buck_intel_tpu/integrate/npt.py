"""Nose-Hoover NPT barostat with a TRACED simulation box.

Host-LAMMPS contract (SURVEY.md H7): ``fix npt temp T T Tdamp iso P P
Pdamp`` and the in.rhodo form ``fix npt temp 300 300 100 z 0 0 1000 mtk no
pchain 0 tchain 1`` (/root/reference/examples/in.rhodo:18-19).  The
integration follows fix_nh.cpp's operator splitting: thermostat chain ->
barostat omega update -> barostat velocity scale -> half kick -> drift +
box dilation -> forces -> half kick -> barostat scale -> omega -> chain.

Design: everywhere else in this framework the box is BAKED into the
compiled program (core/box.py).  NPT needs a variable cell, so this
runner threads the box lengths through jit as a traced (3,) ARGUMENT
(not a closed-over device array).  Pair,
bonded, and Ewald paths consume the traced lengths through
``core.box.axis_lengths`` / ``Ewald.compute_traced``; the neighbor-list
bin GEOMETRY stays static (sized at setup with headroom) while bin
assignment uses the traced box, matching LAMMPS' static neigh grid between
re-neighborings.  Pressure is evaluated every step from the per-axis
virial, so force passes always run with vflag.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.box import Box, make_box
from ..core.state import System
from ..core.units import Units, LJ
from ..core.precision import MATMUL, Precision, single
from ..neighbor.neighbor_list import make_spec, build
from ..models.pair import compute_pair
from ..models.pair.styles import PairStyle
from .verlet import NeighborPolicy
from .nvt import NVTConfig, NHChain, nhc_half
from .shake import (ShakeConstraints, make_clusters,
                    shake_positions_clustered, rattle_velocities_clustered)


@dataclasses.dataclass(frozen=True)
class NPTConfig:
    """fix npt parameters (temp handled by an embedded NVTConfig)."""

    p_start: tuple          # (3,) per-axis target at run start
    p_stop: tuple
    p_damp: float
    flags: tuple = (True, True, True)   # barostatted axes
    couple: str = "xyz"     # "xyz" (iso) | "none" (aniso / z-only)
    mtk: bool = True
    pchain: int = 0         # barostat thermostat chain length (host
    # LAMMPS defaults to 3; in.rhodo sets pchain 0)

    def __post_init__(self):
        if self.pchain < 0:
            raise ValueError("pchain must be >= 0")


class NPTState(NamedTuple):
    x: jnp.ndarray        # (N, 3) wrapped
    v: jnp.ndarray
    f: jnp.ndarray
    image: jnp.ndarray
    boxL: jnp.ndarray     # (3,) traced box lengths
    omega_dot: jnp.ndarray  # (3,) barostat strain rates
    therm: jnp.ndarray    # (2, M) NH chain
    virial: jnp.ndarray   # (6,) from the last force evaluation
    overflow: jnp.ndarray = None  # () bool — sticky neighbor overflow
    ptherm: jnp.ndarray = None    # (2, Mp) barostat NH chain (pchain)
    body: tuple = None            # rigid.BodyState (fix rigid/npt/small)


def nh_omega_dot_half(cfg: NPTConfig, u, n_atoms: int, dt: float,
                      omega_dot, mv2, vir3, V, t_target, p_target,
                      mv2_mtk=None):
    """Half-step barostat strain-rate update (fix_nh.cpp nh_omega_dot) —
    a pure function of psum-completed globals so the single-chip and
    slab engines share one copy.  mv2: (3,) per-axis sum m v_a^2 in
    energy units; vir3: virial diagonal; V: traced volume.

    mv2_mtk: kinetic term for the MTK correction when it differs from
    the pressure's — rigid bodies couple the cell to COM momenta only,
    so their MTK term uses sum_b M V_a^2 with n_atoms = nbody
    (fix rigid/npt/small), while the pressure keeps the full atomic
    mv2 + constraint virial (the molecular-pressure identity in
    rigid.constraint_virial)."""
    p_cur = (mv2 + vir3) / V * u.nktv2p
    flags = np.asarray(cfg.flags, bool)
    if cfg.couple == "xyz":
        pavg = jnp.mean(jnp.asarray(
            [p_cur[a] for a in range(3) if cfg.flags[a]]))
        p_cur = jnp.stack([pavg, pavg, pavg])
    nkt = (n_atoms + 1) * u.boltz * jnp.maximum(t_target, 1e-30)
    W = nkt * cfg.p_damp**2
    f_omega = (p_cur - jnp.asarray(p_target, p_cur.dtype)) * V \
        / (W * u.nktv2p)
    if cfg.mtk:
        # MTK kinetic term (nh_omega_dot mtk_term1): energy units,
        # so no nktv2p here
        pdim = max(int(flags.sum()), 1)
        mk = mv2 if mv2_mtk is None else mv2_mtk
        mtk1 = jnp.sum(jnp.where(jnp.asarray(flags), mk, 0.0)) \
            / (n_atoms * pdim)
        f_omega = f_omega + mtk1 / W
    f_omega = jnp.where(jnp.asarray(flags), f_omega, 0.0)
    return omega_dot + (0.5 * dt) * f_omega.astype(omega_dot.dtype)


def nh_press_vfac(cfg: NPTConfig, n_atoms: int, dt: float, omega_dot):
    """nh_v_press velocity factor exp(-dt/2 (omega_dot + mtk_term2)),
    (3,) — shared by both NPT engines.  For rigid bodies pass
    n_atoms = nbody (the factor scales COM velocities only)."""
    flags = np.asarray(cfg.flags, bool)
    if cfg.mtk:
        pdim = max(int(flags.sum()), 1)
        mtk2 = jnp.sum(jnp.where(jnp.asarray(flags), omega_dot, 0.0)) \
            / (pdim * n_atoms)
    else:
        mtk2 = 0.0
    return jnp.exp((-0.5 * dt) * jnp.where(
        jnp.asarray(flags), omega_dot + mtk2, 0.0))


def baro_chain_half(cfg: NPTConfig, u, n_atoms: int, dt: float,
                    omega_dot, ptherm, t_target):
    """Half-step of the barostat thermostat chain (fix_nh.cpp
    nhc_press_integrate): an NH chain coupled to the barostat kinetic
    energy sum_a W omega_dot_a^2, all chain masses kT p_damp^2
    (etap_mass), target pdim*kT.  Returns (new omega_dot, new ptherm).
    Shared by the single-chip and slab NPT engines (both keep the
    barostat state replicated)."""
    m = cfg.pchain
    flags = np.asarray(cfg.flags, bool)
    pdim = max(int(flags.sum()), 1)
    dt2, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt
    kt = u.boltz * jnp.maximum(t_target, 1e-30)
    W = (n_atoms + 1) * kt * cfg.p_damp ** 2
    q = kt * cfg.p_damp ** 2         # etap_mass, every link
    ke2 = jnp.sum(jnp.where(jnp.asarray(flags),
                            W * omega_dot * omega_dot, 0.0))
    eta, ed = ptherm[0], ptherm[1]

    # backward sweep (tail -> head), same ladder as nvt.nhc_half
    g = [None] * m
    g[0] = (ke2 - pdim * kt) / q
    for k in range(1, m):
        g[k] = (q * ed[k - 1] * ed[k - 1] - kt) / q
    ed = ed.at[m - 1].add(g[m - 1] * dt4)
    for k in range(m - 2, -1, -1):
        expf = jnp.exp(-dt8 * ed[k + 1])
        ed = ed.at[k].set((ed[k] * expf + g[k] * dt4) * expf)

    scale = jnp.exp(-dt2 * ed[0])
    od = jnp.where(jnp.asarray(flags), omega_dot * scale, omega_dot)
    ke2 = ke2 * scale * scale
    eta = eta + dt2 * ed

    # forward sweep with the scaled barostat kinetic energy
    g0 = (ke2 - pdim * kt) / q
    expf = jnp.exp(-dt8 * ed[1]) if m > 1 else 1.0
    ed = ed.at[0].set((ed[0] * expf + g0 * dt4) * expf)
    for k in range(1, m - 1):
        gk = (q * ed[k - 1] * ed[k - 1] - kt) / q
        expf = jnp.exp(-dt8 * ed[k + 1])
        ed = ed.at[k].set((ed[k] * expf + gk * dt4) * expf)
    if m > 1:
        gm = (q * ed[m - 2] * ed[m - 2] - kt) / q
        ed = ed.at[m - 1].add(gm * dt4)
    return od, jnp.stack([eta, ed])


class NPTSimulation:
    """Variable-cell MD driver (neighbor-list engine, capability tier).

    The box stays CENTERED on its initial center; lengths dilate per axis.
    ``fix shake`` couples through shake_positions/rattle under the traced
    box, with the constraint virial tallied into the barostat pressure
    (the in.rhodo:17-19 shake+npt combination)."""

    def __init__(
        self,
        system: System,
        pair: PairStyle,
        npt: NPTConfig,
        thermostat: NVTConfig,
        kspace=None,              # Ewald with mvecs (compute_traced)
        bonded=None,
        units: Units = LJ,
        precision: Precision = None,
        dt: Optional[float] = None,
        neighbor: Optional[NeighborPolicy] = None,
        box_headroom: float = 1.10,
        shake: Optional[ShakeConstraints] = None,
        topology=None,   # core Topology: special-bond exclusion source
        rigid=None,      # rigid.RigidBodies (fix rigid/npt/small)
        exclude_intra: bool = False,  # same-molecule pair exclusion
    ):
        self.units = units
        self.precision = precision or single()
        self.dt = units.dt if dt is None else dt
        self.pair = pair
        self.kspace = kspace
        self.bonded = bonded if (bonded is not None
                                 and bonded.has_terms) else None
        self.neighbor = neighbor or NeighborPolicy(skin=units.skin)
        self.npt = npt
        n = system.n_atoms
        self.n_atoms = n
        flt = self.precision.flt

        box0 = system.box
        L0 = np.asarray(box0.lengths, np.float64)
        self._center = np.asarray(box0.lo) + 0.5 * L0
        self._L0 = L0
        self._headroom = float(box_headroom)
        # triclinic: tilts DERIVE from the traced lengths via the LAMMPS
        # scale rules (fix_nh scalexy/scalexz/scaleyz default yes: xy
        # scales with ly, xz and yz with lz), so box vectors scale
        # uniformly by their axis factor and the dilation map
        # M = h0 diag(s) h0^-1 is constant in time (diagonals commute)
        self._tilt0 = (np.asarray(box0.tilt, np.float64)
                       if getattr(box0, "is_triclinic", False) else None)
        if self._tilt0 is not None:
            if rigid is not None:
                raise NotImplementedError(
                    "fix rigid/npt/small on a triclinic box (body COM "
                    "dynamics under the tilted dilation map; fix npt + "
                    "shake runs tilted via the traced-tilt min image)")
            self._h0 = np.asarray(box0.h_matrix, np.float64)
            self._h0_inv = np.asarray(box0.h_inv, np.float64)
        # static bin geometry sized for a box GROWN by `box_headroom`:
        # bins only get larger if the box shrinks; cell size >= cutneigh
        # must hold for the smallest box reached, so size the count from
        # the initial box and validate at rebuilds (overflow flag).
        # (tilted cells: the perpendicular widths bound the cutoff, and
        # they scale exactly per axis under the vector-scaled dilation)
        cutneigh = float(np.sqrt(pair.cutsq_max)) + self.neighbor.skin
        pw = (np.asarray(box0.perp_widths, np.float64)
              if self._tilt0 is not None else None)
        self.spec = make_spec(n, L0, cutneigh * box_headroom,
                              perp_widths=pw)
        # right-size the per-atom capacity from the OBSERVED neighbor
        # counts (inhomogeneous systems exceed the mean-density estimate;
        # the grow loop is the get_max_nbors retry, SURVEY.md §5.3) —
        # the spec then stays static for the whole run
        from ..neighbor.neighbor_list import build_with_retry as _bwr

        self.typ = np.asarray(jax.device_get(system.type), np.int32)
        self.q = np.asarray(jax.device_get(system.q), np.float64)
        # kept for IO: write_data/checkpoint read sim.topology (bonds/
        # angles sections would silently vanish from NPT decks otherwise)
        self.topology = topology
        if topology is not None and topology.special_idx.shape[1] > 0:
            self.special_idx = topology.special_idx
            self.special_code = topology.special_code
        else:
            self.special_idx = np.zeros((n, 0), np.int32)
            self.special_code = np.zeros((n, 0), np.int8)
        self._mol = None
        if exclude_intra:
            self._mol = np.asarray(jax.device_get(system.molecule),
                                   np.int32)
        mass = np.asarray(jax.device_get(system.mass), np.float64)
        self._mass_col = mass[self.typ][:, None].astype(np.dtype(flt))
        self.dtf = float(0.5 * self.dt * units.ftm2v)
        self.dtv = float(self.dt)

        self.shake = shake
        self.rigid = rigid
        if rigid is not None and shake is not None:
            raise ValueError(
                "fix rigid/npt/small and fix shake are exclusive")
        self._shake_cl = make_clusters(shake) if shake is not None else None
        self._shake_rows = (jnp.asarray(self._shake_cl.rows_np(0))
                            if shake is not None else None)
        t_dof = 3 * n - 3
        if shake is not None:
            t_dof -= shake.n_constraints
        if rigid is not None:
            t_dof -= rigid.n_constraints
        t_dof = max(t_dof, 1)
        self.thermostat = dataclasses.replace(
            thermostat, dof=t_dof, boltz=units.boltz, mvv2e=units.mvv2e,
            dt=self.dt)
        self._tchain = self.thermostat.tchain

        x0 = jnp.asarray(jax.device_get(system.x), flt)
        v0 = jnp.asarray(jax.device_get(system.v), flt)
        im0 = jnp.asarray(jax.device_get(system.image), jnp.int32)
        boxL = jnp.asarray(L0, flt)
        st = NPTState(
            x=x0, v=v0, f=jnp.zeros_like(x0), image=im0, boxL=boxL,
            omega_dot=jnp.zeros((3,), flt),
            therm=jnp.zeros((2, self._tchain), flt),
            virial=jnp.zeros((6,), self.precision.acc),
            overflow=jnp.zeros((), bool),
            ptherm=jnp.zeros((2, npt.pchain), flt),
        )
        if shake is not None:
            # settle onto the constraint manifold (verlet.py settle analog)
            x3 = tuple(st.x[:, c] for c in range(3))
            v3 = tuple(st.v[:, c] for c in range(3))
            L0s = self._shake_L(L0)
            xs, _ = shake_positions_clustered(
                shake, self._shake_cl, x3, x3, v3, 1.0, L0s,
                self._shake_rows)
            vs = rattle_velocities_clustered(
                shake, self._shake_cl, xs, v3, L0s, self._shake_rows)
            st = st._replace(x=jnp.stack(xs, -1), v=jnp.stack(vs, -1))
        if rigid is not None:
            # project onto rigid motion (the settle analog): positions/
            # velocities DERIVE from the body state from here on
            from .rigid import (init_body_state, atom_positions,
                                atom_velocities)

            bs = init_body_state(rigid, v0, dtype=flt)
            xa, d0 = atom_positions(rigid, bs)
            va = atom_velocities(rigid, bs, d0)
            st = st._replace(x=xa.astype(flt), v=va.astype(flt), body=bs)
        _, self.spec = _bwr(
            st.x, box0, self.spec,
            jnp.asarray(self.special_idx)
            if self.special_idx.shape[1] > 0 else None,
            jnp.asarray(self.special_code)
            if self.special_idx.shape[1] > 0 else None,
            None if self._mol is None else jnp.asarray(self._mol))
        self._nl = None
        self.state = jax.jit(self._init_forces)(st)
        self.step_count = 0
        self._block_fns: dict = {}
        self.timings = {"run": 0.0}
        self._thermo_jit = jax.jit(self._thermo_device)

    # ---------- box helpers ----------

    def _tilt_of(self, boxL):
        """Traced (3,) [xy, xz, yz] derived from the traced lengths
        (LAMMPS scale rules: xy ~ ly, xz ~ lz, yz ~ lz); None when
        orthogonal."""
        if self._tilt0 is None:
            return None
        t = jnp.asarray(self._tilt0, boxL.dtype)
        s = boxL / jnp.asarray(self._L0, boxL.dtype)
        return jnp.stack([t[0] * s[1], t[1] * s[2], t[2] * s[2]])

    def _traced_box(self, boxL) -> Box:
        c = jnp.asarray(self._center, boxL.dtype)
        return Box(lo=c - 0.5 * boxL, hi=c + 0.5 * boxL,
                   periodic=np.array([True, True, True]),
                   tilt=self._tilt_of(boxL))

    def _shake_L(self, boxL):
        """Constraint min-image geometry: the traced lengths when
        orthogonal, the (lx, ly, lz, xy, xz, yz) 6-tuple (tilts derived
        by the scale rules) when tilted — shake._minimg_planes contract."""
        if self._tilt0 is None:
            return boxL
        t = self._tilt_of(jnp.asarray(boxL))
        return (boxL[0], boxL[1], boxL[2], t[0], t[1], t[2])

    # ---------- forces ----------

    def _build_nl(self, x, boxL):
        box = self._traced_box(boxL)
        return build(x, box, self.spec, self.special_idx,
                     self.special_code, mol=self._mol)

    def _forces(self, x, boxL, nl, kc=None, eflag=False):
        """Returns (f, virial) — or (f, virial, energies) with
        eflag=True, where energies = (evdwl, ecoul, elong, emol); the
        thermo pass uses it so NPT rows carry the LAMMPS energy ledger."""
        box = self._traced_box(boxL)
        acc = self.precision.acc
        pr = compute_pair(
            self.pair, x, self.typ, self.q, box, nl._replace(
                nnei=None, x0=None, overflow=None),
            eflag=eflag, vflag=True, acc_dtype=self.precision.acc,
            use_special=nl.sb.shape[1] > 0,
        )
        f, virial = pr.f, pr.virial
        evdwl = pr.evdwl if eflag else jnp.zeros((), acc)
        ecoul = pr.ecoul if eflag else jnp.zeros((), acc)
        elong = jnp.zeros((), acc)
        emol = jnp.zeros((), acc)
        if self.kspace is not None:
            kw = {"kc": kc} if kc is not None else {}
            if self._tilt0 is not None:
                kw["tilt"] = self._tilt_of(boxL)
            kr = self.kspace.compute_traced(
                x, jnp.asarray(self.q, x.dtype), boxL,
                eflag=eflag, vflag=True, **kw)
            f = f + kr.f
            virial = virial + kr.virial
            if eflag:
                elong = kr.elong
        if self.bonded is not None:
            from ..models.bonded import compute_bonded

            br = compute_bonded(self.bonded, x, box, eflag=eflag,
                                acc_dtype=self.precision.acc)
            f = f + br.f
            virial = virial + br.virial
            if eflag:
                emol = br.emol
                if br.e14_lj is not None:
                    evdwl = evdwl + br.e14_lj
                    ecoul = ecoul + br.e14_coul
        if eflag:
            return f.astype(x.dtype), virial, (evdwl, ecoul, elong, emol)
        return f.astype(x.dtype), virial

    def _init_forces(self, st: NPTState) -> NPTState:
        nl = self._build_nl(st.x, st.boxL)
        f, virial = self._forces(st.x, st.boxL, nl, kc=self._kspace_kc(st))
        if self.rigid is not None:
            from .rigid import atom_positions, constraint_virial

            _, d = atom_positions(self.rigid, st.body)
            virial = virial + constraint_virial(
                self.rigid, st.body, d, f, self.units.ftm2v,
                self.precision.acc)
        return st._replace(f=f, virial=virial,
                           overflow=st.overflow | nl.overflow)

    def _kspace_kc(self, st: NPTState):
        """Box-baked kspace tables rebuilt from the traced box — the
        PPPM::setup()-on-box-change contract (TracedPPPM.tables), invoked
        once per cadence block, not per step."""
        if self.kspace is not None and hasattr(self.kspace, "tables"):
            if self._tilt0 is not None:
                # traced-h PPPM: tilts derive from the traced lengths
                return self.kspace.tables(st.boxL,
                                          tilt=self._tilt_of(st.boxL))
            return self.kspace.tables(st.boxL)
        return None

    # ---------- NPT step ----------

    def _press_current(self, st: NPTState):
        """Per-axis pressure (sum m v_a^2 + W_aa) / V * nktv2p."""
        u = self.units
        acc = self.precision.acc
        mv2 = jnp.stack([
            jnp.sum((self._mass_col[:, 0] * st.v[:, a] * st.v[:, a])
                    .astype(acc)) for a in range(3)
        ]) * u.mvv2e
        V = (st.boxL[0] * st.boxL[1] * st.boxL[2]).astype(acc)
        p = (mv2 + st.virial[:3]) / V * u.nktv2p
        return p, mv2, V

    def _omega_dot_half(self, st, p_target, t_target):
        _, mv2, V = self._press_current(st)
        od = nh_omega_dot_half(self.npt, self.units, self.n_atoms,
                               self.dt, st.omega_dot, mv2, st.virial[:3],
                               V, t_target, p_target)
        return st._replace(omega_dot=od)

    # ---------- rigid-body NPT (fix rigid/npt/small) ----------

    def _mv2_trans(self, bs):
        """(3,) per-axis sum_b M_b V_a^2 (energy units) — the COM kinetic
        term the rigid barostat's MTK correction uses (only COM momenta
        couple to the cell)."""
        acc = self.precision.acc
        M = jnp.asarray(np.asarray(self.rigid.mtotal), acc)
        return jnp.stack([
            jnp.sum(M * bs.V[:, a].astype(acc) * bs.V[:, a].astype(acc))
            for a in range(3)]) * self.units.mvv2e

    def _omega_dot_half_rigid(self, st, p_target, t_target):
        """Pressure from the full atomic mv2 + virial (incl. the rigid
        constraint virial — the molecular-pressure identity), MTK terms
        from COM momenta with nbody DOFs."""
        _, mv2, V = self._press_current(st)
        od = nh_omega_dot_half(self.npt, self.units, self.rigid.nbody,
                               self.dt, st.omega_dot, mv2, st.virial[:3],
                               V, t_target, p_target,
                               mv2_mtk=self._mv2_trans(st.body))
        return st._replace(omega_dot=od)

    def _one_step_rigid(self, st: NPTState, t_target, p_target):
        """fix rigid/npt/small: the NPT operator splitting of _one_step
        with body-state integration (integrate/rigid.py) — the barostat
        dilates body COMs about the box center and scales COM velocities
        only; the thermostat scales both V and L (atomic KE == body KE).
        Host contract: LAMMPS couples rigid bodies and a barostat through
        the dedicated fix rigid/npt/small (fix_rigid_nh), never by
        stacking plain fix npt on rigid atoms."""
        from .rigid import (atom_positions, atom_velocities,
                            initial_integrate_rigid, final_integrate_rigid,
                            constraint_virial)

        cfg = self.thermostat
        rg = self.rigid
        dtf, dtv = self.dtf, self.dtv
        nb = rg.nbody
        if self.npt.pchain:
            od, pt = baro_chain_half(self.npt, self.units, nb,
                                     self.dt, st.omega_dot, st.ptherm,
                                     t_target)
            st = st._replace(omega_dot=od, ptherm=pt)
        # thermostat half: scale V and L; st.v scales linearly with both
        chain = NHChain(eta=st.therm[0], eta_dot=st.therm[1])
        scale, chain = nhc_half(cfg, chain, st.v, self._mass_col, t_target)
        bs = st.body._replace(V=st.body.V * scale, L=st.body.L * scale)
        st = st._replace(v=st.v * scale, body=bs,
                         therm=jnp.stack([chain.eta, chain.eta_dot]))
        # barostat half
        st = self._omega_dot_half_rigid(st, p_target, t_target)
        # barostat velocity scale: COM velocities only
        fac = nh_press_vfac(self.npt, nb, self.dt, st.omega_dot)
        bs = st.body._replace(V=st.body.V * fac[None, :])
        # rigid half kick + drift
        _, d = atom_positions(rg, bs)
        bs = initial_integrate_rigid(rg, bs, st.f, d, dtv, dtf)
        # COM + box dilation about the fixed center
        flags = jnp.asarray(np.asarray(self.npt.flags, bool))
        s = jnp.exp(dtv * jnp.where(flags, st.omega_dot, 0.0))
        c = jnp.asarray(self._center, bs.X.dtype)
        bs = bs._replace(X=c + (bs.X - c) * s[None, :])
        boxL = st.boxL * s
        # forces at the new configuration
        xa, d2 = atom_positions(rg, bs)
        xa = xa.astype(st.x.dtype)
        nl = self._nl_carried
        f, virial = self._forces(xa, boxL, nl, kc=self._kc_carried)
        # rigid final kick, then barostat COM-velocity scale
        bs = final_integrate_rigid(rg, bs, f, d2, dtf)
        cvir = constraint_virial(rg, bs, d2, f, self.units.ftm2v,
                                 self.precision.acc)
        fac = nh_press_vfac(self.npt, nb, self.dt, st.omega_dot)
        bs = bs._replace(V=bs.V * fac[None, :])
        va = atom_velocities(rg, bs, d2).astype(st.v.dtype)
        st = st._replace(x=xa, v=va, f=f, virial=virial + cvir,
                         boxL=boxL, body=bs)
        st = self._omega_dot_half_rigid(st, p_target, t_target)
        # thermostat half
        chain = NHChain(eta=st.therm[0], eta_dot=st.therm[1])
        scale, chain = nhc_half(cfg, chain, st.v, self._mass_col, t_target)
        bs = st.body._replace(V=st.body.V * scale, L=st.body.L * scale)
        st = st._replace(v=st.v * scale, body=bs,
                         therm=jnp.stack([chain.eta, chain.eta_dot]))
        if self.npt.pchain:
            od, pt = baro_chain_half(self.npt, self.units, nb,
                                     self.dt, st.omega_dot, st.ptherm,
                                     t_target)
            st = st._replace(omega_dot=od, ptherm=pt)
        return st

    def _press_vscale(self, st):
        """nh_v_press: v *= exp(-dt/2 (omega_dot + mtk_term2)) per axis."""
        fac = nh_press_vfac(self.npt, self.n_atoms, self.dt, st.omega_dot)
        return st._replace(v=st.v * fac[None, :])

    def _one_step(self, st: NPTState, t_target, p_target):
        cfg = self.thermostat
        dtf, dtv = self.dtf, self.dtv
        # barostat thermostat chain first (fix_nh initial_integrate order:
        # nhc_press_integrate -> nhc_temp_integrate -> nh_omega_dot)
        if self.npt.pchain:
            od, pt = baro_chain_half(self.npt, self.units, self.n_atoms,
                                     self.dt, st.omega_dot, st.ptherm,
                                     t_target)
            st = st._replace(omega_dot=od, ptherm=pt)
        # thermostat half
        chain = NHChain(eta=st.therm[0], eta_dot=st.therm[1])
        scale, chain = nhc_half(cfg, chain, st.v, self._mass_col, t_target)
        st = st._replace(v=st.v * scale,
                         therm=jnp.stack([chain.eta, chain.eta_dot]))
        # barostat half
        st = self._omega_dot_half(st, p_target, t_target)
        st = self._press_vscale(st)
        # kick half
        minv = 1.0 / self._mass_col
        st = st._replace(v=st.v + (dtf * minv) * st.f)
        # drift + dilation about the fixed center
        x_ref = st.x   # pre-step positions: SHAKE reference directions
        x = st.x + dtv * st.v
        flags = jnp.asarray(np.asarray(self.npt.flags, bool))
        s = jnp.exp(dtv * jnp.where(flags, st.omega_dot, 0.0))
        c = jnp.asarray(self._center, x.dtype)
        if self._tilt0 is not None:
            # lamda-invariant dilation of a tilted cell: box VECTORS
            # scale by their axis factor (h' = h0 diag(cum*s)), so
            # x' = c + M (x - c) with M = h0 diag(s) h0^-1
            M = jnp.matmul(jnp.asarray(self._h0, x.dtype) * s[None, :],
                           jnp.asarray(self._h0_inv, x.dtype),
                           precision=MATMUL)
            x = c + jnp.matmul(x - c, M.T, precision=MATMUL)
        else:
            x = c + (x - c) * s[None, :]
        boxL = st.boxL * s
        vir_c = 0.0
        if self.shake is not None:
            x3, v3, vir_c = shake_positions_clustered(
                self.shake, self._shake_cl,
                tuple(x_ref[:, c2] for c2 in range(3)),
                tuple(x[:, c2] for c2 in range(3)),
                tuple(st.v[:, c2] for c2 in range(3)),
                dtv, self._shake_L(boxL), self._shake_rows,
                virial_factor=1.0 / (dtv * dtf))
            x = jnp.stack(x3, -1)
            st = st._replace(v=jnp.stack(v3, -1))
        st = st._replace(x=x, boxL=boxL)
        # forces at the new configuration
        nl = self._nl_carried
        f, virial = self._forces(st.x, st.boxL, nl, kc=self._kc_carried)
        st = st._replace(f=f, virial=virial + vir_c)
        # kick half + barostat + thermostat
        st = st._replace(v=st.v + (dtf * minv) * st.f)
        if self.shake is not None:
            st = st._replace(v=jnp.stack(rattle_velocities_clustered(
                self.shake, self._shake_cl,
                tuple(st.x[:, c2] for c2 in range(3)),
                tuple(st.v[:, c2] for c2 in range(3)),
                self._shake_L(st.boxL), self._shake_rows), -1))
        st = self._press_vscale(st)
        st = self._omega_dot_half(st, p_target, t_target)
        chain = NHChain(eta=st.therm[0], eta_dot=st.therm[1])
        scale, chain = nhc_half(cfg, chain, st.v, self._mass_col, t_target)
        st = st._replace(v=st.v * scale,
                         therm=jnp.stack([chain.eta, chain.eta_dot]))
        # barostat chain last (mirror of the initial-integrate order)
        if self.npt.pchain:
            od, pt = baro_chain_half(self.npt, self.units, self.n_atoms,
                                     self.dt, st.omega_dot, st.ptherm,
                                     t_target)
            st = st._replace(omega_dot=od, ptherm=pt)
        return st

    def _block(self, st: NPTState, nsteps: int, t_target,
               p_target) -> NPTState:
        """Rebuild + nsteps with the stale list (skin bound)."""
        from ..core.box import wrap

        if self.rigid is None:
            box = self._traced_box(st.boxL)
            xw, im = wrap(st.x, st.image, box)
            st = st._replace(x=xw, image=im)
        # rigid: positions derive from UNWRAPPED body COMs (the binning
        # folds lamda; the pair kernel min-images) — same stance as
        # verlet._block_rigid
        nl = self._build_nl(st.x, st.boxL)
        st = st._replace(overflow=st.overflow | nl.overflow)
        self._nl_carried = nl
        # kspace setup-on-box-change at reneighbor cadence (host LAMMPS
        # re-setups PPPM when the box changes; TracedPPPM rebuilds its
        # influence function here, traced, once per block)
        self._kc_carried = self._kspace_kc(st)
        step = (self._one_step_rigid if self.rigid is not None
                else self._one_step)

        def body(s, _):
            return step(s, t_target, p_target), None

        st, _ = jax.lax.scan(body, st, None, length=nsteps)
        return st

    def _block_fn(self, size: int):
        # (t_target, p_target) are TRACED arguments: ramps re-dispatch per
        # cadence block without recompiling (one program per block size).
        # The frozen config dataclasses join the key so swapping sim.npt /
        # sim.thermostat mid-run (structural flags are baked at trace
        # time) correctly retraces.
        key = (size, self.npt, self.thermostat)
        fn = self._block_fns.get(key)
        if fn is None:
            fn = jax.jit(lambda s, tt, pt: self._block(s, size, tt, pt))
            self._block_fns[key] = fn
        return fn

    # ---------- thermo ----------

    def _thermo_device(self, st: NPTState) -> dict:
        u = self.units
        acc = self.precision.acc
        p_cur, mv2, V = self._press_current(st)
        sum_mv2 = jnp.sum(mv2)
        dof = 3 * self.n_atoms - 3
        if self.shake is not None:
            dof -= self.shake.n_constraints
        if self.rigid is not None:
            dof -= self.rigid.n_constraints
        dof = max(dof, 1)
        temp = sum_mv2 / (dof * u.boltz)
        ke = 0.5 * sum_mv2
        press = (sum_mv2 + st.virial[0] + st.virial[1] + st.virial[2]) \
            / (3.0 * V) * u.nktv2p
        # energy ledger at thermo cadence (the LAMMPS thermo contract —
        # in.rhodo prints PotEng/E_pair under fix npt)
        nl = self._build_nl(st.x, st.boxL)
        _, _, (evdwl, ecoul, elong, emol) = self._forces(
            st.x, st.boxL, nl, kc=self._kspace_kc(st), eflag=True)
        epair = evdwl + ecoul + elong
        return dict(temp=temp, ke=ke, press=press, p_axis=p_cur,
                    boxL=st.boxL, vol=V, omega_dot=st.omega_dot,
                    evdwl=evdwl, ecoul=ecoul, elong=elong, emol=emol,
                    epair=epair, etotal=epair + emol + ke,
                    overflow=st.overflow)

    def thermo(self) -> dict:
        row = jax.device_get(self._thermo_jit(self.state))
        out = {k: (float(v) if np.ndim(v) == 0 else np.asarray(v))
               for k, v in row.items()}
        out["step"] = self.step_count
        out["overflow"] = bool(row["overflow"])
        # overflow first: dropped pairs CAUSE the non-finite dynamics, so
        # report the cause, not the symptom
        if out["overflow"]:
            raise RuntimeError(
                "NPT neighbor overflow: per-atom neighbor count exceeded "
                "the capacity sized from the initial density — compression "
                "outgrew the spec; restart from the compressed state or "
                "raise box_headroom")
        # the static bin geometry is valid only down to 1/box_headroom
        # shrinkage per axis (see __init__): past that the 27-stencil no
        # longer covers cutoff+skin and pairs would be silently dropped
        shrink = np.asarray(out["boxL"]) / self._L0
        if float(shrink.min()) < 1.0 / self._headroom - 1e-9:
            raise RuntimeError(
                f"box shrank to {shrink.min():.3f} of its initial length, "
                f"beyond the bin-geometry bound 1/{self._headroom}; "
                "rebuild the simulation from the compressed state")
        if not np.isfinite(out["temp"]) or not np.isfinite(out["press"]):
            raise RuntimeError(f"non-finite thermo at step {out['step']}")
        return out

    # ---------- IO ----------

    def get_atoms(self) -> dict:
        """Atom-ordered snapshot (host numpy), incl. the current box."""
        st = self.state
        out = jax.device_get(dict(x=st.x, v=st.v, f=st.f, image=st.image,
                                  boxL=st.boxL))
        out = {k: np.asarray(v) for k, v in out.items()}
        out["typ"] = self.typ
        out["q"] = self.q
        return out

    @property
    def current_box(self) -> Box:
        L = np.asarray(jax.device_get(self.state.boxL), np.float64)
        tilt = None
        if self._tilt0 is not None:
            sc = L / self._L0
            tilt = np.array([self._tilt0[0] * sc[1],
                             self._tilt0[1] * sc[2],
                             self._tilt0[2] * sc[2]])
        return make_box(self._center - 0.5 * L, self._center + 0.5 * L,
                        tilt=tilt)

    @property
    def box(self) -> Box:
        """Host Box snapshot at the CURRENT (dilated) lengths — the IO
        contract (dump/write_data/checkpoint read sim.box)."""
        return self.current_box

    # ---------- main loop ----------

    def run(self, nsteps: int, thermo_every: int = 0, log: bool = True):
        rows = []

        def emit():
            row = self.thermo()
            rows.append(row)
            if log:
                L = row["boxL"]
                print(f"{row['step']:>8d} T={row['temp']:.4g} "
                      f"E={row['etotal']:.8g} "
                      f"P={row['press']:.6g} V={row['vol']:.6g} "
                      f"L=({L[0]:.4f},{L[1]:.4f},{L[2]:.4f})")

        t0 = time.perf_counter()
        # config swapped mid-run (tests do sim.npt = NPTConfig(...)):
        # re-seed the barostat chain if its length changed
        if (self.state.ptherm is None
                or self.state.ptherm.shape[1] != self.npt.pchain):
            self.state = self.state._replace(ptherm=jnp.zeros(
                (2, self.npt.pchain), self.precision.flt))
        if thermo_every:
            emit()
        cfg = self.thermostat
        npt = self.npt
        done = 0
        cadence = max(1, self.neighbor.every)
        while done < nsteps:
            target = min(nsteps, done + (thermo_every or nsteps))
            while done < target:
                size = min(cadence, target - done)
                # segment-END evaluation: LAMMPS ramps reach t_stop/p_stop
                # on the final step (matches verlet.py's _t_target contract)
                frac = (done + size) / max(nsteps, 1)
                flt = self.precision.flt
                tt = jnp.asarray(
                    cfg.t_start + (cfg.t_stop - cfg.t_start) * frac, flt)
                pt = jnp.asarray(
                    np.asarray(npt.p_start)
                    + (np.asarray(npt.p_stop)
                       - np.asarray(npt.p_start)) * frac, flt)
                self.state = self._block_fn(size)(self.state, tt, pt)
                done += size
                self.step_count += size
            if thermo_every:
                emit()
        if not thermo_every:
            jax.block_until_ready(self.state)
        # guards must fire even with thermo_every=0 (advisor r2): cheap
        # scalar device_gets of the sticky overflow flag + shrink ratio
        if bool(jax.device_get(self.state.overflow)):
            raise RuntimeError(
                "NPT neighbor overflow: per-atom neighbor count exceeded "
                "the capacity sized from the initial density — compression "
                "outgrew the spec; restart from the compressed state or "
                "raise box_headroom")
        shrink = np.asarray(jax.device_get(self.state.boxL)) / self._L0
        if float(shrink.min()) < 1.0 / self._headroom - 1e-9:
            raise RuntimeError(
                f"box shrank to {shrink.min():.3f} of its initial length, "
                f"beyond the bin-geometry bound 1/{self._headroom}; "
                "rebuild the simulation from the compressed state")
        self.timings["run"] += time.perf_counter() - t0
        return rows
