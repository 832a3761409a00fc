"""Verlet run loop — the L5 orchestration layer (SURVEY.md §3.1).

Replaces host-LAMMPS ``Verlet::run`` + ``Modify`` fix scheduling with a
**fully device-resident** loop: neighbor rebuilds are jit-inlined into the
step chunks (fixed shapes make the cell-list build just another XLA
program), so whole thermo intervals run as a handful of dispatches with zero
host synchronisation; the design fetches exactly one scalar pytree per
thermo row.

``neigh_modify delay/every/check`` semantics (examples/in.buck:26,
in.spce:28) map to a rebuild cadence in steps; with ``check yes`` the
cadence is chosen adaptively from a conservative displacement bound
(2*vmax*dt*steps <= skin, re-planned at every thermo fetch) instead of a
per-step host check.  We may rebuild *more* often than LAMMPS would —
always correct, never missed.  Neighbor overflow is accumulated on device
and surfaced at thermo fetches (the offload overflow-flag analog,
SURVEY.md §5.3).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.box import Box, wrap
from ..core.state import System, Topology
from ..core.units import Units, LJ
from ..core.precision import Precision, single
from ..neighbor import neighbor_list as nlmod
from ..models.pair.driver import compute_pair
from ..models.pair.styles import PairStyle
from .nve import (
    make_nve, initial_integrate, final_integrate,
    initial_integrate_comp, final_integrate_comp,
)
from .nvt import NVTConfig, NHChain, init_chain, nhc_half, chain_energy
from .shake import (
    ShakeConstraints, make_clusters,
    shake_positions_clustered, rattle_velocities_clustered,
)


class MDState(NamedTuple):
    x: jnp.ndarray
    v: jnp.ndarray
    image: jnp.ndarray
    f: jnp.ndarray
    overflow: jnp.ndarray  # () bool — any neighbor overflow since last fetch
    therm: jnp.ndarray     # (2, M) Nose-Hoover chain state ((2,0) when NVE)
    # two-float compensation planes for x/v (None unless the precision
    # policy is compensated — integrate/nve.py two_sum_acc)
    cx: jnp.ndarray = None
    cv: jnp.ndarray = None
    # rigid-body state (integrate/rigid.py BodyState; None unless fix
    # rigid/small is active).  x/v are then DERIVED per block for
    # neighbor/force/thermo use; body is the integrated truth.
    body: object = None


class Forces(NamedTuple):
    f: jnp.ndarray
    evdwl: jnp.ndarray
    ecoul: jnp.ndarray
    elong: jnp.ndarray
    ebond: jnp.ndarray
    eangle: jnp.ndarray
    virial: jnp.ndarray
    emol_extra: jnp.ndarray = None   # dihedral + improper energies


@dataclasses.dataclass
class NeighborPolicy:
    """``neighbor <skin> bin`` + ``neigh_modify`` knobs."""

    skin: float
    every: int = 1
    delay: int = 0
    check: bool = True


class Simulation:
    """Single-device MD driver: pair (+ kspace) forces + velocity-Verlet."""

    def __init__(
        self,
        system: System,
        pair: PairStyle,
        topology: Optional[Topology] = None,
        kspace=None,
        bonded=None,
        units: Units = LJ,
        precision: Precision = None,
        dt: Optional[float] = None,
        neighbor: Optional[NeighborPolicy] = None,
        kmax: Optional[int] = None,
        dense: Optional[bool] = None,
        exclude_intra: bool = False,
        thermostat: Optional[NVTConfig] = None,
        shake: Optional[ShakeConstraints] = None,
        rigid=None,   # integrate/rigid.py RigidBodies (fix rigid/small)
    ):
        self.units = units
        self.precision = precision or single()
        self.dt = units.dt if dt is None else dt
        self.pair = pair
        self.kspace = kspace
        self.bonded = bonded
        self.system = system
        self.topology = topology
        self.neighbor = neighbor or NeighborPolicy(skin=units.skin)

        n = system.n_atoms
        self.n_atoms = n
        flt = self.precision.flt
        # Per-atom constants are HOST numpy: they are closed over by jitted
        # step functions, and closed-over device arrays poison XLA codegen
        # on this runtime (core/box.py note).
        self.typ = np.asarray(jax.device_get(system.type), np.int32)
        self.q = np.asarray(jax.device_get(system.q), np.dtype(flt))
        self.box = system.box
        # fix rigid/small runs tilted too: bodies assemble through the
        # triclinic host min image (rigid._minimg_host), positions stay
        # unwrapped (lamda-fold binning + triclinic pair min image)
        self.mass_per_atom = np.asarray(
            jax.device_get(system.mass), np.float64
        )[self.typ]

        if topology is not None and topology.special_idx.shape[1] > 0:
            self.special_idx = topology.special_idx
            self.special_code = topology.special_code
        else:
            self.special_idx = np.zeros((n, 0), np.int32)
            self.special_code = np.zeros((n, 0), np.int8)

        self._mol = None
        if exclude_intra:
            self._mol = np.asarray(jax.device_get(system.molecule), np.int32)

        cutneigh = float(np.sqrt(pair.cutsq_max)) + self.neighbor.skin
        L = np.asarray(self.box.lengths)
        pw = (np.asarray(self.box.perp_widths)
              if getattr(self.box, "is_triclinic", False) else None)
        self.spec = nlmod.make_spec(n, L, cutneigh, kmax=kmax, dense=dense,
                                    perp_widths=pw)
        self.nve = make_nve(self.dt, units.ftm2v, self.mass_per_atom,
                            dtype=flt)
        self.shake = shake
        self._shake_cl = make_clusters(shake) if shake is not None else None
        self.rigid = rigid
        if rigid is not None and shake is not None:
            raise ValueError("fix rigid/small and fix shake are exclusive")
        self.thermostat = None
        tchain = 0
        if thermostat is not None:
            t_dof = 3 * n - 3
            if shake is not None:
                t_dof -= shake.n_constraints
            if rigid is not None:
                t_dof -= rigid.n_constraints
            self.thermostat = dataclasses.replace(
                thermostat, dof=max(t_dof, 1), boltz=units.boltz,
                mvv2e=units.mvv2e, dt=self.dt,
            )
            tchain = self.thermostat.tchain
        self._mass_col = self.mass_per_atom.astype(np.dtype(flt))[:, None]

        comp = (jnp.zeros((n, 3), flt)
                if self.precision.compensated else None)
        self.state = MDState(
            x=jnp.asarray(jax.device_get(system.x), flt),
            v=jnp.asarray(jax.device_get(system.v), flt),
            image=system.image,
            f=jnp.zeros((n, 3), self.precision.acc),
            overflow=jnp.zeros((), bool),
            therm=jnp.zeros((2, tchain), flt),
            cx=comp, cv=comp,
        )
        if rigid is not None:
            from .rigid import (
                init_body_state, atom_positions, atom_velocities,
            )

            bs = init_body_state(rigid, self.state.v, dtype=flt)
            xa, d = atom_positions(rigid, bs)
            va = atom_velocities(rigid, bs, d)
            # projecting out non-rigid velocity components IS the settle
            self.state = self.state._replace(
                x=xa.astype(flt), v=va.astype(flt), body=bs)
        self.step_count = 0
        self._chunk_fns: dict[tuple, Callable] = {}
        self.timings: dict[str, float] = {"run": 0.0, "setup": 0.0}

        t0 = time.perf_counter()
        # one host round-trip at setup: size the capacity spec properly
        x0, _ = wrap(self.state.x, self.state.image, self.box)
        _, self.spec = nlmod.build_with_retry(
            x0, self.box, self.spec, self.special_idx, self.special_code,
            mol=self._mol,
        )
        self._thermo_fn = jax.jit(self._thermo_device)
        self._init_force_fn = jax.jit(self._init_force)
        if self.shake is not None:
            # settle the initial state onto the constraint manifold (both
            # positions and velocities) so the first step doesn't absorb a
            # one-time kinetic-energy jump
            Lbox = (self.box if self.box.is_triclinic
                    else np.asarray(self.box.lengths, np.float64))
            sc = self.shake
            cl = self._shake_cl
            rows = jnp.asarray(cl.rows_np(0))

            @jax.jit
            def settle(state: MDState) -> MDState:
                x3 = tuple(state.x[:, c] for c in range(3))
                v3 = tuple(state.v[:, c] for c in range(3))
                xf, _ = shake_positions_clustered(
                    sc, cl, x3, x3, v3, 1.0, Lbox,
                    rows)  # discard v feedback
                vf = rattle_velocities_clustered(sc, cl, xf, v3, Lbox,
                                                 rows)
                return state._replace(x=jnp.stack(xf, -1),
                                      v=jnp.stack(vf, -1))

            self.state = settle(self.state)
        self.state = self._init_force_fn(self.state)
        self.timings["setup"] += time.perf_counter() - t0

    # ---------- force evaluation ----------

    def _build(self, x):
        mol = None if self._mol is None else jnp.asarray(self._mol)
        return nlmod.build(x, self.box, self.spec, self.special_idx,
                           self.special_code, mol)

    def _forces(self, x, nlist, eflag: bool, vflag: bool) -> Forces:
        pr = compute_pair(
            self.pair, x, self.typ, self.q, self.box, nlist,
            eflag=eflag, vflag=vflag, acc_dtype=self.precision.acc,
            use_special=self.special_idx.shape[1] > 0,
        )
        f, virial = pr.f, pr.virial
        acc = self.precision.acc
        elong = ebond = eangle = jnp.zeros((), acc)
        if self.kspace is not None:
            kr = self.kspace.compute(x, jnp.asarray(self.q), eflag=eflag,
                                     vflag=vflag)
            f = f + kr.f
            elong = kr.elong
            virial = virial + kr.virial
        evdwl, ecoul = pr.evdwl, pr.ecoul
        emol_extra = jnp.zeros((), acc)
        if self.bonded is not None and self.bonded.has_terms:
            from ..models.bonded import compute_bonded

            br = compute_bonded(self.bonded, x, self.box, eflag=eflag,
                                acc_dtype=acc)
            f = f + br.f
            ebond = br.ebond
            eangle = br.eangle
            emol_extra = br.edihed + br.eimp
            # CHARMM 1-4 terms tally into the pair energies
            evdwl = evdwl + br.e14_lj
            ecoul = ecoul + br.e14_coul
            virial = virial + br.virial
        return Forces(f=f, evdwl=evdwl, ecoul=ecoul, elong=elong,
                      ebond=ebond, eangle=eangle, virial=virial,
                      emol_extra=emol_extra)

    def _init_force(self, state: MDState) -> MDState:
        x, image = wrap(state.x, state.image, self.box)
        nl = self._build(x)
        fr = self._forces(x, nl, eflag=False, vflag=False)
        return MDState(x=x, v=state.v, image=image, f=fr.f,
                       overflow=state.overflow | nl.overflow,
                       therm=state.therm, cx=state.cx, cv=state.cv,
                       body=state.body)

    # ---------- device-resident stepping ----------

    def _block_rigid(self, state: MDState, nsteps: int,
                     t_target) -> MDState:
        """fix rigid/small block: neighbor rebuild once, then nsteps of
        batched quaternion rigid-body velocity-Verlet (integrate/rigid.py).
        Atom x/v are derived from the body state; positions stay unwrapped
        (the cell binning folds lamda and the pair kernel min-images)."""
        from .rigid import (
            atom_positions, atom_velocities, initial_integrate_rigid,
            final_integrate_rigid,
        )

        rg = self.rigid
        nve = self.nve
        cfg = self.thermostat
        mass_col = self._mass_col
        nl = self._build(state.x)

        def one_step(carry, _):
            bs, ff, th = carry
            if cfg is not None:
                _, d0 = atom_positions(rg, bs)
                va = atom_velocities(rg, bs, d0)
                chain = NHChain(eta=th[0], eta_dot=th[1])
                scale, chain = nhc_half(cfg, chain, va, mass_col, t_target)
                bs = bs._replace(V=bs.V * scale, L=bs.L * scale)
                th = jnp.stack([chain.eta, chain.eta_dot])
            _, d = atom_positions(rg, bs)
            bs = initial_integrate_rigid(rg, bs, ff, d, nve.dtv, nve.dtf)
            xa, d2 = atom_positions(rg, bs)
            fr = self._forces(xa, nl, eflag=False, vflag=False)
            bs = final_integrate_rigid(rg, bs, fr.f, d2, nve.dtf)
            if cfg is not None:
                va = atom_velocities(rg, bs, d2)
                chain = NHChain(eta=th[0], eta_dot=th[1])
                scale, chain = nhc_half(cfg, chain, va, mass_col, t_target)
                bs = bs._replace(V=bs.V * scale, L=bs.L * scale)
                th = jnp.stack([chain.eta, chain.eta_dot])
            return (bs, fr.f, th), None

        (bs, f, th), _ = jax.lax.scan(
            one_step, (state.body, state.f, state.therm), None,
            length=nsteps,
        )
        xa, d = atom_positions(rg, bs)
        va = atom_velocities(rg, bs, d)
        flt = self.precision.flt
        return MDState(x=xa.astype(flt), v=va.astype(flt),
                       image=state.image, f=f,
                       overflow=state.overflow | nl.overflow, therm=th,
                       cx=state.cx, cv=state.cv, body=bs)

    def _block(self, state: MDState, nsteps: int,
               t_target: float) -> MDState:
        """wrap -> rebuild -> nsteps scanned NVE/NVT steps, all on device."""
        if self.rigid is not None:
            return self._block_rigid(state, nsteps, t_target)
        x, image = wrap(state.x, state.image, self.box)
        nl = self._build(x)
        nve = self.nve
        cfg = self.thermostat
        mass_col = self._mass_col

        sc = self.shake
        shake_rows = (jnp.asarray(self._shake_cl.rows_np(0))
                      if sc is not None else None)
        Lbox = (self.box if self.box.is_triclinic
                else np.asarray(self.box.lengths, np.float64))

        comp = self.precision.compensated

        def one_step(carry, _):
            xx, vv, ff, th, cx, cv = carry
            if cfg is not None:
                chain = NHChain(eta=th[0], eta_dot=th[1])
                scale, chain = nhc_half(cfg, chain, vv, mass_col, t_target)
                vv = vv * scale
                if comp:
                    cv = cv * scale
                th = jnp.stack([chain.eta, chain.eta_dot])
            x_old = xx
            if comp:
                xx, vv, cx, cv = initial_integrate_comp(
                    nve, xx, vv, ff, cx, cv)
            else:
                xx, vv = initial_integrate(nve, xx, vv, ff)
            if sc is not None:
                x3, v3 = shake_positions_clustered(
                    sc, self._shake_cl,
                    tuple(x_old[:, c] for c in range(3)),
                    tuple(xx[:, c] for c in range(3)),
                    tuple(vv[:, c] for c in range(3)),
                    nve.dtv, Lbox, shake_rows)
                xx = jnp.stack(x3, -1)
                vv = jnp.stack(v3, -1)
            fr = self._forces(xx, nl, eflag=False, vflag=False)
            if comp:
                vv, cv = final_integrate_comp(nve, vv, fr.f, cv)
            else:
                vv = final_integrate(nve, vv, fr.f)
            if sc is not None:
                vv = jnp.stack(rattle_velocities_clustered(
                    sc, self._shake_cl,
                    tuple(xx[:, c] for c in range(3)),
                    tuple(vv[:, c] for c in range(3)),
                    Lbox, shake_rows), -1)
            if cfg is not None:
                chain = NHChain(eta=th[0], eta_dot=th[1])
                scale, chain = nhc_half(cfg, chain, vv, mass_col, t_target)
                vv = vv * scale
                if comp:
                    cv = cv * scale
                th = jnp.stack([chain.eta, chain.eta_dot])
            return (xx, vv, fr.f, th, cx, cv), None

        (x, v, f, th, cx, cv), _ = jax.lax.scan(
            one_step,
            (x, state.v, state.f, state.therm, state.cx, state.cv),
            None, length=nsteps,
        )
        return MDState(x=x, v=v, image=image, f=f,
                       overflow=state.overflow | nl.overflow, therm=th,
                       cx=cx, cv=cv)

    def _repeat_blocks(self, size: int):
        """Jitted (state, n_blocks, t_target) -> state running n_blocks
        rebuild+scan blocks of `size` steps via fori_loop — ONE compilation
        per block size, any repeat count.  The thermostat target is a traced scalar argument, so
        a t_start != t_stop ramp re-dispatches per thermo segment without
        recompiling (it only feeds the O(tchain) chain scalars)."""
        fn = self._chunk_fns.get(size)
        if fn is None:
            def chunk(state: MDState, n_blocks, t_target) -> MDState:
                return jax.lax.fori_loop(
                    0, n_blocks,
                    lambda i, s: self._block(s, size, t_target), state
                )

            fn = jax.jit(chunk)
            self._chunk_fns[size] = fn
        return fn

    # ---------- thermo ----------

    def _thermo_device(self, state: MDState) -> dict:
        x, _ = wrap(state.x, state.image, self.box)
        nl = self._build(x)
        fr = self._forces(x, nl, eflag=True, vflag=True)
        u = self.units
        m = self.mass_per_atom.astype(np.dtype(state.v.dtype))
        v = state.v
        sum_mv2 = jnp.sum(
            (m[:, None] * v * v).astype(self.precision.acc)
        ) * u.mvv2e
        n = v.shape[0]
        dof = 3 * n - 3
        if self.shake is not None:
            dof -= self.shake.n_constraints
        if self.rigid is not None:
            dof -= self.rigid.n_constraints
        dof = max(dof, 1)
        temp = sum_mv2 / (dof * u.boltz)
        ke = 0.5 * sum_mv2
        vol = self.box.volume
        virial = fr.virial
        if self.rigid is not None and state.body is not None:
            from .rigid import atom_positions, constraint_virial

            _, d = atom_positions(self.rigid, state.body)
            virial = virial + constraint_virial(
                self.rigid, state.body, d, fr.f, u.ftm2v,
                acc_dtype=self.precision.acc)
        if self.shake is not None:
            # SHAKE constraint virial (fix_shake.cpp pressure tally)
            from .shake import shake_virial

            virial = virial + shake_virial(
                self.shake, x, v, fr.f, u.ftm2v,
                self.box if self.box.is_triclinic
                else np.asarray(self.box.lengths, np.float64),
                acc_dtype=self.precision.acc)
        vir_trace = virial[0] + virial[1] + virial[2]
        press = (sum_mv2 + vir_trace) / (3.0 * vol) * u.nktv2p
        epair = fr.evdwl + fr.ecoul + fr.elong
        emol = fr.ebond + fr.eangle
        if fr.emol_extra is not None:
            emol = emol + fr.emol_extra
        vmax = jnp.sqrt(jnp.max(jnp.sum(v * v, axis=-1)))
        return dict(
            temp=temp, evdwl=fr.evdwl, ecoul=fr.ecoul, elong=fr.elong,
            ebond=fr.ebond, eangle=fr.eangle, emol=emol,
            epair=epair, ke=ke, etotal=epair + emol + ke, press=press,
            overflow=state.overflow | nl.overflow, vmax=vmax,
            virial=virial,
        )

    def thermo(self) -> dict:
        """ONE batched device->host fetch of all thermo scalars."""
        row = jax.device_get(self._thermo_fn(self.state))
        out = {k: (float(v) if np.ndim(v) == 0 else np.asarray(v))
               for k, v in row.items()}
        out["step"] = self.step_count
        out["overflow"] = bool(row["overflow"])
        if not np.isfinite(out["etotal"]) or not np.isfinite(out["temp"]):
            raise RuntimeError(
                f"non-finite thermodynamics at step {out['step']} "
                f"(etotal={out['etotal']}, temp={out['temp']}): "
                "simulation diverged — reduce the timestep or check "
                "overlapping atoms / force-field coefficients"
            )
        if out["overflow"]:
            raise RuntimeError(
                "neighbor list overflow detected during run; increase kmax "
                "(Simulation(kmax=...)) or reduce rebuild interval"
            )
        return out

    # ---------- planning ----------

    def _cadence(self, vmax: Optional[float]) -> int:
        """Rebuild cadence in steps.

        check=no: the deck's fixed ``every``.
        check=yes: conservative displacement bound — two atoms approaching
        head-on cover 2*vmax*dt per step; rebuild before they cover skin.
        vmax is sampled at the previous thermo fetch and may grow during the
        segment (equilibration spikes), so a 1.5x headroom factor is applied;
        pathological mid-segment acceleration beyond that can still outrun
        the bound — use check=no + every for strict control.
        """
        nb = self.neighbor
        if not nb.check or vmax is None or vmax <= 0:
            return max(1, nb.every)
        safe = int(nb.skin / (2.0 * 1.5 * vmax * self.dt))
        return max(1, min(max(safe, 1), 100))

    def _t_target(self, ahead: int = 0) -> float:
        """Thermostat target (linear ramp evaluated at the END of the
        upcoming segment, baked per chunk — a ramp recompiles once per
        thermo segment)."""
        cfg = self.thermostat
        if cfg is None:
            return 0.0
        if self._run_total <= 0 or cfg.t_start == cfg.t_stop:
            return cfg.t_start
        frac = min(max((self._run_done + ahead) / self._run_total, 0.0), 1.0)
        return cfg.t_start + (cfg.t_stop - cfg.t_start) * frac

    def _advance(self, total: int, cadence: int):
        """Run `total` steps as n full blocks of `cadence` + one tail."""
        flt = self.precision.flt
        tt = jnp.asarray(self._t_target(ahead=total), flt)
        n_full, rem = divmod(total, cadence)
        if n_full:
            self.state = self._repeat_blocks(cadence)(self.state, n_full, tt)
        if rem:
            self.state = self._repeat_blocks(rem)(self.state, 1, tt)

    # ---------- main loop ----------

    def run(self, nsteps: int, thermo_every: int = 0, log: bool = True):
        """Advance nsteps; returns thermo rows (one batched fetch each)."""
        rows = []
        vmax = None

        def emit():
            nonlocal vmax
            row = self.thermo()
            vmax = row.pop("vmax")
            rows.append(row)
            if log:
                if not getattr(self, "_printed_header", False):
                    self._printed_header = True
                    print(f"{'Step':>8} {'Temp':>12} {'E_pair':>14} "
                          f"{'E_long':>14} {'TotEng':>14} {'Press':>14}")
                print(f"{row['step']:>8d} {row['temp']:>12.6g} "
                      f"{row['epair']:>14.8g} {row['elong']:>14.8g} "
                      f"{row['etotal']:>14.8g} {row['press']:>14.6g}")

        t0 = time.perf_counter()
        self._run_total = nsteps
        self._run_done = 0
        if thermo_every:
            emit()
        elif self.neighbor.check:
            # no thermo fetches will supply vmax — sample it once so the
            # displacement-bound cadence applies (else cadence falls to
            # `every`, which is 1 for LAMMPS-idiom 'every 1 delay N
            # check yes' decks: a full rebuild every step)
            vmax = float(jax.device_get(jax.jit(
                lambda s: jnp.sqrt(jnp.max(jnp.sum(s.v * s.v, axis=1))))(
                    self.state)))
        end = self.step_count + nsteps
        while self.step_count < end:
            target = end
            if thermo_every:
                target = min(
                    end,
                    ((self.step_count // thermo_every) + 1) * thermo_every,
                )
            self._advance(target - self.step_count, self._cadence(vmax))
            self._run_done += target - self.step_count
            self.step_count = target
            if thermo_every and self.step_count % thermo_every == 0:
                emit()
        if thermo_every and (not rows or rows[-1]["step"] != self.step_count):
            emit()
        else:
            jax.block_until_ready(self.state)
        self.timings["run"] += time.perf_counter() - t0
        return rows
