"""Multi-chip NPT — the MTK barostat on the slab-sharded cell-slot engine.

Host-LAMMPS contract: ``fix npt`` runs under MPI domain decomposition like
every other fix (/root/reference/examples/in.rhodo:18-19 is the NPT deck;
the pppm_intel.cpp:185,219-228 comm machinery exists so full decks scale).
This engine closes the last deck-visible fix that was single-chip-only.

Design (composition of two existing contracts):

* the SLAB decomposition (parallel/slab.py) is FRACTIONAL: cell walls sit
  at fixed fractions of the box, so a homogeneous MTK dilation moves every
  atom *with* its cell — binning, halo tables, and the migration bound are
  untouched by volume changes.  Only bin ASSIGNMENT and the pair minimum
  image consume the box, and both take it TRACED (cell_slots
  wrap_state_traced / compute_cell_tiles traced-L), so the cell counts
  stay static — the LAMMPS static-neigh-grid-between-reneighborings
  contract under a variable cell.
* the BAROSTAT state (boxL, omega_dot, last-step virial) is replicated,
  like the NH chain: per-device partial reductions (per-axis sum m v_a^2,
  pair/bonded virial partials, ownership-weighted SHAKE constraint
  virial) are psum-completed, then every device advances the identical
  scalar barostat — the integrate/npt.py operator splitting verbatim.
* k-space runs GATHERED + TRACED: all_gather the slot planes and run
  TracedPPPM/Ewald ``compute_traced`` replicated, with the box-baked
  tables (Green's function) rebuilt from the traced box once per cadence
  block — the PPPM::setup()-on-box-change contract on the mesh.

Cells are sized with ``box_headroom`` shrink margin (cells stay >=
cutoff+skin down to boxL/headroom; the run guard raises past it, the
integrate/npt.py contract).
"""
from __future__ import annotations

from time import perf_counter
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.box import Box, make_box
from ..core.units import Units, LJ
from ..integrate.npt import (NPTConfig, nh_omega_dot_half, nh_press_vfac,
                              baro_chain_half)
from ..integrate.shake import (shake_positions_clustered,
                               rattle_velocities_clustered)
from ..neighbor import cell_slots as cs
from .slab import SlabCellPairSimulation, shard_map


class NPTExtras(NamedTuple):
    """Replicated barostat state threaded alongside the sharded slots."""

    boxL: jnp.ndarray       # (3,) traced box lengths
    omega_dot: jnp.ndarray  # (3,) barostat strain rates
    virial: jnp.ndarray     # (6,) GLOBAL virial from the last force pass
    ptherm: jnp.ndarray = None  # (2, Mp) barostat NH chain (pchain)


class SlabNPTSimulation(SlabCellPairSimulation):
    """Variable-cell MD on the slab mesh (``engine: slab`` + ``fix npt``).

    API mirrors ``integrate.npt.NPTSimulation`` (run/thermo/get_atoms/
    current_box); the thermo surface is the NPT one (temp/press/p_axis/
    vol/boxL), computed from the carried global virial."""

    def __init__(self, system, pair, npt: NPTConfig, thermostat,
                 box_headroom: float = 1.10, **kw):
        if thermostat is None:
            raise ValueError("fix npt always thermostats (temp keyword)")
        if system.box.is_triclinic:
            raise NotImplementedError("slab NPT: triclinic box")
        self.npt = npt
        self._headroom = float(box_headroom)
        L0 = np.asarray(system.box.lengths, np.float64)
        self._L0 = L0
        self._center = np.asarray(system.box.lo, np.float64) + 0.5 * L0
        super().__init__(system, pair, thermostat=thermostat,
                         cutneigh_scale=box_headroom,
                         defer_init_force=True, **kw)
        flt = self.precision.flt
        rep = NamedSharding(self.mesh, P())
        ex = NPTExtras(
            boxL=jnp.asarray(L0, flt),
            omega_dot=jnp.zeros((3,), flt),
            virial=jnp.zeros((6,), self.precision.acc),
            ptherm=jnp.zeros((2, npt.pchain), flt),
        )
        self._extras_spec = NPTExtras(boxL=P(), omega_dot=P(), virial=P(),
                                      ptherm=P())
        self.extras = jax.tree.map(lambda a: jax.device_put(a, rep), ex)
        self._npt_chunk_fns: dict = {}
        self._thermo_jit = self._make_npt_thermo_fn()
        if self.rigid is not None:
            (self.state, self.body,
             self.extras) = self._make_npt_init_rigid_fn()(
                self.state, self.body, self.extras)
        else:
            self.state, self.extras = self._make_npt_init_fn()(
                self.state, self.extras)

    # ---------- traced-box helpers ----------

    def _lo_traced(self, boxL):
        return jnp.asarray(self._center, boxL.dtype) - 0.5 * boxL

    def _box_traced(self, boxL) -> Box:
        c = jnp.asarray(self._center, boxL.dtype)
        return Box(lo=c - 0.5 * boxL, hi=c + 0.5 * boxL,
                   periodic=np.array([True, True, True]))

    def _mv2_axes(self, st, minv):
        """psum-completed per-axis sum m v_a^2 (energy units)."""
        acc = self.precision.acc
        mass = jnp.where(st.aid < self.n_atoms,
                         1.0 / jnp.maximum(minv, 1e-30), 0.0)
        mv2 = jnp.stack([
            jnp.sum((mass * st.vx * st.vx).astype(acc)),
            jnp.sum((mass * st.vy * st.vy).astype(acc)),
            jnp.sum((mass * st.vz * st.vz).astype(acc)),
        ]) * self.units.mvv2e
        if self.D > 1:
            mv2 = jax.lax.psum(mv2, self.axis)
        return mv2

    # ---------- barostat pieces (integrate/npt.py ported; global
    # reductions arrive psum-completed, updates are replicated) ----------

    def _omega_dot_half(self, ex: NPTExtras, mv2, t_target, p_target):
        acc = self.precision.acc
        V = (ex.boxL[0] * ex.boxL[1] * ex.boxL[2]).astype(acc)
        od = nh_omega_dot_half(self.npt, self.units, self.n_atoms,
                               self.dt, ex.omega_dot, mv2,
                               ex.virial[:3], V, t_target, p_target)
        return ex._replace(omega_dot=od)

    def _press_vfac(self, ex: NPTExtras):
        """nh_v_press factor exp(-dt/2 (omega_dot + mtk_term2)), (3,)."""
        return nh_press_vfac(self.npt, self.n_atoms, self.dt,
                             ex.omega_dot)

    # ---------- forces under the traced box ----------

    def _forces_virial(self, st, boxL, kcb, ctx):
        """Force planes + psum-completed GLOBAL virial (vflag every step:
        the barostat consumes pressure continuously, npt.py contract)."""
        acc = self.precision.acc
        (fx, fy, fz), _, _, _, _, vir_pair, vir_k = self._forces_local(
            st, kcb, False, True, ctx=ctx, boxL=boxL,
            box=self._box_traced(boxL))
        vir = vir_pair.astype(acc)
        if self.D > 1:
            vir = jax.lax.psum(vir, self.axis)
        return (fx, fy, fz), vir + vir_k

    # ---------- the NPT cadence block ----------

    def _npt_block_local(self, state: cs.SlotState, ex: NPTExtras,
                         nsteps: int, t_target, p_target):
        state = self._rebin_local(state, boxL=ex.boxL,
                                  box_lo=self._lo_traced(ex.boxL))
        ctx = self._term_ctx(state)
        minv = self._minv(state)
        dtf, dtv = self.dtf, self.dtv
        flt = self.precision.flt
        acc = self.precision.acc
        sc = self.shake
        flags = np.asarray(self.npt.flags, bool)
        plane = self._plane
        ns_loc = self.grid.nslots // self.D
        sl = slice(plane, plane + ns_loc)
        # k-space setup-on-box-change at reneighbor cadence: traced
        # tables from the block-start box (integrate/npt.py contract)
        kcb = (self.kspace.tables(ex.boxL)
               if self.kspace is not None else None)
        if sc is not None:
            vw = ctx["shake_vw"].astype(flt)

        def ext3(a, b, c):
            return self._ext_planes(self._halo(a), self._halo(b),
                                    self._halo(c))

        def one_step(carry, _):
            st, ex = carry
            th = st.therm
            # barostat thermostat chain first (fix_nh order; replicated
            # pure function of the replicated omega_dot)
            if self.npt.pchain:
                od, pt = baro_chain_half(
                    self.npt, self.units, self.n_atoms, self.dt,
                    ex.omega_dot, ex.ptherm, t_target)
                ex = ex._replace(omega_dot=od, ptherm=pt)
            # thermostat half (psum'd KE, replicated chain)
            scale, th = self._nhc_scale(st, th, minv, t_target)
            st = st._replace(vx=st.vx * scale, vy=st.vy * scale,
                             vz=st.vz * scale)
            # barostat omega half + velocity scale
            ex = self._omega_dot_half(ex, self._mv2_axes(st, minv),
                                      t_target, p_target)
            fac = self._press_vfac(ex)
            vx = st.vx * fac[0] + (dtf * minv) * st.fx
            vy = st.vy * fac[1] + (dtf * minv) * st.fy
            vz = st.vz * fac[2] + (dtf * minv) * st.fz
            # drift + homogeneous dilation about the fixed center
            s = jnp.exp(dtv * jnp.where(jnp.asarray(flags),
                                        ex.omega_dot, 0.0))
            cx, cy, cz = (jnp.asarray(v, flt) for v in self._center)
            x = cx + (st.x + dtv * vx - cx) * s[0].astype(flt)
            y = cy + (st.y + dtv * vy - cy) * s[1].astype(flt)
            z = cz + (st.z + dtv * vz - cz) * s[2].astype(flt)
            boxL = ex.boxL * s
            ex = ex._replace(boxL=boxL)
            vir_c = jnp.zeros((6,), acc)
            if sc is not None:
                xs_old = ext3(st.x, st.y, st.z)
                st = st._replace(x=x, y=y, z=z)
                xs_new = ext3(st.x, st.y, st.z)
                vs = ext3(vx, vy, vz)
                xs_fix, vs, vir_c = shake_positions_clustered(
                    sc, self._shake_cl, xs_old, xs_new, vs, dtv, boxL,
                    ctx["shake_rows"],
                    virial_factor=1.0 / (dtv * dtf), vweights=vw)
                x, y, z = (p[sl] for p in xs_fix)
                vx, vy, vz = (p[sl] for p in vs)
                vir_c = vir_c.astype(acc)
                if self.D > 1:
                    vir_c = jax.lax.psum(vir_c, self.axis)
            st = st._replace(x=x, y=y, z=z)
            # forces + global virial at the new configuration
            (fx, fy, fz), vir = self._forces_virial(st, boxL, kcb, ctx)
            ex = ex._replace(virial=vir + vir_c)
            fx, fy, fz = fx.astype(flt), fy.astype(flt), fz.astype(flt)
            vx = vx + (dtf * minv) * fx
            vy = vy + (dtf * minv) * fy
            vz = vz + (dtf * minv) * fz
            if sc is not None:
                vs = rattle_velocities_clustered(
                    sc, self._shake_cl, ext3(st.x, st.y, st.z),
                    ext3(vx, vy, vz), boxL, ctx["shake_rows"])
                vx, vy, vz = (p[sl] for p in vs)
            # barostat scale + omega half + thermostat half
            st = st._replace(vx=vx, vy=vy, vz=vz, fx=fx, fy=fy, fz=fz)
            fac = self._press_vfac(ex)
            st = st._replace(vx=st.vx * fac[0], vy=st.vy * fac[1],
                             vz=st.vz * fac[2])
            ex = self._omega_dot_half(ex, self._mv2_axes(st, minv),
                                      t_target, p_target)
            scale, th = self._nhc_scale(st, th, minv, t_target)
            st = st._replace(vx=st.vx * scale, vy=st.vy * scale,
                             vz=st.vz * scale, therm=th)
            if self.npt.pchain:
                od, pt = baro_chain_half(
                    self.npt, self.units, self.n_atoms, self.dt,
                    ex.omega_dot, ex.ptherm, t_target)
                ex = ex._replace(omega_dot=od, ptherm=pt)
            return (st, ex), None

        (state, ex), _ = jax.lax.scan(one_step, (state, ex), None,
                                      length=nsteps)
        return state, ex

    def _repeat_npt_blocks(self, size: int):
        key = (size, self.npt, self.thermostat)
        fn = self._npt_chunk_fns.get(key)
        if fn is None:
            def local(state, ex, n_blocks, t_target, p_target):
                return jax.lax.fori_loop(
                    0, n_blocks,
                    lambda i, se: self._npt_block_local(
                        se[0], se[1], size, t_target, p_target),
                    (state, ex))

            fn = jax.jit(shard_map(
                local, mesh=self.mesh,
                in_specs=(self._state_spec, self._extras_spec,
                          P(), P(), P()),
                out_specs=(self._state_spec, self._extras_spec),
                check_vma=False,
            ))
            self._npt_chunk_fns[key] = fn
        return fn

    def _make_npt_init_fn(self):
        """Initial force + virial pass at the initial (replicated) box."""
        def local(state, ex):
            state = self._rebin_local(state, boxL=ex.boxL,
                                      box_lo=self._lo_traced(ex.boxL))
            ctx = self._term_ctx(state)
            kcb = (self.kspace.tables(ex.boxL)
                   if self.kspace is not None else None)
            (fx, fy, fz), vir = self._forces_virial(state, ex.boxL, kcb,
                                                    ctx)
            flt = state.x.dtype
            return (state._replace(fx=fx.astype(flt), fy=fy.astype(flt),
                                   fz=fz.astype(flt)),
                    ex._replace(virial=vir))

        return jax.jit(shard_map(
            local, mesh=self.mesh,
            in_specs=(self._state_spec, self._extras_spec),
            out_specs=(self._state_spec, self._extras_spec),
            check_vma=False,
        ))

    # ---------- fix rigid/npt/small on the slab mesh ----------
    #
    # The coupled rigid-body barostat (integrate/npt.py _one_step_rigid)
    # composed with the slab engine's replicated-body machinery
    # (parallel/slab.py): per-device force/torque partials are
    # psum-completed, every device advances ALL bodies + the identical
    # barostat, slot planes derive locally.  Pressure keeps the full
    # atomic mv2 + virial + constraint virial (the molecular-pressure
    # identity); MTK terms use COM momenta with nbody DOFs
    # (fix_rigid_nh contract).

    def _mv2_trans_rigid(self, bs):
        """(3,) per-axis sum_b M_b V_a^2 (energy units) — replicated."""
        acc = self.precision.acc
        M = jnp.asarray(np.asarray(self.rigid.mtotal), acc)
        return jnp.stack([
            jnp.sum(M * bs.V[:, a].astype(acc) * bs.V[:, a].astype(acc))
            for a in range(3)]) * self.units.mvv2e

    def _omega_dot_half_rigid(self, ex: NPTExtras, mv2, bs, t_target,
                              p_target):
        acc = self.precision.acc
        V = (ex.boxL[0] * ex.boxL[1] * ex.boxL[2]).astype(acc)
        od = nh_omega_dot_half(self.npt, self.units, self.rigid.nbody,
                               self.dt, ex.omega_dot, mv2,
                               ex.virial[:3], V, t_target, p_target,
                               mv2_mtk=self._mv2_trans_rigid(bs))
        return ex._replace(omega_dot=od)

    def _constraint_virial_local(self, bs, bof, d, fx, fy, fz, T, minv):
        """Slot-local rigid constraint virial partials, psum-completed
        (integrate/rigid.constraint_virial decomposed: the body-level
        alpha/omega are replicated; the d (x) f_c contraction sums over
        owned slots only)."""
        from ..integrate.rigid import quat_rotate, quat_rotate_inv

        rg = self.rigid
        acc = self.precision.acc
        ftm2v = self.units.ftm2v
        iinv = jnp.asarray(rg.iinv, bs.q.dtype)
        Lb = quat_rotate_inv(bs.q, bs.L)
        wb = iinv * Lb
        wdotb = iinv * (ftm2v * quat_rotate_inv(bs.q, T)
                        - jnp.cross(wb, Lb))
        alpha = quat_rotate(bs.q, wdotb)
        om = quat_rotate(bs.q, wb)
        z1 = jnp.zeros((1, 3), bs.q.dtype)
        omi = jnp.concatenate([om, z1])[bof]
        ali = jnp.concatenate([alpha, z1])[bof]
        a = jnp.cross(ali, d) + jnp.cross(omi, jnp.cross(omi, d))
        f = jnp.stack([fx, fy, fz], -1).astype(bs.q.dtype)
        m = jnp.where(jnp.asarray(minv) > 0,
                      1.0 / jnp.maximum(jnp.asarray(minv), 1e-30),
                      0.0).astype(bs.q.dtype)[:, None]
        fc = (m / ftm2v) * a - f
        vir = jnp.stack([
            jnp.sum((d[:, 0] * fc[:, 0]).astype(acc)),
            jnp.sum((d[:, 1] * fc[:, 1]).astype(acc)),
            jnp.sum((d[:, 2] * fc[:, 2]).astype(acc)),
            jnp.sum((d[:, 0] * fc[:, 1]).astype(acc)),
            jnp.sum((d[:, 0] * fc[:, 2]).astype(acc)),
            jnp.sum((d[:, 1] * fc[:, 2]).astype(acc)),
        ])
        if self.D > 1:
            vir = jax.lax.psum(vir, self.axis)
        return vir

    def _npt_block_rigid_local(self, state: cs.SlotState, body,
                               ex: NPTExtras, nsteps: int, t_target,
                               p_target):
        from ..integrate.rigid import (initial_integrate_rigid_ft,
                                       final_integrate_rigid_ft)

        rg = self.rigid
        nb = rg.nbody
        state = self._rebin_local(state, boxL=ex.boxL,
                                  box_lo=self._lo_traced(ex.boxL))
        ctx = self._term_ctx(state)
        bof, rb_s = self._rigid_maps(state)
        minv = self._minv(state)
        dtf, dtv = self.dtf, self.dtv
        flt = self.precision.flt
        flags = np.asarray(self.npt.flags, bool)
        kcb = (self.kspace.tables(ex.boxL)
               if self.kspace is not None else None)
        # per-slot periodic image offsets as INTEGER box multiples: the
        # box dilates inside the block, so offsets scale with the traced
        # boxL (n * L(t)), keeping derived positions continuous with the
        # just-rebinned planes (see slab.py _block_rigid_local)
        _x0, _y0, _z0, _, _, _ = self._derive_xv(body, bof, rb_s)
        n_img = [jnp.round((p - p0) / ex.boxL[a])
                 for a, (p, p0) in enumerate(
                     ((state.x, _x0), (state.y, _y0), (state.z, _z0)))]

        def one_step(carry, _):
            st, bs, ex = carry
            th = st.therm
            if self.npt.pchain:
                od, pt = baro_chain_half(self.npt, self.units, nb,
                                         self.dt, ex.omega_dot,
                                         ex.ptherm, t_target)
                ex = ex._replace(omega_dot=od, ptherm=pt)
            # thermostat half: atomic KE drives the chain; scale both
            # body momenta and the derived slot v planes
            scale, th = self._nhc_scale(st, th, minv, t_target)
            bs = bs._replace(V=bs.V * scale, L=bs.L * scale)
            st = st._replace(vx=st.vx * scale, vy=st.vy * scale,
                             vz=st.vz * scale)
            # barostat half + COM velocity scale (nbody DOFs)
            ex = self._omega_dot_half_rigid(
                ex, self._mv2_axes(st, minv), bs, t_target, p_target)
            fac = nh_press_vfac(self.npt, nb, self.dt, ex.omega_dot)
            bs = bs._replace(V=bs.V * fac[None, :])
            # rigid half kick + drift
            F, T, _ = self._body_ft(bs, bof, rb_s, st.fx, st.fy, st.fz)
            bs = initial_integrate_rigid_ft(rg, bs, F, T, dtv, dtf)
            # COM + box dilation about the fixed center
            s = jnp.exp(dtv * jnp.where(jnp.asarray(flags),
                                        ex.omega_dot, 0.0))
            c = jnp.asarray(self._center, bs.X.dtype)
            bs = bs._replace(X=c + (bs.X - c) * s[None, :])
            boxL = ex.boxL * s
            ex = ex._replace(boxL=boxL)
            x, y, z, _, _, _ = self._derive_xv(bs, bof, rb_s)
            st = st._replace(
                x=x + (n_img[0] * boxL[0]).astype(flt),
                y=y + (n_img[1] * boxL[1]).astype(flt),
                z=z + (n_img[2] * boxL[2]).astype(flt))
            # forces + global virial at the new configuration
            (fx, fy, fz), vir = self._forces_virial(st, boxL, kcb, ctx)
            fx, fy, fz = fx.astype(flt), fy.astype(flt), fz.astype(flt)
            F, T, d2 = self._body_ft(bs, bof, rb_s, fx, fy, fz)
            bs = final_integrate_rigid_ft(rg, bs, F, T, dtf)
            cvir = self._constraint_virial_local(bs, bof, d2, fx, fy, fz,
                                                 T, minv)
            ex = ex._replace(virial=vir + cvir)
            fac = nh_press_vfac(self.npt, nb, self.dt, ex.omega_dot)
            bs = bs._replace(V=bs.V * fac[None, :])
            vx, vy, vz = self._derive_xv(bs, bof, rb_s, want_x=False)
            st = st._replace(vx=vx, vy=vy, vz=vz, fx=fx, fy=fy, fz=fz)
            ex = self._omega_dot_half_rigid(
                ex, self._mv2_axes(st, minv), bs, t_target, p_target)
            scale, th = self._nhc_scale(st, th, minv, t_target)
            bs = bs._replace(V=bs.V * scale, L=bs.L * scale)
            st = st._replace(vx=st.vx * scale, vy=st.vy * scale,
                             vz=st.vz * scale, therm=th)
            if self.npt.pchain:
                od, pt = baro_chain_half(self.npt, self.units, nb,
                                         self.dt, ex.omega_dot,
                                         ex.ptherm, t_target)
                ex = ex._replace(omega_dot=od, ptherm=pt)
            return (st, bs, ex), None

        (state, body, ex), _ = jax.lax.scan(one_step, (state, body, ex),
                                            None, length=nsteps)
        return state, body, ex

    def _repeat_npt_rigid_blocks(self, size: int):
        key = ("rigid", size, self.npt, self.thermostat)
        fn = self._npt_chunk_fns.get(key)
        if fn is None:
            def local(state, body, ex, n_blocks, t_target, p_target):
                return jax.lax.fori_loop(
                    0, n_blocks,
                    lambda i, sbe: self._npt_block_rigid_local(
                        sbe[0], sbe[1], sbe[2], size, t_target, p_target),
                    (state, body, ex))

            fn = jax.jit(shard_map(
                local, mesh=self.mesh,
                in_specs=(self._state_spec, self._body_spec,
                          self._extras_spec, P(), P(), P()),
                out_specs=(self._state_spec, self._body_spec,
                           self._extras_spec),
                check_vma=False,
            ))
            self._npt_chunk_fns[key] = fn
        return fn

    def _make_npt_init_rigid_fn(self):
        def local(state, body, ex):
            state = self._rebin_local(state, boxL=ex.boxL,
                                      box_lo=self._lo_traced(ex.boxL))
            ctx = self._term_ctx(state)
            bof, rb_s = self._rigid_maps(state)
            minv = self._minv(state)
            kcb = (self.kspace.tables(ex.boxL)
                   if self.kspace is not None else None)
            (fx, fy, fz), vir = self._forces_virial(state, ex.boxL, kcb,
                                                    ctx)
            flt = state.x.dtype
            fxs, fys, fzs = fx.astype(flt), fy.astype(flt), fz.astype(flt)
            F, T, d = self._body_ft(body, bof, rb_s, fxs, fys, fzs)
            cvir = self._constraint_virial_local(body, bof, d, fxs, fys,
                                                 fzs, T, minv)
            return (state._replace(fx=fxs, fy=fys, fz=fzs), body,
                    ex._replace(virial=vir + cvir))

        return jax.jit(shard_map(
            local, mesh=self.mesh,
            in_specs=(self._state_spec, self._body_spec,
                      self._extras_spec),
            out_specs=(self._state_spec, self._body_spec,
                       self._extras_spec),
            check_vma=False,
        ))

    # ---------- thermo (the NPTSimulation surface) ----------

    def _make_npt_thermo_fn(self):
        u = self.units
        acc = self.precision.acc

        def local(state, ex):
            boxL = ex.boxL
            state = self._rebin_local(state, boxL=boxL,
                                      box_lo=self._lo_traced(boxL))
            minv = self._minv(state)
            mv2 = self._mv2_axes(state, minv)
            V = (boxL[0] * boxL[1] * boxL[2]).astype(acc)
            p_axis = (mv2 + ex.virial[:3]) / V * u.nktv2p
            sum_mv2 = jnp.sum(mv2)
            temp = sum_mv2 / (self._dof() * u.boltz)
            press = (sum_mv2 + ex.virial[0] + ex.virial[1]
                     + ex.virial[2]) / (3.0 * V) * u.nktv2p
            # energy ledger at thermo cadence (LAMMPS thermo contract)
            ctx = self._term_ctx(state)
            kcb = (self.kspace.tables(boxL)
                   if self.kspace is not None else None)
            _, evdwl, ecoul, elong, emol, _, _ = self._forces_local(
                state, kcb, True, False, ctx=ctx, boxL=boxL,
                box=self._box_traced(boxL))
            if self.D > 1:
                evdwl = jax.lax.psum(evdwl, self.axis)
                ecoul = jax.lax.psum(ecoul, self.axis)
                emol = jax.lax.psum(emol, self.axis)
            epair = evdwl + ecoul + elong   # elong arrives replicated
            return dict(temp=temp, ke=0.5 * sum_mv2, press=press,
                        p_axis=p_axis, boxL=boxL, vol=V,
                        omega_dot=ex.omega_dot,
                        evdwl=evdwl, ecoul=ecoul, elong=elong, emol=emol,
                        epair=epair, etotal=epair + emol + 0.5 * sum_mv2,
                        overflow=state.overflow)

        specs = dict(temp=P(), ke=P(), press=P(), p_axis=P(), boxL=P(),
                     vol=P(), omega_dot=P(), overflow=P(),
                     evdwl=P(), ecoul=P(), elong=P(), emol=P(),
                     epair=P(), etotal=P())
        return jax.jit(shard_map(
            local, mesh=self.mesh,
            in_specs=(self._state_spec, self._extras_spec),
            out_specs=specs, check_vma=False,
        ))

    def thermo(self) -> dict:
        row = jax.device_get(self._thermo_jit(self.state, self.extras))
        out = {k: (float(v) if np.ndim(v) == 0 else np.asarray(v))
               for k, v in row.items()}
        out["step"] = self.step_count
        out["overflow"] = bool(row["overflow"])
        if out["overflow"]:
            raise RuntimeError(
                "slab NPT overflow: cell capacity exceeded or an atom "
                "drifted past the adjacent slab between rebins — "
                "compression densified the system past the sizing; raise "
                "cap / box_headroom or shrink the rebuild interval")
        self._shrink_guard(np.asarray(out["boxL"]))
        if not np.isfinite(out["temp"]) or not np.isfinite(out["press"]):
            raise RuntimeError(f"non-finite thermo at step {out['step']}")
        return out

    def _shrink_guard(self, boxL_now: np.ndarray):
        shrink = boxL_now / self._L0
        if float(shrink.min()) < 1.0 / self._headroom - 1e-9:
            raise RuntimeError(
                f"box shrank to {shrink.min():.3f} of its initial length, "
                f"beyond the cell-geometry bound 1/{self._headroom}; "
                "rebuild the simulation from the compressed state")

    # ---------- IO ----------

    @property
    def current_box(self) -> Box:
        L = np.asarray(jax.device_get(self.extras.boxL), np.float64)
        return make_box(self._center - 0.5 * L, self._center + 0.5 * L)

    @property
    def box(self) -> Box:
        """The IO contract (write_data/checkpoint/dump read sim.box):
        the CURRENT dilated box once the barostat state exists; the
        static initial box during construction (the parent's cell
        geometry is sized from it)."""
        if getattr(self, "extras", None) is not None:
            return self.current_box
        return self._box0

    @box.setter
    def box(self, v: Box):
        self._box0 = v

    # ---------- main loop (NPTSimulation.run ported) ----------

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

        t0 = perf_counter()
        if thermo_every:
            emit()
        cfg = self.thermostat
        npt = self.npt
        flt = self.precision.flt
        done = 0
        cadence = max(1, self.neighbor.every)
        while done < nsteps:
            target = min(nsteps, done + (thermo_every or nsteps))
            while done < target:
                size = min(cadence, target - done)
                # segment-END ramp evaluation (verlet.py _t_target)
                frac = (done + size) / max(nsteps, 1)
                tt = jnp.asarray(
                    cfg.t_start + (cfg.t_stop - cfg.t_start) * frac, flt)
                pt = jnp.asarray(
                    np.asarray(npt.p_start)
                    + (np.asarray(npt.p_stop)
                       - np.asarray(npt.p_start)) * frac, flt)
                if self.rigid is not None:
                    (self.state, self.body,
                     self.extras) = self._repeat_npt_rigid_blocks(size)(
                        self.state, self.body, self.extras, 1, tt, pt)
                else:
                    self.state, self.extras = self._repeat_npt_blocks(
                        size)(self.state, self.extras, 1, tt, pt)
                done += size
                self.step_count += size
            if thermo_every:
                emit()
        if not thermo_every:
            float(jax.device_get(self.extras.boxL)[0])  # completion
        # guards fire even with thermo_every=0 (advisor r2 contract)
        ov = bool(np.asarray(jax.device_get(self.state.overflow)).any())
        if ov:
            raise RuntimeError(
                "slab NPT overflow: cell capacity exceeded or an atom "
                "drifted past the adjacent slab between rebins")
        self._shrink_guard(np.asarray(
            jax.device_get(self.extras.boxL), np.float64))
        self.timings["run"] += perf_counter() - t0
        return rows
