"""FIRE energy minimization — the host ``minimize`` command analog.

Host LAMMPS ships cg/sd/fire minimizers (SURVEY H7 periphery; the
reference's in.* decks start from pre-equilibrated data instead).  A
device-resident minimizer must be jit-compilable with static shapes, which
rules out line searches with data-dependent trip counts — FIRE (Bitzek
et al., PRL 97, 170201, 2006) is the natural fit: a fixed-form damped
dynamics with scalar adaptive state (dt, alpha, n_pos) that lives in the
scan carry.

Runs on the neighbor-list engine's force stack (atom-order arrays): the
deck runner minimizes through a temporary f64 nlist Simulation, then
hands the relaxed coordinates to whichever production engine the deck
selected.  Constraints (SHAKE/rigid) are ignored during minimization —
the host minimizer has the same restriction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def fire_minimize(sim, maxiter: int = 1000, ftol: float = 1e-4,
                  dmax: float = 0.1, dt0: float = None,
                  log: bool = False):
    """Minimize sim's potential energy in place (nlist Simulation).

    ftol: force infinity-norm convergence gate (units' force units).
    dmax: per-component displacement cap per step (the host's `dmax`).
    Returns (n_iters, fmax, epot) at exit; sim.state.x holds the
    minimized coordinates (v zeroed, images preserved).
    """
    from ..core.box import wrap

    dt0 = sim.dt if dt0 is None else dt0
    dt_max = 10.0 * dt0
    minv = 1.0 / np.asarray(jax.device_get(sim._mass_col))
    minv = jnp.asarray(minv, sim.precision.flt)
    cadence = max(1, sim.neighbor.every)

    def block(x, image, v, dt, alpha, n_pos):
        xw, image = wrap(x, image, sim.box)
        nl = sim._build(xw)

        def step(carry, _):
            x, v, dt, alpha, n_pos = carry
            fr = sim._forces(x, nl, eflag=False, vflag=False)
            f = fr.f.astype(x.dtype)
            # velocity Verlet-ish kick (FIRE uses simple Euler on v)
            v = v + dt * minv * f
            p = jnp.sum(v * f)
            fnorm = jnp.sqrt(jnp.sum(f * f))
            vnorm = jnp.sqrt(jnp.sum(v * v))
            v_mix = (1.0 - alpha) * v \
                + alpha * (vnorm / jnp.maximum(fnorm, 1e-30)) * f
            uphill = p <= 0.0
            v = jnp.where(uphill, jnp.zeros_like(v), v_mix)
            n_pos = jnp.where(uphill, 0, n_pos + 1)
            grow = (~uphill) & (n_pos > 5)
            dt = jnp.where(grow, jnp.minimum(dt * 1.1, dt_max),
                           jnp.where(uphill, dt * 0.5, dt))
            alpha = jnp.where(grow, alpha * 0.99,
                              jnp.where(uphill, 0.1, alpha))
            dx = jnp.clip(dt * v, -dmax, dmax)
            return (x + dx, v, dt, alpha, n_pos), None

        (x, v, dt, alpha, n_pos), _ = jax.lax.scan(
            step, (xw, v, dt, alpha, n_pos), None, length=cadence)
        fr = sim._forces(x, nl, eflag=True, vflag=False)
        fmax = jnp.max(jnp.abs(fr.f))
        epot = fr.evdwl + fr.ecoul + fr.elong + fr.ebond + fr.eangle
        if fr.emol_extra is not None:
            epot = epot + fr.emol_extra
        return x, image, v, dt, alpha, n_pos, fmax, epot, nl.overflow

    blk = jax.jit(block)
    st = sim.state
    x, image = st.x, st.image
    v = jnp.zeros_like(x)
    dt = jnp.asarray(dt0, x.dtype)
    alpha = jnp.asarray(0.1, x.dtype)
    n_pos = jnp.zeros((), jnp.int32)
    it = 0
    fmax_f = epot_f = float("nan")
    while it < maxiter:
        x, image, v, dt, alpha, n_pos, fmax, epot, ovf = blk(
            x, image, v, dt, alpha, n_pos)
        it += cadence
        fmax_f, epot_f = float(fmax), float(epot)
        if bool(jax.device_get(ovf)):
            raise RuntimeError("minimize: neighbor overflow — increase "
                               "kmax or reduce dmax")
        if log:
            print(f"# minimize iter {it}: fmax={fmax_f:.3e} "
                  f"epot={epot_f:.6g}")
        if not np.isfinite(epot_f):
            raise RuntimeError("minimize: non-finite energy")
        if fmax_f < ftol:
            break
    sim.state = st._replace(x=x, image=image, v=jnp.zeros_like(x))
    return it, fmax_f, epot_f
