"""Velocity-Verlet NVE — the FixNVEIntel analog.

Reference: /root/reference/fix_nve_intel.cpp — initial_integrate (:60-99)
``v += dtfm*f; x += dtv*v`` and final_integrate (:103-127) ``v += dtfm*f``,
with a per-DOF ``_dtfm`` array generalising multi-type / group-masked atoms
(:129-194).  Here the per-DOF array is just ``dtf * ftm2v / mass[type]``
broadcast, and group masking is a multiplicative (N,1) mask (zeroed entries
freeze atoms, exactly the reference's zeroed-dtfm trick).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class NVEParams(NamedTuple):
    """dtv/dtf are python floats and mass_inv host numpy: NVEParams is
    CLOSED OVER by jitted step functions, and closed-over *device* arrays
    poison XLA codegen on this runtime (see core/box.py) — host values are
    baked as literals instead."""

    dtv: float          # dt
    dtf: float          # 0.5 * dt * ftm2v
    mass_inv: object    # (N, 1) numpy, 1/mass per atom, zeroed outside group


def make_nve(dt: float, ftm2v: float, mass_per_atom, group_mask=None,
             dtype=jnp.float32) -> NVEParams:
    import numpy as np
    import jax

    m = np.asarray(jax.device_get(mass_per_atom), np.dtype(dtype))
    minv = 1.0 / m
    if group_mask is not None:
        minv = minv * np.asarray(jax.device_get(group_mask), np.dtype(dtype))
    return NVEParams(
        dtv=float(dt),
        dtf=float(0.5 * dt * ftm2v),
        mass_inv=minv[:, None],
    )


def initial_integrate(p: NVEParams, x, v, f):
    v = v + (p.dtf * p.mass_inv) * f.astype(v.dtype)
    x = x + p.dtv * v
    return x, v


def final_integrate(p: NVEParams, v, f):
    return v + (p.dtf * p.mass_inv) * f.astype(v.dtype)


# ---- compensated (two-float) integration: an f32-only analog of the
# reference's mixed precision mode (f32 compute / f64 accumulate,
# pair_buck_intel.cpp:50-52).  The accumulated quantities — positions and velocities, whose per-step update
# rounding is what makes single-precision MD drift over 10^3+ steps — carry
# a Neumaier compensation plane: (s, c) with s + c the exact running sum.


def two_sum_acc(s, c, t):
    """One compensated accumulation step: returns (s', c') with
    s' + c' == s + c + t to ~2 ulp^2.  Branchless Neumaier two-sum."""
    t = t + c          # fold the carried residual into the increment
    snew = s + t
    big = jnp.abs(s) >= jnp.abs(t)
    err = jnp.where(big, (s - snew) + t, (t - snew) + s)
    return snew, err


def initial_integrate_comp(p: NVEParams, x, v, f, cx, cv):
    dv = (p.dtf * p.mass_inv) * f.astype(v.dtype)
    v, cv = two_sum_acc(v, cv, dv)
    x, cx = two_sum_acc(x, cx, p.dtv * (v + cv))
    return x, v, cx, cv


def final_integrate_comp(p: NVEParams, v, f, cv):
    dv = (p.dtf * p.mass_inv) * f.astype(v.dtype)
    return two_sum_acc(v, cv, dv)
