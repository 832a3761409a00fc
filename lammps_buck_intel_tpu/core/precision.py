"""Precision policy — the analog of the reference's precision templating.

The reference compiles every kernel three ways, ``template<flt_t, acc_t>`` in
single (float,float), mixed (float,double) and double (double,double) modes,
selected at runtime from ``fix->precision()``
(pair_buck_intel.cpp:48-62, pppm_intel.cpp:170-179).

Here the analog is a dtype policy threaded through array construction:
``flt`` is the per-pair compute dtype, ``acc`` the accumulation dtype for
forces/energies/virials.  f64 needs ``jax_enable_x64``; the entry points
turn it on for ``mixed`` and ``double`` decks on every backend.

``MATMUL`` pins the precision of every device-side f32 ``einsum`` /
``dot`` of the force path.  A GPU may run a DEFAULT-precision f32 matrix
product in TF32 (about three decimal digits), which would break the
1e-4 PPPM accuracy target without raising any error.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

MATMUL = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    flt: jnp.dtype  # pair/grid compute dtype
    acc: jnp.dtype  # force / energy / virial accumulation dtype
    # compensated=True: positions/velocities integrate with Neumaier
    # two-float accumulation (integrate/nve.py two_sum_acc) — f64-like
    # integration drift from f32 state.  Honored by BOTH the neighbor-
    # list and the production cell-slot engine (residual planes ride the
    # rebin permutation, neighbor/cell_slots.py SlotState.comp);
    # triclinic cellpair falls back to nlist (the lamda wrap would
    # destroy the two-float split).
    compensated: bool = False

    def __post_init__(self):
        if self.acc == jnp.float64 or self.flt == jnp.float64:
            if not jax.config.read("jax_enable_x64"):
                raise ValueError(
                    f"precision mode {self.name!r} needs jax_enable_x64=True"
                )


def single() -> Precision:
    return Precision("single", jnp.dtype(jnp.float32), jnp.dtype(jnp.float32))


def mixed() -> Precision:
    """The reference's mixed mode: f32 compute, f64 accumulate
    (pair_buck_intel.cpp:50-52).  Needs x64; raises without it."""
    return Precision("mixed", jnp.dtype(jnp.float32), jnp.dtype(jnp.float64))


def double() -> Precision:
    return Precision("double", jnp.dtype(jnp.float64), jnp.dtype(jnp.float64))


def single_comp() -> Precision:
    """f32 everywhere + compensated (two-float) integration."""
    return Precision("single_comp", jnp.dtype(jnp.float32),
                     jnp.dtype(jnp.float32), compensated=True)


def needs_x64(name: str) -> bool:
    """True for the modes that accumulate (or compute) in f64."""
    return name in ("mixed", "double")


def get_precision(name: str) -> Precision:
    try:
        return {"single": single, "mixed": mixed, "double": double,
                "single_comp": single_comp}[name]()
    except KeyError:
        raise ValueError(f"unknown precision mode {name!r}") from None
