"""Every matrix product of the force path carries the pinned precision.

A GPU may run a DEFAULT-precision f32 ``dot_general`` in TF32, which keeps
about three decimal digits and breaks the 1e-4 PPPM accuracy target
without an error.  These tests trace one force evaluation of small decks
and walk the jaxpr (into every sub-jaxpr: jit, scan, map, cond) for
``dot_general`` equations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lammps_buck_intel_tpu.core.precision import MATMUL

SILICA = {
    "units": "metal", "precision": "single",
    "read_data": "examples/data.aC",
    "velocity": {"temp": 300.0, "seed": 1281937},
    "pair_style": {"name": "buck/coul/long", "cut": 7.0,
                   "coeffs": {"2 2": [1388.77, 0.3623188, 175.0],
                              "1 2": [18003.0, 0.2052124, 133.5381],
                              "1 1": [0.0, 0.1, 0.0]}},
    "neighbor": {"skin": 1.0, "every": 20, "delay": 0, "check": False},
    "timestep": 0.001,
}


def _sub_jaxprs(v):
    if hasattr(v, "eqns"):                       # Jaxpr
        yield v
    elif hasattr(getattr(v, "jaxpr", None), "eqns"):   # ClosedJaxpr
        yield v.jaxpr
    elif isinstance(v, (list, tuple)):
        for u in v:
            yield from _sub_jaxprs(u)


def dot_generals(jaxpr):
    """Every dot_general equation in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from dot_generals(sub)


def _pinned(eqn) -> bool:
    p = eqn.params.get("precision")
    if p is None:
        return False
    ps = p if isinstance(p, tuple) else (p,)
    return all(q == MATMUL for q in ps)


def _float_dots(sim):
    """Float dot_generals of one energy + virial force evaluation."""
    st = sim.state
    if hasattr(sim, "_slot_specials"):                    # cell-pair engine
        sp = sim._slot_specials(st)

        def fn(s):
            return sim._forces(s, sp, True, True)
    else:                                                 # neighbor list
        def fn(s):
            return sim._forces(s.x, sim._build(s.x), True, True)
    jaxpr = jax.make_jaxpr(fn)(st).jaxpr
    return [e for e in dot_generals(jaxpr)
            if jnp.issubdtype(e.invars[0].aval.dtype, jnp.floating)]


@pytest.mark.parametrize("variant", [
    "cellpair_cellpppm_order7", "cellpair_cellpppm_ad", "cellpair_ewald",
    "nlist_ewald"])
def test_f32_dot_generals_are_pinned(variant):
    from lammps_buck_intel_tpu.run import build_simulation

    cfg = dict(SILICA)
    if variant.startswith("cellpair"):
        cfg["engine"] = "cellpair"
    ks = {"name": "pppm", "accuracy": 1e-4}
    if variant == "cellpair_cellpppm_order7":
        ks["order"] = 7
    elif variant == "cellpair_cellpppm_ad":
        ks["diff"] = "ad"
    elif variant.endswith("ewald"):
        ks = {"name": "ewald", "accuracy": 1e-4}
    cfg["kspace_style"] = ks
    sim = build_simulation(cfg)
    if "cellpppm" in variant:
        from lammps_buck_intel_tpu.models.kspace import CellPPPM

        assert isinstance(sim.kspace, CellPPPM)
        assert sim.state.x.dtype == jnp.float32
    dots = _float_dots(sim)
    assert dots, "the force path traced no matrix product"
    bad = [e for e in dots if not _pinned(e)]
    assert not bad, (f"{len(bad)} of {len(dots)} dot_generals run at "
                     f"default precision: {bad[0]}")


def test_walk_finds_unpinned_dot():
    """The walk sees through jit and scan, and flags a default-precision
    product (so the test above cannot pass vacuously)."""
    def f(a, b):
        def body(c, _):
            return c + jnp.einsum("ij,jk->ik", a, b), None

        return jax.lax.scan(jax.jit(body), jnp.zeros((2, 2)), None,
                            length=2)[0]

    a = np.ones((2, 2), np.float32)
    jaxpr = jax.make_jaxpr(f)(a, a).jaxpr
    dots = list(dot_generals(jaxpr))
    assert len(dots) == 1 and not _pinned(dots[0])
