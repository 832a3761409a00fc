"""Per-phase performance breakdown — the HPAC_TIMING analog (SURVEY.md §5.1).

The reference instruments PPPM phases with clock_gettime printfs
(pppm_intel.cpp:113-123, 329-334, 529-533, 813-819) and pack/pair watch
timers (pair_buck_intel.cpp:80-90).  Under XLA whole steps fuse into single
programs, so phase timing means compiling each phase standalone and timing
it with chained data dependencies, ended by ``jax.block_until_ready``.

Usage:
    from lammps_buck_intel_tpu.utils.profiler import profile_phases
    print(profile_phases(sim))        # {'pair': ms, 'kspace': ms, ...}
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def _honest_ms(fn, arg, nscan: int = 10, reps: int = 3) -> float:
    """Wall ms per iteration of fn chained nscan times inside one jit."""

    @jax.jit
    def run(a):
        def body(c, _):
            return fn(c), None
        c, _ = jax.lax.scan(body, a, None, length=nscan)
        return c

    jax.block_until_ready(run(arg))                    # compile + warm
    t0 = time.perf_counter()
    c = arg
    for _ in range(reps):
        c = run(c)
    jax.block_until_ready(c)
    return (time.perf_counter() - t0) / (reps * nscan) * 1000.0


def profile_phases(sim, nscan: int = 10, reps: int = 3) -> dict:
    """Phase breakdown for a CellPairSimulation (ms per step).

    Phases mirror the reference taxonomy: pair (eval hot loop), kspace
    (deposition+poisson+fieldforce as one fused phase), rebin (the
    neighbor-build analog), step (full integration step including all of
    the above).
    """
    from ..neighbor import cell_slots as cs

    state = sim.state
    out = {}

    def _chain(st, fx, fy, fz):
        # chain ALL coordinate planes through the scan: chaining only x
        # lets XLA hoist every y/z-dependent stage (spline weights, tile
        # diffs) out of the loop and under-report the phase by ~2x
        flt = st.x.dtype
        return st._replace(x=st.x + 0.0 * fx.astype(flt),
                           y=st.y + 0.0 * fy.astype(flt),
                           z=st.z + 0.0 * fz.astype(flt))

    def pair_only(st):
        spp = sim._slot_specials(st)
        from ..models.pair.cellpair import compute_cellpair

        rr = compute_cellpair(
            sim.pair, sim.grid, sim.box, st, eflag=False, vflag=False,
            acc_dtype=sim.precision.acc,
            slot_special_idx=spp[0], slot_special_code=spp[1],
            uniform_special=getattr(sim, "_uniform_special", None),
            slot_umol=spp[2] if len(spp) > 2 else None,
        )
        return _chain(st, rr.fx, rr.fy, rr.fz)

    out["pair"] = _honest_ms(pair_only, state, nscan, reps)

    if sim.kspace is not None:
        def kspace_only(st):
            if hasattr(sim.kspace, "compute_slots"):
                fx, fy, fz, e, v = sim.kspace.compute_slots(st, False, False)
            else:
                xs = jnp.stack([st.x, st.y, st.z], -1)
                kr = sim.kspace.compute(xs, st.q, eflag=False, vflag=False)
                fx, fy, fz = kr.f[:, 0], kr.f[:, 1], kr.f[:, 2]
            return _chain(st, fx, fy, fz)

        out["kspace"] = _honest_ms(kspace_only, state, nscan, reps)

    def rebin_only(st):
        st2 = cs.rebin_incremental(sim.grid, sim.box, st)
        return st2._replace(x=st2.x + 0.0)

    out["rebin"] = _honest_ms(rebin_only, state, nscan, reps)

    def rebin_full_only(st):
        st2 = cs.rebin(sim.grid, sim.box, st)
        return st2._replace(x=st2.x + 0.0)

    out["rebin_full"] = _honest_ms(rebin_full_only, state, nscan, reps)

    def full_step(st):
        return sim._block(st, 1)

    out["step"] = _honest_ms(full_step, state, nscan, reps)
    return out
