"""Time two design choices of the silica deck on the card.

1. ``reach_z``: warm ms/step of examples/decks/silica_pppm.yaml with the
   cell grid's z refinement forced to 1, 2 and 3, beside the reach the
   padded-work model in ``CellPairSimulation`` picks.
2. k-space transfer: one f32 force evaluation (no energy, no virial) of
   ``CellPPPM`` and of the scatter-add ``PPPM`` (models/kspace/pppm.py) on
   the same mesh and order, and of the cell-tile pair kernel for scale.

Host-clock timings of jitted calls ended by ``jax.block_until_ready``,
after a warm-up call.  GPU only; every line carries the card's name and
power limit.

Usage:  python tools/card_timings.py [--steps 100] [--reps 20] [--record PATH]
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DECK = os.path.join(ROOT, "examples", "decks", "silica_pppm.yaml")


@contextlib.contextmanager
def forced_reach_z(reach):
    """Every cell grid the engine sizes gets this z refinement."""
    from lammps_buck_intel_tpu.neighbor import cell_slots as cs

    orig = cs.make_grid

    def make_grid(n, L, cutneigh, cap=None, safety=1.6, reach_z=1):
        return orig(n, L, cutneigh, cap=cap, safety=safety, reach_z=reach)

    cs.make_grid = make_grid
    try:
        yield
    finally:
        cs.make_grid = orig


def deck_cfg():
    from lammps_buck_intel_tpu.io.deck import load_deck

    cfg = load_deck(DECK)
    for k in ("run", "thermo"):
        cfg.pop(k, None)
    return cfg


def warm_ms_per_step(sim, steps):
    import jax

    sim.run(steps, log=False)                 # compile + warm-up
    t0 = time.perf_counter()
    sim.run(steps, log=False)
    jax.block_until_ready(sim.state)
    return (time.perf_counter() - t0) / steps * 1e3


def time_call(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))          # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def reach_z_sweep(cfg, steps, say):
    from lammps_buck_intel_tpu.run import build_simulation

    out = {}
    for reach in (1, 2, 3):
        with forced_reach_z(reach):
            sim = build_simulation(cfg)
        g = sim.grid
        ms = warm_ms_per_step(sim, steps)
        out[reach] = dict(ms_per_step=ms, nc=list(g.nc), cap=g.cap,
                          grows=sim.capacity_grows)
        say(f"reach_z={reach}: {ms:.3f} ms/step (nc={g.nc}, cap={g.cap}, "
            f"grows={sim.capacity_grows})")
        del sim
    sim = build_simulation(cfg)
    out["model_pick"] = sim.grid.reach_z
    say(f"model pick: reach_z={sim.grid.reach_z} (cap={sim.grid.cap})")
    return out, sim


def force_evals(sim, reps, say):
    import jax
    import jax.numpy as jnp

    from chip_smoke import same_mesh_pppm
    from lammps_buck_intel_tpu.models.pair.cellpair import compute_cellpair
    from lammps_buck_intel_tpu.neighbor import cell_slots as cs

    grid, box, n = sim.grid, sim.box, sim.n_atoms
    st = jax.jit(lambda s: cs.rebin(grid, box, s))(sim.state)
    cell = jax.jit(lambda s: sim.kspace.compute_slots(s, False, False)[:3])
    pair = jax.jit(lambda s: compute_cellpair(
        sim.pair, grid, box, s, eflag=False, vflag=False,
        acc_dtype=sim.precision.acc, newton=sim._newton)[:3])
    atoms = jax.device_get(jax.jit(lambda s: cs.to_atoms(grid, s))(st))
    pm = sim.kspace.pm
    pm32 = same_mesh_pppm(sim, atoms["q"], jnp.float32)
    x = jnp.asarray(atoms["x"], jnp.float32)
    q = jnp.asarray(atoms["q"], jnp.float32)
    generic = jax.jit(lambda x_, q_: pm32.compute(x_, q_, eflag=False,
                                                  vflag=False).f)
    out = dict(mesh=list(pm.grid), order=pm.order, n_atoms=n,
               cellpppm_ms=time_call(cell, (st,), reps),
               pppm_scatter_ms=time_call(generic, (x, q), reps),
               pair_cell_tiles_ms=time_call(pair, (st,), reps))
    say(f"k-space force eval, mesh {tuple(pm.grid)} order {pm.order}: "
        f"CellPPPM {out['cellpppm_ms']:.3f} ms, scatter-add pppm.py "
        f"{out['pppm_scatter_ms']:.3f} ms; pair cell tiles "
        f"{out['pair_cell_tiles_ms']:.3f} ms")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--record", help="write the numbers to this JSON file")
    args = ap.parse_args()

    from lammps_buck_intel_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lammps_buck_intel_tpu.utils.device import (
        card_name_power, require_gpu)

    enable_compile_cache()
    devs = require_gpu()
    card = card_name_power()
    print(card, flush=True)

    def say(msg):
        print(f"[{card}] {msg}", flush=True)

    rec = {"card": card, "device_kind": devs[0].device_kind}
    rec["reach_z"], sim = reach_z_sweep(deck_cfg(), args.steps, say)
    rec["force_eval"] = force_evals(sim, args.reps, say)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
