"""Run the in.spce deck (examples/in.spce of the reference): SPC/E water,
lj/cut/coul/long 6.8 8.8 + pppm 1e-4, real units, special_bonds 0 0 0.5.

The shipped deck uses SHAKE + NVT at dt=2fs; until SHAKE lands this runs
flexible water (harmonic bonds/angles from the deck) at a smaller dt.

Usage: python examples/run_spce.py [--replicate 1] [--steps 20] [--cpu] [--f64]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicate", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--thermo", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--data", default="/root/reference/examples/data.spce")
    ap.add_argument("--shake", action="store_true",
                    help="fix shake b 1 a 1 (rigid water, deck default)")
    ap.add_argument("--nvt", type=float, default=0.0,
                    help="Nose-Hoover target T (deck: 300)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    from lammps_buck_intel_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    import jax.numpy as jnp
    from lammps_buck_intel_tpu.core import (
        make_box, make_system, get_units, single, double, build_topology,
    )
    from lammps_buck_intel_tpu.io import read_data, lattice, velocity
    from lammps_buck_intel_tpu.models.pair import build_lj
    from lammps_buck_intel_tpu.models.kspace import setup_pppm
    from lammps_buck_intel_tpu.models.bonded import make_bonded
    from lammps_buck_intel_tpu.integrate import (
        Simulation, NeighborPolicy, make_shake, NVTConfig,
    )

    u = get_units("real")
    prec = double() if args.f64 else single()
    d = read_data(args.data)
    x, lo, hi = d.x, d.box_lo, d.box_hi
    typ, q, v0, image, mol = d.type, d.q, d.v, d.image, d.molecule
    bonds, angles = d.bonds, d.angles
    r = args.replicate
    if r > 1:
        x, lo, hi, pa, bonds, angles, _, _, mol = lattice.replicate(
            x, lo, hi, (r, r, r),
            per_atom={"type": typ, "q": q, "image": image},
            bonds=bonds, angles=angles, molecule=mol,
        )
        typ, q, image = pa["type"], pa["q"], pa["image"]
    n = len(x)
    print(f"# {n} atoms on {jax.devices()[0]}")
    box = make_box(lo, hi)
    topo = build_topology(n, bonds=bonds, angles=angles)
    style = build_lj(
        2, {(0, 0): (0.15535, 3.166), (0, 1): (0.0, 0.0),
            (1, 1): (0.0, 0.0)},
        cut_global=6.8, coul="long", cut_coul=8.8,
        special_lj=(1.0, 0.0, 0.0, 0.5), special_coul=(1.0, 0.0, 0.0, 0.5),
        qqrd2e=u.qqrd2e, name="lj/cut/coul/long",
    )
    pm = setup_pppm(box, q, cutoff=8.8, accuracy_rel=1e-4, qqrd2e=u.qqrd2e,
                    acc_dtype=prec.acc)
    style = style.replace(g_ewald=pm.g_ewald)
    print(f"# pppm: grid {pm.grid}, g_ewald {pm.g_ewald:.4f}, order {pm.order}")
    bonded = make_bonded(bonds=bonds, angles=angles,
                         bond_coeffs=[[1000.0, 1.0]],
                         angle_coeffs=[[100.0, 109.47]])
    mass_per_atom = d.mass[typ]
    v = velocity.create(n, 300.0, 432567, mass_per_atom, u, dist="uniform")
    system = make_system(x, box, type=typ, v=v, q=q, image=image,
                         mass=d.mass, molecule=mol, dtype=prec.flt)
    shake = None
    if args.shake:
        shake = make_shake(bonds, np.array([[1000.0, 1.0]]), angles,
                           np.array([[100.0, 109.47]]), mass_per_atom,
                           iters=30)
        bonded = None  # constrained bonds carry no flexible forces
    thermostat = None
    if args.nvt > 0:
        thermostat = NVTConfig(t_start=args.nvt, t_stop=args.nvt,
                               t_damp=100.0)
    sim = Simulation(
        system, style, topology=topo, kspace=pm, bonded=bonded, units=u,
        precision=prec, dt=args.dt, shake=shake, thermostat=thermostat,
        neighbor=NeighborPolicy(skin=2.0, every=5, delay=0, check=False),
    )
    sim.run(1, log=False)  # warmup
    t0 = time.perf_counter()
    sim.run(args.steps, thermo_every=args.thermo)
    dt_w = time.perf_counter() - t0
    print(f"# {args.steps} steps in {dt_w:.2f}s -> "
          f"{n * args.steps / dt_w:,.0f} atom-steps/s")


if __name__ == "__main__":
    main()
