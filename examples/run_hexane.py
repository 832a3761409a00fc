"""Run the in.hexane deck (examples/in.hexane of the reference): united-atom
hexane, lj/long/coul/long long off 9.8 + pppm/disp 1e-4, real units.

The deck's fix rigid/small is pending; intramolecular pairs are excluded
(neigh_modify exclude molecule/intra semantics) and beads run free.

Usage: python examples/run_hexane.py [--steps 50] [--cpu] [--f64] [--nvt T]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--thermo", type=int, default=10)
    ap.add_argument("--dt", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--nvt", type=float, default=0.0,
                    help="target T for Nose-Hoover NVT (0 = NVE)")
    ap.add_argument("--data",
                    default="/root/reference/examples/equilibrated_data.hexane")
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
        make_box, make_system, get_units, single, double,
    )
    from lammps_buck_intel_tpu.io import read_data
    from lammps_buck_intel_tpu.models.pair import build_lj
    from lammps_buck_intel_tpu.models.kspace import (
        setup_pppm_disp, solve_g6, BoundKSpace,
    )
    from lammps_buck_intel_tpu.integrate import Simulation, NeighborPolicy
    from lammps_buck_intel_tpu.integrate.nvt import NVTConfig

    u = get_units("real")
    prec = double() if args.f64 else single()
    d = read_data(args.data)
    n = d.n_atoms
    print(f"# {n} atoms on {jax.devices()[0]}")
    box = make_box(d.box_lo, d.box_hi)
    EPS = (0.1744742, 0.1147228)   # in.hexane:19-20
    SIG = (3.97, 3.97)
    CUT = 9.8
    g6 = solve_g6(CUT, 1e-4)
    style = build_lj(
        2, {0: (EPS[0], SIG[0]), 1: (EPS[1], SIG[1])},
        cut_global=CUT, coul="none", disp="long",
        name="lj/long/coul/long", dtype=prec.flt,
    ).replace(g_ewald_6=g6)
    B = np.sqrt(4.0 * np.asarray(EPS)) * np.asarray(SIG) ** 3
    pm = setup_pppm_disp(box, B, d.type, cutoff=CUT, g_ewald_6=g6,
                         acc_dtype=prec.acc)
    print(f"# pppm/disp: grid {pm.grid}, g_ewald_6 {g6:.4f}")
    kspace = BoundKSpace(pm, B[d.type])
    system = make_system(d.x, box, type=d.type, v=d.v, image=d.image,
                         mass=d.mass, molecule=d.molecule, dtype=prec.flt)
    thermostat = None
    if args.nvt > 0:
        thermostat = NVTConfig(t_start=args.nvt, t_stop=args.nvt,
                               t_damp=100.0)
    sim = Simulation(
        system, style, kspace=kspace, units=u, precision=prec, dt=args.dt,
        neighbor=NeighborPolicy(skin=2.0, every=5, delay=0, check=False),
        exclude_intra=True, thermostat=thermostat,
    )
    sim.run(1, log=False)
    t0 = time.perf_counter()
    sim.run(args.steps, thermo_every=args.thermo)
    dt_w = time.perf_counter() - t0
    print(f"# {args.steps} steps in {dt_w:.2f}s -> "
          f"{n * args.steps / dt_w:,.0f} atom-steps/s")


if __name__ == "__main__":
    main()
