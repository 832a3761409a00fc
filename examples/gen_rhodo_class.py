"""Generate examples/data.rhodo_class — a synthetic CHARMM-class system.

The reference ships in.rhodo (/root/reference/examples/in.rhodo) but NOT
data.rhodo (the 32k-atom rhodopsin benchmark data file is distributed
separately).  This generator builds a deterministic stand-in exercising
the same force-field machinery: atom_style full with dihedrals and
impropers, lj/charmm/coul/long pair, charmm angles (Urey-Bradley), charmm
dihedrals (weighted 1-4), harmonic impropers, H atoms for `fix shake m
1.0`, and `special_bonds charmm`.

System: united-atom-ish chains  H-C-C(-H)-C(-H)-C-H  packed on a cubic
lattice of molecules, charges summing to zero per molecule.

Run: python examples/gen_rhodo_class.py   (writes examples/data.rhodo_class)
"""
import os
import sys

import numpy as np


def build(nx=6, ny=6, nz=6, spacing=9.0, seed=20260816):
    rng = np.random.default_rng(seed)
    # one molecule: 4 backbone C + 4 H, zig-zag
    cb = np.array([[0.0, 0.0, 0.0], [1.53, 0.0, 0.3],
                   [2.3, 1.3, 0.0], [3.83, 1.3, 0.3]])
    hoff = np.array([[-0.6, -0.8, 0.4], [0.3, -1.0, -0.3],
                     [0.3, 0.9, 0.5], [0.8, -0.5, -0.4]], np.float64)
    hoff *= 1.09 / np.linalg.norm(hoff, axis=1, keepdims=True)
    hb = cb + hoff
    xm = np.concatenate([cb, hb])              # 8 sites: 0-3 C, 4-7 H
    qm = np.array([0.15, -0.15, -0.15, 0.15, -0.1, 0.1, 0.1, -0.1])
    tm = np.array([0, 0, 0, 0, 1, 1, 1, 1])    # type 0 = C, 1 = H
    bonds_m = [(0, 0, 1), (0, 1, 2), (0, 2, 3),          # C-C (type 1)
               (1, 0, 4), (1, 1, 5), (1, 2, 6), (1, 3, 7)]  # C-H (type 2)
    angles_m = [(0, 0, 1, 2), (0, 1, 2, 3),              # C-C-C charmm+UB
                (1, 4, 0, 1), (1, 5, 1, 2), (1, 6, 2, 3)]  # H-C-C
    diheds_m = [(0, 0, 1, 2, 3),                         # C-C-C-C n=3
                (1, 4, 0, 1, 2)]                         # H-C-C-C n=1
    improp_m = [(0, 1, 0, 2, 5)]                         # planarity at C2

    X, Q, T, MOL = [], [], [], []
    B, A, D, I = [], [], [], []
    m = 0
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                off = (np.array([i, j, k], float) * spacing
                       + 0.5 * spacing + rng.uniform(-0.25, 0.25, 3))
                # random rigid rotation ABOUT THE CENTROID for disorder
                # (base-corner rotations let neighbor molecules overlap)
                ang = rng.uniform(0, 2 * np.pi, 3)
                cz, sz = np.cos(ang[0]), np.sin(ang[0])
                cy, sy = np.cos(ang[1]), np.sin(ang[1])
                R = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]) @ \
                    np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                cen = xm.mean(axis=0)
                xr = (xm - cen) @ R.T + off
                base = len(X) * 0 + 8 * m
                X.extend(xr)
                Q.extend(qm)
                T.extend(tm)
                MOL.extend([m] * 8)
                B += [(t, base + a, base + b) for t, a, b in bonds_m]
                A += [(t, base + a, base + b, base + c)
                      for t, a, b, c in angles_m]
                D += [(t, base + a, base + b, base + c, base + d)
                      for t, a, b, c, d in diheds_m]
                I += [(t, base + a, base + b, base + c, base + d)
                      for t, a, b, c, d in improp_m]
                m += 1
    L = np.array([nx, ny, nz], float) * spacing
    return (np.asarray(X), np.asarray(Q), np.asarray(T, np.int32),
            np.asarray(MOL, np.int32), np.asarray(B, np.int32),
            np.asarray(A, np.int32), np.asarray(D, np.int32),
            np.asarray(I, np.int32), L)


def write(path, nx=6, ny=6, nz=6):
    X, Q, T, MOL, B, A, D, I, L = build(nx, ny, nz)
    n = len(X)
    with open(path, "w") as f:
        f.write("synthetic rhodo-class CHARMM system "
                "(examples/gen_rhodo_class.py)\n\n")
        f.write(f"{n} atoms\n{len(B)} bonds\n{len(A)} angles\n"
                f"{len(D)} dihedrals\n{len(I)} impropers\n"
                "2 atom types\n2 bond types\n2 angle types\n"
                "2 dihedral types\n1 improper types\n\n")
        f.write(f"0.0 {L[0]:.6f} xlo xhi\n0.0 {L[1]:.6f} ylo yhi\n"
                f"0.0 {L[2]:.6f} zlo zhi\n\nMasses\n\n"
                "1 12.011\n2 1.008\n\n")
        f.write("Atoms # full\n\n")
        for a in range(n):
            f.write(f"{a + 1} {MOL[a] + 1} {T[a] + 1} {Q[a]:.4f} "
                    f"{X[a, 0]:.6f} {X[a, 1]:.6f} {X[a, 2]:.6f}\n")
        for name, arr in (("Bonds", B), ("Angles", A),
                          ("Dihedrals", D), ("Impropers", I)):
            f.write(f"\n{name}\n\n")
            for r, row in enumerate(arr):
                cols = " ".join(str(v + 1) for v in row)
                f.write(f"{r + 1} {cols}\n")
    print(f"wrote {path}: {n} atoms, box {L}")


def equilibrate(path, log=True):
    """Settle the synthetic lattice into a thermal state and write the
    result back (the analog of the reference's equilibrated_data.hexane,
    a write_data product re-read by the deck — in.hexane:6).

    The raw lattice carries ~3,800 kcal of bonded+overlap strain.  A
    single long NVT run cannot digest it: the strain->heat flux
    overwhelms the thermostat, the NH chain winds up, exp() underflows
    and the system freezes at T=0 (observed twice).  Protocol that
    works (standard MD practice):
      1. FIRE-minimize the worst strain away;
      2. velocity-redraw annealing — short runs at a small timestep
         with a stiff thermostat, redrawing 300 K velocities between
         stages (each redraw dumps the accumulated heat AND resets the
         NH chain);
      3. a settle run at the deck's production timestep/thermostat, so
         the written Velocities are dynamical, not freshly drawn."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # one-off host job: f64 on the CPU backend
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from lammps_buck_intel_tpu.io.deck import load_deck
    from lammps_buck_intel_tpu.run import run_deck

    here = os.path.dirname(os.path.abspath(__file__))

    def base_cfg():
        cfg = load_deck(os.path.join(here, "decks", "rhodo_class.yaml"))
        cfg.pop("dump", None)
        cfg.pop("write_restart", None)
        cfg.pop("velocity", None)
        cfg["read_data"] = path
        cfg["precision"] = "double"   # equilibrate in f64 (one-off, host)
        # the dilute lattice clusters as it cools; manual slot capacity
        # absorbs the local densification (deck `cap` escape hatch)
        cfg["cap"] = 160
        cfg["write_data"] = path      # each stage reads the previous
        return cfg

    # 1. minimize (run: 0 — write minimized coords + a velocity draw).
    # maxiter 600: FIRE clusters the dilute lattice as it relaxes, and
    # past ~600 iters the local densification overflows the minimizer's
    # density-sized neighbor capacity (observed).  The anneal stages
    # below absorb the residual strain (fmax ~5e2 after 600 iters).
    cfg = base_cfg()
    cfg["minimize"] = {"maxiter": 600, "ftol": 5.0, "dmax": 0.05}
    cfg["velocity"] = {"temp": 300.0, "seed": 4928459}
    cfg["run"] = 0
    cfg["thermo"] = 1
    run_deck(cfg, log=log)

    # 2. annealing stages: dt 0.25 fs, t_damp 5 fs, fresh velocities
    for k in range(6):
        cfg = base_cfg()
        cfg["velocity"] = {"temp": 300.0, "seed": 4928459 + 101 * k}
        cfg["timestep"] = 0.25
        cfg["fixes"] = [
            {"name": "shake", "m": 1.0, "tol": 0.0001},
            {"name": "nvt", "t_start": 300.0, "t_damp": 5.0,
             "tchain": 3},
        ]
        cfg["run"] = 400
        cfg["thermo"] = 200
        run_deck(cfg, log=log)
        print(f"# anneal stage {k + 1}/6 done")

    # 3. settle; velocities carry over.  The glassy lattice keeps
    # releasing heat for a long tail, so the settle keeps a STIFF
    # multi-link chain (dt 0.5, t_damp 10, tchain 3) — the production
    # thermostat (t_damp 50, tchain 1) froze at T=0 here twice: the
    # chain winds up on the relaxation heat and exp-underflows.
    cfg = base_cfg()
    cfg["timestep"] = 0.5
    cfg["fixes"] = [
        {"name": "shake", "m": 1.0, "tol": 0.0001},
        {"name": "nvt", "t_start": 300.0, "t_damp": 10.0, "tchain": 3},
    ]
    cfg["run"] = 2000
    cfg["thermo"] = 400
    _, rows = run_deck(cfg, log=log)
    t_fin = float(rows[-1]["temp"])
    if not (150.0 < t_fin < 450.0):
        raise RuntimeError(
            f"equilibration settle ended at T={t_fin:.1f} K — NOT a "
            "thermal state; refusing to write a bad golden input")
    print(f"equilibrated {path}: staged anneal + 2000-step settle, "
          f"final T={t_fin:.1f} K (f64)")


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    target = os.path.join(here, "data.rhodo_class")
    if "--raw" in sys.argv:
        write(target)
        sys.exit(0)
    # build + equilibrate in a scratch file; install on SUCCESS only.
    # (The shipped file once ended up as the raw strained lattice — no
    # Velocities, T=0 start — because write() overwrote the target
    # before an equilibrate that then failed.)
    tmp = target + ".building"
    write(tmp)
    equilibrate(tmp)
    os.replace(tmp, target)
    print(f"installed {target}")
