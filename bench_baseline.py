"""Measure the CPU baseline for BASELINE.md: run the native C++
implementation of the reference's algorithm (native/baseline_md.cpp —
binned half lists + Newton, buck/coul/long with A&S erfc, order-5 ik
PPPM, NVE) on the north-star silica workload, on THIS machine's CPU.

Prints one JSON line with the measured single-core atom-steps/s plus the
step-0 energy cross-check against the JAX engine (same physics).

Usage: python bench_baseline.py [--steps 10] [--atoms-scale 1]
"""
import argparse
import json
import os
import struct
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_system():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from lammps_buck_intel_tpu.io import read_data, lattice, velocity
    from lammps_buck_intel_tpu.io.deck import load_deck
    from lammps_buck_intel_tpu.core import get_units, make_box
    from lammps_buck_intel_tpu.models.kspace import setup_pppm

    cfg = load_deck(os.path.join(ROOT, "examples/decks/silica_pppm.yaml"))
    d = read_data(os.path.join(ROOT, cfg["read_data"]))
    x, lo, hi, pa, *_ = lattice.replicate(
        d.x, d.box_lo, d.box_hi, tuple(cfg["replicate"]),
        per_atom={"type": d.type, "q": d.q, "image": d.image},
    )
    typ, q = pa["type"], pa["q"]
    u = get_units("metal")
    n = len(x)
    mass = d.mass
    v = velocity.create(n, cfg["velocity"]["temp"], cfg["velocity"]["seed"],
                        mass[typ], u)
    box = make_box(lo, hi)
    ps = cfg["pair_style"]
    ntypes = len(mass)
    A = np.zeros((ntypes, ntypes))
    rho = np.ones((ntypes, ntypes))
    C = np.zeros((ntypes, ntypes))
    for k, val in ps["coeffs"].items():
        i, j = (int(t) - 1 for t in k.split())
        for (m, arr) in ((0, A), (1, rho), (2, C)):
            arr[i, j] = arr[j, i] = val[m]
    pm = setup_pppm(box, q, cutoff=ps["cut"],
                    accuracy_rel=cfg["kspace_style"]["accuracy"],
                    qqrd2e=u.qqrd2e)
    return dict(n=n, ntypes=ntypes, box=np.asarray(hi) - np.asarray(lo),
                x=np.asarray(x) - np.asarray(lo), v=v, q=q, typ=typ,
                A=A, rho=rho, C=C, cut=float(ps["cut"]),
                cut_coul=float(ps.get("cut_coul", ps["cut"])),
                g_ewald=pm.g_ewald, qqrd2e=u.qqrd2e,
                dt=float(cfg["timestep"]), mass=mass, grid=pm.grid)


def build_spce_system():
    """The literal in.spce workload (288k SPC/E water, lj/cut/coul/long
    + pppm 1e-4 + shake + nvt — /root/reference/examples/in.spce:6-40)
    for native/baseline_spce.cpp."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from lammps_buck_intel_tpu.io import read_data, lattice, velocity
    from lammps_buck_intel_tpu.io.deck import load_deck
    from lammps_buck_intel_tpu.core import get_units, make_box
    from lammps_buck_intel_tpu.models.kspace import setup_pppm

    cfg = load_deck(os.path.join(ROOT, "examples/decks/spce.yaml"))
    d = read_data(os.path.join(ROOT, cfg["read_data"]))
    rep = lattice.replicate(
        d.x, d.box_lo, d.box_hi, tuple(cfg["replicate"]),
        per_atom={"type": d.type, "q": d.q, "image": d.image},
        molecule=d.molecule,
    )
    x, lo, hi, pa = rep[0], rep[1], rep[2], rep[3]
    molid = rep[8]
    typ, q = pa["type"], pa["q"]
    u = get_units("real")
    n = len(x)
    mass = d.mass
    v = velocity.create(n, cfg["velocity"]["temp"], cfg["velocity"]["seed"],
                        mass[typ], u)
    box = make_box(lo, hi)
    ps = cfg["pair_style"]
    ntypes = len(mass)
    eps = np.zeros((ntypes, ntypes))
    sig = np.zeros((ntypes, ntypes))
    for k, val in ps["coeffs"].items():
        i, j = (int(t) - 1 for t in k.split())
        eps[i, j] = eps[j, i] = val[0]
        sig[i, j] = sig[j, i] = val[1]
    lj1 = 48.0 * eps * sig**12
    lj2 = 24.0 * eps * sig**6
    lj3 = 4.0 * eps * sig**12
    lj4 = 4.0 * eps * sig**6
    pm = setup_pppm(box, q, cutoff=float(ps.get("cut_coul", ps["cut"])),
                    accuracy_rel=cfg["kspace_style"]["accuracy"],
                    qqrd2e=u.qqrd2e)
    # water triangles: (O, H1, H2) per molecule id, O first
    order = np.lexsort((typ, molid))
    mol = order.reshape(-1, 3).astype(np.int32)
    assert (typ[mol[:, 0]] == 0).all() and (typ[mol[:, 1:]] == 1).all()
    bond = cfg["bond_style"]["coeffs"][0][1]
    theta = np.deg2rad(cfg["angle_style"]["coeffs"][0][1])
    d_hh = 2.0 * bond * np.sin(theta / 2.0)
    sp = cfg.get("special_bonds", [0.0, 0.0, 0.5])
    nvt = [f for f in cfg["fixes"] if f["name"] == "nvt"][0]
    return dict(n=n, ntypes=ntypes, nmol=len(mol),
                box=np.asarray(hi) - np.asarray(lo),
                x=np.asarray(x) - np.asarray(lo), v=v, q=q, typ=typ,
                lj1=lj1, lj2=lj2, lj3=lj3, lj4=lj4,
                cut=float(ps["cut"]),
                cut_coul=float(ps.get("cut_coul", ps["cut"])),
                g_ewald=pm.g_ewald, qqrd2e=u.qqrd2e,
                dt=float(cfg["timestep"]), mass=mass,
                ftm2v=u.ftm2v, mvv2e=u.mvv2e, boltz=u.boltz,
                mol=mol, d_oh=float(bond), d_hh=float(d_hh),
                t_target=float(nvt["t_start"]),
                t_damp=float(nvt["t_damp"]),
                sp_lj12=float(sp[0]), sp_lj13=float(sp[1]),
                sp_c12=float(sp[0]), sp_c13=float(sp[1]),
                grid=pm.grid)


def write_spce_bin(path, s):
    with open(path, "wb") as f:
        f.write(struct.pack("iii", s["n"], s["ntypes"], s["nmol"]))
        f.write(np.asarray(s["box"], np.float64).tobytes())
        f.write(np.asarray(s["x"], np.float64).tobytes())
        f.write(np.asarray(s["v"], np.float64).tobytes())
        f.write(np.asarray(s["q"], np.float64).tobytes())
        f.write(np.asarray(s["typ"], np.int32).tobytes())
        for k in ("lj1", "lj2", "lj3", "lj4"):
            f.write(np.asarray(s[k], np.float64).tobytes())
        f.write(struct.pack("ddddd", s["cut"], s["cut_coul"],
                            s["g_ewald"], s["qqrd2e"], s["dt"]))
        f.write(np.asarray(s["mass"], np.float64).tobytes())
        f.write(struct.pack("ddd", s["ftm2v"], s["mvv2e"], s["boltz"]))
        f.write(np.asarray(s["mol"], np.int32).tobytes())
        f.write(struct.pack("dddd", s["d_oh"], s["d_hh"],
                            s["t_target"], s["t_damp"]))
        f.write(struct.pack("dddd", s["sp_lj12"], s["sp_lj13"],
                            s["sp_c12"], s["sp_c13"]))


def write_bin(path, s):
    with open(path, "wb") as f:
        f.write(struct.pack("ii", s["n"], s["ntypes"]))
        f.write(np.asarray(s["box"], np.float64).tobytes())
        f.write(np.asarray(s["x"], np.float64).tobytes())
        f.write(np.asarray(s["v"], np.float64).tobytes())
        f.write(np.asarray(s["q"], np.float64).tobytes())
        f.write(np.asarray(s["typ"], np.int32).tobytes())
        for k in ("A", "rho", "C"):
            f.write(np.asarray(s[k], np.float64).tobytes())
        f.write(struct.pack("ddddd", s["cut"], s["cut_coul"],
                            s["g_ewald"], s["qqrd2e"], s["dt"]))
        f.write(np.asarray(s["mass"], np.float64).tobytes())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--deck", choices=["silica", "spce"], default="silica")
    args = ap.parse_args()

    name = "baseline_md" if args.deck == "silica" else "baseline_spce"
    exe = os.path.join(ROOT, "native", name)
    if not os.path.exists(exe):
        subprocess.check_call(
            ["g++", "-O3", "-march=native", "-std=c++17", "-o", exe,
             os.path.join(ROOT, "native", name + ".cpp"), "-lm"])
    if args.deck == "spce":
        s = build_spce_system()
        binp = os.path.join(ROOT, "native", "_baseline_spce.bin")
        write_spce_bin(binp, s)
    else:
        s = build_system()
        binp = os.path.join(ROOT, "native", "_baseline_sys.bin")
        write_bin(binp, s)

    # pow2-padded FFT grid >= the accuracy-driven grid per axis
    def pow2(v):
        g = 1
        while g < v:
            g *= 2
        return g

    grid = [pow2(v) for v in s["grid"]]
    out = subprocess.run(
        [exe, binp, str(args.steps)] + [str(g) for g in grid],
        capture_output=True, text=True)
    sys.stderr.write(out.stderr)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["hardware"] = open("/proc/cpuinfo").read().split(
        "model name\t: ")[1].split("\n")[0]
    rec["cores_used"] = 1
    rec["accuracy_grid"] = list(s["grid"])
    rec["fft_grid"] = grid
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
