"""Rebuild ``examples/data.aC`` from ``native/_baseline_sys.bin``.

The binary (written by ``bench_baseline.py write_bin``) holds the
259,200-atom silica system, the 1,200-atom amorphous-silica base cell
replicated 6 x 6 x 6 with positions stored as offsets from ``lo``.  Its
first 1,200 atoms are the (0, 0, 0) replica, so they are the base cell
itself; the base box is the full box divided by the replication.

Usage:  python tools/make_data_aC.py [--out examples/data.aC]
"""
import argparse
import os
import struct

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(ROOT, "native", "_baseline_sys.bin")
REPLICATE = (6, 6, 6)
N_BASE = 1200


def read_baseline_bin(path: str = BIN) -> dict:
    """Parse the ``bench_baseline.py write_bin`` layout."""
    with open(path, "rb") as f:
        buf = f.read()
    n, nt = struct.unpack_from("ii", buf, 0)
    off = 8

    def take(dtype, count):
        nonlocal off
        a = np.frombuffer(buf, dtype, count, off)
        off += a.nbytes
        return a

    box = take(np.float64, 3)
    x = take(np.float64, 3 * n).reshape(n, 3)
    take(np.float64, 3 * n)                      # velocities (not shipped)
    q = take(np.float64, n)
    typ = take(np.int32, n)
    take(np.float64, 3 * nt * nt)                # A, rho, C tables
    take(np.float64, 5)                          # cut, cut_coul, g, qqrd2e, dt
    mass = take(np.float64, nt)
    return dict(n=n, ntypes=nt, box=box, x=x, q=q, typ=typ, mass=mass)


def base_cell(sys_: dict) -> dict:
    """The first replica: 1,200 atoms in the box ``box / REPLICATE``."""
    return dict(x=sys_["x"][:N_BASE], q=sys_["q"][:N_BASE],
                typ=sys_["typ"][:N_BASE], mass=sys_["mass"],
                box=sys_["box"] / np.asarray(REPLICATE, np.float64))


def write_data_aC(path: str, cell: dict) -> None:
    """LAMMPS ``charge``-style data file with lo = 0; floats in repr form
    so that reading the file back gives the binary's values exactly."""
    x, q, typ, mass, box = (cell["x"], cell["q"], cell["typ"],
                            cell["mass"], cell["box"])
    lines = ["LAMMPS data file: amorphous silica base cell "
             "(rebuilt by tools/make_data_aC.py)", "",
             f"{len(x)} atoms", f"{len(mass)} atom types", ""]
    for ax, name in enumerate("xyz"):
        lines.append(f"0.0 {float(box[ax])!r} {name}lo {name}hi")
    lines += ["", "Masses", ""]
    lines += [f"{t + 1} {float(m)!r}" for t, m in enumerate(mass)]
    lines += ["", "Atoms # charge", ""]
    for i in range(len(x)):
        lines.append(f"{i + 1} {int(typ[i]) + 1} {float(q[i])!r} "
                     f"{float(x[i, 0])!r} {float(x[i, 1])!r} "
                     f"{float(x[i, 2])!r}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "examples",
                                                   "data.aC"))
    args = ap.parse_args()
    write_data_aC(args.out, base_cell(read_baseline_bin()))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
