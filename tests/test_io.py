import numpy as np
import pytest

from lammps_buck_intel_tpu.io import read_data, lattice, velocity
from lammps_buck_intel_tpu.core import get_units


def test_read_data_charge(examples_dir):
    d = read_data(f"{examples_dir}/data.aC")
    assert d.n_atoms == 1200
    assert d.n_atom_types == 2
    # charge neutral silica: 400 Si (q=2.96653) + 800 O
    np.testing.assert_allclose(d.q.sum(), 0.0, atol=1e-9)
    assert np.isclose(d.mass[0], 28.0855)
    assert np.isclose(d.box_hi[2], 28.0202560)
    assert d.type.min() == 0 and d.type.max() == 1


def test_read_data_full_spce(reference_dir):
    d = read_data(f"{reference_dir}/examples/data.spce")
    assert d.n_atoms == 4500
    assert d.n_bonds == 3000
    assert d.n_angles == 1500
    # image flags present (data.spce:22-34)
    assert np.abs(d.image).max() >= 1
    # water: molecules of O + 2H
    assert d.molecule.max() == 1499
    np.testing.assert_allclose(d.q.sum(), 0.0, atol=1e-8)
    # bonds reference O-H pairs within same molecule
    b = d.bonds
    assert np.all(d.molecule[b[:, 1]] == d.molecule[b[:, 2]])


def test_read_data_full_unsorted_hexane(reference_dir):
    d = read_data(f"{reference_dir}/examples/equilibrated_data.hexane")
    assert d.n_atoms == 6000
    # Velocities section present in write_data output
    assert np.abs(d.v).max() > 0
    # atom id 5405 row appears first but must land at index 5404
    assert np.isclose(d.x[5404, 0], 1.0331041960003817e02)


def test_fcc_lattice():
    x, lo, hi = lattice.create_atoms("fcc", 0.8442, 20, 20, 20)
    assert x.shape == (32000, 3)  # in.buck: 20^3 cells x 4 basis
    a = lattice.lattice_constant("fcc", 0.8442)
    np.testing.assert_allclose(hi, [20 * a] * 3)
    # density check
    vol = np.prod(hi - lo)
    np.testing.assert_allclose(len(x) / vol, 0.8442, rtol=1e-12)


def test_replicate(examples_dir):
    d = read_data(f"{examples_dir}/data.aC")
    x, lo, hi, per_atom, *_ = lattice.replicate(
        d.x, d.box_lo, d.box_hi, (4, 4, 4),
        per_atom={"type": d.type, "q": d.q},
    )
    assert x.shape == (76800, 3)  # in.buck_coul_cut atom count
    assert per_atom["type"].shape == (76800,)
    np.testing.assert_allclose(hi - lo, (d.box_hi - d.box_lo) * 4)


def test_replicate_carries_velocities(reference_dir):
    """LAMMPS replicate tiles every per-atom array including velocities
    (replicate.cpp) — a deck with equilibrated data velocities and no
    `velocity create` must NOT start cold after replicate (the
    hexane_if / rhodo_32k decks)."""
    d = read_data(f"{reference_dir}/examples/equilibrated_data.hexane")
    assert np.abs(d.v).max() > 0
    x, lo, hi, per_atom, *_ = lattice.replicate(
        d.x, d.box_lo, d.box_hi, (1, 3, 1),
        per_atom={"type": d.type, "v": d.v},
    )
    n = len(d.x)
    assert per_atom["v"].shape == (3 * n, 3)
    np.testing.assert_array_equal(per_atom["v"][:n], d.v)
    np.testing.assert_array_equal(per_atom["v"][n:2 * n], d.v)


def test_velocity_create():
    u = get_units("lj")
    m = np.ones(1000)
    v = velocity.create(1000, 1.44, 87287, m, u)
    t = velocity.temperature(v, m, u)
    np.testing.assert_allclose(t, 1.44, rtol=1e-10)
    p = (m[:, None] * v).sum(axis=0)
    np.testing.assert_allclose(p, 0.0, atol=1e-10)


def test_ranpark_park_miller_fixed_point():
    """The LCG core is the Park-Miller minimal standard: from seed 1,
    the 10,000th iterate is 1043618065 (Park & Miller, CACM 1988) —
    pins the host-LAMMPS RanPark stream bit-for-bit."""
    g = velocity.RanPark(1)
    for _ in range(10000):
        g.uniform()
    assert g.seed == 1043618065


def test_velocity_create_lammps_loop_all():
    u = get_units("real")
    m = np.full(3000, 18.0)
    v = velocity.create(3000, 300.0, 432567, m, u, dist="uniform",
                        rng="lammps")
    t = velocity.temperature(v, m, u)
    np.testing.assert_allclose(t, 300.0, rtol=1e-10)
    p = (m[:, None] * v).sum(axis=0)
    np.testing.assert_allclose(p, 0.0, atol=1e-8)
    # deterministic stream
    v2 = velocity.create(3000, 300.0, 432567, m, u, dist="uniform",
                         rng="lammps")
    np.testing.assert_array_equal(v, v2)
    # gaussian path exercises the odd-draw carry
    vg = velocity.create(3001, 300.0, 87287, m[:3001] if len(m) >= 3001
                         else np.full(3001, 18.0), u, dist="gaussian",
                         rng="lammps")
    np.testing.assert_allclose(
        velocity.temperature(vg, np.full(3001, 18.0), u), 300.0,
        rtol=1e-10)


def test_velocity_create_lammps_loop_geom_order_independent():
    """loop geom: each atom's draw depends only on its coordinates, so
    shuffling the atom array permutes the velocities identically — the
    decomposition-independence the host documents for this mode."""
    u = get_units("lj")
    n = 500
    rng = np.random.RandomState(7)
    x = rng.uniform(0.0, 10.0, (n, 3))
    m = np.ones(n)
    v = velocity.create(n, 1.44, 87287, m, u, dist="uniform",
                        rng="lammps", loop="geom", coords=x)
    perm = rng.permutation(n)
    vp = velocity.create(n, 1.44, 87287, m, u, dist="uniform",
                         rng="lammps", loop="geom", coords=x[perm])
    # pre-rescale values follow atoms exactly; post-rescale the momentum
    # zeroing + temperature factor are permutation-invariant too
    np.testing.assert_allclose(vp, v[perm], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(velocity.temperature(v, m, u), 1.44,
                               rtol=1e-10)


def test_translator_emits_lammps_rng(reference_dir):
    from lammps_buck_intel_tpu.io.lammps_input import translate

    cfg = translate(f"{reference_dir}/examples/in.buck")
    assert cfg["velocity"] == {"temp": 1.44, "seed": 87287,
                               "rng": "lammps", "dist": "uniform",
                               "loop": "geom"}
    cfg = translate(f"{reference_dir}/examples/in.spce")
    v = cfg["velocity"]
    assert v["rng"] == "lammps" and v["dist"] == "uniform"
    assert "loop" not in v


@pytest.mark.parametrize("name", ["data.aC", "data.spce",
                                  "equilibrated_data.hexane"])
def test_native_reader_matches_python(name, reference_dir, examples_dir):
    """The C++ fastdata parser and the Python parser must agree exactly."""
    from lammps_buck_intel_tpu.io.fastdata import _load

    if _load() is None:
        pytest.skip("native fastdata unavailable (no g++?)")
    # data.aC ships in this repository; the other two are the reference's
    where = examples_dir if name == "data.aC" else f"{reference_dir}/examples"
    a = read_data(f"{where}/{name}", native=True)
    b = read_data(f"{where}/{name}", native=False)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.v, b.v)
    np.testing.assert_array_equal(a.q, b.q)
    np.testing.assert_array_equal(a.type, b.type)
    np.testing.assert_array_equal(a.molecule, b.molecule)
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.mass, b.mass)
    np.testing.assert_array_equal(a.bonds, b.bonds)
    np.testing.assert_array_equal(a.angles, b.angles)


def test_dump_image(tmp_path):
    """`dump image` analog: a PPM frame per dump interval through the deck
    runner (in.spce:39 contract)."""
    from lammps_buck_intel_tpu.run import run_deck

    cfg = {
        "units": "lj",
        "lattice": {"style": "fcc", "density": 0.8442,
                    "nx": 3, "ny": 3, "nz": 3},
        "mass": [1.0],
        "pair_style": {"name": "lj/cut", "cut": 2.5,
                       "coeffs": {"1 1": [1.0, 1.0]}},
        "velocity": {"temp": 1.0, "seed": 7},
        "neighbor": {"skin": 0.3, "every": 5, "check": False},
        "run": 10, "thermo": 5,
        "dump": {"style": "image", "every": 5, "size": 64,
                 "file": str(tmp_path / "frame_*.ppm")},
    }
    run_deck(cfg, log=False)
    frames = sorted(tmp_path.glob("frame_*.ppm"))
    assert len(frames) == 3  # steps 0, 5, 10
    data = frames[0].read_bytes()
    assert data.startswith(b"P6\n64 64\n255\n")
    body = data.split(b"255\n", 1)[1]
    assert len(body) == 64 * 64 * 3
    assert max(body) > 0  # something was drawn


def test_native_writers_match_python(tmp_path, monkeypatch):
    """Native C++ dump/data writers produce byte-identical files to the
    python fallback (same formats, interchangeable)."""
    import lammps_buck_intel_tpu.io.fastdata as fastdata
    from lammps_buck_intel_tpu.io import dump as dumpmod
    from lammps_buck_intel_tpu.io.data_reader import write_data

    rng = np.random.default_rng(3)
    n = 50

    class S:
        pass

    s = S()
    s.x = rng.random((n, 3)) * 10
    s.v = rng.normal(size=(n, 3))
    s.q = rng.normal(size=n)
    s.type = (np.arange(n) % 3).astype(np.int32)
    s.image = rng.integers(-2, 3, (n, 3)).astype(np.int32)
    s.molecule = (np.arange(n) // 5).astype(np.int32)
    s.mass = np.array([1.0, 2.0, 3.0])

    class B:
        pass

    s.box = B()
    s.box.lo = np.zeros(3)
    s.box.hi = np.full(3, 10.0)
    s.box.tilt = None

    class Sim:
        step_count = 7
        box = s.box
        typ = s.type

        def get_atoms(self):
            return {"x": s.x, "typ": s.type, "v": s.v}

    if fastdata._load() is None:
        pytest.skip("native library unavailable")

    pn = tmp_path / "native.data"
    write_data(str(pn), s, atom_style="full")
    pp = tmp_path / "python.data"
    monkeypatch.setattr(fastdata, "write_data_body",
                        lambda *a, **k: False)
    write_data(str(pp), s, atom_style="full")
    assert pn.read_bytes() == pp.read_bytes()

    tn = tmp_path / "native.lammpstrj"
    dumpmod.write_lammpstrj(str(tn), Sim(), append=False)
    monkeypatch.setattr(fastdata, "write_lammpstrj_frame",
                        lambda *a, **k: False)
    tp = tmp_path / "python.lammpstrj"
    dumpmod.write_lammpstrj(str(tp), Sim(), append=False)
    assert tn.read_bytes() == tp.read_bytes()


def test_dump_triclinic_box_bounds(tmp_path):
    """Triclinic frames carry the LAMMPS `xy xz yz` bounds header with
    tilt-adjusted bounds (dump.cpp convention) — an orthorhombic header
    would misrepresent the cell (advisor r3)."""
    import jax.numpy as jnp
    from lammps_buck_intel_tpu.core import (
        make_box, make_system, get_units, get_precision,
    )
    from lammps_buck_intel_tpu.models.pair import build_lj
    from lammps_buck_intel_tpu.integrate import Simulation
    from lammps_buck_intel_tpu.io import dump as dumpmod

    u = get_units("lj")
    L = np.array([6.0, 5.0, 7.0])
    tilt = (0.8, 0.4, -0.6)
    rng = np.random.default_rng(2)
    lam = rng.uniform(0, 1, (24, 3))
    H = np.array([[L[0], 0, 0], [tilt[0], L[1], 0],
                  [tilt[1], tilt[2], L[2]]])
    x = lam @ H
    box = make_box(np.zeros(3), L, tilt=tilt)
    sys_ = make_system(x, box, mass=np.array([1.0]),
                       dtype=jnp.float64)
    style = build_lj(1, {0: (1.0, 1.0)}, cut_global=2.0,
                     dtype=jnp.float64)
    sim = Simulation(sys_, style, units=u,
                     precision=get_precision("double"))
    for writer, fname in ((dumpmod.write_lammpstrj, "t.lammpstrj"),):
        path = str(tmp_path / fname)
        writer(path, sim, append=False)
        lines = open(path).read().splitlines()
        ib = lines.index("ITEM: BOX BOUNDS xy xz yz pp pp pp")
        b0 = [float(v) for v in lines[ib + 1].split()]
        b1 = [float(v) for v in lines[ib + 2].split()]
        b2 = [float(v) for v in lines[ib + 3].split()]
        # tilt columns
        assert b0[2] == tilt[0] and b1[2] == tilt[1] and b2[2] == tilt[2]
        # LAMMPS bound adjustment: xlo_bound = xlo + min(0,xy,xz,xy+xz)
        assert b0[0] == min(0.0, tilt[0], tilt[1], tilt[0] + tilt[1])
        assert b0[1] == L[0] + max(0.0, tilt[0], tilt[1],
                                   tilt[0] + tilt[1])
        assert b1[0] == min(0.0, tilt[2]) and b1[1] == L[1] + max(
            0.0, tilt[2])
    # custom dump shares the header helper
    path = str(tmp_path / "t.custom")
    dumpmod.write_custom(path, sim, ["id", "x", "y", "z"], append=False)
    assert "ITEM: BOX BOUNDS xy xz yz pp pp pp" in open(path).read()
