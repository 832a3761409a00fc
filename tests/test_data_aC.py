"""examples/data.aC is the base cell of native/_baseline_sys.bin."""
import os
import sys

import numpy as np
import pytest

from lammps_buck_intel_tpu.io import lattice, read_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import make_data_aC  # noqa: E402


@pytest.fixture(scope="module")
def shipped():
    return read_data(os.path.join(ROOT, "examples", "data.aC"))


@pytest.fixture(scope="module")
def binary():
    return make_data_aC.read_baseline_bin()


def test_binary_is_the_259k_system(binary):
    assert binary["n"] == 259200 and binary["ntypes"] == 2


def test_positions_charges_types(shipped, binary):
    n = make_data_aC.N_BASE
    assert shipped.n_atoms == n
    np.testing.assert_array_equal(shipped.x, binary["x"][:n])
    np.testing.assert_array_equal(shipped.q, binary["q"][:n])
    np.testing.assert_array_equal(shipped.type, binary["typ"][:n])
    # 400 Si at +2.96653, 800 O at -1.483265
    assert np.sum(shipped.q == 2.96653) == 400
    assert np.sum(shipped.q == -1.483265) == 800


def test_masses_and_box(shipped, binary):
    np.testing.assert_array_equal(shipped.mass, binary["mass"])
    np.testing.assert_array_equal(shipped.box_lo, np.zeros(3))
    np.testing.assert_array_equal(
        shipped.box_hi, binary["box"] / np.asarray(make_data_aC.REPLICATE))
    np.testing.assert_allclose(shipped.box_hi,
                               [25.15832, 25.15832, 28.020256], rtol=1e-15)


def test_replicating_gives_back_the_binary(shipped, binary):
    """replicate 6 6 6 of the shipped cell reproduces the binary's
    positions (stored as offsets from lo) and box."""
    x, lo, hi, per_atom, *_ = lattice.replicate(
        shipped.x, shipped.box_lo, shipped.box_hi,
        make_data_aC.REPLICATE, per_atom={"q": shipped.q})
    np.testing.assert_allclose(hi - lo, binary["box"], rtol=1e-15)
    np.testing.assert_allclose(x - lo, binary["x"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(per_atom["q"], binary["q"])


def test_rebuild_is_byte_identical(tmp_path, binary):
    out = tmp_path / "data.aC"
    make_data_aC.write_data_aC(str(out), make_data_aC.base_cell(binary))
    with open(os.path.join(ROOT, "examples", "data.aC"), "rb") as f:
        assert out.read_bytes() == f.read()
