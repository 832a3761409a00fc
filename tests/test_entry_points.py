"""Entry-point plumbing: compile cache, GPU-only measurements, precision.

chip_smoke.py and bench.py measure on the card only; here (CPU) they must
fail without printing a result.  chip_smoke's phases themselves are
rehearsed in-process on a 1,200-atom cut of the silica deck.
"""
import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(env_dir, monkeypatch, tmp_path):
    from lammps_buck_intel_tpu.utils import compile_cache as cc

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv(cc.ENV, raising=False)
            assert cc.enable_compile_cache() == cc.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
            assert cc.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv(cc.ENV, want)
            jax.config.update("jax_compilation_cache_dir", "unchanged")
            # the variable is JAX's own: the helper sets no directory
            assert cc.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == "unchanged"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(args, cwd=ROOT, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _ok_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("ok") is True:
            out.append(rec)
    return out


def test_chip_smoke_fails_without_a_gpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)


def test_bench_fails_without_a_gpu():
    r = _run(["bench.py"])
    assert r.returncode != 0
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["error"] == "no_gpu" and rec["value"] is None


def test_translate_only_prints_json():
    r = _run(["-m", "lammps_buck_intel_tpu.run",
              "examples/decks/silica_pppm.yaml", "--translate-only"])
    assert r.returncode == 0, r.stderr
    cfg = json.loads(r.stdout)
    assert cfg["read_data"] == "examples/data.aC"
    assert cfg["kspace_style"] == {"name": "pppm", "accuracy": 1e-4,
                                   "order": 7}


def test_mixed_without_x64_raises():
    from lammps_buck_intel_tpu.core.precision import get_precision

    with jax.enable_x64(False):
        with pytest.raises(ValueError, match="x64"):
            get_precision("mixed")
    assert get_precision("mixed").acc == jax.numpy.float64


def test_chip_smoke_phases_small():
    """Phases 2 and 3 of chip_smoke.py at 1,200 atoms (cutoff 7 so the
    base cell holds 3 cells per axis), f32 with x64 off as on the card:
    every gate holds and every number is recorded."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    with jax.enable_x64(False):
        cfg = chip_smoke.load_cfg()
        cfg["replicate"] = [1, 1, 1]
        cfg["pair_style"]["cut"] = 7.0
        rec = {"card": "cpu"}
        sim = chip_smoke.phase_main_path(
            rec, jax.devices(), chip_smoke.CompileLog(), cfg,
            n_expected=1200, steps=20)
        chip_smoke.phase_kernels(rec, sim)
    mp, k = rec["main_path"], rec["kernels"]
    assert mp["grows_in_window"] == 0 and mp["ms_per_step"] > 0
    assert k["rebin"]["same_cell"] == 1200
    assert k["pair"]["epair_rel"] <= chip_smoke.PAIR_E_RTOL
    assert k["kspace"]["f_rms_rel"] <= chip_smoke.KSPACE_F_RTOL
