"""Test harness: CPU backend with 8 virtual devices + x64 for f64 golden refs.

Multi-device paths run on a virtual CPU mesh (SURVEY.md §4 item 4) so
distributed code is exercised without a multi-card host.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lammps_buck_intel_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

# Persistent XLA compile cache: the suite is COMPILE-dominated (the top
# slab/molecular parity tests each spend 30-80 s compiling 8-device
# programs); caching compiled executables across runs cuts repeat full
# suites several-fold.  Keyed by HLO hash — safe across code changes.
enable_compile_cache(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 ".jax_test_cache"), min_compile_secs=1.0)

import pytest  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(scope="session")
def reference_dir():
    """The reference package's directory (its examples/ holds data.spce
    and equilibrated_data.hexane, which this repository does not ship)."""
    return "/root/reference"


@pytest.fixture(scope="session")
def examples_dir():
    """This repository's examples/ (data.aC, data.triclinic, decks)."""
    return EXAMPLES
