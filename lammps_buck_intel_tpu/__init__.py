"""lammps_buck_intel_tpu — a JAX molecular dynamics engine.

A from-scratch JAX/XLA re-design of the capabilities of
HPAC/lammps-buck-intel (a LAMMPS USER-INTEL extension: Buckingham/LJ pair
styles with cut/long-range Coulomb, PPPM and dispersion-PPPM electrostatics,
NVE integration, and the host-LAMMPS machinery its decks exercise).

Nothing here is a port: state is a functional pytree, kernels are
fixed-shape masked gathers fused under jit, threading races are removed by
construction, and multi-chip scaling is jax.sharding over a device Mesh.
"""

__version__ = "0.1.0"

from . import core
from . import io
from . import utils
from . import computes
