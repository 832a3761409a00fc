"""Benchmark: the BASELINE.json north-star workload — atom-steps/sec on a
259,200-atom buck/coul/long + PPPM system (examples/decks/silica_pppm.yaml,
the reference's data.aC silica scaled to in.spce's size class), running on
the production cell-pair engine with the scatter-free cell-patch PPPM.

Runs on a GPU only: any other backend is an error.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...} with the device
(platform, kind, count), the card's name and power limit, and the peak
device memory.  Failures print the same line with an "error" field and
exit non-zero.

Baseline note: the reference publishes no numbers (BASELINE.md).  The
vs_baseline denominator is 1.06e6 atom-steps/s — MEASURED, not guessed:
native/baseline_md.cpp (a C++ implementation of the reference's own
algorithm: half lists + Newton, A&S-erfc buck/coul/long, order-5 ik
PPPM) runs this exact workload at 37,836 atom-steps/s on one core of a
Xeon (energies cross-checked against the JAX engine to <=1.5e-4),
extrapolated x28 cores to one socket.  Full provenance and the AVX-512
vectorization caveat: BASELINE.md "Measured CPU baseline".  Reproduce
with `python bench_baseline.py`.

Usage:  python bench.py
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(ROOT, "examples", "decks", "silica_pppm.yaml")
METRIC = "atom_steps_per_sec_silica_buck_coul_long_pppm_259k"
BASELINE = 1.06e6  # atom-steps/s, measured single-socket CPU (BASELINE.md)
STEPS = 100


def _fail(stage: str, detail: str) -> None:
    print(json.dumps({
        "metric": METRIC, "value": None, "unit": "atom-steps/s",
        "vs_baseline": None, "error": stage,
        "detail": detail[-2000:],
    }))
    sys.exit(1)


def main():
    import jax

    from lammps_buck_intel_tpu.io.deck import load_deck
    from lammps_buck_intel_tpu.run import build_simulation
    from lammps_buck_intel_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lammps_buck_intel_tpu.utils.device import (
        NoGPUError, card_name_power, peak_memory_bytes, require_gpu)

    cache = enable_compile_cache()
    try:
        devs = require_gpu()
    except NoGPUError as e:
        _fail("no_gpu", str(e))
    card = card_name_power()
    sys.stderr.write(f"[bench] {card} | {devs[0].device_kind} x"
                     f"{len(devs)} | jax {jax.__version__} | "
                     f"cache {cache}\n")

    sim = build_simulation(load_deck(DECK))
    # warm-up at the timed window's block sizes: compiles everything the
    # window runs
    sim.run(STEPS, log=False)
    grows = sim.capacity_grows
    t0 = time.perf_counter()
    sim.run(STEPS, log=False)          # ends in jax.block_until_ready
    dt = time.perf_counter() - t0
    if sim.capacity_grows != grows:
        _fail("capacity_grow", f"{sim.capacity_grows - grows} capacity "
              "grows inside the timed window")
    row = sim.thermo()                 # raises on non-finite thermo
    n = sim.n_atoms
    rate = n * STEPS / dt
    print(json.dumps({
        "metric": METRIC,
        "value": rate,
        "unit": "atom-steps/s",
        "vs_baseline": rate / BASELINE,
        "ms_per_step": dt / STEPS * 1e3,
        "n_atoms": n,
        "steps": STEPS,
        "etotal": row["etotal"],
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card,
        "peak_bytes_in_use": peak_memory_bytes(devs[0]),
    }))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException as e:  # emit structured JSON, never a bare traceback
        import traceback
        _fail(type(e).__name__, traceback.format_exc())
