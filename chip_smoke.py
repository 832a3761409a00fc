"""Smoke test of the production path on one NVIDIA GPU.

Runs the north-star deck, examples/decks/silica_pppm.yaml (259,200-atom
amorphous silica, buck/coul/long + order-7 PPPM, NVE), through the
normal entry points, then checks every kernel of that path against the
repository's plain references at full width:

1. device    — JAX's first device must be a GPU (no CPU fallback);
               prints the card's name and power limit, the device kind,
               the JAX version and the compile-cache directory.
2. main path — 100 steps, thermo every 10: finite thermo, etotal drift
               per atom within the deck's 5e-3 gate; compile time, warm
               ms/step and atom-steps/s (timed after a warm-up run, ended
               by jax.block_until_ready), peak device memory, capacity
               grows.
3. kernels   — on the same positions: the f32 cell-tile pair kernel vs
               the f64 neighbor-list engine; f32 CellPPPM vs the f64
               scatter-add PPPM on the same mesh and order (and the error
               the same comparison gives at DEFAULT matmul precision);
               incremental vs full-sort rebin after a 20-step run.

``--four`` runs only the multi-card engines on four cards: the slab
engine (``devices: 4``) and the 2-D pencil engine (``devices_2d: [2, 2]``)
against the one-card engine.

Everything runs in ONE process (one process per card); the f64
references run inside ``jax.enable_x64`` after every f32 result exists.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed
phase exits non-zero without it.

Usage:  python chip_smoke.py [--four] [--record PATH]
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(ROOT, "examples", "decks", "silica_pppm.yaml")
STEPS = 100
THERMO = 10
DRIFT_GATE = 5e-3        # etotal drift per atom (tools/record_goldens.py)
# Pair: f32 pair terms summed over ~1e2 neighbours per atom, accumulated
# in f32: ~1e-6 relative noise in the energy sums, ~1e-5 in a force.
PAIR_E_RTOL = 1e-5
PAIR_F_RTOL = 1e-4
# k-space: same mesh and order as the reference, so only rounding differs.
# The long-range force of a neutral system is a small residual of large
# cancelling mesh sums, so f32 leaves ~1e-4 relative RMS error in it; the
# plain scatter-add solver's own f32 path is printed beside it as that
# floor.  5e-4 stays far below the deck's accuracy target in absolute
# terms (also printed).  TF32 products read ~5e-2 here.
KSPACE_E_RTOL = 1e-5
KSPACE_F_RTOL = 5e-4
# --four: step 0 differs by reduction order and by the slightly different
# k-space mesh the decompositions need (both within the 1e-4 accuracy
# target); after 20 steps f32 trajectories diverge chaotically.
FOUR_STEP0_RTOL = 1e-5
FOUR_STEP20_RTOL = 1e-4
FOUR_FIELDS = ("temp", "evdwl", "ecoul", "elong", "etotal")


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def say(msg=""):
    print(msg, flush=True)


def rel(a, b):
    """|a - b| / max(|b|, 1): relative error against the reference b."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1.0)


def rms_rel(f, ref):
    import numpy as np

    return float(np.sqrt(np.sum((f - ref) ** 2) / np.sum(ref ** 2)))


class CompileLog:
    """Sums JAX's compile-duration events (tracing, lowering, backend)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.backend_compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration
        if event == self.EVENTS[-1]:
            self.backend_compiles += 1


def load_cfg():
    from lammps_buck_intel_tpu.io.deck import load_deck

    cfg = load_deck(DECK)
    for k in ("run", "thermo", "dump", "write_data", "write_restart"):
        cfg.pop(k, None)
    return cfg


# ---------------------------------------------------------------- phase 1
def phase_device(rec):
    import jax

    from lammps_buck_intel_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lammps_buck_intel_tpu.utils.device import (
        card_name_power, require_gpu)

    cache = enable_compile_cache()
    devs = require_gpu()
    card = card_name_power()
    say(card)                          # one line per card, as nvidia-smi
    lines = card.splitlines()
    label = lines[0] if len(set(lines)) == 1 else "; ".join(lines)
    if len(lines) > 1:
        label += f" x{len(lines)}"
    say(f"# device_kind: {devs[0].device_kind} x{len(devs)} | "
        f"jax {jax.__version__} | compile cache: {cache}")
    rec["device"] = {"platform": devs[0].platform,
                     "kind": devs[0].device_kind, "count": len(devs)}
    rec["card"] = label
    return devs


# ---------------------------------------------------------------- phase 2
def phase_main_path(rec, devs, clog, cfg, n_expected=259200,
                    steps=STEPS):
    import jax
    import numpy as np

    from lammps_buck_intel_tpu.run import build_simulation
    from lammps_buck_intel_tpu.utils.device import peak_memory_bytes

    card = rec["card"]
    t0 = time.perf_counter()
    c0 = clog.seconds
    sim = build_simulation(cfg)
    rows = sim.run(steps, thermo_every=THERMO, log=False)
    first_s = time.perf_counter() - t0
    n = sim.n_atoms
    check(n == n_expected, f"deck built {n} atoms, expected {n_expected}")
    check(sim.state.x.dtype == np.float32, "main path is not f32")
    for r in rows:
        for k in ("temp", "epair", "elong", "etotal", "press"):
            check(np.isfinite(r[k]), f"non-finite {k} at step {r['step']}")
    e0 = rows[0]["etotal"]
    drift = max(abs(r["etotal"] - e0) for r in rows) / n
    check(drift <= DRIFT_GATE,
          f"etotal drift {drift:.3e}/atom exceeds the {DRIFT_GATE} gate")
    say(f"# main path: {n} atoms, {steps} steps, thermo every {THERMO}: "
        f"etotal {rows[0]['etotal']:.10g} -> {rows[-1]['etotal']:.10g}, "
        f"drift/atom {drift:.3e} (gate {DRIFT_GATE})")

    # warm window with thermo off: the blocks of the deck's rebin cadence
    sim.run(steps, log=False)                        # compile + warm-up
    compile_s = clog.seconds - c0
    grows0, comp0 = sim.capacity_grows, clog.backend_compiles
    t1 = time.perf_counter()
    sim.run(steps, log=False)
    jax.block_until_ready(sim.state)
    window_s = time.perf_counter() - t1
    grows = sim.capacity_grows - grows0
    compiles = clog.backend_compiles - comp0
    check(grows == 0, f"{grows} capacity grows in the timed window")
    ms = window_s / steps * 1e3
    rate = n * steps / window_s
    peak = peak_memory_bytes(devs[0])
    peak_s = "not reported" if peak is None else f"{peak / 2**30:.3f} GiB"
    say(f"# [{card}] compile {compile_s:.1f} s (first {steps}-step deck "
        f"run incl. compile {first_s:.1f} s)")
    say(f"# [{card}] warm {ms:.3f} ms/step, {rate:.6g} atom-steps/s "
        f"({steps} steps, grid nc={sim.grid.nc} cap={sim.grid.cap} "
        f"reach_z={sim.grid.reach_z})")
    say(f"# [{card}] peak device memory {peak_s}; capacity grows: "
        f"{sim.capacity_grows} in all, {grows} in the window; "
        f"compilations in the window: {compiles}")
    rec["main_path"] = dict(
        n_atoms=n, steps=steps, drift_per_atom=drift,
        etotal_first=rows[0]["etotal"], etotal_last=rows[-1]["etotal"],
        compile_s=compile_s, first_run_s=first_s, ms_per_step=ms,
        atom_steps_per_s=rate, peak_bytes_in_use=peak,
        capacity_grows=sim.capacity_grows, grows_in_window=grows,
        compiles_in_window=compiles, reach_z=sim.grid.reach_z,
        cap=sim.grid.cap)
    return sim


# ---------------------------------------------------------------- phase 3
def to_atom_order(aid, n, *planes):
    """Slot planes -> (n, len(planes)) atom-ordered host array."""
    import numpy as np

    aid = np.asarray(aid)
    valid = aid < n
    out = np.zeros((n, len(planes)), np.float64)
    for c, p in enumerate(planes):
        out[aid[valid], c] = np.asarray(p, np.float64)[valid]
    return out


@contextlib.contextmanager
def cellpppm_matmul_precision(precision):
    """Trace CellPPPM with another matmul precision (diagnostic only)."""
    import lammps_buck_intel_tpu.models.kspace.pppm_cells as pc

    old = pc.MATMUL
    pc.MATMUL = precision
    try:
        yield
    finally:
        pc.MATMUL = old


def f32_results(sim):
    """Everything the comparisons need from the f32 path, on one rebinned
    state; runs before any x64 tracing."""
    import jax
    import numpy as np

    from lammps_buck_intel_tpu.models.kspace import CellPPPM
    from lammps_buck_intel_tpu.models.pair.cellpair import compute_cellpair
    from lammps_buck_intel_tpu.neighbor import cell_slots as cs

    check(isinstance(sim.kspace, CellPPPM), "deck did not bind CellPPPM")
    sim.run(20, log=False)
    st = sim.state
    grid, box, n = sim.grid, sim.box, sim.n_atoms
    st_inc = jax.jit(lambda s: cs.rebin_incremental(grid, box, s))(st)
    st_full = jax.jit(lambda s: cs.rebin(grid, box, s))(st)

    def pair(s):
        r = compute_cellpair(sim.pair, grid, box, s, eflag=True, vflag=True,
                             acc_dtype=sim.precision.acc,
                             newton=sim._newton)
        return r.fx, r.fy, r.fz, r.evdwl, r.ecoul

    def kspace(s):
        fx, fy, fz, elong, _ = sim.kspace.compute_slots(s, True, False)
        return fx, fy, fz, elong

    pr = jax.device_get(jax.jit(pair)(st_inc))
    kr = jax.device_get(jax.jit(kspace)(st_inc))
    with cellpppm_matmul_precision(jax.lax.Precision.DEFAULT):
        # a new function object, so jit traces again instead of reusing
        # the HIGHEST trace
        kr_default = jax.device_get(jax.jit(lambda s: kspace(s))(st_inc))
    for a in (pr[0], kr[0], kr_default[0], st_inc.x):
        check(a.dtype == np.float32, f"f32 path produced {a.dtype}")
    host = jax.device_get(st_inc)
    x = to_atom_order(host.aid, n, host.x, host.y, host.z)
    q = to_atom_order(host.aid, n, host.q)[:, 0]
    # the plain scatter-add solver's own f32 path: the f32 floor
    pm32 = same_mesh_pppm(sim, q, np.float32)
    plain32 = jax.device_get(jax.jit(lambda x_, q_: pm32.compute(
        x_, q_, eflag=False, vflag=False).f)(x.astype(np.float32),
                                             q.astype(np.float32)))
    typ = to_atom_order(host.aid, n, host.typ)[:, 0].astype(np.int32)
    cell_inc = to_atom_order(host.aid, n,
                             np.arange(grid.nslots) // grid.cap)[:, 0]
    full = jax.device_get(st_full)
    cell_full = to_atom_order(full.aid, n,
                              np.arange(grid.nslots) // grid.cap)[:, 0]
    return dict(
        x=x, q=q, typ=typ, cell_inc=cell_inc, cell_full=cell_full,
        overflow=bool(host.overflow) or bool(full.overflow),
        n_inc=int(np.sum(np.asarray(host.aid) < n)),
        n_full=int(np.sum(np.asarray(full.aid) < n)),
        pair_f=to_atom_order(host.aid, n, *pr[:3]),
        evdwl=float(pr[3]), ecoul=float(pr[4]),
        kspace_f=to_atom_order(host.aid, n, *kr[:3]), elong=float(kr[3]),
        kspace_f_default=to_atom_order(host.aid, n, *kr_default[:3]),
        elong_default=float(kr_default[3]),
        kspace_f_plain32=np.asarray(plain32, np.float64))


def same_mesh_pppm(sim, q, dtype):
    """The scatter-add PPPM on CellPPPM's mesh, order and g_ewald (which
    fix everything the accuracy target would otherwise choose)."""
    import numpy as np

    from lammps_buck_intel_tpu.models.kspace import setup_pppm

    pm = sim.kspace.pm
    out = setup_pppm(sim.box, q, cutoff=float(np.sqrt(sim.pair.cutsq_max)),
                     accuracy_rel=1e-4, qqrd2e=pm.qqrd2e, order=pm.order,
                     g_ewald=pm.g_ewald, grid=tuple(pm.grid),
                     acc_dtype=dtype, diff=pm.diff)
    check(tuple(out.grid) == tuple(pm.grid), "reference mesh differs")
    return out


def f64_references(sim, r):
    """The plain references, in f64, on the f32 path's positions."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lammps_buck_intel_tpu.models.pair import compute_pair
    from lammps_buck_intel_tpu.neighbor import neighbor_list as nlmod

    n = sim.n_atoms
    pm = sim.kspace.pm
    box = sim.box
    with jax.enable_x64(True):
        x = jnp.asarray(r["x"], jnp.float64)
        q = jnp.asarray(r["q"], jnp.float64)
        typ = jnp.asarray(r["typ"])
        cutneigh = float(np.sqrt(sim.pair.cutsq_max)) + sim.neighbor.skin
        spec = nlmod.make_spec(n, np.asarray(box.lengths), cutneigh)
        nl, _ = nlmod.build_with_retry(x, box, spec)
        pr = jax.jit(lambda x_, nl_: compute_pair(
            sim.pair, x_, typ, q, box, nl_, eflag=True, vflag=False,
            acc_dtype=jnp.float64, use_special=False))(x, nl)
        pm64 = same_mesh_pppm(sim, r["q"], jnp.float64)
        kr = jax.jit(lambda x_, q_: pm64.compute(x_, q_, eflag=True,
                                                 vflag=False))(x, q)
        out = dict(pair_f=np.asarray(pr.f), evdwl=float(pr.evdwl),
                   ecoul=float(pr.ecoul), kspace_f=np.asarray(kr.f),
                   elong=float(kr.elong), grid=tuple(pm.grid),
                   order=pm.order, accuracy_abs=pm.accuracy_abs)
    for a in (sim.state.x, sim.state.vx, sim.state.fx, sim.state.q):
        check(a.dtype == np.float32, "x64 tracing changed the f32 state")
    return out


def phase_kernels(rec, sim):
    import numpy as np

    card = rec["card"]
    r = f32_results(sim)
    ref = f64_references(sim, r)

    # pair: cell tiles (f32) vs neighbor list (f64)
    e32, e64 = r["evdwl"] + r["ecoul"], ref["evdwl"] + ref["ecoul"]
    pair = dict(epair_rel=rel(e32, e64), evdwl_rel=rel(r["evdwl"],
                                                      ref["evdwl"]),
                ecoul_rel=rel(r["ecoul"], ref["ecoul"]),
                f_rms_rel=rms_rel(r["pair_f"], ref["pair_f"]),
                e_rtol=PAIR_E_RTOL, f_rtol=PAIR_F_RTOL)
    say(f"# [{card}] pair  cell-tile f32 vs nlist f64: evdwl+ecoul rel "
        f"{pair['epair_rel']:.3e} (tol {PAIR_E_RTOL:g}; evdwl "
        f"{pair['evdwl_rel']:.3e}, ecoul {pair['ecoul_rel']:.3e}), force "
        f"RMS rel {pair['f_rms_rel']:.3e} (tol {PAIR_F_RTOL:g})")

    # k-space: CellPPPM (f32) vs scatter-add PPPM (f64), same mesh/order
    ref_f = ref["kspace_f"]
    ks = dict(elong_rel=rel(r["elong"], ref["elong"]),
              f_rms_rel=rms_rel(r["kspace_f"], ref_f),
              f_rms_abs=float(np.sqrt(np.mean(np.sum(
                  (r["kspace_f"] - ref_f) ** 2, axis=1)))),
              accuracy_abs=ref["accuracy_abs"],
              f_rms_rel_plain32=rms_rel(r["kspace_f_plain32"], ref_f),
              elong_rel_default=rel(r["elong_default"], ref["elong"]),
              f_rms_rel_default=rms_rel(r["kspace_f_default"],
                                        ref["kspace_f"]),
              grid=list(ref["grid"]), order=ref["order"],
              e_rtol=KSPACE_E_RTOL, f_rtol=KSPACE_F_RTOL)
    say(f"# [{card}] kspace CellPPPM f32 vs pppm.py f64 (mesh "
        f"{ref['grid']}, order {ref['order']}): elong rel "
        f"{ks['elong_rel']:.3e} (tol {KSPACE_E_RTOL:g}), force RMS rel "
        f"{ks['f_rms_rel']:.3e} (tol {KSPACE_F_RTOL:g})")
    say(f"# [{card}] kspace f32 floor: pppm.py f32 vs f64 force RMS rel "
        f"{ks['f_rms_rel_plain32']:.3e}; CellPPPM absolute RMS force error "
        f"{ks['f_rms_abs']:.3e} vs the deck's accuracy target "
        f"{ks['accuracy_abs']:.3e} (force units)")
    say(f"# [{card}] kspace at DEFAULT matmul precision: elong rel "
        f"{ks['elong_rel_default']:.3e}, force RMS rel "
        f"{ks['f_rms_rel_default']:.3e} (not gated)")

    # rebin: incremental counting sort vs full sort
    n = sim.n_atoms
    same = int(np.sum(r["cell_inc"] == r["cell_full"]))
    rb = dict(atoms=n, same_cell=same, overflow=r["overflow"],
              binned_inc=r["n_inc"], binned_full=r["n_full"])
    say(f"# rebin incremental vs full sort after 20 steps: {same}/{n} "
        f"atoms in the same cell (binned {r['n_inc']} / {r['n_full']})")
    rec["kernels"] = dict(pair=pair, kspace=ks, rebin=rb)

    check(pair["epair_rel"] <= PAIR_E_RTOL, "pair energy out of tolerance")
    check(pair["f_rms_rel"] <= PAIR_F_RTOL, "pair forces out of tolerance")
    check(ks["elong_rel"] <= KSPACE_E_RTOL, "elong out of tolerance")
    check(ks["f_rms_rel"] <= KSPACE_F_RTOL,
          "k-space forces out of tolerance")
    check(not r["overflow"] and r["n_inc"] == n and r["n_full"] == n,
          "rebin dropped atoms")
    check(same == n, f"rebin assignments differ for {n - same} atoms")


# ------------------------------------------------------------------ --four
def phase_four(rec, devs, cfg):
    import jax
    import numpy as np

    from lammps_buck_intel_tpu.parallel import (
        Pencil2DSimulation, SlabCellPairSimulation)
    from lammps_buck_intel_tpu.run import build_simulation

    card = rec["card"]
    check(len(devs) >= 4, f"--four needs 4 GPUs, JAX sees {len(devs)}")
    runs = (("slab4", {"devices": 4}, SlabCellPairSimulation),
            ("pencil2x2", {"devices_2d": [2, 2]}, Pencil2DSimulation),
            ("one_card", {}, None))
    out = {}
    for label, extra, cls in runs:
        t0 = time.perf_counter()
        sim = build_simulation(dict(cfg, **extra))
        used = set()
        for leaf in jax.tree_util.tree_leaves(sim.state):
            used |= set(getattr(leaf, "sharding").device_set)
        if cls is not None:
            check(isinstance(sim, cls), f"{label}: built {type(sim)}")
            check(len(used) == 4,
                  f"{label}: state lives on {len(used)} cards, not 4")
        row0 = sim.thermo()
        sim.run(20, log=False)
        row20 = sim.thermo()
        first_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        sim.run(20, log=False)
        jax.block_until_ready(sim.state)
        ms = (time.perf_counter() - t1) / 20 * 1e3
        out[label] = dict(row0={k: row0[k] for k in FOUR_FIELDS + ("press",)},
                          etotal20=row20["etotal"], cards=len(used),
                          build_and_first_20_s=first_s, warm_ms_per_step=ms)
        say(f"# [{card}] {label}: {len(used)} card(s), build + 20 steps "
            f"{first_s:.1f} s, warm {ms:.3f} ms/step (20 steps), "
            f"step-0 etotal {row0['etotal']:.10g}, step-20 etotal "
            f"{row20['etotal']:.10g}")
        del sim
    base = out["one_card"]
    ok = True
    for label in ("slab4", "pencil2x2"):
        r = out[label]
        worst0 = max(rel(r["row0"][k], base["row0"][k])
                     for k in FOUR_FIELDS)
        press0 = rel(r["row0"]["press"], base["row0"]["press"])
        e20 = rel(r["etotal20"], base["etotal20"])
        r.update(step0_worst_rel=worst0, step0_press_rel=press0,
                 etotal20_rel=e20)
        say(f"# {label} vs one card: step-0 worst rel over {FOUR_FIELDS} "
            f"{worst0:.3e} (tol {FOUR_STEP0_RTOL:g}), press rel "
            f"{press0:.3e} (not gated), etotal after 20 steps rel "
            f"{e20:.3e} (tol {FOUR_STEP20_RTOL:g})")
        ok &= worst0 <= FOUR_STEP0_RTOL and e20 <= FOUR_STEP20_RTOL
    rec["four"] = out
    check(ok, "multi-card run disagrees with the one-card run")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the slab and 2x2 pencil engines on four "
                    "cards against one card")
    ap.add_argument("--record", help="write every measured number to this "
                    "JSON file")
    args = ap.parse_args()
    try:
        import lammps_buck_intel_tpu  # noqa: F401
    except ImportError as e:
        sys.stderr.write(f"chip_smoke: the package is not importable: {e}\n")
        return 2
    from lammps_buck_intel_tpu.utils.device import NoGPUError

    rec = {}
    try:
        devs = phase_device(rec)
    except NoGPUError as e:
        sys.stderr.write(f"chip_smoke: {e}\n")
        return 2
    try:
        if args.four:
            phase_four(rec, devs, load_cfg())
        else:
            clog = CompileLog()
            sim = phase_main_path(rec, devs, clog, load_cfg())
            phase_kernels(rec, sim)
    finally:
        if args.record:
            os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                        exist_ok=True)
            with open(args.record, "w") as f:
                json.dump(rec, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": rec["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
