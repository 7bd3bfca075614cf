#!/usr/bin/env python3
"""Proof that the solver's main path runs on an NVIDIA GPU.

    python chip_smoke.py [--seed N]      # one card
    python chip_smoke.py --four          # the sharded path on four cards

One process, which opens the card(s) once.  Phases (one card):

  1. device   — the card's name and power limit (nvidia-smi), JAX's devices;
                fails unless JAX's platform is "gpu".
  2. node state — the per-node pass (su2_tpu/state.py: Cons2Prim with the
                secant temperature solve, dT/dU, dP/dU, Wilke transport) on
                565,671 random 9-species mixture states at 250-2500 K, in
                f32 against f64.  The main path has no hand-written kernel:
                every phase runs what XLA compiles for the card.
  3. main path — the stand-in combustor (su2_tpu/testcase.py) at 565,671
                nodes through ``su2_tpu.driver.main([cfg, "50"])``: two
                25-iteration device chunks, history.dat and the restart are
                written and checked.  Then 10 iterations in f32 against 10
                in f64, with setup, compile and per-iteration times.

``--four`` runs only the 2,259,341-node stand-in sharded over four cards
(Simulation(ndevices=4), a 1-D "cells" mesh) against the same run on one
card.

The last line of standard output is a JSON object with "ok" and the device;
any failed phase raises, so the script exits non-zero without that line.
The case and its outputs (hundreds of MB at this size) go to .chip_smoke/
beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# ---- tolerances (max over columns of max|a - b| / max|b|, the reference b)
# node state f32 vs f64: the f32 rounding of the conserved inputs moves
# T by up to eps32 * |c1| (c1 = e/R reaches ~1e5 K for H-rich mixtures,
# ~6e-3 K), plus the f32 secant stop (4 eps |T|): ~1e-5 of T; 10x margin.
TOL_NODE_F64 = 1e-4
# 10 coupled iterations, f32 vs f64, flow state and T: f32 rounding of the
# explicit updates accumulating over 10 steps.
TOL_STEP_FIELDS = 1e-4
# k and omega, per column: the f32 gap is largest in omega next to the
# walls, where f32 rounding of the wall-scale terms (wall omega ~1e8, ~1e3
# inside) swamps the small interior updates, and grows with wall
# refinement: 4.7e-5 at 22k nodes on the CPU, 2.7e-4 at 565k on an H100.
# Control (scripts/precision_control.py, 565k, H100): the (k, omega) state
# cut to bf16 after every update reads 6.7e-2.
TOL_STEP_TURB = 1e-3
# residual rows, |log10 rms_f32 - log10 rms_f64| over the last half of the
# iterations: the first iterations from the uniform freestream have some
# residuals at the f32 rounding floor of the fluxes (the transverse
# momentum residual is ~1e-14 in f64 at iteration 0), which f32 cannot
# resolve; once the flow develops the rows agree to ~1e-2.
TOL_STEP_LOGRES = 0.05
# SST residual rows, same measure: 2.1e-5 at 565k on an H100; with the SST
# linear system's right side and solution cut to bf16 (a loss the column
# k/omega check does not see) 4.0e-4 (scripts/precision_control.py).
TOL_STEP_SST_LOGRES = 1e-4
# four cards vs one: same arithmetic, other reduction order in the RMS
# and the f32 Krylov dot products over 2.26M nodes; residual rows over the last half of the
# iterations, as for f32 vs f64 (early rows sit at the f32 rounding floor).
TOL_FOUR = 1e-4
TOL_FOUR_LOGRES = 1e-2

N_STEP_CMP = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def colwise_rel(a, b, groups=()):
    """max over columns of max|a - b| / max|b| (columns of 2-D arrays).
    Columns in each of ``groups`` (slices or index lists) share one scale,
    the largest of the group — the components of a vector are compared at
    its magnitude, the partial densities at the density."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a2 = a.reshape(a.shape[0], -1)
    b2 = b.reshape(b.shape[0], -1)
    scale = np.abs(b2).max(axis=0)
    for g in groups:
        scale[g] = scale[g].max()
    scale[scale == 0.0] = 1.0
    return float((np.abs(a2 - b2).max(axis=0) / scale).max())


def state_groups(lay):
    """colwise_rel groups of the conserved state: momentum, and density
    with the partial densities (a species absent to round-off is compared
    at the density, not at its own ~1e-22 scale)."""
    import numpy as np
    return [slice(lay.RHOVX, lay.RHOVX + lay.ndim),
            np.r_[lay.RHO, lay.RHOS:lay.RHOS + lay.ns]]


def live_rows(lay, l64):
    """Residual rows (log10 RMS, iterations x equations) that f32 can
    resolve: rows with a residual at all, and of the species rows those
    above 1e-5 of the continuity row — below that a species residual is
    f32 round-off of the mass flux (Y_s eps32), e.g. the products of the
    ~1e-22 reaction rate of the cold premix."""
    import numpy as np
    live = (l64 > -200.0).all(axis=0)
    sp = slice(lay.RHOS, lay.RHOS + lay.ns)
    live[sp] &= (l64[:, sp] > l64[:, lay.RHO:lay.RHO + 1] - 5.0).all(axis=0)
    return live


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def phase_device(nexpect: int):
    import jax
    devs = jax.devices()
    log(f"jax {jax.__version__}: {devs}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    if len(devs) < nexpect:
        raise SystemExit(f"need {nexpect} GPUs, JAX sees {len(devs)}")
    card = card_line()
    log(f"device: {card}")
    log(f"device_kind: {devs[0].device_kind}, count {len(devs)}")
    return devs, card


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def _node_state(lib_path, inputs, dtype):
    import jax
    import jax.numpy as jnp
    from su2_tpu import state as st
    from su2_tpu.chemistry import library as cl
    from su2_tpu.state import Layout, TSolveParams

    lib = cl.load_library(lib_path, None, dtype)
    libd = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if hasattr(x, "dtype") else x, lib)
    lay = Layout(2, lib.nspecies)
    args = [jnp.asarray(x, dtype) for x in inputs]
    f = jax.jit(lambda u, t, k: st.node_state(libd, lay, u, t,
                                              TSolveParams(), turb_ke=k))
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    tc = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return lay, out, tc, sorted(times)[2]


def phase_node_f32(lib_path, n, seed):
    """The node-state pass in f32 on ``n`` random mixtures.  Returns its
    outputs (host) and the inputs for the f64 comparison."""
    import jax.numpy as jnp
    import numpy as np
    from su2_tpu import testcase
    from su2_tpu.chemistry import library as cl
    from su2_tpu.state import Layout

    lib = cl.load_library(lib_path, None, jnp.float64)
    inputs = testcase.mixture_states(lib, Layout(2, lib.nspecies), n, seed)
    lay, out, tc, tm = _node_state(lib_path, inputs, jnp.float32)
    log(f"node state f32 at {n} nodes: compile+first {tc:.3f} s, median "
        f"call {tm * 1e3:.3f} ms")
    out = {k: np.asarray(getattr(out, k)) for k in
           ("v", "nonphys", "dtdu", "dpdu", "mu", "kappa", "xs")}
    if out["nonphys"].any():
        raise AssertionError("f32 node state flags nonphysical states")
    for k, x in out.items():
        if not np.isfinite(x).all():
            raise AssertionError(f"f32 node state {k} not finite")
    return out, inputs


def phase_node_f64(lib_path, o32, inputs):
    import jax.numpy as jnp
    lay, ref, tc, tm = _node_state(lib_path, inputs, jnp.float64)
    log(f"node state f64: compile+first {tc:.3f} s, median call "
        f"{tm * 1e3:.3f} ms")
    for name, key in (("T", "v"), ("p", "v"), ("dT/dU", "dtdu"),
                      ("dP/dU", "dpdu"), ("mu", "mu"), ("kappa", "kappa"),
                      ("X", "xs")):
        a, b = o32[key], getattr(ref, key)
        if key == "v":
            c = lay.T if name == "T" else lay.P
            a, b = a[:, c:c + 1], b[:, c:c + 1]
        d = colwise_rel(a, b)
        log(f"  node state f32 vs f64  {name:6s} {d:.3e} (tol "
            f"{TOL_NODE_F64:.0e})")
        if not d <= TOL_NODE_F64:
            raise AssertionError(f"node state f32 vs f64: {name} differs {d}")


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------

def phase_main(case_dir, cfg_path, niter=50):
    import numpy as np
    from su2_tpu import driver
    from su2_tpu.io import restart as rio

    for k in ("SU2_TPU_DTYPE", "SU2_TPU_CHUNK", "SU2_TPU_DEVICES"):
        os.environ.pop(k, None)
    cwd = os.getcwd()
    os.chdir(case_dir)
    try:
        t0 = time.perf_counter()
        rc = driver.main([cfg_path, str(niter)])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"driver.main returned {rc}")
    log(f"driver.main: {niter} iterations in two 25-iteration chunks, "
        f"{wall:.3f} s wall (setup + compile + run + output)")
    hist = os.path.join(case_dir, "history.dat")
    rows = [ln for ln in open(hist).read().splitlines()
            if ln.strip() and ln.strip()[0].isdigit()]
    vals = np.array([[float(x) for x in ln.replace(",", " ").split()]
                     for ln in rows])
    if vals.shape[0] != niter or not np.isfinite(vals).all():
        raise AssertionError(f"history.dat: {vals.shape[0]} rows, finite "
                             f"{bool(np.isfinite(vals).all())}")
    u, turb = rio.read_restart(os.path.join(case_dir, "restart_flow.dat"),
                               2, 13, 2)
    if not (np.isfinite(u).all() and np.isfinite(turb).all()):
        raise AssertionError("restart state not finite")
    log(f"history.dat: {vals.shape[0]} finite residual rows; restart: "
        f"{u.shape[0]} nodes, finite")
    return u, turb


def _run_sim(cfg_path, dtype, n_cmp):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation

    t0 = time.perf_counter()
    sim = Simulation(Config(cfg_path), dtype=dtype)
    q = sim.initial_turb_state()
    jax.block_until_ready((sim.u0, q))
    setup = time.perf_counter() - t0
    ign = jnp.zeros((n_cmp,), bool)
    t0 = time.perf_counter()
    carry, ys = sim.rans_multistep(sim.u0, sim.t0, *q, ign)
    jax.block_until_ready(carry)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry2, _ = sim.rans_multistep(*carry, ign)
    jax.block_until_ready(carry2)
    per_it = (time.perf_counter() - t0) / n_cmp
    mem = sim._multistep_jit.lower(
        *([sim._big_buffers()] if sim._multistep_args else []),
        *carry, ign, None).compile().memory_analysis()
    out = dict(u=np.asarray(carry[0]), t=np.asarray(carry[1]),
               q=np.asarray(carry[2]), rms=np.asarray(ys[0]),
               trms=np.asarray(ys[2]), nerr=np.asarray(ys[3]))
    return sim, out, setup, first - per_it * n_cmp, per_it, mem


def phase_step_compare(cfg_path, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    sim32, o32, setup, comp, per_it, mem = _run_sim(
        cfg_path, jnp.float32, N_STEP_CMP)
    n = o32["u"].shape[0]
    log(f"device: {card} | f32 coupled step at {n} nodes: setup "
        f"{setup:.3f} s, compile {comp:.3f} s, {per_it * 1e3:.3f} ms/iter "
        f"({n / per_it / 1e6:.3f} Mcell-updates/s)")
    log(f"f32 step memory_analysis: {mem}")
    if int(o32["nerr"].max()) != 0:
        raise AssertionError(f"f32: {int(o32['nerr'].max())} nonphysical "
                             "nodes")
    for k in ("u", "t", "q", "rms", "trms"):
        if not np.isfinite(o32[k]).all():
            raise AssertionError(f"f32 {k} not finite")
    jax.config.update("jax_enable_x64", True)
    sim64, o64, setup, comp, per_it, _ = _run_sim(
        cfg_path, jnp.float64, N_STEP_CMP)
    log(f"device: {card} | f64 coupled step at {n} nodes: setup "
        f"{setup:.3f} s, compile {comp:.3f} s, {per_it * 1e3:.3f} ms/iter")
    if int(o64["nerr"].max()) != 0:
        raise AssertionError("f64: nonphysical nodes")
    readings = step_readings(sim64.lay, o32, o64)
    for name, (d, tol) in readings.items():
        log(f"  {N_STEP_CMP} its f32 vs f64  {name:18s} {d:.3e} (tol "
            f"{tol:.0e})")
    for name, (d, tol) in readings.items():
        if not d <= tol:
            raise AssertionError(f"f32 vs f64 after {N_STEP_CMP} its: "
                                 f"{name} differs {d}")


def step_readings(lay, o32, o64):
    """f32 against f64 after the same iterations: {name: (reading, bound)}.
    Residual rows are |log10 rms_f32 - log10 rms_f64| over the last half of
    the iterations, on the rows f32 can resolve (live_rows)."""
    import numpy as np
    l32 = np.log10(np.maximum(o32["rms"].astype(np.float64), 1e-300))
    l64 = np.log10(np.maximum(o64["rms"], 1e-300))
    half = l64.shape[0] // 2
    live = live_rows(lay, l64[half:])
    dres = np.abs(l32[half:] - l64[half:]).max(axis=0)
    tres = np.abs(np.log10(o32["trms"][half:])
                  - np.log10(o64["trms"][half:])).max(axis=0)
    log(f"  residual rows log10 f32: {np.array2string(l32[-1], precision=3)}")
    log(f"  residual rows log10 f64: {np.array2string(l64[-1], precision=3)}")
    log(f"  max |dlog10 rms| per equation: "
        f"{np.array2string(dres, precision=3)}; compared: {live.astype(int)}"
        f"; SST: {np.array2string(tres, precision=3)}")
    return {
        "u": (colwise_rel(o32["u"], o64["u"], state_groups(lay)),
              TOL_STEP_FIELDS),
        "T": (colwise_rel(o32["t"][:, None], o64["t"][:, None]),
              TOL_STEP_FIELDS),
        "k,omega": (colwise_rel(o32["q"], o64["q"]), TOL_STEP_TURB),
        "residual rows": (float(dres[live].max()), TOL_STEP_LOGRES),
        "SST residual rows": (float(tres.max()), TOL_STEP_SST_LOGRES)}


# --------------------------------------------------------------------------
# --four
# --------------------------------------------------------------------------

def phase_four(case_dir, seed, card, size="2.26M"):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from su2_tpu import testcase
    from su2_tpu.config import Config
    from su2_tpu.driver import Simulation

    nx, ny = testcase.SIZES[size] if isinstance(size, str) else size
    testcase.write_library(case_dir)
    cfg_path = os.path.join(case_dir, "case.cfg")
    with open(cfg_path, "w") as f:
        f.write(testcase.cfg_text())
    raw = testcase.graded_channel(nx, ny, seed)
    devs = jax.devices()[:4]
    ign = jnp.zeros((N_STEP_CMP,), bool)
    outs = {}
    for nd in (None, 4):
        t0 = time.perf_counter()
        sim = Simulation(Config(cfg_path), dtype=jnp.float32, ndevices=nd,
                         devices=devs if nd else None, raw_mesh=raw)
        q = sim.initial_turb_state()
        jax.block_until_ready((sim.u0, q))
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        carry, ys = sim.rans_multistep(sim.u0, sim.t0, *q, ign)
        jax.block_until_ready(carry)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(sim.rans_multistep(*carry, ign))
        per_it = (time.perf_counter() - t0) / N_STEP_CMP
        label = f"{nd or 1} card{'s' if nd else ''}"
        log(f"device: {card} | f32 coupled step at {raw.npoint} nodes on "
            f"{label}: setup {setup:.3f} s, compile "
            f"{first - per_it * N_STEP_CMP:.3f} s, {per_it * 1e3:.3f} "
            f"ms/iter")
        if nd:
            shard_devs = {s.device for s in carry[0].addressable_shards}
            log(f"  state sharding {carry[0].sharding}; shards on "
                f"{sorted(d.id for d in shard_devs)}")
            if len(shard_devs) != 4 or shard_devs != set(devs):
                raise AssertionError("state is not spread over four cards")
        if int(np.asarray(ys[3]).max()) != 0:
            raise AssertionError(f"{label}: nonphysical nodes")
        outs[nd] = (sim.to_file_order(carry[0]),
                    sim.to_file_order(carry[2]), np.asarray(ys[0]))
    for name, i in (("u", 0), ("k,omega", 1)):
        d = colwise_rel(outs[4][i], outs[None][i],
                        state_groups(sim.lay) if i == 0 else ())
        log(f"  4 cards vs 1 card after {N_STEP_CMP} its  {name:8s} {d:.3e}"
            f" (tol {TOL_FOUR:.0e})")
        if not (np.isfinite(outs[4][i]).all() and d <= TOL_FOUR):
            raise AssertionError(f"four cards vs one: {name} differs {d}")
    r4, r1 = (np.log10(np.maximum(outs[k][2].astype(np.float64), 1e-300))
              for k in (4, None))
    half = N_STEP_CMP // 2                    # as in phase_step_compare
    live = live_rows(sim.lay, r1[half:])
    dres = np.abs(r4[half:] - r1[half:])[:, live].max()
    log(f"  4 cards vs 1 card: max |dlog10 rms| {dres:.3e} (tol "
        f"{TOL_FOUR_LOGRES:.0e})")
    if not dres <= TOL_FOUR_LOGRES:
        raise AssertionError("four cards vs one: residual rows differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded four-card phase")
    args = ap.parse_args()
    if not os.path.isfile(os.path.join(HERE, "su2_tpu", "driver.py")):
        raise SystemExit("chip_smoke.py: the su2_tpu package is not beside "
                         "this script")
    sys.path.insert(0, HERE)
    devs, card = phase_device(4 if args.four else 1)

    from su2_tpu import testcase
    out_root = os.path.join(HERE, ".chip_smoke")
    if args.four:
        case_dir = os.path.join(out_root, "four")
        os.makedirs(case_dir, exist_ok=True)
        phase_four(case_dir, args.seed, card)
    else:
        nx, ny = testcase.SIZES["565k"]
        case_dir = os.path.join(out_root, "case")
        t0 = time.perf_counter()
        cfg_path = testcase.write_case(case_dir, nx, ny, seed=args.seed,
                                       niter=50)
        log(f"stand-in case written ({nx}x{ny} nodes) in "
            f"{time.perf_counter() - t0:.3f} s")
        lib_path = os.path.join(case_dir, "library.txt")
        o32, inputs = phase_node_f32(lib_path, nx * ny, args.seed)
        phase_main(case_dir, cfg_path)
        phase_step_compare(cfg_path, card)
        phase_node_f64(lib_path, o32, inputs)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
