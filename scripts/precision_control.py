#!/usr/bin/env python3
"""Does chip_smoke's f32-vs-f64 step check catch a loss of precision?

    python scripts/precision_control.py [--size 565k | NXxNY] [--seed N]

Runs the stand-in combustor's coupled step for ``chip_smoke.N_STEP_CMP``
iterations in f64 (the reference), then in f32 four ways:

  highest    as shipped (``jax_default_matmul_precision="highest"``);
  tf32       the default matmul precision (TF32 dots on an NVIDIA GPU);
  bf16-sst   the SST linear system's right side and solution cut to
             bfloat16's 8 significant bits at every iteration;
  bf16-turb  the (k, omega) state cut to 8 significant bits after every
             SST update.

The cuts clear the low 16 bits of each float32 (a bit mask, which XLA
cannot fold away as it may an f32 -> bf16 -> f32 round trip).  Each run's
readings are printed beside chip_smoke's bounds, with k and omega also
per node (|a - b| / |b|) for information; a control that stays within
every bound is a precision loss the check would miss.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def cut_bf16(x):
    import jax
    import jax.numpy as jnp
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    return jax.lax.bitcast_convert_type(
        bits & jnp.uint32(0xFFFF0000), jnp.float32).astype(x.dtype)


@contextlib.contextmanager
def patched(module, name, wrap):
    inner = getattr(module, name)
    setattr(module, name, wrap(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def bf16_sst_solve():
    from su2_tpu.linalg import krylov

    def wrap(inner):
        def fgmres(matvec, precond, b, *args, **kw):
            sol, *rest = inner(matvec, precond, cut_bf16(b), *args, **kw)
            return (cut_bf16(sol), *rest)
        return fgmres
    return patched(krylov, "fgmres", wrap)


def bf16_turb_state():
    from su2_tpu.turbulence import sst

    def wrap(inner):
        def sst_step(*args, **kw):
            q_new, *rest = inner(*args, **kw)
            return (cut_bf16(q_new), *rest)
        return sst_step
    return patched(sst, "sst_step", wrap)


def per_node(a, b):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="565k")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these variants")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import chip_smoke as cs
    from su2_tpu import testcase

    if args.size in testcase.SIZES:
        nx, ny = testcase.SIZES[args.size]
    else:
        nx, ny = (int(v) for v in args.size.lower().split("x"))
    case = os.path.join(ROOT, ".chip_smoke", "control")
    cfg = testcase.write_case(case, nx, ny, seed=args.seed)
    dev = jax.devices()[0]
    cs.log(f"precision controls at {nx * ny} nodes on {dev.platform} "
           f"({dev.device_kind})")

    variants = {
        "highest": contextlib.nullcontext,
        "tf32": lambda: jax.default_matmul_precision("default"),
        "bf16-sst": bf16_sst_solve,
        "bf16-turb": bf16_turb_state,
    }
    runs = {}
    for name, ctx in variants.items():
        if args.only and name not in args.only:
            continue
        with ctx():
            _, out, _, comp, per_it, _ = cs._run_sim(
                cfg, jnp.float32, cs.N_STEP_CMP)
        cs.log(f"{name}: compile {comp:.3f} s, {per_it * 1e3:.3f} ms/iter")
        runs[name] = out
    jax.config.update("jax_enable_x64", True)
    sim64, o64, *_ = cs._run_sim(cfg, jnp.float64, cs.N_STEP_CMP)
    for name, out in runs.items():
        cs.log(f"-- {name} f32 vs f64")
        readings = cs.step_readings(sim64.lay, out, o64)
        over = [k for k, (d, tol) in readings.items() if not d <= tol]
        for k, (d, tol) in readings.items():
            cs.log(f"  {k:18s} {d:.3e} (bound {tol:.0e})")
        for c, q in enumerate(("k", "omega")):
            cs.log(f"  {q:5s} column {cs.colwise_rel(out['q'][:, c:c + 1], o64['q'][:, c:c + 1]):.3e}"
                   f", per node {per_node(out['q'][:, c], o64['q'][:, c]):.3e}")
        cs.log(f"  {name}: "
               + ("fails " + ", ".join(over) if over else "passes every bound"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
