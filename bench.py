"""Benchmark: the coupled reactive-RANS step on the stand-in combustor.

Runs the flagship physics (reactive NS + SST + PaSR, 9 species: 13 flow +
2 SST variables) on the in-repo stand-in case (su2_tpu/testcase.py) at
565,671 nodes in float32 and prints one JSON line: ms per coupled
iteration and Mcell-updates/s, with the device it ran on.

The timed loop is the driver's on-device multi-step program
(Simulation.rans_multistep: lax.scan over CHUNK coupled iterations), the
path a production run takes through run(chunk=K).  It fails when JAX finds
no GPU: a CPU number is not a device number.

    python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# one device program per CHUNK iterations: host dispatch is paid once per
# chunk, as in run(chunk=K)
CHUNK = 100
N_CHUNKS = 5


def card():
    """(name, power limit) from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.split(","))
    return name, limit


def main():
    import __graft_entry__ as g

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {dev.platform!r})")
    name, limit = card()
    t0 = time.perf_counter()
    sim = g._flagship_sim(jnp.float32)
    q0, mu_t0, grad_k0, sigma_k0 = sim.initial_turb_state()
    jax.block_until_ready(q0)
    setup = time.perf_counter() - t0
    ignites = jnp.zeros((CHUNK,), bool)

    def advance(state):
        carry, _ = sim.rans_multistep(*state, ignites)
        return carry

    state = (sim.u0, sim.t0, q0, mu_t0, grad_k0, sigma_k0)
    t0 = time.perf_counter()
    state = jax.block_until_ready(advance(state))      # compile + warm-up
    first = time.perf_counter() - t0

    chunk_times = []
    for _ in range(N_CHUNKS):
        t0 = time.perf_counter()
        state = jax.block_until_ready(advance(state))
        chunk_times.append(time.perf_counter() - t0)
    per_iter = np.array(chunk_times) / CHUNK
    ncells = int(sim.raw.npoint)
    med = float(np.median(per_iter))
    result = {
        "metric": "ms per coupled reactive-RANS iteration",
        "ms_per_iter": med * 1e3,
        "ms_per_iter_chunks": [t * 1e3 for t in per_iter],
        "mcell_updates_per_s": ncells / med / 1e6,
        "ncells": ncells,
        "chunk": CHUNK,
        "setup_s": setup,
        "compile_and_first_chunk_s": first,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "name": name,
                   "power_limit": limit},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
