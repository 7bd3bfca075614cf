"""su2_tpu — an unstructured finite-volume solver for turbulent reactive
compressible flows, written in JAX.

A ground-up JAX/XLA re-design of the capabilities of the SU2 v5.0.0 fork
"Development of a turbulent numerical solver for reactive flows in SU2"
(multispecies reactive Navier-Stokes + SST k-omega + PaSR turbulent
combustion closure).  See SURVEY.md at the repo root for the layer map of the
reference this framework re-implements.

Architecture:
  - struct-of-arrays state: U[nPoint, nVar], V[nPoint, nPrimVar] jnp arrays
  - mesh preprocessing on host (NumPy / native C++) producing static-shape
    device arrays (edges, dual normals, volumes, padded BC index sets)
  - per-edge/per-cell loops -> vectorized gather / compute / segment-sum
  - per-cell secant T-solve, per-face Stefan-Maxwell -> batched, branchless
  - implicit solve -> block-sparse FGMRES with multicolor SGS
  - MPI domain decomposition -> jax.sharding.Mesh over the node axis
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache: the coupled step is a large program, so
# benchmarks, tests and restarts reuse compiled executables across
# processes.  JAX_COMPILATION_CACHE_DIR, when set, is honored by JAX itself
# and nothing is set here; otherwise the cache lives at <repo>/.jax_cache.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Full-precision contractions: every contraction in this solver is a small
# physics contraction (WLS gradient 3x3 systems, flux projections, Jacobian
# blocks) where reduced-precision inputs are not acceptable — on an NVIDIA
# GPU the DEFAULT precision lets XLA run f32 dots in TF32 (10-bit
# mantissa), and the f32 flagship case diverges from rounded WLS gradients.
# The contractions are 2-13 wide and bandwidth-bound, so full f32 costs
# nothing measurable.
_jax.config.update("jax_default_matmul_precision", "highest")

from su2_tpu.version import __version__

__all__ = ["__version__"]
