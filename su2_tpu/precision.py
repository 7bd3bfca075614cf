"""Precision control — layer-0 infrastructure.

The framework runs in two modes:
  - validation: float64 (requires ``jax.config.update("jax_enable_x64", True)``)
    used when matching the reference residual histories to 1e-6.
  - production: float32 state with float32 accumulation.

All numerics modules fetch their working dtype from here instead of
hard-coding one, so a single switch flips the whole solver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_VALIDATION = False


def enable_x64() -> None:
    """Switch the whole framework (and JAX) to float64 validation mode."""
    global _VALIDATION
    jax.config.update("jax_enable_x64", True)
    _VALIDATION = True


def validation_mode() -> bool:
    return _VALIDATION


def dtype() -> jnp.dtype:
    """Working floating dtype for solver state."""
    return jnp.float64 if _VALIDATION else jnp.float32


def int_dtype() -> jnp.dtype:
    return jnp.int32


# Small number guards (match the reference's EPS usage in spirit; the value of
# EPS in SU2 is 1e-16, see Common/include/option_structure.hpp).
EPS = 1e-16
TINY_MASS_FRACTION = 1.0e-30  # clip for vanishing species (reacting_model_library.cpp:73)
