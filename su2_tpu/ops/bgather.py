"""Boundary (small static index set) gather/scatter.

Marker node lists are static host-side numpy arrays; these helpers are
plain indexing and ``.at[]`` updates, kept as one place for the boundary
code's gathers and scatters.

Reference semantics: per-marker vertex loops, e.g. BC loops in
SU2_CFD/src/solver_direct_reactive.cpp:2881-4129.
"""

from __future__ import annotations

import jax


def rows(x: jax.Array, idx) -> jax.Array:
    """x[idx] for x of shape (n, ...) with a small idx."""
    return x[idx]


def add_rows(dest: jax.Array, idx, vals: jax.Array) -> jax.Array:
    """dest.at[idx].add(vals)."""
    return dest.at[idx].add(vals)


def set_col_rows(dest: jax.Array, idx, col: int, vals: jax.Array) -> jax.Array:
    """dest.at[idx, col].set(vals)."""
    return dest.at[idx, col].set(vals)


def set_rows(dest: jax.Array, idx, vals: jax.Array) -> jax.Array:
    """dest.at[idx].set(vals)."""
    return dest.at[idx].set(vals)
