"""Boundary gather/scatter helpers (ops/bgather.py) are bit-equal to direct
indexing on the index sets the boundary code passes them: scattered lists,
contiguous wall runs, strided inflow columns and their concatenations
(reference: per-marker vertex loops, solver_direct_reactive.cpp:2881-4129)."""

import pytest

import numpy as np
import jax
import jax.numpy as jnp

from su2_tpu.ops import bgather as bg


def _rng(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).normal(size=shape))


def test_rows_matches_indexing():
    x = _rng((500, 16))
    idx = np.array([3, 99, 499, 0, 17, 17])   # duplicates allowed for rows
    np.testing.assert_array_equal(np.asarray(bg.rows(x, idx)),
                                  np.asarray(x[idx]))


def test_rows_1d_and_3d():
    v = _rng((321,), 1)
    idx = np.array([5, 7, 320])
    np.testing.assert_array_equal(np.asarray(bg.rows(v, idx)),
                                  np.asarray(v[idx]))
    g = _rng((100, 14, 2), 2)
    np.testing.assert_array_equal(np.asarray(bg.rows(g, idx % 100)),
                                  np.asarray(g[idx % 100]))


def test_add_rows_matches_scatter_add():
    dest = _rng((200, 13), 3)
    # unique indices (marker vertex lists are unique): bit-equal
    idx = np.array([0, 5, 41, 199])
    vals = _rng((4, 13), 4)
    np.testing.assert_array_equal(np.asarray(bg.add_rows(dest, idx, vals)),
                                  np.asarray(dest.at[idx].add(vals)))
    # duplicates still sum, up to addition-order rounding
    idx2 = np.array([0, 5, 5, 199])
    np.testing.assert_allclose(np.asarray(bg.add_rows(dest, idx2, vals)),
                               np.asarray(dest.at[idx2].add(vals)),
                               rtol=1e-14)


def test_set_rows_and_col():
    dest = _rng((150, 4), 5)
    idx = np.array([2, 9, 149])
    vals = _rng((3, 4), 6)
    np.testing.assert_array_equal(np.asarray(bg.set_rows(dest, idx, vals)),
                                  np.asarray(dest.at[idx].set(vals)))
    cv = _rng((3,), 7)
    np.testing.assert_array_equal(
        np.asarray(bg.set_col_rows(dest, idx, 2, cv)),
        np.asarray(dest.at[idx, 2].set(cv)))


def test_traced_index_falls_back():
    x = _rng((50, 3))

    @jax.jit
    def f(idx):
        return bg.rows(x, idx)

    idx = jnp.asarray([1, 2, 3])
    np.testing.assert_array_equal(np.asarray(f(idx)), np.asarray(x[idx]))


def test_bool_dest_falls_back():
    mask = jnp.zeros((40,), bool)
    idx = np.array([1, 4])
    out = bg.set_rows(mask, idx, True)
    assert bool(out[1]) and bool(out[4]) and not bool(out[0])


# index sets as structured-ordered markers produce them: a contiguous wall
# run, a strided inflow column, and a concatenation of both
AP_SETS = {
    "contiguous": np.arange(40, 60),
    "strided": np.arange(3, 200, 10),
    "segments": np.concatenate([np.arange(0, 10), np.arange(105, 205, 10)]),
}


@pytest.mark.parametrize("kind", sorted(AP_SETS))
def test_ap_rows_and_add_rows(kind):
    idx = AP_SETS[kind]
    x = _rng((210, 3), 8)
    np.testing.assert_array_equal(np.asarray(bg.rows(x, idx)),
                                  np.asarray(x[idx]))
    vals = _rng((idx.size, 3), 9)
    np.testing.assert_array_equal(np.asarray(bg.add_rows(x, idx, vals)),
                                  np.asarray(x.at[idx].add(vals)))


@pytest.mark.parametrize("kind", sorted(AP_SETS))
def test_ap_set_rows_under_jit(kind):
    idx = AP_SETS[kind]
    x = _rng((210, 2), 10)
    vals = _rng((idx.size, 2), 11)
    got = jax.jit(lambda d, v: bg.set_rows(d, idx, v))(x, vals)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(x.at[idx].set(vals)))
