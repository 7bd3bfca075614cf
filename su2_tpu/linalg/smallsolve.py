"""Batched dense solves for small (Ns x Ns) systems.

jnp.linalg.solve lowers to per-matrix LAPACK-style LU, a poor fit for huge
batches of tiny systems.  This Gauss-Jordan elimination with partial
pivoting is pure vectorized elementwise work over the batch: n unrolled
pivot steps of (B, n, m) updates.
"""

from __future__ import annotations

import jax.numpy as jnp


def gauss_solve(a: jnp.ndarray, b: jnp.ndarray, pivot: bool = True) -> jnp.ndarray:
    """Solve a @ x = b for batches of small systems.

    a: (..., n, n); b: (..., n, k).  Returns (..., n, k).
    Partial (row) pivoting via batched row selection; n is static and small,
    so the pivot loop unrolls at trace time.

    pivot=False skips the row exchanges (argmax + take_along_axis lower to
    per-batch dynamic gathers, which dominate the solve for large
    batches).  Use it for systems with a guaranteed dominant diagonal — the
    regularized Stefan-Maxwell matrix, the molar->mass operator, and the
    time-augmented block-Jacobi diagonals all qualify.
    """
    n = a.shape[-1]
    if not pivot:
        aug = jnp.concatenate([a, b], axis=-1)
        rows = jnp.arange(n)
        for col in range(n):
            pivval = aug[..., col, col][..., None]
            safe = jnp.where(pivval == 0.0, 1.0, pivval)
            prow = aug[..., col, :] / safe
            factors = aug[..., :, col][..., None]
            not_col = (rows != col)[:, None]
            # single select (the .at[col].set row write lowers to a
            # scatter)
            aug = jnp.where(not_col, aug - factors * prow[..., None, :],
                            jnp.broadcast_to(prow[..., None, :], aug.shape))
        return aug[..., :, n:]

    aug = jnp.concatenate([a, b], axis=-1)              # (..., n, m)
    rows = jnp.arange(n)

    for col in range(n):
        # partial pivot among rows >= col
        colvals = jnp.abs(aug[..., :, col])
        colvals = jnp.where(rows >= col, colvals, -jnp.inf)
        piv = jnp.argmax(colvals, axis=-1)              # (...,)
        piv_row = jnp.take_along_axis(
            aug, piv[..., None, None], axis=-2)[..., 0, :]   # (..., m)
        cur_row = aug[..., col, :]
        is_piv = (rows[:, None] == piv[..., None, None])     # (..., n, 1)
        aug = jnp.where(is_piv, cur_row[..., None, :], aug)
        aug = aug.at[..., col, :].set(piv_row)

        # normalize pivot row, eliminate all other rows (Gauss-Jordan)
        pivval = aug[..., col, col][..., None]               # (..., 1)
        safe = jnp.where(pivval == 0.0, 1.0, pivval)
        prow = aug[..., col, :] / safe                       # (..., m)
        factors = aug[..., :, col][..., None]                # (..., n, 1)
        not_col = (rows != col)[:, None]
        aug = jnp.where(not_col, aug - factors * prow[..., None, :], aug)
        aug = aug.at[..., col, :].set(prow)

    return aug[..., :, n:]


def gauss_inv_t(a: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of (B, n, n) blocks with the BATCH axis minor.

    Same pivot-free Gauss-Jordan arithmetic as gauss_solve(pivot=False),
    but every elementwise op runs on (n, 2n, B) arrays, so the batch axis
    is the contiguous one and the tiny n x n blocks never sit in the
    minor dimensions.  Two relayout transposes bracket the solve."""
    bsz, n = a.shape[0], a.shape[-1]
    at = a.reshape(bsz, n * n).T                            # (n*n, B) 2-D
    one = jnp.ones((bsz,), a.dtype)
    zero = jnp.zeros((bsz,), a.dtype)
    # aug[i][j]: python grid of (B,) lane vectors — every op below is a
    # 1-D/2-D elementwise op with B on the minor axis, so XLA's layout
    # keeps lanes dense (a (n, 2n, B) array form let layout assignment
    # put B on the MAJOR axis, 8x-padding every (n, 2n) block: 2 GB
    # temporaries at B=524k, n=8)
    aug = [[at[i * n + j] for j in range(n)]
           + [one if i == j else zero for j in range(n)]
           for i in range(n)]
    for col in range(n):
        pivval = aug[col][col]
        safe = jnp.where(pivval == 0.0, 1.0, pivval)
        prow = [aug[col][j] / safe for j in range(2 * n)]
        for i in range(n):
            if i == col:
                continue
            f = aug[i][col]
            aug[i] = [aug[i][j] - f * prow[j] for j in range(2 * n)]
        aug[col] = prow
    inv_t = jnp.stack([aug[i][n + j] for i in range(n) for j in range(n)],
                      axis=0)                               # (n*n, B)
    return inv_t.T.reshape(bsz, n, n)
