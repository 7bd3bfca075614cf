"""Reference-exact sequential LU-SGS preconditioner (validation only).

The production preconditioner is a multicolor symmetric block-Gauss-Seidel
sweep (linalg/blockcsr.py:multicolor_sgs_apply) — every color updates as one
dense batch, which is the data-parallel ordering.  The reference sweeps nodes
SEQUENTIALLY in natural order (CSysMatrix::ComputeLU_SGSPreconditioner,
Common/src/matrix_structure.cpp:1673):

    (D + L) x* = b        forward, node 0 .. n-1
    (D + U) z  = D x*     backward, node n-1 .. 0

The documented turb-phase parity deviation (~1e-3 field / ~1e-2 residual
level, BASELINE.md) is attributed to this ordering difference.  This module
DEMONSTRATES the attribution (round-2 verdict item 5): it applies the exact
natural-order sweep through a host callback (scipy sparse triangular
solves), so a CPU validation run can show the parity gap collapse.

Block-to-scalar reduction: left-multiplying by the block-diagonal inverse
gives (I + D^-1 L) x* = D^-1 b and (I + D^-1 U) z = x*, whose scalar
expansions are strictly triangular with unit diagonal — so two scipy
spsolve_triangular calls reproduce the reference's per-node block
Gauss-elimination sweep exactly (same ordering, same arithmetic to
rounding).

Selected with LINEAR_SOLVER_PREC= LU_SGS_SEQ or (turb system only) the
env var SU2_TPU_SEQ_SGS_TURB=1.  Defeats jit fusion and SPMD — never use
in production; it exists so the deviation claim is tested, not assumed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _host_apply(n: int, v: int, rows: np.ndarray, cols: np.ndarray,
                blocks: np.ndarray, diag: np.ndarray, r: np.ndarray):
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    diag = np.asarray(diag, np.float64)
    blocks = np.asarray(blocks, np.float64)
    r64 = np.asarray(r, np.float64)
    dinv = np.linalg.inv(diag)                                # (n, v, v)
    scaled = np.einsum("evw,ewx->evx", dinv[rows], blocks)    # D^-1 applied

    ar = np.arange(v)

    def scalar_csr(mask):
        rws, cls, blks = rows[mask], cols[mask], scaled[mask]
        e = rws.size
        ri = np.broadcast_to(rws[:, None, None] * v + ar[None, :, None],
                             (e, v, v)).ravel()
        ci = np.broadcast_to(cls[:, None, None] * v + ar[None, None, :],
                             (e, v, v)).ravel()
        m = sp.coo_matrix((blks.ravel(), (ri, ci)), shape=(n * v, n * v))
        return (m.tocsr() + sp.identity(n * v, format="csr")).sorted_indices()

    t_lower = scalar_csr(rows > cols)
    t_upper = scalar_csr(rows < cols)
    b = np.einsum("nvw,nw->nv", dinv, r64).ravel()
    x = spsolve_triangular(t_lower, b, lower=True)
    z = spsolve_triangular(t_upper, x, lower=False)
    return z.reshape(r.shape).astype(r.dtype)


def fam_preconditioner(mesh, v: int):
    """Sequential-SGS pc(diag, sel, r) for the family-major layout
    sel (K, nP, v, v): sel[k, p] couples row p to column (p+o_k) mod n."""
    offsets = [int(o) for o in mesh.stencil_offsets]
    n = int(mesh.npoint)
    rows = np.tile(np.arange(n), len(offsets))
    cols = np.concatenate([(np.arange(n) + o) % n for o in offsets])

    def pc(diag, sel, r):
        def host(diag_h, sel_h, r_h):
            blocks = np.asarray(sel_h).reshape(len(offsets) * n, v, v)
            return _host_apply(n, v, rows, cols, blocks,
                               np.asarray(diag_h), np.asarray(r_h))
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(r.shape, r.dtype), diag, sel, r)
    return pc


def edge_preconditioner(mesh, v: int):
    """Sequential-SGS pc(diag, off_ij, off_ji, r) for the edge layout."""
    edges = np.asarray(mesh.edges)
    n = int(mesh.npoint)
    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])

    def pc(diag, off_ij, off_ji, r):
        def host(diag_h, oij_h, oji_h, r_h):
            blocks = np.concatenate([np.asarray(oij_h), np.asarray(oji_h)])
            return _host_apply(n, v, rows, cols, blocks,
                               np.asarray(diag_h), np.asarray(r_h))
        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(r.shape, r.dtype),
            diag, off_ij, off_ji, r)
    return pc
