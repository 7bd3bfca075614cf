"""Spatial gradients of selected primitive variables.

Green-Gauss (SetPrimitive_Gradient_GG, solver_direct_reactive.cpp:1086-1165)
and weighted least squares (SetPrimitive_Gradient_LS, :1170-1326), vectorized
over all nodes via the padded adjacency.

``q`` is the (nP, nG) array of the variables being differentiated — the Euler
path uses [T, u, v, P]; the NS path appends mole fractions
(solver_direct_reactive.cpp:4167).
"""

from __future__ import annotations

import jax.numpy as jnp

from su2_tpu.geometry.mesh_data import MeshArrays

EPS = 1e-16

# cfg NUM_METHOD_GRAD -> gradient kind (solvers.euler.compute_gradients)
GRAD_METHOD_MODE = {
    "GREEN_GAUSS": "GG",
    "WEIGHTED_LEAST_SQUARES": "WLS",
    "LEAST_SQUARES": "WLS",
}


def pg_fix(mesh: MeshArrays, grad: jnp.ndarray,
           vel_rows=None) -> jnp.ndarray:
    """Overwrite rotational-periodic ghost gradient rows with the rotated
    donor gradients (Set_MPI_Solution_Gradient rotation).  grad: (nP, nG,
    d).  vel_rows=(lo, hi) marks a block of vector components that rotates
    across the variable index as well; scalar-only sets pass None."""
    if mesh.pg_src is None:
        return grad
    gsrc = grad[mesh.pg_src]                       # (nG?, ...) small gather
    rot = mesh.pg_rot.astype(grad.dtype)
    g2 = jnp.einsum("ngd,ned->nge", gsrc, rot)     # grad' = grad @ R^T
    if vel_rows is not None:
        lo, hi = vel_rows
        vel = jnp.einsum("nvc,ncd->nvd", rot, g2[:, lo:hi])
        g2 = g2.at[:, lo:hi].set(vel)
    return grad.at[mesh.pg_start:].set(g2)


def green_gauss(mesh: MeshArrays, q: jnp.ndarray) -> jnp.ndarray:
    """(nP, nG) -> (nP, nG, d) gradient.

    grad_i = (sum_edges sgn * 0.5(q_i+q_j) n_e  -  q_i * n_bnd,i) / Vol_i
    where n_bnd,i is the accumulated (inward) vertex normal.
    """
    if mesh.gg_snormal is not None:
        # stencil meshes: per-offset signed dual normals make the whole
        # edge sweep K rolls + FMAs (no gather, no scatter) — each edge's
        # two side contributions are enumerated by the +-o offset pair
        acc = None
        for k, o in enumerate(mesh.stencil_offsets):
            avg = 0.5 * (q + jnp.roll(q, -o, axis=0))           # (nP, nG)
            part = avg[:, :, None] * mesh.gg_snormal[k][:, None, :]
            acc = part if acc is None else acc + part
    else:
        qi = q[mesh.edges[:, 0]]
        qj = q[mesh.edges[:, 1]]
        avg = 0.5 * (qi + qj)                                   # (nE, nG)
        flux = avg[:, :, None] * mesh.edge_normal[:, None, :]   # (nE, nG, d)
        acc = mesh.scatter_edges(flux)                          # (nP, nG, d)
    acc = acc - q[:, :, None] * mesh.bnd_accum_normal[:, None, :]
    return acc / mesh.volume[:, None, None]


def weighted_least_squares(mesh: MeshArrays, q: jnp.ndarray) -> jnp.ndarray:
    """(nP, nG) -> (nP, nG, d) inverse-distance-weighted LS gradient.

    Matches the reference's Cholesky-through-R formulation incl. its
    singular-matrix guards (gradient = 0 if R is singular).
    """
    if mesh.wls_coeff is not None:
        # stencil meshes: the normal-equation inverse is pure geometry and
        # is folded into per-offset coefficient vectors at setup
        # (mesh_data._stencil_grad_geometry) — runtime is K rolls + FMAs.
        # Missing neighbors carry zero coefficients, nulling rolled wraps.
        grad = None
        for k, o in enumerate(mesh.stencil_offsets):
            dq = jnp.roll(q, -o, axis=0) - q                    # (nP, nG)
            part = mesh.wls_coeff[k][:, None, :] * dq[:, :, None]
            grad = part if grad is None else grad + part
        return grad
    if mesh.ndim == 3:
        return _wls_3d(mesh, q)
    assert mesh.ndim == 2
    xi = mesh.coords                                            # (nP, 2)
    xj = mesh.coords[mesh.node_nbrs]                            # (nP, D, 2)
    dx = (xj - xi[:, None, :])
    w = jnp.sum(dx * dx, axis=-1)                               # (nP, D)
    valid = (w > EPS) & (mesh.nbr_mask > 0.5)
    invw = jnp.where(valid, 1.0 / jnp.where(valid, w, 1.0), 0.0)

    r11s = jnp.sum(dx[..., 0] * dx[..., 0] * invw, axis=1)
    r12s = jnp.sum(dx[..., 0] * dx[..., 1] * invw, axis=1)
    r22s = jnp.sum(dx[..., 1] * dx[..., 1] * invw, axis=1)

    dq = q[mesh.node_nbrs] - q[:, None, :]                      # (nP, D, nG)
    cx = jnp.einsum("pd,pdg->pg", dx[..., 0] * invw, dq)
    cy = jnp.einsum("pd,pdg->pg", dx[..., 1] * invw, dq)

    r11 = jnp.where(r11s > EPS, jnp.sqrt(jnp.maximum(r11s, 0.0)), 0.0)
    r12 = jnp.where(jnp.abs(r11) > EPS, r12s / jnp.where(r11 == 0, 1.0, r11), 0.0)
    r22sq = r22s - r12 * r12
    r22 = jnp.where(r22sq > EPS, jnp.sqrt(jnp.maximum(r22sq, 0.0)), 0.0)

    det_r2 = (r11 * r22) ** 2
    singular = jnp.abs(det_r2) < EPS
    det_safe = jnp.where(singular, 1.0, det_r2)

    s00 = jnp.where(singular, 0.0, (r12 * r12 + r22 * r22) / det_safe)
    s01 = jnp.where(singular, 0.0, -r11 * r12 / det_safe)
    s11 = jnp.where(singular, 0.0, r11 * r11 / det_safe)

    gx = cx * s00[:, None] + cy * s01[:, None]
    gy = cx * s01[:, None] + cy * s11[:, None]
    return jnp.stack([gx, gy], axis=-1)

def _wls_3d(mesh: MeshArrays, q: jnp.ndarray) -> jnp.ndarray:
    """3D inverse-distance-weighted LS via normal equations + adjugate 3x3
    inverse (equivalent to the reference's 3D Cholesky-through-R path,
    solver_direct_mean.cpp LS branch, with the same det~0 -> grad 0 guard)."""
    xi = mesh.coords
    dx = mesh.coords[mesh.node_nbrs] - xi[:, None, :]           # (nP, D, 3)
    w = jnp.sum(dx * dx, axis=-1)
    valid = (w > EPS) & (mesh.nbr_mask > 0.5)
    invw = jnp.where(valid, 1.0 / jnp.where(valid, w, 1.0), 0.0)

    a = jnp.einsum("pd,pdi,pdj->pij", invw, dx, dx)             # (nP, 3, 3)
    dq = q[mesh.node_nbrs] - q[:, None, :]                      # (nP, D, nG)
    b = jnp.einsum("pd,pdi,pdg->pig", invw, dx, dq)             # (nP, 3, nG)

    # adjugate inverse (vectorized; avoids per-node LAPACK calls)
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c02 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c10 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c20 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c21 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c10 + a[:, 0, 2] * c20
    singular = jnp.abs(det) < EPS
    inv_det = jnp.where(singular, 0.0, 1.0 / jnp.where(singular, 1.0, det))
    ainv = jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c10, c11, c12], axis=-1),
        jnp.stack([c20, c21, c22], axis=-1)], axis=-2) * inv_det[:, None, None]
    grad = jnp.einsum("pij,pjg->pgi", ainv, b)
    return grad
