"""Elasticity FEM (plane strain) on 2D tri/quad meshes.

Reference capability: CFEASolver / CFEM_ElasticitySolver
(SU2_CFD/src/solver_direct_elasticity.cpp), both the small-deformation
branch and the geometrically nonlinear branch with the compressible
Neo-Hookean material (CFEM_NeoHookean_Comp,
numerics_direct_elasticity_nonlinear.cpp:747-766: Cauchy stress
sigma = mu/J (b - I) + lambda/J ln(J) I, i.e. the strain energy
W = mu/2 (tr C - 3) - mu ln J + lambda/2 ln^2 J), plus the
linear-elasticity mesh deformation of CVolumetricMovement
(Common/src/grid_movement_structure.cpp::SetVolume_Deformation with
DEFORM_STIFFNESS_TYPE).

Linear path: element stiffnesses precomputed in one batched einsum (P1
triangles exactly, bilinear quads with 2x2 Gauss); matrix-free
Jacobi-preconditioned CG with boundary elimination.  Nonlinear path
(array-idiomatic replacement for the hand-coded tangent/stress kernels):
the total Neo-Hookean energy is a pure JAX function of the displacement,
the residual is jax.grad of it and the consistent tangent operator is the
JVP of that gradient — Newton-Krylov with incremental Dirichlet loading
(the reference's INCREMENTAL_LOAD).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.io.mesh import RawMesh
from su2_tpu.linalg import krylov

_GAUSS = 1.0 / np.sqrt(3.0)
_QPTS = [(-_GAUSS, -_GAUSS), (_GAUSS, -_GAUSS),
         (_GAUSS, _GAUSS), (-_GAUSS, _GAUSS)]


def _dmat(e_mod, nu):
    """Plane-strain constitutive matrix (3, 3)."""
    c = e_mod / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return np.array([[c * (1 - nu), c * nu, 0.0],
                     [c * nu, c * (1 - nu), 0.0],
                     [0.0, 0.0, c * (1 - 2 * nu) / 2.0]])


def _tri_stiffness(xy, d):
    """(nE, 3, 2) -> (nE, 6, 6) exact P1 stiffness."""
    x, y = xy[..., 0], xy[..., 1]
    b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]],
                 axis=1)
    c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]],
                 axis=1)
    area2 = (x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2])
    area = 0.5 * np.abs(area2)
    bm = np.zeros((len(xy), 3, 6))
    for a in range(3):
        bm[:, 0, 2 * a] = b[:, a]
        bm[:, 1, 2 * a + 1] = c[:, a]
        bm[:, 2, 2 * a] = c[:, a]
        bm[:, 2, 2 * a + 1] = b[:, a]
    bm /= area2[:, None, None]
    return np.einsum("eia,ij,ejb,e->eab", bm, d, bm, area)


def _quad_stiffness(xy, d):
    """(nE, 4, 2) -> (nE, 8, 8) bilinear stiffness, 2x2 Gauss."""
    ke = np.zeros((len(xy), 8, 8))
    for xi, eta in _QPTS:
        dn = 0.25 * np.array([
            [-(1 - eta), -(1 - xi)], [(1 - eta), -(1 + xi)],
            [(1 + eta), (1 + xi)], [-(1 + eta), (1 - xi)]])  # (4, 2)
        jac = np.einsum("ai,eaj->eij", dn, xy)               # (nE, 2, 2)
        det = jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0]
        inv = np.empty_like(jac)
        inv[:, 0, 0] = jac[:, 1, 1]
        inv[:, 1, 1] = jac[:, 0, 0]
        inv[:, 0, 1] = -jac[:, 0, 1]
        inv[:, 1, 0] = -jac[:, 1, 0]
        inv /= det[:, None, None]
        gdn = np.einsum("eij,aj->eai", inv, dn)              # (nE, 4, 2)
        bm = np.zeros((len(xy), 3, 8))
        for a in range(4):
            bm[:, 0, 2 * a] = gdn[:, a, 0]
            bm[:, 1, 2 * a + 1] = gdn[:, a, 1]
            bm[:, 2, 2 * a] = gdn[:, a, 1]
            bm[:, 2, 2 * a + 1] = gdn[:, a, 0]
        ke += np.einsum("eia,ij,ejb,e->eab", bm, d, bm, np.abs(det))
    return ke


def element_stiffness(mesh: RawMesh, e_mod=1.0, nu=0.3,
                      stiffness_type: str = "CONSTANT_STIFFNESS"):
    """Batched element stiffnesses; INVERSE_VOLUME scales E by 1/area
    (DEFORM_STIFFNESS_TYPE, grid_movement_structure.cpp)."""
    d = _dmat(1.0, nu)
    kes, elem_lists = [], []
    for t, fn, nn in ((5, _tri_stiffness, 3), (9, _quad_stiffness, 4)):
        sel = np.nonzero(mesh.elem_types == t)[0]
        if sel.size == 0:
            continue
        nodes = mesh.elem_nodes[sel][:, :nn]
        xy = mesh.coords[nodes]
        ke = fn(xy, d)
        if stiffness_type == "INVERSE_VOLUME":
            if t == 5:
                x, y = xy[..., 0], xy[..., 1]
                area = 0.5 * np.abs(
                    (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
                    - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
            else:
                area = 0.5 * np.abs(
                    (xy[:, 2, 0] - xy[:, 0, 0]) * (xy[:, 3, 1] - xy[:, 1, 1])
                    - (xy[:, 3, 0] - xy[:, 1, 0]) * (xy[:, 2, 1] - xy[:, 0, 1]))
            ke = ke / area[:, None, None]
        kes.append(e_mod * ke)
        elem_lists.append(nodes)
    return kes, elem_lists


def solve_elasticity(mesh: RawMesh, bnd_mask: np.ndarray,
                     bnd_disp: np.ndarray, e_mod=1.0, nu=0.3,
                     stiffness_type="CONSTANT_STIFFNESS",
                     n_iter: int = 600, tol: float = 1e-12, loads=None):
    """Displacement field with Dirichlet data on bnd_mask nodes and
    optional nodal force loads (K u = f; the FSI driver feeds transferred
    flow tractions here, CFEM_ElasticitySolver + CTransfer_FlowTraction)."""
    kes, elem_lists = element_stiffness(mesh, e_mod, nu, stiffness_type)
    kes = [jnp.asarray(k) for k in kes]
    elem_lists = [jnp.asarray(e, dtype=jnp.int32) for e in elem_lists]
    n = mesh.npoint
    mask = jnp.asarray(bnd_mask)
    disp_b = jnp.where(mask[:, None], jnp.asarray(bnd_disp), 0.0)

    def kmul(x):
        y = jnp.zeros_like(x)
        for ke, en in zip(kes, elem_lists):
            nn = en.shape[1]
            ue = x[en].reshape(en.shape[0], 2 * nn)
            fe = jnp.einsum("eab,eb->ea", ke, ue).reshape(en.shape[0], nn, 2)
            y = y.at[en].add(fe)
        return y

    def op(x):
        x0 = jnp.where(mask[:, None], 0.0, x)
        return jnp.where(mask[:, None], x, kmul(x0))

    # Jacobi preconditioner from the stiffness diagonal
    diag = jnp.zeros((n, 2))
    for ke, en in zip(kes, elem_lists):
        nn = en.shape[1]
        de = jnp.diagonal(ke, axis1=1, axis2=2).reshape(en.shape[0], nn, 2)
        diag = diag.at[en].add(de)
    dinv = jnp.where(mask[:, None], 1.0, 1.0 / jnp.maximum(diag, 1e-300))

    rhs = jnp.where(mask[:, None], 0.0, -kmul(disp_b))
    if loads is not None:
        rhs = rhs + jnp.where(mask[:, None], 0.0, jnp.asarray(loads))
    x, _, _ = krylov.cg(op, lambda r: dinv * r, rhs,
                        max_iter=n_iter, tol=tol)
    return disp_b + jnp.where(mask[:, None], 0.0, x)


# --------------------------------------------------------------------------
# Geometrically nonlinear FEM (compressible Neo-Hookean)
# --------------------------------------------------------------------------

def _grad_tables(mesh: RawMesh):
    """Per-element-type reference shape-function gradients and weights.

    Returns a list of (elem_nodes (nE, nn), dndx (nE, nq, nn, 2),
    w (nE, nq)) with nq quadrature points (tris: 1 exact point, quads:
    2x2 Gauss)."""
    out = []
    tri_sel = np.nonzero(mesh.elem_types == 5)[0]
    if tri_sel.size:
        nodes = mesh.elem_nodes[tri_sel][:, :3]
        xy = mesh.coords[nodes]
        x, y = xy[..., 0], xy[..., 1]
        b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0],
                      y[:, 0] - y[:, 1]], axis=1)
        c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2],
                      x[:, 1] - x[:, 0]], axis=1)
        area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
        dndx = np.stack([b, c], axis=-1) / area2[:, None, None]  # (nE,3,2)
        out.append((nodes, dndx[:, None], 0.5 * np.abs(area2)[:, None]))
    quad_sel = np.nonzero(mesh.elem_types == 9)[0]
    if quad_sel.size:
        nodes = mesh.elem_nodes[quad_sel][:, :4]
        xy = mesh.coords[nodes]
        dndxs, ws = [], []
        for xi, eta in _QPTS:
            dn = 0.25 * np.array([
                [-(1 - eta), -(1 - xi)], [(1 - eta), -(1 + xi)],
                [(1 + eta), (1 + xi)], [-(1 + eta), (1 - xi)]])
            jac = np.einsum("ai,eaj->eij", dn, xy)
            det = jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0]
            inv = np.empty_like(jac)
            inv[:, 0, 0] = jac[:, 1, 1]
            inv[:, 1, 1] = jac[:, 0, 0]
            inv[:, 0, 1] = -jac[:, 0, 1]
            inv[:, 1, 0] = -jac[:, 1, 0]
            inv /= det[:, None, None]
            dndxs.append(np.einsum("eij,aj->eai", inv, dn))
            ws.append(np.abs(det))
        out.append((nodes, np.stack(dndxs, axis=1), np.stack(ws, axis=1)))
    return out


def neo_hookean_energy(tables, u, mu, lam, material="NEO_HOOKEAN_COMP"):
    """Total plane-strain Neo-Hookean strain energy of displacement u.

    NEO_HOOKEAN_COMP: W = mu/2 (tr C - 3) - mu ln J + lambda/2 ln^2 J per
    unit reference volume, with the 2D F embedded as diag(F2, 1)
    (tr C = tr C2 + 1, J = det F2) — the energy whose Cauchy stress is the
    reference's CFEM_NeoHookean_Comp::Compute_Stress_Tensor.

    NEO_HOOKEAN_INCOMP: deviatoric/volumetric split
    W = mu/2 (J^(-2/3) tr C - 3) + kappa/2 (J - 1)^2, whose deviatoric
    Cauchy stress mu J^(-5/3) (b - tr(b)/3 I) matches
    CFEM_NeoHookean_Incomp::Compute_Stress_Tensor with the element
    pressure realized as the volumetric penalty p = kappa (J - 1)
    (near-incompressible penalty form of the reference's mixed pressure;
    kappa = lambda + 2 mu / 3)."""
    total = 0.0
    eye = jnp.eye(2, dtype=u.dtype)
    for nodes, dndx, w in tables:
        ue = u[jnp.asarray(nodes)]                         # (nE, nn, 2)
        g = jnp.einsum("eqad,eai->eqid", jnp.asarray(dndx, u.dtype), ue)
        f = eye[None, None] + g                            # (nE, nq, 2, 2)
        jdet = f[..., 0, 0] * f[..., 1, 1] - f[..., 0, 1] * f[..., 1, 0]
        trc = jnp.sum(f * f, axis=(-2, -1)) + 1.0          # tr(F^T F) 3D
        jsafe = jnp.maximum(jdet, 1e-12)
        if material == "NEO_HOOKEAN_INCOMP":
            kappa = lam + 2.0 * mu / 3.0
            wq = mu / 2.0 * (jsafe ** (-2.0 / 3.0) * trc - 3.0) \
                + kappa / 2.0 * (jdet - 1.0) ** 2
        else:
            lnj = jnp.log(jsafe)
            wq = mu / 2.0 * (trc - 3.0) - mu * lnj + lam / 2.0 * lnj * lnj
        total = total + jnp.sum(jnp.asarray(w, u.dtype) * wq)
    return total


def solve_nonlinear_elasticity(mesh: RawMesh, bnd_mask: np.ndarray,
                               bnd_disp: np.ndarray, e_mod=1.0, nu=0.3,
                               n_incr: int = 4, newton_iter: int = 20,
                               newton_tol: float = 1e-10,
                               cg_iter: int = 400, cg_tol: float = 1e-10,
                               material: str = "NEO_HOOKEAN_COMP"):
    """Large-deformation displacement field with Dirichlet data.

    Newton-Krylov on the energy gradient: residual = grad E, tangent
    applied matrix-free as the JVP of the gradient; Dirichlet data ramps
    over n_incr load increments (INCREMENTAL_LOAD)."""
    mu = e_mod / (2.0 * (1.0 + nu))
    lam = e_mod * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    tables = _grad_tables(mesh)
    mask = jnp.asarray(bnd_mask)
    target = jnp.asarray(bnd_disp)

    energy = lambda u: neo_hookean_energy(tables, u, mu, lam, material)
    grad_e = jax.grad(energy)

    # static Jacobi preconditioner from the linear stiffness diagonal
    kes, elem_lists = element_stiffness(mesh, e_mod, nu)
    diag = jnp.zeros((mesh.npoint, 2))
    for ke, en in zip(kes, elem_lists):
        nn = en.shape[1]
        de = np.diagonal(ke, axis1=1, axis2=2).reshape(en.shape[0], nn, 2)
        diag = diag.at[jnp.asarray(en)].add(jnp.asarray(de))
    dinv = jnp.where(mask[:, None], 1.0, 1.0 / jnp.maximum(diag, 1e-300))

    u = jnp.zeros((mesh.npoint, 2), dtype=jnp.asarray(bnd_disp).dtype)
    for inc in range(1, n_incr + 1):
        u = jnp.where(mask[:, None], target * (inc / n_incr), u)
        for _ in range(newton_iter):
            r = jnp.where(mask[:, None], 0.0, grad_e(u))
            if float(jnp.abs(r).max()) < newton_tol:
                break

            def kop(x):
                x0 = jnp.where(mask[:, None], 0.0, x)
                hx = jax.jvp(grad_e, (u,), (x0,))[1]
                return jnp.where(mask[:, None], x, hx)

            dx, _, _ = krylov.cg(kop, lambda s: dinv * s, -r,
                                 max_iter=cg_iter, tol=cg_tol)
            u = u + jnp.where(mask[:, None], 0.0, dx)
    return u
