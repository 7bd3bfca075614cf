"""Mesh deformation: Hicks-Henne surface design variables + spring-analogy
volume propagation (SU2_DEF capability; reference:
Common/src/grid_movement_structure.cpp — CSurfaceMovement::SetHicksHenne
:3080-3260, CVolumetricMovement).

The reference propagates surface displacements with a linear-elasticity FEM
solve; here the volume motion uses the classical edge-spring analogy
(stiffness 1/len^2) solved matrix-free with Jacobi-preconditioned CG — the
same Dirichlet data and a data-parallel operator.  Simplifications vs the
reference's Hicks-Henne: deformation applied along +y (2D airfoil
convention), chord computed from the marker extent, no AoA rotation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from su2_tpu.geometry.mesh_data import MeshArrays
from su2_tpu.linalg import krylov


def hicks_henne(xs: np.ndarray, x_loc: float, t2: float = 3.0) -> np.ndarray:
    """Bump shape f(x) = sin(pi x^m)^t2 with m = log(0.5)/log(x_loc)
    (SetHicksHenne, grid_movement_structure.cpp:3200)."""
    x_loc = min(max(x_loc, 1e-6), 1.0 - 1e-6)
    m = np.log(0.5) / np.log(x_loc)
    xs = np.clip(xs, 0.0, 1.0)
    return np.sin(np.pi * xs ** m) ** t2


def _bernstein_basis(n: int, t: np.ndarray) -> np.ndarray:
    """(len(t), n+1) Bernstein polynomials B_i^n(t) (GetBernstein,
    free_form_def_box CFreeFormDefBox)."""
    from math import comb

    t = np.clip(t, 0.0, 1.0)
    return np.stack([comb(n, i) * t ** i * (1.0 - t) ** (n - i)
                     for i in range(n + 1)], axis=1)


class FFDBox:
    """Bezier free-form deformation box (CFreeFormDefBox,
    Common/src/grid_movement_structure.cpp:6000+), 2D or 3D.

    Corners follow FFD_DEFINITION order (2D: 4 corners CCW, 8 coords; 3D:
    8 corners, 24 coords); the control lattice is the bi/trilinear
    interpolation of the corners with (degree+1) points per direction.
    Parametric coordinates of embedded points come from Newton inversion of
    the bi/trilinear corner map (GetParametricCoord_Iterative).
    """

    def __init__(self, tag: str, corner_coords: list, degree: list, ndim: int):
        self.tag = tag
        self.ndim = ndim
        c = np.asarray(corner_coords, float)
        if ndim == 2:
            self.corners = c.reshape(4, -1)[:, :2]
            self.degree = (int(degree[0]), int(degree[1]))
        else:
            self.corners = c.reshape(8, 3)
            self.degree = (int(degree[0]), int(degree[1]), int(degree[2]))
        self.cp = self._lattice()

    def _lin(self, uvw):
        """Bi/trilinear corner interpolation at parametric uvw (N, d)."""
        q = self.corners
        if self.ndim == 2:
            u, v = uvw[:, 0:1], uvw[:, 1:2]
            return ((1 - u) * (1 - v) * q[0] + u * (1 - v) * q[1]
                    + u * v * q[2] + (1 - u) * v * q[3])
        u, v, w = uvw[:, 0:1], uvw[:, 1:2], uvw[:, 2:3]
        return ((1 - u) * (1 - v) * (1 - w) * q[0]
                + u * (1 - v) * (1 - w) * q[1]
                + u * v * (1 - w) * q[2] + (1 - u) * v * (1 - w) * q[3]
                + (1 - u) * (1 - v) * w * q[4] + u * (1 - v) * w * q[5]
                + u * v * w * q[6] + (1 - u) * v * w * q[7])

    def _lattice(self):
        axes = [np.linspace(0.0, 1.0, d + 1) for d in self.degree]
        grids = np.meshgrid(*axes, indexing="ij")
        uvw = np.stack([g.ravel() for g in grids], axis=1)
        return self._lin(uvw).reshape(
            tuple(d + 1 for d in self.degree) + (self.ndim,))

    def parametrize(self, pts: np.ndarray, n_newton: int = 50,
                    tol: float = 1e-12):
        """(uvw, inside_mask) for pts (N, d): Newton on the corner map."""
        n = pts.shape[0]
        uvw = np.full((n, self.ndim), 0.5)
        for _ in range(n_newton):
            r = self._lin(uvw) - pts
            if np.abs(r).max() < tol:
                break
            # finite-difference Jacobian of the (low-order) corner map
            jac = np.empty((n, self.ndim, self.ndim))
            eps = 1e-7
            for k in range(self.ndim):
                d = np.zeros((1, self.ndim))
                d[0, k] = eps
                jac[:, :, k] = (self._lin(uvw + d) - self._lin(uvw - d)) \
                    / (2 * eps)
            uvw = uvw - np.linalg.solve(jac, r[..., None])[..., 0]
        eps_in = 1e-8
        inside = np.all((uvw > -eps_in) & (uvw < 1.0 + eps_in), axis=1)
        return uvw, inside

    def displace(self, pts: np.ndarray, cp_disp: np.ndarray) -> np.ndarray:
        """Displacement of pts from control-point displacements cp_disp
        (same lattice shape as self.cp); points outside the box are
        unaffected (SetCartesianCoord)."""
        uvw, inside = self.parametrize(pts)
        bi = _bernstein_basis(self.degree[0], uvw[:, 0])
        bj = _bernstein_basis(self.degree[1], uvw[:, 1])
        if self.ndim == 2:
            w = np.einsum("ni,nj->nij", bi, bj)
            disp = np.einsum("nij,ijd->nd", w, cp_disp)
        else:
            bk = _bernstein_basis(self.degree[2], uvw[:, 2])
            w = np.einsum("ni,nj,nk->nijk", bi, bj, bk)
            disp = np.einsum("nijk,ijkd->nd", w, cp_disp)
        return np.where(inside[:, None], disp, 0.0)


def build_ffd_boxes(cfg, ndim: int) -> dict:
    """FFD_DEFINITION + FFD_DEGREE -> {tag: FFDBox}."""
    boxes = {}
    for k, (tag, coords) in enumerate(cfg.ffd_definition):
        deg = cfg.ffd_degree[k] if k < len(cfg.ffd_degree) else [4, 1, 0]
        boxes[tag] = FFDBox(tag, coords, deg, ndim)
    return boxes


def surface_displacement(coords: np.ndarray, marker_nodes: np.ndarray,
                         dvs: list, ffd_boxes: dict | None = None,
                         ffd_scale: float = 1.0) -> np.ndarray:
    """Accumulated (nP, d) boundary displacement from the design variables.

    Hicks-Henne dvs: {kind: 'HICKS_HENNE', up: 0/1, x_loc: float, value}.
    FFD dvs: {kind: 'FFD_CONTROL_POINT_2D'|'FFD_CONTROL_POINT',
    params: [boxtag, i, j, (k,) xm, ym, (zm)], value} — control point
    (i,j[,k]) of the named box moves by value*scale*(xm,ym[,zm])
    (SetFFDCPChange_2D / SetFFDCPChange,
    grid_movement_structure.cpp:4116+)."""
    disp = np.zeros_like(coords)
    ndim = coords.shape[1]

    hh = [dv for dv in dvs if dv["kind"] == "HICKS_HENNE"]
    if hh:
        mx = coords[marker_nodes, 0]
        x0, x1 = mx.min(), mx.max()
        chord = max(x1 - x0, 1e-300)
        xn = (mx - x0) / chord
        for dv in hh:
            ek = hicks_henne(xn, dv["x_loc"])
            sgn = 1.0 if dv.get("up", 1) else -1.0
            disp[marker_nodes, 1] += sgn * dv["value"] * ek * chord

    ffd = [dv for dv in dvs if dv["kind"].startswith("FFD_CONTROL_POINT")]
    if ffd:
        if not ffd_boxes:
            raise ValueError("FFD design variables need FFD_DEFINITION")
        # accumulate control-point displacements per box, then evaluate once
        cp_disp = {t: np.zeros_like(b.cp) for t, b in ffd_boxes.items()}
        for dv in ffd:
            p = dv["params"]
            tag = p[0] if isinstance(p[0], str) else next(iter(ffd_boxes))
            box = ffd_boxes[tag]
            off = 1 if isinstance(p[0], str) else 0
            if box.ndim == 2:
                i, j = int(p[off]), int(p[off + 1])
                mov = np.asarray(p[off + 2:off + 4], float)
                cp_disp[tag][i, j] += dv["value"] * ffd_scale * mov
            else:
                i, j, k = (int(p[off]), int(p[off + 1]), int(p[off + 2]))
                mov = np.asarray(p[off + 3:off + 6], float)
                cp_disp[tag][i, j, k] += dv["value"] * ffd_scale * mov
        for tag, box in ffd_boxes.items():
            if np.any(cp_disp[tag]):
                disp[marker_nodes] += box.displace(
                    coords[marker_nodes], cp_disp[tag])

    bad = [dv["kind"] for dv in dvs
           if dv["kind"] != "HICKS_HENNE"
           and not dv["kind"].startswith("FFD_CONTROL_POINT")]
    if bad:
        raise NotImplementedError(bad[0])
    return disp


def spring_deform(mesh: MeshArrays, bnd_mask: np.ndarray,
                  bnd_disp: np.ndarray, n_iter: int = 200,
                  tol: float = 1e-12) -> jnp.ndarray:
    """Propagate boundary displacements into the volume.

    Solves K dx = 0 on interior nodes with Dirichlet rows at every boundary
    node (the reference fixes all non-moving boundaries too,
    CVolumetricMovement::SetBoundaryDisplacements).  K is the graph
    Laplacian with edge stiffness 1/len^2.
    """
    i = np.asarray(mesh.edges)[:, 0]
    j = np.asarray(mesh.edges)[:, 1]
    coords = np.asarray(mesh.coords)
    k_e = 1.0 / np.maximum(((coords[i] - coords[j]) ** 2).sum(1), 1e-300)
    k_e = jnp.asarray(k_e)
    mask = jnp.asarray(bnd_mask)
    disp_b = jnp.where(mask[:, None], jnp.asarray(bnd_disp), 0.0)

    def lap(x):
        flux = k_e[:, None] * (x[mesh.edges[:, 0]] - x[mesh.edges[:, 1]])
        return mesh.scatter_edges(flux)

    # boundary elimination keeps the interior operator SPD for CG: identity
    # on boundary rows, pure-interior Laplacian elsewhere
    def matvec(x):
        x0 = jnp.where(mask[:, None], 0.0, x)
        return jnp.where(mask[:, None], x, lap(x0))

    deg = mesh.sum_edges_abs(k_e[:, None])[:, 0]
    dinv = jnp.where(mask, 1.0, 1.0 / jnp.maximum(deg, 1e-300))

    rhs = jnp.where(mask[:, None], 0.0, -lap(disp_b))
    x, _, _ = krylov.cg(matvec, lambda r: dinv[:, None] * r, rhs,
                        max_iter=n_iter, tol=tol)
    return disp_b + jnp.where(mask[:, None], 0.0, x)


def deform_coords(mesh: MeshArrays, marker_disp: np.ndarray,
                  n_iter: int = 200, method: str = "SPRING",
                  raw=None, stiffness_type: str = "INVERSE_VOLUME") -> jnp.ndarray:
    """coords + volume-propagated displacement field.

    method SPRING uses the edge-spring analogy; ELASTICITY (requires the
    RawMesh for element connectivity) uses the linear-elasticity FEM like
    the reference's CVolumetricMovement.
    """
    bnd_mask = np.zeros(mesh.npoint, dtype=bool)
    for tag, (nodes, _) in mesh.markers.items():
        bnd_mask[np.asarray(nodes)] = True
    if method == "ELASTICITY" and raw is not None:
        from su2_tpu.solvers import elasticity
        dx = elasticity.solve_elasticity(
            raw, bnd_mask, marker_disp, stiffness_type=stiffness_type,
            n_iter=max(n_iter, 400))
    else:
        dx = spring_deform(mesh, bnd_mask, marker_disp, n_iter=n_iter)
    return mesh.coords + dx


def parse_dv_options(cfg) -> tuple[list, list]:
    """DV_KIND / DV_MARKER / DV_PARAM / DV_VALUE (config_structure.cpp
    design-variable options).  Returns (dv list, marker tags)."""
    kinds = cfg.dv_kind if isinstance(cfg.dv_kind, list) else [cfg.dv_kind]
    params = cfg.dv_param
    values = cfg.dv_value if isinstance(cfg.dv_value, list) else [cfg.dv_value]
    dvs = []
    for k, (kind, val) in enumerate(zip(kinds, values)):
        p = params[k] if k < len(params) else [1.0, 0.5]
        if kind.startswith("FFD"):
            dvs.append({"kind": kind, "params": p, "value": float(val)})
        else:
            dvs.append({"kind": kind,
                        "up": int(round(p[0])) if len(p) > 1 else 1,
                        "x_loc": float(p[-1]), "value": float(val)})
    return dvs, list(cfg.dv_marker)
