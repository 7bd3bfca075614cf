"""Local time step from inviscid/viscous spectral radii.

SetTime_Step (reference: solver_direct_reactive.cpp:2000-2171 Euler,
:5057-5230 NS).  Note the fork's inviscid eigenvalue uses the area-weighted
projected velocity: Lambda = (|v . N| + a_mean) * Area with N the (un-unit)
dual normal — reproduced exactly.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from su2_tpu.geometry.mesh_data import MeshArrays
from su2_tpu.state import Layout
from su2_tpu.ops import bgather as bg

EPS = 1e-16


def _static_marker(nodes, normal):
    """(nodes, normal) as host numpy if trace-time static, else None."""
    if isinstance(nodes, jax.core.Tracer) or isinstance(normal,
                                                         jax.core.Tracer):
        return None
    return np.asarray(nodes), np.asarray(normal)


def precompute_dense_markers(mesh: MeshArrays, dtype) -> None:
    """Materialize the dense per-marker (normal, area) fields ONCE as
    DEVICE arrays and stash them on the mesh.

    The boundary spectral-radius routines densify each marker to a
    full-mesh field; built at trace time from numpy they are inlined into
    the HLO as literals — a few hundred MB at 2M+ cells, which bloats
    every program.  Built here (outside jit) they become captured device
    buffers: same math, same fusion, parameter-passed instead of inlined.
    Also precomputes the merged viscous area^2 weight (ns.py)."""
    cache = {}
    n = int(mesh.npoint)
    w2 = np.zeros((n,), np.float64)
    ok_w2 = True
    for tag, (nodes, normal) in mesh.markers.items():
        stat = _static_marker(nodes, normal)
        if stat is None:
            ok_w2 = False
            continue
        sn, nm = stat
        nd = np.zeros((n, nm.shape[1]), np.float64)
        nd[sn] = nm
        ad = np.zeros((n,), np.float64)
        ad[sn] = np.linalg.norm(nm, axis=1)
        cache[tag] = (jnp.asarray(nd, dtype), jnp.asarray(ad, dtype))
        np.add.at(w2, sn, np.sum(nm.astype(np.float64) ** 2, axis=1))
    if ok_w2 and cache:
        cache["_visc_w2"] = jnp.asarray(w2, dtype)
    object.__setattr__(mesh, "dense_marker_cache", cache)


def boundary_lambda_inv(mesh: MeshArrays, lay: Layout, v: jnp.ndarray,
                        lam: jnp.ndarray, grid_vel=None) -> jnp.ndarray:
    """Add the boundary-vertex inviscid spectral radii to lam.

    Marker node lists and normals are trace-time constants, so each marker
    densifies to one full-mesh elementwise pass against zero-padded static
    normal/area fields (exact: off-marker vertices contribute |v . 0| +
    a*0 = 0) — no gathers or scatters, which otherwise dominate large-mesh
    BC sections as one-hot contractions."""
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    if grid_vel is not None:
        # moving grids: spectral radius from the RELATIVE velocity
        vel = vel - grid_vel
    a = v[:, lay.A]
    n = v.shape[0]
    dense = getattr(mesh, "dense_marker_cache", {})
    for tag, (nodes, normal) in mesh.markers.items():
        hit = dense.get(tag)
        if hit is not None:
            # setup-time device buffers (precompute_dense_markers):
            # captured parameters, not HLO literals
            ndv, adv = hit
            proj = jnp.sum(vel * ndv.astype(v.dtype), axis=1)
            lam = lam + (jnp.abs(proj) + a) * adv.astype(v.dtype)
            continue
        stat = _static_marker(nodes, normal)
        if stat is not None:
            sn, nm = stat
            nd = np.zeros((n, nm.shape[1]), nm.dtype)
            nd[sn] = nm
            ad = np.zeros((n,), nm.dtype)
            ad[sn] = np.linalg.norm(nm, axis=1)
            proj = jnp.sum(vel * jnp.asarray(nd, v.dtype), axis=1)
            lam = lam + (jnp.abs(proj) + a) * jnp.asarray(ad, v.dtype)
            continue
        area = jnp.linalg.norm(normal, axis=1)
        proj = jnp.sum(bg.rows(vel, nodes) * normal, axis=1)
        lam_b = (jnp.abs(proj) + bg.rows(a, nodes)) * area
        lam = bg.add_rows(lam, nodes, lam_b)
    return lam


def max_lambda_inv(mesh: MeshArrays, lay: Layout, v: jnp.ndarray,
                   grid_vel=None) -> jnp.ndarray:
    """Per-node accumulated inviscid spectral radius (interior + boundary);
    with grid_vel the projections use the relative velocity (moving-grid
    SetTime_Step)."""
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    if grid_vel is not None:
        vel = vel - grid_vel
    a = v[:, lay.A]

    if mesh.fam_offsets is not None:
        # family rolls: per positive offset the (p, p+o) edge quantities
        # are node-local expressions; padding slots carry zero normals
        lam = jnp.zeros_like(a)
        for k, o in enumerate(mesh.fam_offsets):
            nrm = mesh.fam_normal[k]                       # (nP, d)
            area = jnp.linalg.norm(nrm, axis=1)
            proj_i = jnp.sum(vel * nrm, axis=1)
            proj_j = jnp.sum(jnp.roll(vel, -o, axis=0) * nrm, axis=1)
            mean_a = 0.5 * (a + jnp.roll(a, -o, axis=0))
            lam_e = (jnp.abs(0.5 * (proj_i + proj_j)) + mean_a) * area
            lam = lam + lam_e + jnp.roll(lam_e, o, axis=0)
        return boundary_lambda_inv(mesh, lay, v, lam, grid_vel=grid_vel)

    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    proj_i = jnp.sum(vel[i] * mesh.edge_normal, axis=1)
    proj_j = jnp.sum(vel[j] * mesh.edge_normal, axis=1)
    mean_proj = 0.5 * (proj_i + proj_j)
    mean_a = 0.5 * (a[i] + a[j])
    lam_e = (jnp.abs(mean_proj) + mean_a) * mesh.edge_area

    lam = mesh.sum_edges_abs(lam_e)
    return boundary_lambda_inv(mesh, lay, v, lam)


def local_time_step(mesh: MeshArrays, lay: Layout, v: jnp.ndarray,
                    cfl: float, max_dt: float = 1e6,
                    lam_visc: jnp.ndarray | None = None, k_v: float = 0.25,
                    grid_vel=None):
    """Per-node dt = CFL*Vol/lambda_inv with the reference's guards; with a
    viscous spectral radius, dt = min(dt_inv, CFL*K_v*Vol^2/lambda_visc)
    (NS SetTime_Step, solver_direct_reactive.cpp:5216-5220).
    Returns (dt, min_dt, max_dt_seen).
    """
    lam = max_lambda_inv(mesh, lay, v, grid_vel=grid_vel)
    vol_ok = mesh.volume > EPS
    dt = jnp.where(vol_ok, cfl * mesh.volume / jnp.where(lam > 0, lam, 1.0), 0.0)
    if lam_visc is not None:
        dt_v = cfl * k_v * mesh.volume ** 2 / jnp.where(lam_visc > 0, lam_visc, 1.0)
        dt = jnp.where(vol_ok, jnp.minimum(dt, dt_v), 0.0)
    dt_pos = jnp.where(vol_ok, dt, jnp.inf)
    min_dt = dt_pos.min()
    max_dt_seen = jnp.where(vol_ok, dt, 0.0).max()
    dt = jnp.minimum(dt, max_dt)
    # CVs with a single neighbor take the global min dt (:2120-2123)
    dt = jnp.where(mesh.n_neighbors == 1, min_dt, dt)
    return dt, min_dt, max_dt_seen


def apply_time_marching(dt, min_dt, mode: str, unst_dt: float = 0.0,
                        unst_cfl: float = 0.0):
    """TIME_STEPPING: one global dt everywhere — the fixed UNST_TIMESTEP when
    the unsteady CFL is zero, else the global minimum local step
    (solver_direct_reactive.cpp:2125-2143)."""
    if mode != "TIME_STEPPING":
        return dt
    if unst_cfl <= 0.0 and unst_dt > 0.0:
        return jnp.full_like(dt, unst_dt)
    return jnp.full_like(dt, min_dt)
