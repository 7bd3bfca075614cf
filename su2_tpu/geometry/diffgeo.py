"""Differentiable re-evaluation of the dual-grid metrics from coordinates.

The combinatorial topology (edges, adjacency, marker membership) is frozen on
the host; volumes, dual-face normals and boundary vertex normals are then
re-evaluated in JAX as pure functions of the node coordinates.  This is what
makes mesh sensitivities d(residual)/d(coords) available to `jax.vjp` — the
Data-parallel replacement for the reference's CoDiPack mesh-sensitivity taping
(SU2_CFD_AD / SU2_DOT capability; geometry formulas identical to
geometry/dual_grid.py, i.e. Common/src/geometry_structure.cpp:10457 and the
2D boundary-vertex loop at :9645).

2D only for now (the shipped reference cases are 2D).
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.geometry.dual_grid import (VTK_IS_3D, _element_cg,
                                        _fix_orientation_2d)
from su2_tpu.geometry.mesh_data import MeshArrays
from su2_tpu.io.mesh import ELEM_FACES, RawMesh


@dataclass(frozen=True)
class DiffGeo:
    """Static occurrence tables for differentiable metric evaluation."""
    # interior (element, face-edge) occurrences:
    occ_a: jax.Array          # (nOcc,) first endpoint (winding order)
    occ_b: jax.Array          # (nOcc,)
    occ_edge: jax.Array       # (nOcc,) owning unique-edge id
    occ_flip: jax.Array       # (nOcc,) 1.0 if (a,b) order was flipped to i<j
    elem_nodes: jax.Array     # (nElem, maxN) -1 padded (orientation-fixed)
    elem_mask: jax.Array      # (nElem, maxN)
    elem_counts: jax.Array    # (nElem,)
    occ_elem: jax.Array       # (nOcc,) element id
    # boundary line elements per marker tag:
    marker_lines: dict        # tag -> (nL, 2) node ids
    marker_nodes: dict        # tag -> (nV,) node ids (same order as MeshArrays)
    nedge: int
    npoint: int


def build_diffgeo(mesh: RawMesh, grid) -> DiffGeo:
    """Freeze the topology of an already-built 2D DualGrid."""
    assert mesh.ndim == 2, "differentiable geometry is 2D for now"
    fixed = _fix_orientation_2d(mesh)
    occ_a, occ_b, occ_elem = [], [], []
    for t, faces in ELEM_FACES.items():
        if VTK_IS_3D.get(t, False):
            continue
        sel = np.nonzero(fixed.elem_types == t)[0]
        if sel.size == 0:
            continue
        nodes = fixed.elem_nodes[sel]
        for (a, b) in faces:
            occ_a.append(nodes[:, a])
            occ_b.append(nodes[:, b])
            occ_elem.append(sel)
    occ_a = np.concatenate(occ_a)
    occ_b = np.concatenate(occ_b)
    occ_elem = np.concatenate(occ_elem)

    edge_lut = {(int(i), int(j)): e for e, (i, j) in enumerate(grid.edges)}
    occ_edge = np.empty(len(occ_a), dtype=np.int64)
    occ_flip = np.zeros(len(occ_a))
    for k, (a, b) in enumerate(zip(occ_a, occ_b)):
        key = (int(min(a, b)), int(max(a, b)))
        occ_edge[k] = edge_lut[key]
        occ_flip[k] = 1.0 if a > b else 0.0

    counts = (fixed.elem_nodes >= 0).sum(axis=1)
    marker_lines = {tag: fixed.markers[tag][:, :2].copy()
                    for tag in fixed.markers}
    marker_nodes = {tag: np.asarray(grid.bnd_nodes[tag])
                    for tag in grid.bnd_nodes}

    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    return DiffGeo(
        occ_a=i32(occ_a), occ_b=i32(occ_b), occ_edge=i32(occ_edge),
        occ_flip=jnp.asarray(occ_flip),
        elem_nodes=i32(np.where(fixed.elem_nodes >= 0, fixed.elem_nodes, 0)),
        elem_mask=jnp.asarray((fixed.elem_nodes >= 0).astype(np.float64)),
        elem_counts=jnp.asarray(counts.astype(np.float64)),
        occ_elem=i32(occ_elem),
        marker_lines={t: i32(v) for t, v in marker_lines.items()},
        marker_nodes={t: i32(v) for t, v in marker_nodes.items()},
        nedge=grid.nedge, npoint=grid.npoint)


def geo_metrics(dg: DiffGeo, coords: jax.Array):
    """coords (nP, 2) -> (volume, edge_normal, {tag: bnd_normal}) in JAX.

    Same math as the NumPy builder: per (elem, face) occurrence the 2D dual
    face contribution is rot_cw(Elem_CG - Edge_CG) (sign-flipped when the
    winding endpoint order was swapped to the i<j storage), the dual volume
    is the triangle (P, Edge_CG, Elem_CG) area added to both endpoints, and
    the boundary vertex normal is rot_cw((n0 - n1)/2) at both line endpoints.
    """
    pts = coords[dg.elem_nodes] * dg.elem_mask[..., None]
    elem_cg = pts.sum(axis=1) / dg.elem_counts[:, None]

    pa = coords[dg.occ_a]
    pb = coords[dg.occ_b]
    edge_cg = 0.5 * (pa + pb)
    ecg = elem_cg[dg.occ_elem]
    d = ecg - edge_cg
    rot = jnp.stack([d[:, 1], -d[:, 0]], axis=1)
    sgn = (1.0 - 2.0 * dg.occ_flip)[:, None]
    edge_normal = jnp.zeros((dg.nedge, 2), dtype=coords.dtype)
    edge_normal = edge_normal.at[dg.occ_edge].add(sgn * rot)

    va = edge_cg - pa
    vb = ecg - pa
    tri = 0.5 * jnp.abs(va[:, 0] * vb[:, 1] - va[:, 1] * vb[:, 0])
    vc = edge_cg - pb
    vd = ecg - pb
    trj = 0.5 * jnp.abs(vc[:, 0] * vd[:, 1] - vc[:, 1] * vd[:, 0])
    volume = jnp.zeros(dg.npoint, dtype=coords.dtype)
    volume = volume.at[dg.occ_a].add(tri)
    volume = volume.at[dg.occ_b].add(trj)

    bnd = {}
    for tag, lines in dg.marker_lines.items():
        dl = (coords[lines[:, 0]] - coords[lines[:, 1]]) * 0.5
        rotl = jnp.stack([dl[:, 1], -dl[:, 0]], axis=1)
        acc = jnp.zeros((dg.npoint, 2), dtype=coords.dtype)
        acc = acc.at[lines[:, 0]].add(rotl)
        acc = acc.at[lines[:, 1]].add(rotl)
        bnd[tag] = acc[dg.marker_nodes[tag]]
    return volume, edge_normal, bnd


def remesh(mesh: MeshArrays, dg: DiffGeo, coords: jax.Array) -> MeshArrays:
    """MeshArrays with all metric fields re-evaluated from ``coords``."""
    volume, edge_normal, bnd = geo_metrics(dg, coords)
    area = jnp.linalg.norm(edge_normal, axis=1)
    markers = {tag: (mesh.markers[tag][0], bnd[tag]) for tag in mesh.markers}
    accum = jnp.zeros_like(coords)
    for tag in markers:
        accum = accum.at[markers[tag][0]].add(bnd[tag])
    return dc_replace(
        mesh, coords=coords, volume=volume, edge_normal=edge_normal,
        edge_area=area, markers=markers, bnd_accum_normal=accum)
