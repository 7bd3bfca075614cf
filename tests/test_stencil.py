"""Static-stencil discovery (geometry/stencil.py) and the roll-based
off-diagonal product it enables in linalg/blockcsr.py.

Reference counterpart: the index-gather half of CSysMatrix's block-CSR
matvec (Common/src/matrix_structure.cpp) — here the sparsity of a
logically-structured mesh collapses to a few constant index offsets.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from su2_tpu.geometry import stencil as stn
from su2_tpu.geometry.dual_grid import build_dual_grid
from su2_tpu.geometry.mesh_data import mesh_arrays
from su2_tpu.io.mesh import RawMesh
from su2_tpu.linalg import blockcsr, krylov


def _quad_grid(ni, nj, perm=None):
    """Structured ni x nj node grid as a RawMesh; optionally scramble the
    node numbering with perm (perm[k] = new id of old node k)."""
    xs, ys = np.meshgrid(np.linspace(0, 1, ni), np.linspace(0, 1, nj),
                         indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=1)
    elems = []
    for i in range(ni - 1):
        for j in range(nj - 1):
            a = i * nj + j
            elems.append([a, a + nj, a + nj + 1, a + 1])
    elems = np.array(elems)
    bnd = []
    for j in range(nj - 1):
        bnd.append([j, j + 1])
        bnd.append([(ni - 1) * nj + j + 1, (ni - 1) * nj + j])
    for i in range(ni - 1):
        bnd.append([(i + 1) * nj, i * nj])
        bnd.append([i * nj + nj - 1, (i + 1) * nj + nj - 1])
    bnd = np.array(bnd)
    if perm is not None:
        coords = coords.copy()
        coords[perm] = coords.copy()
        elems = perm[elems]
        bnd = perm[bnd]
    return RawMesh(ndim=2, coords=coords,
                   elem_types=np.full(len(elems), 9, dtype=np.int32),
                   elem_nodes=elems,
                   markers={"b": bnd},
                   marker_types={"b": np.full(len(bnd), 3, np.int32)})


def test_natural_order_has_small_offsets():
    mesh = _quad_grid(7, 5)
    grid = build_dual_grid(mesh)
    offs = stn.edge_offsets(grid.edges)
    assert set(offs.tolist()) == {-5, -1, 1, 5}


def test_structured_order_recovers_scrambled_grid():
    rng = np.random.default_rng(3)
    perm_scramble = rng.permutation(7 * 6)
    mesh = _quad_grid(7, 6, perm=perm_scramble)
    grid = build_dual_grid(mesh)
    assert len(stn.edge_offsets(grid.edges)) > stn.MAX_OFFSETS

    order = stn.structured_order(mesh)
    assert order is not None
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    offs = stn.edge_offsets(inv[np.asarray(grid.edges)])
    assert 0 < len(offs) <= stn.MAX_OFFSETS


def test_structured_order_rejects_non_grid():
    # an L-shaped quad mesh is all-quad but not logically rectangular
    mesh = _quad_grid(5, 5)
    keep = []
    for k, q in enumerate(mesh.elem_nodes):
        i = q[0] // 5
        j = q[0] % 5
        if not (i >= 2 and j >= 2):
            keep.append(k)
    mesh2 = RawMesh(ndim=2, coords=mesh.coords,
                    elem_types=mesh.elem_types[keep],
                    elem_nodes=mesh.elem_nodes[keep],
                    markers=mesh.markers, marker_types=mesh.marker_types)
    assert stn.structured_order(mesh2) is None


def test_stencil_matvec_matches_dense():
    mesh = _quad_grid(6, 9)
    grid = build_dual_grid(mesh)
    ma = mesh_arrays(grid)
    assert ma.stencil_offsets is not None
    assert ma.stencil_sel is not None

    v = 3
    rng = np.random.default_rng(0)
    npnt, ne = ma.npoint, ma.nedge
    jac = blockcsr.BlockJacobian(
        diag=jnp.asarray(rng.normal(0, 1, (npnt, v, v)) + 4 * np.eye(v)),
        off_ij=jnp.asarray(rng.normal(0, 1, (ne, v, v))),
        off_ji=jnp.asarray(rng.normal(0, 1, (ne, v, v))))
    x = jnp.asarray(rng.normal(0, 1, (npnt, v)))

    # dense ground truth
    a = np.zeros((npnt * v, npnt * v))
    for p in range(npnt):
        a[p * v:(p + 1) * v, p * v:(p + 1) * v] = np.asarray(jac.diag)[p]
    for e, (i, j) in enumerate(np.asarray(ma.edges)):
        a[i * v:(i + 1) * v, j * v:(j + 1) * v] += np.asarray(jac.off_ij)[e]
        a[j * v:(j + 1) * v, i * v:(i + 1) * v] += np.asarray(jac.off_ji)[e]
    want = (a @ np.asarray(x).ravel()).reshape(npnt, v)

    got = blockcsr.matvec(ma, jac, x)
    sel = blockcsr.gather_offdiag(ma, jac)
    assert sel.ndim == 4 and sel.shape[0] == len(ma.stencil_offsets)
    got2 = blockcsr.matvec(ma, jac, x, offdiag=sel)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got2), want, rtol=1e-12)


def test_stencil_sgs_matches_gather_path():
    mesh = _quad_grid(6, 7)
    grid = build_dual_grid(mesh)
    ma = mesh_arrays(grid)
    assert ma.stencil_sel is not None
    # the same mesh with the stencil disabled = the gather path
    ma_g = ma.__class__(**{**{f: getattr(ma, f) for f in
                              ma.__dataclass_fields__},
                           "stencil_sel": None, "stencil_offsets": None})

    v = 2
    rng = np.random.default_rng(1)
    jac = blockcsr.BlockJacobian(
        diag=jnp.asarray(rng.normal(0, .2, (ma.npoint, v, v))
                         + 3 * np.eye(v)),
        off_ij=jnp.asarray(rng.normal(0, .2, (ma.nedge, v, v))),
        off_ji=jnp.asarray(rng.normal(0, .2, (ma.nedge, v, v))))
    r = jnp.asarray(rng.normal(0, 1, (ma.npoint, v)))
    dinv = blockcsr.block_jacobi_factor(jac)
    colors = blockcsr.greedy_coloring(np.asarray(ma.node_nbrs))
    masks = [jnp.asarray(colors == c) for c in range(colors.max() + 1)]

    z_s = blockcsr.multicolor_sgs_apply(ma, jac, dinv, masks, r)
    z_g = blockcsr.multicolor_sgs_apply(ma_g, jac, dinv, masks, r)
    np.testing.assert_allclose(np.asarray(z_s), np.asarray(z_g),
                               rtol=1e-11, atol=1e-13)


def test_stencil_gradients_match_gather_path():
    """Roll-based WLS / Green-Gauss (precomputed per-offset geometry in
    mesh_data) must match the gather-based formulations."""
    from su2_tpu.ops import gradients

    mesh = _quad_grid(8, 6)
    grid = build_dual_grid(mesh)
    ma = mesh_arrays(grid)
    assert ma.wls_coeff is not None and ma.gg_snormal is not None
    ma_g = ma.__class__(**{**{f: getattr(ma, f) for f in
                              ma.__dataclass_fields__},
                           "wls_coeff": None, "gg_snormal": None,
                           "stencil_sel": None, "stencil_offsets": None})

    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(0, 1, (ma.npoint, 5)))
    for fn in (gradients.weighted_least_squares, gradients.green_gauss):
        g_roll = fn(ma, q)
        g_gather = fn(ma_g, q)
        np.testing.assert_allclose(np.asarray(g_roll), np.asarray(g_gather),
                                   rtol=1e-10, atol=1e-12)


def test_driver_renumbers_combustion_mesh(combustion_dir):
    """The shipped combustion mesh is a scrambled 90x100 logical grid; the
    driver should recover row-major order and run gather-free."""
    import os
    from su2_tpu.io.mesh import read_su2_mesh
    raw = read_su2_mesh(os.path.join(combustion_dir, "mesh_stretched.su2"))
    order = stn.structured_order(raw)
    assert order is not None
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    grid = build_dual_grid(raw)
    offs = stn.edge_offsets(inv[np.asarray(grid.edges)])
    assert 0 < len(offs) <= stn.MAX_OFFSETS


