import os

import numpy as np
import pytest

from su2_tpu.io.mesh import read_su2_mesh
from su2_tpu.geometry.dual_grid import build_dual_grid


@pytest.fixture(scope="module")
def combustion_grid(standin_dir):
    """The stand-in combustor's wall-graded, seed-jittered channel."""
    mesh = read_su2_mesh(os.path.join(standin_dir, "mesh.su2"))
    return mesh, build_dual_grid(mesh)


def test_standin_mesh_read(standin_dir):
    """The stand-in's .su2 file round-trips through the reader."""
    from su2_tpu import testcase
    mesh = read_su2_mesh(os.path.join(standin_dir, "mesh.su2"))
    ref = testcase.graded_channel(33, 17, seed=0)
    assert mesh.ndim == 2 and mesh.npoint == 33 * 17
    assert mesh.nelem == 32 * 16
    np.testing.assert_array_equal(mesh.elem_nodes, ref.elem_nodes)
    np.testing.assert_allclose(mesh.coords, ref.coords, rtol=1e-15)
    assert set(mesh.markers) == {"inlet", "outlet", "lower_wall",
                                 "upper_wall"}


def test_mesh_read(combustion_dir):
    mesh = read_su2_mesh(os.path.join(combustion_dir, "mesh_stretched.su2"))
    assert mesh.ndim == 2
    assert mesh.nelem == 8811
    assert mesh.npoint == 9000
    assert set(mesh.markers) == {
        "Oxidizer_Inlet", "Outlet", "upper_wall", "Fuel_Inlet",
        "lower_wall_pre", "lower_wall_post"}


def test_total_volume_matches_element_area(combustion_grid):
    mesh, grid = combustion_grid
    # sum of dual volumes == sum of element areas
    total_elem = 0.0
    for k in range(mesh.nelem):
        nodes = mesh.elem_nodes[k]
        nodes = nodes[nodes >= 0]
        pts = mesh.coords[nodes]
        x, y = pts[:, 0], pts[:, 1]
        total_elem += 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    assert np.isclose(grid.volume.sum(), total_elem, rtol=1e-10)
    assert (grid.volume > 0).all()


def test_control_volume_closure(combustion_grid):
    """Sum of outward dual-face normals of every CV must close to zero.

    Interior faces: +n_e for node i, -n_e for node j. Boundary faces: the
    stored SU2 vertex normal points INTO the domain (the BC code negates it
    for the outward convention, solver_direct_reactive.cpp:2910), so closure
    is  sum(sgn*n_e) - n_vertex == 0.
    """
    mesh, grid = combustion_grid
    acc = np.zeros_like(grid.coords)
    np.add.at(acc, grid.edges[:, 0], grid.edge_normal)
    np.subtract.at(acc, grid.edges[:, 1], grid.edge_normal)
    bnd = np.zeros_like(acc)
    for tag in grid.bnd_nodes:
        np.add.at(bnd, grid.bnd_nodes[tag], grid.bnd_normal[tag])
    resid = acc - bnd
    scale = np.abs(grid.edge_normal).max()
    assert np.abs(resid).max() < 1e-12 * max(scale, 1.0), np.abs(resid).max()


def test_adjacency_consistency(combustion_grid):
    mesh, grid = combustion_grid
    nE = grid.nedge
    # every real slot points at an edge that has this node as an endpoint
    for p in range(0, grid.npoint, 997):
        for k in range(grid.max_degree):
            e = grid.node_edges[p, k]
            if e == nE:
                assert grid.node_edge_sign[p, k] == 0.0
                continue
            i, j = grid.edges[e]
            if grid.node_edge_sign[p, k] == 1.0:
                assert i == p and grid.node_nbrs[p, k] == j
            else:
                assert j == p and grid.node_nbrs[p, k] == i
    # degree counts match
    deg = (grid.node_edges < nE).sum(axis=1)
    deg2 = np.bincount(grid.edges.ravel(), minlength=grid.npoint)
    assert (deg == deg2).all()


def test_single_quad():
    """Hand-checked dual grid on one unit quad."""
    from su2_tpu.io.mesh import RawMesh
    coords = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    mesh = RawMesh(ndim=2, coords=coords,
                   elem_types=np.array([9], dtype=np.int32),
                   elem_nodes=np.array([[0, 1, 2, 3]]),
                   markers={"b": np.array([[0, 1], [1, 2], [2, 3], [3, 0]])},
                   marker_types={"b": np.array([3, 3, 3, 3], dtype=np.int32)})
    grid = build_dual_grid(mesh)
    assert np.isclose(grid.volume.sum(), 1.0)
    assert np.allclose(grid.volume, 0.25)
    assert grid.nedge == 4
    # edge (0,1): dual face from its midpoint (0.5, 0) to CG (0.5, 0.5),
    # normal rot_cw(CG - mid) = (0.5, 0) pointing 0 -> 1
    e01 = np.nonzero((grid.edges == [0, 1]).all(axis=1))[0][0]
    assert np.allclose(grid.edge_normal[e01], [0.5, 0.0])
