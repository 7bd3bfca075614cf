"""Linelet preconditioner: construction + exactness on line-tridiagonal
systems (ComputeLineletPreconditioner parity,
Common/src/matrix_structure.cpp:1837-2148)."""

import numpy as np
import pytest

import jax.numpy as jnp

from su2_tpu.geometry.structured import channel_mesh
from su2_tpu.geometry.dual_grid import build_dual_grid
from su2_tpu.geometry.mesh_data import mesh_arrays
from su2_tpu.linalg import blockcsr, linelet as ll


class _BC:
    def __init__(self, kind, nodes):
        self.kind = kind
        self.nodes = nodes


@pytest.fixture(scope="module")
def setup():
    # strongly stretched channel: wall-normal (y) edges carry the large
    # area/volume weight, so lines grow up the columns from both walls
    raw = channel_mesh(12, 9, lx=1.0, ly=0.02)
    mesh = mesh_arrays(build_dual_grid(raw), jnp.float64)
    bcs = [_BC("heatflux_wall", np.asarray(mesh.markers["lower_wall"][0])),
           _BC("isothermal_wall", np.asarray(mesh.markers["upper_wall"][0]))]
    lines = ll.build_linelets(mesh, bcs=bcs)
    return mesh, lines


def test_linelet_lines_cover_columns(setup):
    mesh, lines = setup
    assert lines is not None
    flat = lines[lines >= 0]
    assert len(np.unique(flat)) == flat.size          # each node in <= 1 line
    # both walls seeded: 2 * nx lines
    assert lines.shape[0] == 24
    # the stretched channel's columns (9 nodes) split between the two walls
    assert lines.shape[1] >= 4


def test_linelet_exact_on_line_tridiagonal(setup):
    mesh, lines = setup
    n = mesh.npoint
    v = 3
    rng = np.random.default_rng(0)
    edges = np.asarray(mesh.edges)
    ne = edges.shape[0]
    edge_of = {}
    for e, (i, j) in enumerate(edges):
        edge_of[(int(i), int(j))] = (e, True)
        edge_of[(int(j), int(i))] = (e, False)

    diag = rng.normal(size=(n, v, v)) + 6.0 * np.eye(v)
    off_ij = np.zeros((ne, v, v))
    off_ji = np.zeros((ne, v, v))
    # couple ONLY consecutive line nodes: then the linelet preconditioner
    # is the exact inverse (off-line nodes are purely diagonal -> Jacobi
    # is exact too)
    for k in range(lines.shape[0]):
        for e in range(1, lines.shape[1]):
            prev, cur = int(lines[k, e - 1]), int(lines[k, e])
            if cur < 0:
                break
            b1 = rng.normal(size=(v, v))
            b2 = rng.normal(size=(v, v))
            eid, fwd = edge_of[(prev, cur)]
            if fwd:      # edge is (prev, cur): block(prev,cur)=off_ij
                off_ij[eid] = b1          # block(prev, cur)
                off_ji[eid] = b2          # block(cur, prev)
            else:        # edge is (cur, prev)
                off_ji[eid] = b1
                off_ij[eid] = b2

    # dense assembly
    a = np.zeros((n * v, n * v))
    for p in range(n):
        a[p * v:(p + 1) * v, p * v:(p + 1) * v] = diag[p]
    for e, (i, j) in enumerate(edges):
        a[i * v:(i + 1) * v, j * v:(j + 1) * v] = off_ij[e]
        a[j * v:(j + 1) * v, i * v:(i + 1) * v] = off_ji[e]

    r = rng.normal(size=(n, v))
    dinv = blockcsr.block_diag_inv(jnp.asarray(diag))
    apply = ll.make_linelet_apply(
        mesh, lines, jnp.asarray(diag), jnp.asarray(off_ij),
        jnp.asarray(off_ji), dinv)
    z = np.asarray(apply(jnp.asarray(r)))
    z_ref = np.linalg.solve(a, r.reshape(-1)).reshape(n, v)
    np.testing.assert_allclose(z, z_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.slow
def test_linelet_solver_ops_route(setup):
    mesh, lines = setup
    n = mesh.npoint
    v = 2
    rng = np.random.default_rng(1)
    ne = np.asarray(mesh.edges).shape[0]
    jac = blockcsr.BlockJacobian(
        diag=jnp.asarray(rng.normal(size=(n, v, v)) + 5.0 * np.eye(v)),
        off_ij=jnp.asarray(0.1 * rng.normal(size=(ne, v, v))),
        off_ji=jnp.asarray(0.1 * rng.normal(size=(ne, v, v))))
    mv, pc = blockcsr.make_solver_ops(mesh, jac, "LINELET", linelets=lines)
    r = jnp.asarray(rng.normal(size=(n, v)))
    from su2_tpu.linalg import krylov
    sol, rel, iters = krylov.fgmres(mv, pc, r, max_iter=30, tol=1e-10)
    resid = np.asarray(mv(sol) - r)
    assert np.abs(resid).max() / np.abs(np.asarray(r)).max() < 1e-8
