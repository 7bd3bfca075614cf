"""Static-stencil discovery: turn unstructured sparsity into lane shifts.

Data-parallel replacement for the index-gather half of the reference's
block-CSR machinery (Common/src/matrix_structure.cpp): when the mesh's
node numbering places every neighbor at one of a few constant index
offsets (any logically-structured mesh, once ordered), the sparse
neighbor product  y[p] += B[p,q] x[q]  becomes

    y += sum_k  M_k * roll(x, -o_k)

with K static offsets o_k — no gathers, no scatter, pure elementwise
work that XLA fuses.

Discovery runs on the host at setup:

1. If the as-read ordering already has a small offset set (programmatic
   meshes, SU2 structured exports like the flat plate's {+-1, +-137}),
   use it directly — no renumbering.
2. Otherwise, for all-quad 2D meshes, recover the logical (i, j) grid
   coordinates by BFS over quads (each quad imposes ij[a] + ij[c] ==
   ij[b] + ij[d] on its cyclic corners) and renumber row-major.  The
   shipped combustion mesh (mesh_stretched.su2) is a scrambled 90x100
   grid that collapses to offsets {+-1, +-100}.
3. Meshes with no small stencil keep the gather-based path.
"""

from __future__ import annotations

import numpy as np

# Above this many distinct offsets the roll form loses to the gather form
# (each offset is a full (nP, v, v) elementwise pass).
MAX_OFFSETS = 8


def edge_offsets(edges: np.ndarray) -> np.ndarray:
    """Sorted distinct signed index offsets of an edge list (both
    directions)."""
    e = np.asarray(edges)
    if e.size == 0:
        return np.zeros((0,), dtype=np.int64)
    d = e[:, 1].astype(np.int64) - e[:, 0].astype(np.int64)
    return np.unique(np.concatenate([d, -d]))


def structured_order(mesh) -> np.ndarray | None:
    """Recover a row-major structured ordering of an all-quad 2D mesh.

    Returns perm (perm[k] = original node id of new node k) or None when
    the mesh is not a single logically-rectangular quad grid.

    Fully vectorized (the quad-by-quad Python BFS this replaces was ~30
    minutes at 2.26M cells — the million-cell preprocessing bottleneck):
    on a logically rectangular grid the quad-edge graph's BFS distance IS
    the Manhattan distance, so two C-speed BFS sweeps from two adjacent
    degree-2 corner nodes give  d0 = i + j  and  d1 = (ni-1-i) + j,
    which invert algebraically to (i, j).  The candidate labeling is then
    verified completely (bijection onto the ni x nj lattice + every quad's
    cyclic corners trace a unit square), so a wrong guess degrades to the
    same None the old code returned — never a wrong perm.
    """
    types = np.asarray(mesh.elem_types)
    if mesh.ndim != 2 or not np.all(types == 9):
        return None
    n = mesh.npoint
    quads = np.asarray(mesh.elem_nodes)[:, :4].astype(np.int64)
    if quads.size == 0 or quads.min() < 0 or quads.max() >= n:
        return None

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    # undirected quad-boundary-edge graph (diagonals excluded)
    eu = quads.ravel()
    ev = np.roll(quads, -1, axis=1).ravel()
    one = np.ones(2 * eu.size, dtype=np.int8)
    adj = coo_matrix((one, (np.concatenate([eu, ev]),
                            np.concatenate([ev, eu]))), shape=(n, n)).tocsr()
    adj.sum_duplicates()
    deg = np.diff(adj.indptr)
    corners = np.flatnonzero(deg == 2)
    if len(corners) != 4:
        return None

    def bfs_dist(src):
        d = dijkstra(adj, unweighted=True, indices=src)
        return None if np.isinf(d).any() else d.astype(np.int64)

    c0 = corners[0]
    d0 = bfs_dist(c0)
    if d0 is None:
        return None
    others = corners[1:]
    c1 = others[np.argmin(d0[others])]       # an ADJACENT corner of c0
    d1 = bfs_dist(c1)
    if d1 is None:
        return None
    length = d0[c1]                          # = ni - 1 along the c0->c1 side
    ti = d0 - d1 + length
    if np.any(ti & 1):
        return None
    i = ti >> 1
    j = d0 - i
    if i.min() < 0 or j.min() < 0:
        return None
    # canonicalize to the labeling a corner-anchored propagation from quad
    # 0 produces (u axis = corner0->corner1 of quad 0, v axis = corner0->
    # corner3): lattice labelings are unique up to reflection/transpose,
    # and downstream printed-digit parity pins depend on the summation
    # order the node numbering induces, so the choice must be
    # deterministic in the MESH, not in which degree-2 node scipy lists
    # first
    p0, p1, p3 = quads[0][0], quads[0][1], quads[0][3]
    e1 = np.array([i[p1] - i[p0], j[p1] - j[p0]])
    e2 = np.array([i[p3] - i[p0], j[p3] - j[p0]])
    if np.abs(e1).sum() != 1 or np.abs(e2).sum() != 1 or np.any(e1 == e2):
        return None
    ci = e1[0] * (i - i[p0]) + e1[1] * (j - j[p0])
    cj = e2[0] * (i - i[p0]) + e2[1] * (j - j[p0])
    i, j = ci - ci.min(), cj - cj.min()
    ni, nj = i.max() + 1, j.max() + 1
    if ni * nj != n:
        return None
    keys = i * nj + j
    if len(np.unique(keys)) != n:
        return None
    # complete verification: each quad's cyclic corners must trace a unit
    # square of the lattice (this is exactly the constraint the old BFS
    # propagated; it also rejects non-cyclic corner listings)
    qi, qj = i[quads], j[quads]
    di = qi - qi.min(axis=1, keepdims=True)
    dj = qj - qj.min(axis=1, keepdims=True)
    code = np.sort(di * 2 + dj, axis=1)
    if np.any(di > 1) or np.any(dj > 1) \
            or np.any(code != np.array([0, 1, 2, 3])):
        return None
    si = np.abs(qi - np.roll(qi, -1, axis=1))
    sj = np.abs(qj - np.roll(qj, -1, axis=1))
    if np.any(si + sj != 1):
        return None
    return np.argsort(keys, kind="stable")


def discover(raw_mesh, edges: np.ndarray,
             max_offsets: int = MAX_OFFSETS):
    """(perm | None, offsets | None) for a raw mesh + its dual-grid edges.

    perm is None when the natural ordering already works; offsets is None
    when no small stencil exists (keep the gather path).
    """
    offs = edge_offsets(edges)
    if 0 < len(offs) <= max_offsets:
        return None, tuple(int(o) for o in offs)
    perm = structured_order(raw_mesh)
    if perm is None:
        return None, None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    offs = edge_offsets(inv[np.asarray(edges)])
    if 0 < len(offs) <= max_offsets:
        return perm, tuple(int(o) for o in offs)
    return None, None


def stencil_select(edges: np.ndarray, npoint: int,
                   offsets: tuple) -> np.ndarray:
    """(K, nP) int32 index into concat([off_ij, off_ji, zero]) such that
    sel[k, p] names the block of row p whose column is p + offsets[k]
    (2*nE = the zero pad when p has no neighbor at that offset)."""
    e = np.asarray(edges)
    ne = e.shape[0]
    koff = {o: k for k, o in enumerate(offsets)}
    sel = np.full((len(offsets), npoint), 2 * ne, dtype=np.int64)
    d = e[:, 1].astype(np.int64) - e[:, 0].astype(np.int64)
    eid = np.arange(ne, dtype=np.int64)
    kf = np.array([koff[int(o)] for o in d])
    kb = np.array([koff[int(-o)] for o in d])
    sel[kf, e[:, 0]] = eid            # row i, column j: off_ij block
    sel[kb, e[:, 1]] = eid + ne       # row j, column i: off_ji block
    return sel.astype(np.int32)
