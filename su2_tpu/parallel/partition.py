"""Spatial mesh partitioning for device sharding.

Data-parallel replacement for the reference's ParMETIS domain decomposition
(Common/src/geometry_structure.cpp:11465-11554): a recursive coordinate
bisection (RCB) run on host at setup.  Nodes are REORDERED so each device
owns one contiguous, equally-sized block — the natural layout for
jax.sharding over the leading axis, and the layout that keeps most edge
gathers shard-local (ICI traffic only at partition frontiers).
"""

from __future__ import annotations

import numpy as np


def rcb_order(coords: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection permutation.

    Returns perm with len(coords) entries: perm[k] = original node id of the
    node placed at position k.  nparts must be a power of two; each of the
    nparts contiguous chunks of the permutation is one spatial part.
    """
    n = coords.shape[0]
    assert nparts & (nparts - 1) == 0, "nparts must be a power of two"

    def rec(ids: np.ndarray, parts: int) -> np.ndarray:
        if parts == 1:
            return ids
        pts = coords[ids]
        widths = pts.max(axis=0) - pts.min(axis=0)
        axis = int(np.argmax(widths))
        order = ids[np.argsort(pts[:, axis], kind="stable")]
        half = (len(order) + 1) // 2
        return np.concatenate([rec(order[:half], parts // 2),
                               rec(order[half:], parts // 2)])

    return rec(np.arange(n), nparts)


def partition_counts(n: int, nparts: int) -> np.ndarray:
    """Sizes of the contiguous RCB chunks (first chunks get the remainder)."""
    base = n // nparts
    sizes = np.full(nparts, base)
    sizes[: n - base * nparts] += 1
    return sizes


def permute_raw_mesh(mesh, perm: np.ndarray):
    """Renumber a RawMesh so node perm[k] becomes node k."""
    from su2_tpu.io.mesh import RawMesh

    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    elem_nodes = np.where(mesh.elem_nodes >= 0, inv[mesh.elem_nodes],
                          mesh.elem_nodes)
    markers = {tag: np.where(m >= 0, inv[m], m)
               for tag, m in mesh.markers.items()}
    return RawMesh(ndim=mesh.ndim, coords=mesh.coords[perm],
                   elem_types=mesh.elem_types, elem_nodes=elem_nodes,
                   markers=markers, marker_types=mesh.marker_types)


def frontier_stats(edges: np.ndarray, part_of: np.ndarray) -> dict:
    """Cut statistics for a partition (diagnostics)."""
    cut = part_of[edges[:, 0]] != part_of[edges[:, 1]]
    return {"nedge": len(edges), "cut_edges": int(cut.sum()),
            "cut_fraction": float(cut.mean())}
