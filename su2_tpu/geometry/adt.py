"""Alternating-digital-tree (k-d) point search.

Reference capability: CADTPointsOnlyClass (Common/src/adt_structure.cpp:490)
used for nearest-neighbor queries in wall distances and interpolation.
Host-side NumPy build + batched queries; for large query sets the chunked
turbulence/sst.py::wall_distance uses a k-d tree query — this
tree serves host-side setup (interpolation donors, normal neighbors).
"""

from __future__ import annotations

import numpy as np


class ADT:
    """Median-split alternating-dimension tree over a point set."""

    def __init__(self, points: np.ndarray, leaf_size: int = 16):
        self.points = np.asarray(points, dtype=np.float64)
        self.leaf_size = leaf_size
        n = len(self.points)
        self.idx = np.arange(n)
        # nodes: (lo, hi, dim, split, left, right) over idx slices
        self.nodes = []
        self._build(0, n, 0)

    def _build(self, lo, hi, depth):
        node_id = len(self.nodes)
        self.nodes.append(None)
        if hi - lo <= self.leaf_size:
            self.nodes[node_id] = (lo, hi, -1, 0.0, -1, -1)
            return node_id
        dim = depth % self.points.shape[1]
        sel = self.idx[lo:hi]
        order = np.argsort(self.points[sel, dim], kind="stable")
        self.idx[lo:hi] = sel[order]
        mid = (lo + hi) // 2
        split = self.points[self.idx[mid], dim]
        left = self._build(lo, mid, depth + 1)
        right = self._build(mid, hi, depth + 1)
        self.nodes[node_id] = (lo, hi, dim, split, left, right)
        return node_id

    def _query_one(self, q):
        best_d2, best_i = np.inf, -1
        stack = [0]
        while stack:
            nid = stack.pop()
            lo, hi, dim, split, left, right = self.nodes[nid]
            if dim < 0:
                sel = self.idx[lo:hi]
                d2 = ((self.points[sel] - q) ** 2).sum(axis=1)
                k = int(np.argmin(d2))
                if d2[k] < best_d2:
                    best_d2, best_i = float(d2[k]), int(sel[k])
                continue
            delta = q[dim] - split
            near, far = (left, right) if delta <= 0 else (right, left)
            stack.append(near)
            if delta * delta < best_d2 or best_i < 0:
                stack.append(far)
        return best_i, best_d2

    def query(self, qs: np.ndarray):
        """(m, d) queries -> (indices (m,), distances (m,))."""
        qs = np.atleast_2d(np.asarray(qs, dtype=np.float64))
        out_i = np.empty(len(qs), dtype=np.int64)
        out_d = np.empty(len(qs))
        for k, q in enumerate(qs):
            i, d2 = self._query_one(q)
            out_i[k] = i
            out_d[k] = np.sqrt(d2)
        return out_i, out_d
