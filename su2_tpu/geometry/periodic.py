"""Periodic boundaries: dual-CV merging (translation), ghost layer (rotation).

Reference capability: MARKER_PERIODIC + SU2_MSH's periodic ghost-layer setup
(CPhysicalGeometry periodic donor search, Common/src/geometry_structure.cpp;
solver-side rotation/translation in the Set_MPI_* halo exchanges).

Design, translation: instead of ghost layers exchanged every
iteration, the paired boundary vertices are merged into single dual CVs at
setup — edges crossing the cut are re-glued, volumes summed, and the
periodic markers disappear.  Periodicity then costs nothing at runtime and
is exact (dual-face normals are translation-invariant).

Rotation: merging cannot absorb the frame change (velocities on the two
faces differ by the rotation), so the reference's ghost layer is rebuilt
functionally: donor-side elements are duplicated as rotated ghost elements
attached to the periodic face (both directions), giving the face nodes
complete dual CVs; the solver refreshes the ghost-node states each
iteration as state[ghost] = rotate(state[src]) (momentum rotated, scalars
copied) and overwrites ghost gradient rows with the rotated donor
gradients — the Set_MPI_Solution / Set_MPI_Solution_Gradient rotation
(solver_direct_reactive.cpp:1530-1999) as a pure function of the state.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace

import numpy as np

from su2_tpu.geometry.dual_grid import DualGrid, _adjacency_tables


def match_periodic_nodes(grid: DualGrid, tag_a: str, tag_b: str,
                         translation, tol: float = 1e-8) -> np.ndarray:
    """(nPair, 2) node pairs with coords[b] == coords[a] + translation."""
    a_nodes = np.asarray(grid.bnd_nodes[tag_a])
    b_nodes = np.asarray(grid.bnd_nodes[tag_b])
    a_xy = grid.coords[a_nodes] + np.asarray(translation)[:grid.ndim]
    b_xy = grid.coords[b_nodes]
    pairs = []
    for k, bx in zip(b_nodes, b_xy):
        d2 = ((a_xy - bx) ** 2).sum(axis=1)
        m = int(np.argmin(d2))
        if d2[m] > tol * tol:
            raise ValueError(
                f"periodic match failed for node {k}: nearest donor at "
                f"distance {np.sqrt(d2[m]):.3e}")
        pairs.append((int(a_nodes[m]), int(k)))
    return np.asarray(pairs, dtype=np.int64)


def merge_periodic(grid: DualGrid, pairs: np.ndarray,
                   tag_a: str, tag_b: str) -> DualGrid:
    """Merge each (a, b) pair into the single CV a; b becomes an orphan
    placeholder node (no edges, unit volume) so all array shapes and node
    ids stay static."""
    remap = np.arange(grid.npoint, dtype=np.int64)
    remap[pairs[:, 1]] = pairs[:, 0]

    edges = remap[np.asarray(grid.edges)]
    swap = edges[:, 0] > edges[:, 1]
    normals = np.asarray(grid.edge_normal).copy()
    normals[swap] *= -1.0
    edges = np.stack([np.minimum(edges[:, 0], edges[:, 1]),
                      np.maximum(edges[:, 0], edges[:, 1])], axis=1)

    volume = np.asarray(grid.volume).copy()
    volume[pairs[:, 0]] += volume[pairs[:, 1]]
    volume[pairs[:, 1]] = 1.0      # orphan placeholder

    node_edges, node_sign, node_nbrs = _adjacency_tables(
        grid.npoint, edges, None)

    bnd_nodes = {t: v for t, v in grid.bnd_nodes.items()
                 if t not in (tag_a, tag_b)}
    bnd_normal = {t: v for t, v in grid.bnd_normal.items()
                  if t not in (tag_a, tag_b)}
    bnd_nn = {t: v for t, v in grid.bnd_nn.items()
              if t not in (tag_a, tag_b)}
    # corner nodes of remaining markers may have been remapped (e.g. a wall
    # meeting the periodic cut): point their entries at the surviving node
    for t in bnd_nodes:
        bnd_nodes[t] = remap[np.asarray(bnd_nodes[t])]
        bnd_nn[t] = remap[np.asarray(bnd_nn[t])]
    # a surviving corner CV absorbs its pair's wall-vertex normal: merge
    # duplicate marker entries
    for t in list(bnd_nodes):
        nodes, inv = np.unique(bnd_nodes[t], return_inverse=True)
        acc = np.zeros((len(nodes), grid.ndim))
        np.add.at(acc, inv, np.asarray(bnd_normal[t]))
        nn = np.zeros(len(nodes), dtype=np.int64)
        nn[inv] = np.asarray(bnd_nn[t])
        bnd_nodes[t], bnd_normal[t], bnd_nn[t] = nodes, acc, nn

    return dc_replace(
        grid, volume=volume, edges=edges, edge_normal=normals,
        node_edges=node_edges, node_edge_sign=node_sign,
        node_nbrs=node_nbrs, bnd_nodes=bnd_nodes, bnd_normal=bnd_normal,
        bnd_nn=bnd_nn)


def apply_periodic_markers(grid: DualGrid, cfg) -> DualGrid:
    """Consume translational MARKER_PERIODIC pairs from the config
    (config_structure.cpp periodic option: marker, donor, rotation center,
    rotation angles, translation).  Rotational pairs are handled earlier at
    the raw-mesh level (rotational_ghost_layer)."""
    for tag_a, (tag_b, rot_c, rot_a, trans) in cfg.marker_periodic.items():
        if any(abs(x) > 0 for x in rot_a):
            continue                      # ghost layer built from the raw mesh
        pairs = match_periodic_nodes(grid, tag_b, tag_a, trans)
        grid = merge_periodic(grid, pairs, tag_b, tag_a)
    return grid


# --------------------------------------------------------------------------
# Rotational periodicity: ghost element layer on the raw mesh
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PGhost:
    """Ghost-layer refresh data: ghost nodes occupy rows [start, start+nG)
    of every node array; state[start + g] = rot[g] applied to state[src[g]]
    (momentum/vector components rotated, scalars copied)."""
    start: int
    src: np.ndarray        # (nG,) donor interior node ids
    rot: np.ndarray        # (nG, d, d) rotation applied to vectors


def _rot2d(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def rotational_ghost_layer(raw, cfg, tol: float = 1e-8):
    """(raw_ext, PGhost | None): duplicate the elements adjacent to each
    rotationally periodic face as rotated ghost elements on the partner
    face (both directions), appending ghost copies of the off-face nodes.

    The periodic/donor markers' nodes then own complete dual CVs and the
    markers need no boundary treatment; ghost-node states are refreshed by
    the solver every iteration."""
    rot_pairs = [(tag_a, v) for tag_a, v in cfg.marker_periodic.items()
                 if any(abs(x) > 0 for x in v[2])]       # rotation angles
    if not rot_pairs:
        return raw, None
    assert raw.ndim == 2, "rotational periodicity: 2D meshes (z-rotation)"

    coords = np.asarray(raw.coords, np.float64)
    elem_nodes = np.asarray(raw.elem_nodes)
    elem_types = np.asarray(raw.elem_types)
    n0 = coords.shape[0]

    new_coords = [coords]
    new_elems = [elem_nodes]
    new_types = [elem_types]
    ghost_src, ghost_rot = [], []
    extra_marker_faces: dict = {}
    nextid = n0

    def marker_nodes(tag):
        m = np.asarray(raw.markers[tag])
        return np.unique(m[m >= 0])

    for tag_a, (tag_b, center, angles, _trans) in rot_pairs:
        theta = float(angles[2] if len(angles) > 2 else angles[-1])
        c2 = np.asarray(center[:2], np.float64)
        r_ab = _rot2d(theta)              # donor -> periodic frame
        per = marker_nodes(tag_a)
        don = marker_nodes(tag_b)

        def match(src_nodes, dst_nodes, rot):
            """partner[src] = dst node at rot @ (coords[src] - c) + c."""
            dst_xy = coords[dst_nodes]
            out = {}
            for s in src_nodes:
                x = (coords[s] - c2) @ rot.T + c2
                d2 = ((dst_xy - x) ** 2).sum(axis=1)
                m = int(np.argmin(d2))
                if d2[m] > tol * tol:
                    raise ValueError(
                        f"rotational periodic match failed at node {s}")
                out[int(s)] = int(dst_nodes[m])
            return out

        don2per = match(don, per, r_ab)
        per2don = match(per, don, r_ab.T)

        rot_tags = {tag_a, tag_b}

        def add_layer(face_nodes, partner, rot):
            """Duplicate elements touching face_nodes, mapped through
            partner (face nodes) / rotated ghost copies (others); also
            duplicate wall-marker faces of the layer so wall corners on
            the periodic cut keep their full vertex normals."""
            nonlocal nextid
            face_set = set(int(x) for x in face_nodes)
            ghost_of = {}
            rows = []
            for ei in range(elem_nodes.shape[0]):
                nodes = [int(q) for q in elem_nodes[ei] if q >= 0]
                if not any(q in face_set for q in nodes):
                    continue
                gnodes = []
                for q in nodes:
                    if q in face_set:
                        gnodes.append(partner[q])
                    else:
                        if q not in ghost_of:
                            ghost_of[q] = nextid
                            new_coords.append(
                                ((coords[q] - c2) @ rot.T + c2)[None])
                            ghost_src.append(q)
                            ghost_rot.append(rot)
                            nextid += 1
                        gnodes.append(ghost_of[q])
                row = np.full(elem_nodes.shape[1], -1, dtype=elem_nodes.dtype)
                row[:len(gnodes)] = gnodes
                rows.append((row, elem_types[ei]))
            if rows:
                new_elems.append(np.stack([r for r, _ in rows]))
                new_types.append(np.asarray([t for _, t in rows],
                                            dtype=elem_types.dtype))
            mapped = set(face_set) | set(ghost_of)
            for tag, faces in raw.markers.items():
                if tag in rot_tags:
                    continue
                for f in np.asarray(faces):
                    fn = [int(q) for q in f if q >= 0]
                    if all(q in mapped for q in fn) \
                            and any(q in face_set for q in fn):
                        gf = [partner[q] if q in face_set else ghost_of[q]
                              for q in fn]
                        row = np.full(len(f), -1, dtype=np.asarray(f).dtype)
                        row[:len(gf)] = gf
                        extra_marker_faces.setdefault(tag, []).append(row)

        # donor-side elements appear rotated behind the periodic face, and
        # periodic-side elements rotated back behind the donor face
        add_layer(don, don2per, r_ab)
        add_layer(per, per2don, r_ab.T)

    if nextid == n0:
        return raw, None
    markers = {t: np.asarray(v).copy() for t, v in raw.markers.items()}
    marker_types = {t: np.asarray(v).copy()
                    for t, v in raw.marker_types.items()}
    for tag, rows in extra_marker_faces.items():
        add = np.stack(rows)
        markers[tag] = np.concatenate([markers[tag], add], axis=0)
        marker_types[tag] = np.concatenate(
            [marker_types[tag],
             np.full(len(rows), marker_types[tag][0],
                     dtype=marker_types[tag].dtype)])
    raw_ext = dc_replace(
        raw, coords=np.concatenate(new_coords, axis=0),
        elem_nodes=np.concatenate(new_elems, axis=0),
        elem_types=np.concatenate(new_types, axis=0),
        markers=markers, marker_types=marker_types)
    pg = PGhost(start=n0, src=np.asarray(ghost_src, np.int64),
                rot=np.stack(ghost_rot))
    return raw_ext, pg
