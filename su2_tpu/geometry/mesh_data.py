"""Static device-array mesh (struct-of-arrays) built from the host DualGrid.

Everything here is shape-static so the whole residual evaluation jits once.
Edge->node scatter is gather-based: each node stores its (padded) incident
edge list and signs, so residual accumulation is a deterministic gather+sum —
no atomics, no data-dependent shapes (accelerator-friendly replacement for the
reference's LinSysRes.AddBlock/SubtractBlock edge loops).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.geometry.dual_grid import DualGrid


@dataclass(frozen=True)
class MeshArrays:
    ndim: int
    npoint: int
    nedge: int
    max_degree: int
    coords: jax.Array        # (nP, d)
    volume: jax.Array        # (nP,)
    edges: jax.Array         # (nE, 2) int32
    edge_normal: jax.Array   # (nE, d)
    edge_area: jax.Array     # (nE,)
    node_edges: jax.Array    # (nP, D) int32, pad = nE
    node_sign: jax.Array     # (nP, D)
    node_nbrs: jax.Array     # (nP, D) int32, pad = self
    nbr_mask: jax.Array      # (nP, D) 1.0 for real neighbors
    n_neighbors: jax.Array   # (nP,) int32
    bnd_accum_normal: jax.Array  # (nP, d) sum of vertex normals over markers
    markers: dict            # tag -> (nodes (nV,) int32, normal (nV, d))
    marker_nn: dict          # tag -> (nV,) int32 normal-neighbor node ids
    # (nP, D) index into concat([off_ij, off_ji, pad]): slot with sign>0 ->
    # edge id, sign<0 -> edge id + nE, pad -> 2nE.  One gather replaces the
    # two-gather + select in blockcsr.gather_offdiag.
    node_edges_sel: jax.Array = None
    # slot-major flattened variants (D*nP,): gathers produce (D*nP, k) whose
    # per-slot reduction is CONTIGUOUS row slices g[d*nP:(d+1)*nP] — the
    # (nP, D, k) form forces a relayout reshape before the axis-1 reduce.
    node_edges_t: jax.Array = None   # (D*nP,) int32 = node_edges.T.ravel()
    node_sign_t: jax.Array = None    # (D*nP,)
    node_nbrs_t: jax.Array = None    # (D*nP,) int32 = node_nbrs.T.ravel()
    node_edges_sel_t: jax.Array = None  # (D*nP,) int32, slot-major sel
    # static-stencil form (geometry/stencil.py): when every neighbor sits at
    # one of K static index offsets, stencil_sel[k, p] indexes the block of
    # row p / column p+offsets[k] in concat([off_ij, off_ji, zero]) and the
    # sparse neighbor product becomes K roll+multiply passes (no gathers).
    stencil_sel: jax.Array = None       # (K, nP) int32, or None
    stencil_offsets: tuple = None       # static K signed offsets, or None
    # Precomputed static-geometry factors for gather-free gradients on
    # stencil meshes (see ops/gradients.py).  The WLS normal-equation
    # inverse is pure geometry, so the whole gradient collapses to
    #   grad[:, g, i] = sum_k wls_coeff[k, :, i] * (roll(q, -o_k) - q)[:, g]
    # and Green-Gauss to rolls against per-offset SIGNED dual normals.
    wls_coeff: jax.Array = None         # (K, nP, d), or None
    gg_snormal: jax.Array = None        # (K, nP, d), or None
    # (K, nP) static edge-projection factor (dx . n_signed)/|dx|^2 of the
    # (p, p+o_k) edge (0 if absent) — side-invariant, so per-node-sided
    # viscous Jacobian terms need no gather (see turbulence/sst.py)
    stencil_pvec: jax.Array = None
    # family-major edge geometry over POSITIVE offsets: entry [k, p] is the
    # (p, p+fam_offsets[k]) edge's area normal / node-to-node vector, zero
    # where the edge is absent.  Lets the family-major assembly read
    # endpoint states as rolls of the node matrix and write the residual
    # scatter as roll-subtracts (solvers/ns.py).
    fam_normal: jax.Array = None        # (Kh, nP, d)
    fam_evec: jax.Array = None          # (Kh, nP, d)
    fam_offsets: tuple = None           # Kh positive offsets
    # rotational-periodic ghost layer (geometry/periodic.PGhost): node rows
    # [pg_start, nP) hold rotated copies of interior rows pg_src, refreshed
    # every iteration; gradient sweeps overwrite their rows with the
    # rotated donor gradients
    pg_src: jax.Array = None            # (nG,) int32 donor node ids
    pg_rot: jax.Array = None            # (nG, d, d) vector rotation
    pg_start: int = None
    # number of devices the node axis is sharded over (parallel/sharding.py).
    # >1 selects the roll/family paths (GSPMD partitions rolls into
    # neighbor collective-permutes — the halo exchange).
    n_shards: int = 1

    def _slot_slices(self, g):
        n = self.npoint
        return [g[d * n:(d + 1) * n] for d in range(self.max_degree)]

    # ---- family-major virtual edge set (stencil meshes) ----
    # The Kh*nP rows enumerate the (p, p+fam_offsets[k]) edge slots in
    # family-major order; absent edges are padding with zero fam_normal.
    # Endpoint gathers are tiles/rolls and the scatters are roll-subtracts,
    # so an implicit assembly on this view produces its off-diagonal
    # Jacobian blocks directly in the static-stencil layout (no
    # gather_offdiag relayout copies — see linalg/blockcsr.FamilyJacobian).

    @property
    def fam_normal_flat(self):
        kh = len(self.fam_offsets)
        return self.fam_normal.reshape(kh * self.npoint, -1)

    @property
    def fam_valid_flat(self):
        return jnp.any(self.fam_normal_flat != 0.0, axis=-1)

    def fam_gather_i(self, x: jax.Array) -> jax.Array:
        kh = len(self.fam_offsets)
        return jnp.concatenate([x] * kh, axis=0)

    def fam_gather_j(self, x: jax.Array) -> jax.Array:
        return jnp.concatenate(
            [jnp.roll(x, -o, axis=0) for o in self.fam_offsets], axis=0)

    def _fam_parts(self, ev: jax.Array):
        n = self.npoint
        return [ev[k * n:(k + 1) * n] for k in range(len(self.fam_offsets))]

    def fam_scatter(self, ev: jax.Array) -> jax.Array:
        """out[i] += ev, out[j] -= ev over the family slots (padding rows
        must already be zero — wrapped rolls then contribute nothing)."""
        parts = self._fam_parts(ev)
        pos = sum(parts[1:], parts[0])
        neg = [jnp.roll(p, o, axis=0) for p, o in zip(parts, self.fam_offsets)]
        return pos - sum(neg[1:], neg[0])

    def fam_accum(self, val_i: jax.Array, val_j: jax.Array) -> jax.Array:
        """out[i] += val_i, out[j] += val_j over the family slots."""
        pi = self._fam_parts(val_i)
        pj = [jnp.roll(p, o, axis=0)
              for p, o in zip(self._fam_parts(val_j), self.fam_offsets)]
        return sum(pi[1:], pi[0]) + sum(pj[1:], pj[0])

    def scatter_edges(self, edge_vals: jax.Array) -> jax.Array:
        """Accumulate per-edge values to nodes with +/- orientation.

        edge_vals: (nE, ...) -> (nP, ...): out[i] = sum_e sign(i,e)*edge_vals[e].
        """
        pad = jnp.zeros((1,) + edge_vals.shape[1:], dtype=edge_vals.dtype)
        ext = jnp.concatenate([edge_vals, pad], axis=0)           # (nE+1, ...)
        if self.node_edges_t is None:     # sharded / coarse meshes
            gathered = ext[self.node_edges]                        # (nP, D, ...)
            sign = self.node_sign.reshape(
                self.node_sign.shape + (1,) * (edge_vals.ndim - 1))
            return (gathered * sign).sum(axis=1)
        gathered = ext[self.node_edges_t]                          # (D*nP, ...)
        sign = self.node_sign_t.reshape(
            self.node_sign_t.shape + (1,) * (edge_vals.ndim - 1))
        g = gathered * sign
        out = self._slot_slices(g)
        return sum(out[1:], out[0])

    def accumulate_sides(self, val_i: jax.Array, val_j: jax.Array) -> jax.Array:
        """out[p] = sum over incident edges e of val_i[e] where p is the edge's
        i-node and val_j[e] where p is its j-node.

        The gather-based replacement for `x.at[i].add(a); x.at[j].add(b)` —
        scatter-adds with duplicate indices serialize (or need atomics)
        inside fused programs; this is a pure gather+sum.
        """
        pad = jnp.zeros((1,) + val_i.shape[1:], dtype=val_i.dtype)
        if self.node_edges_t is None:
            ei = jnp.concatenate([val_i, pad], axis=0)[self.node_edges]
            ej = jnp.concatenate([val_j, pad], axis=0)[self.node_edges]
            sign = self.node_sign.reshape(
                self.node_sign.shape + (1,) * (val_i.ndim - 1))
            sel = jnp.where(sign > 0.5, ei, jnp.where(sign < -0.5, ej,
                                                      jnp.zeros_like(ei)))
            return sel.sum(axis=1)
        ei = jnp.concatenate([val_i, pad], axis=0)[self.node_edges_t]
        ej = jnp.concatenate([val_j, pad], axis=0)[self.node_edges_t]
        sign = self.node_sign_t.reshape(
            self.node_sign_t.shape + (1,) * (val_i.ndim - 1))
        sel = jnp.where(sign > 0.5, ei, jnp.where(sign < -0.5, ej,
                                                  jnp.zeros_like(ei)))
        out = self._slot_slices(sel)
        return sum(out[1:], out[0])

    def scatter_edges_mixed(self, signed_vals: jax.Array,
                            abs_vals: jax.Array):
        """One gather+sum for a signed block and an unsigned block.

        signed_vals: (nE, k) accumulated with +/- orientation (like
        scatter_edges); abs_vals: (nE, m) accumulated unsigned (like
        sum_edges_abs).  Returns ((nP, k), (nP, m)).  Fuses the residual
        scatter and the two spectral-radius accumulations of the fused edge
        kernel into a single node-edge gather."""
        k = signed_vals.shape[1]
        vals = jnp.concatenate([signed_vals, abs_vals], axis=1)
        pad = jnp.zeros((1, vals.shape[1]), dtype=vals.dtype)
        ext = jnp.concatenate([vals, pad], axis=0)
        if self.node_edges_t is None:
            gathered = ext[self.node_edges]                   # (nP, D, k+m)
            sign = self.node_sign[:, :, None]
            mult = jnp.concatenate(
                [jnp.broadcast_to(sign, sign.shape[:2] + (k,)),
                 jnp.broadcast_to(jnp.abs(sign),
                                  sign.shape[:2] + (vals.shape[1] - k,))],
                axis=2)
            out = (gathered * mult).sum(axis=1)
            return out[:, :k], out[:, k:]
        gathered = ext[self.node_edges_t]                     # (D*nP, k+m)
        sign = self.node_sign_t[:, None]
        mult = jnp.concatenate(
            [jnp.broadcast_to(sign, (sign.shape[0], k)),
             jnp.broadcast_to(jnp.abs(sign),
                              (sign.shape[0], vals.shape[1] - k))],
            axis=1)
        g = gathered * mult
        out = self._slot_slices(g)
        tot = sum(out[1:], out[0])
        return tot[:, :k], tot[:, k:]

    def sum_edges_abs(self, edge_vals: jax.Array) -> jax.Array:
        """out[i] = sum over incident edges of edge_vals (no sign)."""
        pad = jnp.zeros((1,) + edge_vals.shape[1:], dtype=edge_vals.dtype)
        ext = jnp.concatenate([edge_vals, pad], axis=0)
        if self.node_edges_t is None:
            gathered = ext[self.node_edges]
            mask = jnp.abs(self.node_sign).reshape(
                self.node_sign.shape + (1,) * (edge_vals.ndim - 1))
            return (gathered * mask).sum(axis=1)
        gathered = ext[self.node_edges_t]
        mask = jnp.abs(self.node_sign_t).reshape(
            self.node_sign_t.shape + (1,) * (edge_vals.ndim - 1))
        g = gathered * mask
        out = self._slot_slices(g)
        return sum(out[1:], out[0])


jax.tree_util.register_dataclass(
    MeshArrays,
    data_fields=["coords", "volume", "edges", "edge_normal", "edge_area",
                 "node_edges", "node_sign", "node_nbrs", "nbr_mask",
                 "n_neighbors", "bnd_accum_normal", "markers", "marker_nn",
                 "node_edges_sel", "node_edges_t", "node_sign_t",
                 "node_nbrs_t", "node_edges_sel_t", "stencil_sel",
                 "wls_coeff", "gg_snormal", "stencil_pvec",
                 "fam_normal", "fam_evec", "pg_src", "pg_rot"],
    meta_fields=["ndim", "npoint", "nedge", "max_degree", "stencil_offsets",
                 "fam_offsets", "pg_start", "n_shards"],
)


def _stencil_grad_geometry(offsets, edges, coords, npoint, ndim):
    """Host precompute of the per-offset WLS gradient coefficients and the
    per-offset signed dual normals (both (K, nP, d) float64).

    WLS: the inverse-distance-weighted normal equations
    (SetPrimitive_Gradient_LS, solver_direct_reactive.cpp:1170-1326) have a
    purely geometric system matrix; folding its inverse into per-offset
    coefficient vectors makes the runtime gradient K rolls + FMAs.
    Missing neighbors carry zero coefficients, which also nulls the
    wrapped lanes of the rolls.
    """
    k = len(offsets)
    d = ndim
    exists = np.zeros((k, npoint), dtype=bool)
    kidx = {o: ki for ki, o in enumerate(offsets)}
    ei, ej = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    diff = ej - ei
    for ki, o in enumerate(offsets):
        if o > 0:
            exists[ki, ei[diff == o]] = True
        else:
            exists[ki, ej[diff == -o]] = True

    dx = np.zeros((k, npoint, d))
    for ki, o in enumerate(offsets):
        rolled = np.roll(coords, -o, axis=0)
        dx[ki] = np.where(exists[ki][:, None], rolled - coords, 0.0)

    w = (dx * dx).sum(axis=-1)                                 # (K, nP)
    valid = exists & (w > 1e-16)
    invw = np.where(valid, 1.0 / np.where(valid, w, 1.0), 0.0)
    a = np.einsum("kp,kpi,kpj->pij", invw, dx, dx)             # (nP, d, d)
    if d == 2:
        # reference Cholesky-through-R guards (grad = 0 on singular R)
        r11s, r12s, r22s = a[:, 0, 0], a[:, 0, 1], a[:, 1, 1]
        r11 = np.where(r11s > 1e-16, np.sqrt(np.maximum(r11s, 0.0)), 0.0)
        r12 = np.where(np.abs(r11) > 1e-16,
                       r12s / np.where(r11 == 0, 1.0, r11), 0.0)
        r22sq = r22s - r12 * r12
        r22 = np.where(r22sq > 1e-16, np.sqrt(np.maximum(r22sq, 0.0)), 0.0)
        det2 = (r11 * r22) ** 2
        sing = np.abs(det2) < 1e-16
        dets = np.where(sing, 1.0, det2)
        s = np.zeros((npoint, 2, 2))
        s[:, 0, 0] = np.where(sing, 0.0, (r12 * r12 + r22 * r22) / dets)
        s[:, 0, 1] = s[:, 1, 0] = np.where(sing, 0.0, -r11 * r12 / dets)
        s[:, 1, 1] = np.where(sing, 0.0, r11 * r11 / dets)
    else:
        det = np.linalg.det(a)
        sing = np.abs(det) < 1e-16
        a_safe = np.where(sing[:, None, None], np.eye(d)[None], a)
        s = np.where(sing[:, None, None], 0.0, np.linalg.inv(a_safe))
    coeff = np.einsum("pij,kpj->kpi", s, invw[:, :, None] * dx)
    return coeff


def _stencil_gg_snormal(offsets, edges, edge_normal, npoint, ndim):
    """(K, nP, d) signed edge normal of the (p, p+o_k) edge (0 if absent)."""
    k = len(offsets)
    snormal = np.zeros((k, npoint, ndim))
    kidx = {o: ki for ki, o in enumerate(offsets)}
    ei, ej = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    diff = ej - ei
    for ki, o in enumerate(offsets):
        if o > 0:
            sel = diff == o
            snormal[ki, ei[sel]] = edge_normal[sel]
        else:
            sel = diff == -o
            snormal[ki, ej[sel]] = -edge_normal[sel]
    return snormal


def mesh_arrays(grid: DualGrid, dtype=jnp.float64) -> MeshArrays:
    f = lambda x: jnp.asarray(x, dtype=dtype)
    i = lambda x: jnp.asarray(x, dtype=jnp.int32)

    # static-stencil form of the node adjacency (geometry/stencil.py):
    # discovered from the final edge list so periodic merging etc. is seen
    from su2_tpu.geometry import stencil as stn
    offsets = stn.edge_offsets(grid.edges)
    if 0 < len(offsets) <= stn.MAX_OFFSETS:
        stencil_offsets = tuple(int(o) for o in offsets)
        stencil_sel = i(stn.stencil_select(grid.edges, grid.npoint,
                                           stencil_offsets))
    else:
        stencil_offsets = None
        stencil_sel = None
    wls_coeff = gg_snormal = stencil_pvec = None
    if stencil_offsets is not None:
        e_np = np.asarray(grid.edges)
        coords_np = np.asarray(grid.coords)
        wls_coeff = f(_stencil_grad_geometry(
            stencil_offsets, e_np, coords_np, grid.npoint, grid.ndim))
        sn = _stencil_gg_snormal(
            stencil_offsets, e_np, np.asarray(grid.edge_normal),
            grid.npoint, grid.ndim)
        gg_snormal = f(sn)
        pvec = np.zeros((len(stencil_offsets), grid.npoint))
        for ki, o in enumerate(stencil_offsets):
            dxk = np.roll(coords_np, -o, axis=0) - coords_np
            d2 = (dxk * dxk).sum(axis=1)
            pvec[ki] = (dxk * sn[ki]).sum(axis=1) / np.where(d2 == 0, 1, d2)
        stencil_pvec = f(pvec)
        # positive-offset family geometry for the fused edge kernel
        pos = tuple(o for o in stencil_offsets if o > 0)
        fam_offsets = pos
        fnorm = np.zeros((len(pos), grid.npoint, grid.ndim))
        fevec = np.zeros((len(pos), grid.npoint, grid.ndim))
        e_np64 = e_np.astype(np.int64)
        diff_e = e_np64[:, 1] - e_np64[:, 0]
        en_np = np.asarray(grid.edge_normal)
        for ki, o in enumerate(pos):
            sel_e = diff_e == o
            own = e_np64[sel_e, 0]
            fnorm[ki, own] = en_np[sel_e]
            fevec[ki, own] = coords_np[e_np64[sel_e, 1]] - coords_np[own]
        fam_normal = f(fnorm)
        fam_evec = f(fevec)
    else:
        fam_offsets = None
        fam_normal = fam_evec = None

    bnd_accum = np.zeros_like(grid.coords)
    for tag in grid.bnd_nodes:
        np.add.at(bnd_accum, grid.bnd_nodes[tag], grid.bnd_normal[tag])

    markers = {tag: (i(grid.bnd_nodes[tag]), f(grid.bnd_normal[tag]))
               for tag in grid.bnd_nodes}
    marker_nn = {tag: i(grid.bnd_nn[tag]) for tag in grid.bnd_nn}
    area = np.linalg.norm(grid.edge_normal, axis=1)
    nnb = (grid.node_edges < grid.nedge).sum(axis=1)

    ne = grid.nedge
    sel_idx = np.where(grid.node_edge_sign > 0.5, grid.node_edges,
                       np.where(grid.node_edge_sign < -0.5,
                                grid.node_edges + ne, 2 * ne))

    return MeshArrays(
        ndim=grid.ndim, npoint=grid.npoint, nedge=grid.nedge,
        max_degree=grid.max_degree,
        coords=f(grid.coords), volume=f(grid.volume),
        edges=i(grid.edges), edge_normal=f(grid.edge_normal), edge_area=f(area),
        node_edges=i(grid.node_edges), node_sign=f(grid.node_edge_sign),
        node_nbrs=i(grid.node_nbrs),
        nbr_mask=f((grid.node_edges < grid.nedge).astype(np.float64)),
        n_neighbors=i(nnb),
        bnd_accum_normal=f(bnd_accum), markers=markers, marker_nn=marker_nn,
        node_edges_sel=i(sel_idx),
        node_edges_t=i(grid.node_edges.T.reshape(-1)),
        node_sign_t=f(grid.node_edge_sign.T.reshape(-1)),
        node_nbrs_t=i(grid.node_nbrs.T.reshape(-1)),
        node_edges_sel_t=i(sel_idx.T.reshape(-1)),
        stencil_sel=stencil_sel,
        stencil_offsets=stencil_offsets,
        wls_coeff=wls_coeff,
        gg_snormal=gg_snormal,
        stencil_pvec=stencil_pvec,
        fam_normal=fam_normal,
        fam_evec=fam_evec,
        fam_offsets=fam_offsets,
    )
