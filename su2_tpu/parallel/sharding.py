"""Multi-chip sharding of the solver state over a device mesh.

Replacement for the reference's MPI domain decomposition + halo exchange
(SURVEY §2.3): nodes are RCB-reordered so each device owns a
contiguous spatial block, node- and edge-indexed arrays are sharded over the
leading axis of a 1-D ``jax.sharding.Mesh`` ("cells" axis — the only
parallel axis this physics has), and the jitted step runs as one SPMD
program.  Cross-shard edge gathers at partition frontiers become XLA
collectives (the GSPMD partitioner inserts them from the sharding
annotations); psum-style reductions (min dt, RMS) fall out of the same
propagation.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from su2_tpu.geometry.dual_grid import DualGrid
from su2_tpu.geometry.mesh_data import MeshArrays, mesh_arrays
from su2_tpu.parallel.partition import rcb_order, permute_raw_mesh


def pad_grid(grid: DualGrid, d: int) -> DualGrid:
    """Pad nodes/edges to multiples of d with isolated dummy entities.

    Dummy nodes have unit volume and no incident real edges; dummy edges
    connect dummy nodes with a tiny (1e-16) normal so downstream unit-normal
    divisions stay finite.  Real rows are unchanged, so residuals on real
    nodes match the unpadded mesh exactly.
    """
    np_, ne = grid.npoint, grid.nedge
    ne_pad = (-ne) % d
    extra_nodes = (-np_) % d
    if extra_nodes == 0 and ne_pad == 0:
        return grid
    # dummy edges need two dummy endpoints
    if ne_pad > 0 and extra_nodes < 2:
        extra_nodes += d
    n_new = np_ + extra_nodes
    ne_new = ne + ne_pad

    # distinct dummy coordinates: coincident pads make every edge-length
    # division on the dummy edges 0/0 (e.g. the viscous edge-projection
    # correction), and the resulting pad-row NaNs propagate into real rows
    # through 0*NaN in the roll-based stencil sweeps
    pad_xyz = (1.0 + np.arange(extra_nodes, dtype=np.float64))[:, None] \
        * np.ones((1, grid.ndim))
    coords = np.vstack([grid.coords, pad_xyz])
    volume = np.concatenate([grid.volume, np.ones(extra_nodes)])
    da, db = (np_, np_ + 1) if extra_nodes >= 2 else (0, 0)
    pad_edges = np.tile(np.array([[da, db]]), (ne_new - ne, 1))
    edges = np.vstack([grid.edges, pad_edges]).astype(np.int64)
    edge_normal = np.vstack([grid.edge_normal,
                             np.full((ne_new - ne, grid.ndim), 1e-16)])
    maxdeg = grid.node_edges.shape[1]
    node_edges = np.vstack([
        np.where(grid.node_edges >= ne, ne_new, grid.node_edges),
        np.full((extra_nodes, maxdeg), ne_new, dtype=np.int64)])
    node_sign = np.vstack([grid.node_edge_sign,
                           np.zeros((extra_nodes, maxdeg))])
    node_nbrs = np.vstack([
        grid.node_nbrs,
        np.tile(np.arange(np_, n_new, dtype=np.int64)[:, None], (1, maxdeg))])
    return DualGrid(
        ndim=grid.ndim, coords=coords, volume=volume, edges=edges,
        edge_normal=edge_normal, node_edges=node_edges,
        node_edge_sign=node_sign, node_nbrs=node_nbrs,
        bnd_nodes=grid.bnd_nodes, bnd_normal=grid.bnd_normal,
        bnd_nn=grid.bnd_nn)


def cells_mesh(devices=None, n: int | None = None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n is not None:
        devices = devices[:n]
    return Mesh(np.array(devices), axis_names=("cells",))


def shard_mesh_arrays(mesh: MeshArrays, dmesh: Mesh) -> MeshArrays:
    """Place node/edge-indexed arrays sharded over the cells axis.

    Leading-axis (nP/nE, ...) arrays shard over the row axis; stencil/family
    geometry shaped (K, nP, ...) shards over axis 1 (the roll-based gradient
    /limiter/assembly paths then partition into neighbor collective-permute
    halo exchanges); small boundary-marker data is replicated.  The
    slot-major flattened index forms are dropped — their interleaved layout
    is not expressible as a 1-D block sharding (the (nP, D) forms are)."""
    import dataclasses

    row = NamedSharding(dmesh, P("cells"))
    mid = NamedSharding(dmesh, P(None, "cells"))
    rep = NamedSharding(dmesh, P())
    n, ne = mesh.npoint, mesh.nedge

    def put_rep(x):
        return jax.device_put(x, rep)

    out = {}
    for f in dataclasses.fields(MeshArrays):
        v = getattr(mesh, f.name)
        if f.name == "markers":
            out[f.name] = {tag: (put_rep(a), put_rep(b))
                           for tag, (a, b) in v.items()}
        elif f.name == "marker_nn":
            out[f.name] = {tag: put_rep(x) for tag, x in v.items()}
        elif f.name in ("node_edges_t", "node_sign_t", "node_nbrs_t",
                        "node_edges_sel_t"):
            out[f.name] = None
        elif isinstance(v, (jax.Array, np.ndarray)) and v.ndim >= 1:
            if v.shape[0] in (n, ne):
                out[f.name] = jax.device_put(v, row)
            elif v.ndim >= 2 and v.shape[1] == n:
                out[f.name] = jax.device_put(v, mid)
            else:
                out[f.name] = put_rep(v)
        else:
            out[f.name] = v
    out["n_shards"] = int(dmesh.devices.size)
    return MeshArrays(**out)


def shard_state(dmesh: Mesh, *arrays):
    row = NamedSharding(dmesh, P("cells"))
    return tuple(jax.device_put(a, row) for a in arrays)


def reorder_and_pad(raw_mesh, ndevices: int):
    """RCB-reorder the raw mesh for a power-of-two device count and return
    (permuted raw mesh, builder that pads the DualGrid)."""
    perm = rcb_order(raw_mesh.coords, ndevices)
    permuted = permute_raw_mesh(raw_mesh, perm)
    return permuted, perm
