"""Dense (full-field) boundary-condition assembly for sharded runs.

The gather-based BC path (es.flux_bc_batch + bg.rows/add_rows) computes BC
work on REPLICATED concatenated marker-row batches; under GSPMD every
transfer between the row-sharded state and those replicated batches
materializes a marker-scale all-gather (22 per coupled step on the shipped
combustion case, TODO.md round-2 item).  The reference's BC work is
rank-local vertex loops (integration_structure.cpp:95-193); the data-parallel
equivalent used here makes BC work SHARD-LOCAL by evaluating the pointwise
BC math DENSELY over all nodes with STATIC per-node marker fields
(mask/normal/params, zero or dummy off-marker) and masking the
accumulation.  Every runtime op is then elementwise over the sharded node
axis (strong-wall neighbor access is a stencil roll, which GSPMD turns
into a collective-permute slab exchange), so the BC section partitions
with ZERO all-gathers.

A vertex shared by two weak markers receives one flux contribution per
marker, exactly like the reference's per-marker vertex loops: setup
assigns each (marker, vertex) row to a dense LAYER such that no vertex
appears twice within a layer; multiplicity L costs L dense flux passes
(L == 1 on the shipped cases, 2 at weak-weak marker corners).

The dense pass evaluates each ghost-state construction over all nodes
(~one extra node-wise flux evaluation per layer); that trade is only paid
on sharded runs, where it replaces 22 latency-bound collectives per step.
Single-device runs keep the gather path unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

WEAK_FLUX_KINDS = ("inlet", "outlet", "supersonic_inlet",
                   "supersonic_outlet", "far_field")
SUPPORTED_KINDS = WEAK_FLUX_KINDS + ("euler_wall", "isothermal_wall",
                                     "heatflux_wall")


@dataclass(frozen=True)
class FluxLayer:
    """One dense pass over the weak flux-BC rows of this layer."""
    any_mask: jax.Array       # (nP,) bool — some weak row active here
    normal: jax.Array         # (nP, d) stored (inward) vertex normal; dummy
    #                           (1, 0, ..) off-marker so area divisions stay 1
    coord_nn: jax.Array       # (nP, d) normal-neighbor coords (viscous dij)
    kinds: tuple              # ((kind, inlet_mode, mask (nP,) bool,
    #                            marker: es.BCMarker with dense params), ...)


@dataclass(frozen=True)
class EulerLayer:
    mask: jax.Array           # (nP,) bool
    normal: jax.Array         # (nP, d)


@dataclass(frozen=True)
class WallEntry:
    """One strong no-slip wall marker, dense."""
    kind: str                 # isothermal_wall | heatflux_wall
    mask: jax.Array           # (nP,) bool
    area: jax.Array           # (nP,) static vertex area (0 off-marker)
    dnn: jax.Array            # (nP,) static |coord_nn - coord| (1 off-marker)
    offset: int               # uniform nn - node stencil offset (roll)
    twall: float
    qwall: float


@dataclass(frozen=True)
class DenseBC:
    flux_layers: tuple        # FluxLayer...
    euler_layers: tuple       # EulerLayer...
    walls: tuple              # WallEntry...
    wall_mask: jax.Array      # (nP,) bool — static union of strong walls


def supported(bcs) -> bool:
    """Dense path covers these kinds; strong walls additionally need a
    uniform stencil nn offset (checked in build — returns None if not)."""
    return all(bc.kind in SUPPORTED_KINDS for bc in bcs)


def _assign_layers(entries):
    """entries: [(key, nodes np)]. Returns [ {key: row_idx_array} ] layers
    such that within a layer no node appears twice."""
    layers = []
    for key, nodes in entries:
        rem = np.arange(len(nodes))
        li = 0
        while rem.size:
            if li == len(layers):
                layers.append({"used": set(), "rows": {}})
            used = layers[li]["used"]
            take = np.fromiter((int(n) not in used for n in nodes[rem]),
                               dtype=bool, count=rem.size)
            pick = rem[take]
            if pick.size:
                used.update(int(n) for n in nodes[pick])
                layers[li]["rows"][key] = pick
            rem = rem[~take]
            li += 1
    return layers


def build(bcs, mesh, lay, dtype) -> DenseBC | None:
    """Host-side construction of the dense static marker fields.

    Returns None when any marker is outside the supported set or a strong
    wall lacks a uniform stencil nn offset."""
    from su2_tpu.solvers import euler as es

    if not supported(bcs):
        return None
    npnt = int(mesh.coords.shape[0])
    nd = lay.ndim
    coords = np.asarray(mesh.coords, np.float64)

    # ---- strong walls: per marker (cheap dense elementwise passes) ----
    walls = []
    wall_mask = np.zeros(npnt, bool)
    for bc in bcs:
        if bc.kind not in ("isothermal_wall", "heatflux_wall"):
            continue
        nodes = np.asarray(bc.nodes)
        nn = np.asarray(bc.nn)
        offs = np.unique(nn - nodes)
        if offs.size != 1:
            return None
        normal = np.asarray(bc.normal, np.float64)
        area = np.zeros(npnt)
        area[nodes] = np.linalg.norm(normal, axis=1)
        dnn = np.ones(npnt)
        dnn[nodes] = np.linalg.norm(coords[nn] - coords[nodes], axis=1)
        mask = np.zeros(npnt, bool)
        mask[nodes] = True
        wall_mask |= mask
        walls.append(WallEntry(
            kind=bc.kind, mask=jnp.asarray(mask),
            area=jnp.asarray(area, dtype), dnn=jnp.asarray(dnn, dtype),
            offset=int(offs[0]),
            twall=float(np.asarray(bc.params.get("twall", 0.0))),
            qwall=float(np.asarray(bc.params.get("qwall", 0.0)))))

    # ---- euler (slip) walls: layered mask + dense normal ----
    euler_entries = [(k, np.asarray(bc.nodes))
                     for k, bc in enumerate(bcs) if bc.kind == "euler_wall"]
    euler_layers = []
    for li in _assign_layers(euler_entries):
        mask = np.zeros(npnt, bool)
        normal = np.zeros((npnt, nd))
        normal[:, 0] = 1.0
        for k, rows in li["rows"].items():
            nodes = np.asarray(bcs[k].nodes)[rows]
            mask[nodes] = True
            normal[nodes] = np.asarray(bcs[k].normal, np.float64)[rows]
        euler_layers.append(EulerLayer(
            mask=jnp.asarray(mask), normal=jnp.asarray(normal, dtype)))

    # ---- weak flux BCs: layered, per (kind, inlet_mode) dense params ----
    flux_entries = [(k, np.asarray(bc.nodes))
                    for k, bc in enumerate(bcs)
                    if bc.kind in WEAK_FLUX_KINDS]
    flux_layers = []
    arange = np.arange(npnt)
    for li in _assign_layers(flux_entries):
        any_mask = np.zeros(npnt, bool)
        normal = np.zeros((npnt, nd))
        normal[:, 0] = 1.0
        coord_nn = coords + 1.0
        groups = {}                     # (kind, mode) -> [(bc, rows)]
        for k, rows in li["rows"].items():
            bc = bcs[k]
            nodes = np.asarray(bc.nodes)[rows]
            any_mask[nodes] = True
            normal[nodes] = np.asarray(bc.normal, np.float64)[rows]
            coord_nn[nodes] = coords[np.asarray(bc.nn)[rows]]
            groups.setdefault((bc.kind, bc.inlet_mode), []).append((bc, rows))
        normal_j = jnp.asarray(normal, dtype)
        kinds = []
        for (kind, mode), lst in groups.items():
            mask = np.zeros(npnt, bool)
            for bc, rows in lst:
                mask[np.asarray(bc.nodes)[rows]] = True

            def dense_scalar(name, default):
                fld = np.full(npnt, default)
                for bc, rows in lst:
                    fld[np.asarray(bc.nodes)[rows]] = \
                        float(np.asarray(bc.params[name]))
                return jnp.asarray(fld, dtype)

            def dense_vec(name, default):
                w = np.asarray(lst[0][0].params[name]).shape[-1]
                fld = np.tile(np.asarray(default, np.float64)[:w],
                              (npnt, 1))
                for bc, rows in lst:
                    fld[np.asarray(bc.nodes)[rows]] = \
                        np.asarray(bc.params[name], np.float64)
                return jnp.asarray(fld, dtype)

            if kind == "inlet":
                params = {
                    "v1": dense_scalar("v1", 300.0),
                    "v2": dense_scalar("v2", 1.0),
                    "flow_dir": dense_vec(
                        "flow_dir", [1.0, 0.0, 0.0][:nd]),
                    "ys": dense_vec(
                        "ys", np.asarray(lst[0][0].params["ys"])),
                }
            elif kind == "outlet":
                params = {"p_exit": dense_scalar("p_exit", 1.0e5)}
            elif kind == "supersonic_inlet":
                params = {
                    "t": dense_scalar("t", 300.0),
                    "p": dense_scalar("p", 1.0e5),
                    "vel": dense_vec("vel", [1.0, 0.0, 0.0][:nd]),
                    "ys": dense_vec(
                        "ys", np.asarray(lst[0][0].params["ys"])),
                }
            elif kind == "far_field":
                params = lst[0][0].params        # global freestream scalars
            else:                                # supersonic_outlet
                params = {}
            marker = es.BCMarker(
                kind, "dense", mode, nodes=arange, normal=normal_j,
                params=params, nn=None)
            kinds.append((kind, mode, jnp.asarray(mask), marker))
        flux_layers.append(FluxLayer(
            any_mask=jnp.asarray(any_mask), normal=normal_j,
            coord_nn=jnp.asarray(coord_nn, dtype), kinds=tuple(kinds)))

    return DenseBC(flux_layers=tuple(flux_layers),
                   euler_layers=tuple(euler_layers), walls=tuple(walls),
                   wall_mask=jnp.asarray(wall_mask))


def flux_ghost_layers(lib, lay, dense: DenseBC, v, dpdu_full, tke_inf):
    """Dense ghost states per flux layer.

    Returns [(layer, v_ghost (nP, nPrim), gamma (nP,), vel2 (nP,),
    imposed (nP,) bool — turb (k, w) imposed on inflow kinds)], with
    non-layer rows falling back to the domain state (finite; masked at
    accumulation)."""
    from su2_tpu.solvers import euler as es

    dpdu_e = dpdu_full[:, lay.RHOE]
    nd = lay.ndim
    out = []
    for layer in dense.flux_layers:
        vel_d = v[:, lay.VX:lay.VX + nd]
        v_ghost = v
        gamma = dpdu_e + 1.0
        vel2 = jnp.sum(vel_d * vel_d, axis=1)
        imposed = jnp.zeros(v.shape[0], bool)
        for kind, mode, mask, marker in layer.kinds:
            if kind == "inlet":
                vg, gm, w2 = es.inlet_state(lib, lay, marker, v, dpdu_e,
                                            tke_inf)
            elif kind == "outlet":
                vg, gm, w2, _ = es.outlet_state(lib, lay, marker, v,
                                                dpdu_e, tke_inf)
            elif kind == "supersonic_inlet":
                vg, gm, w2 = es.supersonic_inlet_state(lib, lay, marker, v,
                                                       tke_inf)
            elif kind == "supersonic_outlet":
                vg = v
                gm = dpdu_e + 1.0
                w2 = vel2
            else:                                      # far_field
                vg, gm, w2 = es.far_field_state(lib, lay, marker, v, dpdu_e)
            m1 = mask[:, None]
            v_ghost = jnp.where(m1, vg, v_ghost)
            gamma = jnp.where(mask, jnp.broadcast_to(gm, mask.shape), gamma)
            vel2 = jnp.where(mask, jnp.broadcast_to(w2, mask.shape), vel2)
            if kind in ("inlet", "supersonic_inlet", "far_field"):
                imposed = imposed | mask
        out.append((layer, v_ghost, gamma, vel2, imposed))
    return out
