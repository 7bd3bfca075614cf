"""Linelet preconditioner: block-Thomas along wall-normal lines.

Data-parallel form of CSysMatrix::BuildLineletPreconditioner /
ComputeLineletPreconditioner (reference: Common/src/matrix_structure.cpp
:1837-2028 build, :2029-2148 apply): lines grow from no-slip/Euler-wall
vertices along the strongest-coupling (largest area/volume weight) edge
while weight/max_weight > alpha = 0.9; the preconditioner solves the
block-tridiagonal system restricted to each line with the Thomas
algorithm and applies block-Jacobi everywhere else.

Lines are padded to one static length and solved as a lax.scan over the
line axis, batched across all lines (each step is a (nLines, v, v)
batched small-block inverse/multiply).  The scan is sequential over
~wall-normal extent, so this preconditioner trades latency for
the stronger smoothing — the multicolor SGS is usually faster per
application; LINELET is provided for reference parity and for strongly
anisotropic meshes where the line solve pays off.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from su2_tpu.geometry.mesh_data import MeshArrays

ALPHA = 0.9


def build_linelets(mesh: MeshArrays, wall_kinds=("isothermal_wall",
                                                 "heatflux_wall",
                                                 "euler_wall"),
                   bcs=None):
    """Host-side linelet construction.

    Returns (lines (nL, Lmax) int64 padded with -1, or None when no wall
    markers exist).  Mirrors the reference's greedy growth: seed one line
    per wall vertex, extend to the unvisited neighbor with weight =
    0.5*area*(1/vol_i + 1/vol_j) > alpha*max_weight, stop when several
    candidates qualify (isotropic zone) or none does."""
    nbrs = np.asarray(mesh.node_nbrs)
    edges = np.asarray(mesh.edges)
    area = np.asarray(jnp.linalg.norm(mesh.edge_normal, axis=1))
    vol = np.asarray(mesh.volume)
    n = vol.shape[0]

    edge_of = {}
    for e, (i, j) in enumerate(edges):
        edge_of[(int(i), int(j))] = e
        edge_of[(int(j), int(i))] = e

    seeds = []
    if bcs is not None:
        for bc in bcs:
            if bc.kind in wall_kinds:
                seeds.extend(int(p) for p in np.asarray(bc.nodes))
    if not seeds:
        return None

    def weight(i, j):
        e = edge_of[(i, j)]
        return 0.5 * area[e] * (1.0 / vol[i] + 1.0 / vol[j])

    unvisited = np.ones(n, dtype=bool)
    for p in seeds:
        unvisited[p] = False
    lines = []
    for seed in seeds:
        line = [seed]
        while True:
            p = line[-1]
            cands = [int(q) for q in nbrs[p]
                     if q != p and unvisited[q]]
            if not cands:
                break
            wmax = max(weight(p, q) for q in cands)
            good = [q for q in cands
                    if weight(p, q) / wmax > ALPHA
                    and (len(line) < 2 or q != line[-2])]
            if len(good) != 1:          # isotropic zone or dead end
                break
            line.append(good[0])
            unvisited[good[0]] = False
        lines.append(line)

    lmax = max(len(l) for l in lines)
    if lmax < 2:
        return None
    out = np.full((len(lines), lmax), -1, dtype=np.int64)
    for k, l in enumerate(lines):
        out[k, :len(l)] = l
    return out


def block_sel_edges(mesh: MeshArrays, lines: np.ndarray):
    """Static index maps for the line-neighbor blocks (edge-major form).

    Returns (lsel, fsel): (nL, Lmax) int64 into concat([off_ij, off_ji,
    zero]); lsel[k, e] names block(line[e], line[e-1]) (the lower block of
    step e), fsel[k, e] block(line[e-1], line[e]) (upper).  Element 0 and
    padding slots point at the zero pad."""
    edges = np.asarray(mesh.edges)
    ne = edges.shape[0]
    edge_of = {}
    for e, (i, j) in enumerate(edges):
        edge_of[(int(i), int(j))] = (e, True)     # (i,j): off_ij = block(i,j)
        edge_of[(int(j), int(i))] = (e, False)
    nl, lmax = lines.shape
    lsel = np.full((nl, lmax), 2 * ne, dtype=np.int64)
    fsel = np.full((nl, lmax), 2 * ne, dtype=np.int64)
    for k in range(nl):
        for e in range(1, lmax):
            prev, cur = lines[k, e - 1], lines[k, e]
            if cur < 0:
                break
            eid, fwd = edge_of[(int(cur), int(prev))]
            # block(cur, prev): row cur col prev
            lsel[k, e] = eid if fwd else eid + ne
            eid2, fwd2 = edge_of[(int(prev), int(cur))]
            fsel[k, e] = eid2 if fwd2 else eid2 + ne
    return lsel, fsel


def block_sel_family(mesh: MeshArrays, lines: np.ndarray):
    """Static index maps for the family-major form (blockcsr.
    FamilyJacobian): slot (k, p) of off_ij is block(p, p+o_k), of off_ji
    block(p+o_k, p); indices address concat([off_ij, off_ji, zero])."""
    offs = {o: k for k, o in enumerate(mesh.fam_offsets)}
    n = mesh.npoint
    kh = len(mesh.fam_offsets)
    pad = 2 * kh * n
    nl, lmax = lines.shape
    lsel = np.full((nl, lmax), pad, dtype=np.int64)
    fsel = np.full((nl, lmax), pad, dtype=np.int64)
    for li in range(nl):
        for e in range(1, lmax):
            prev, cur = int(lines[li, e - 1]), int(lines[li, e])
            if cur < 0:
                break
            d = cur - prev
            if d in offs:               # cur = prev + o
                k = offs[d]
                lsel[li, e] = kh * n + k * n + prev     # off_ji[k, prev]
                fsel[li, e] = k * n + prev              # off_ij[k, prev]
            else:                        # prev = cur + o
                k = offs[-d]
                lsel[li, e] = k * n + cur               # off_ij[k, cur]
                fsel[li, e] = kh * n + k * n + cur      # off_ji[k, cur]
    return lsel, fsel


def _inv_blocks(a):
    from su2_tpu.linalg.smallsolve import gauss_solve
    v = a.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(v, dtype=a.dtype), a.shape)
    return gauss_solve(a, eye, pivot=False)


def make_linelet_apply(mesh: MeshArrays, lines: np.ndarray, diag, off_ij,
                       off_ji, dinv, family: bool = False):
    """Closure r -> z applying the linelet preconditioner.

    diag: (nP, v, v); off_ij/off_ji: edge blocks ((nE, v, v) edge-major or
    (Kh*nP, v, v) family-major with family=True); dinv: the block-Jacobi
    factor used off the lines (reference does the same)."""
    nl, lmax = lines.shape
    v = diag.shape[-1]
    if family:
        lsel, fsel = block_sel_family(mesh, lines)
    else:
        lsel, fsel = block_sel_edges(mesh, lines)
    node_idx = jnp.asarray(np.where(lines < 0, 0, lines))        # (nL, Lmax)
    valid = jnp.asarray(lines >= 0)
    pad = jnp.zeros((1, v, v), dtype=diag.dtype)
    stacked = jnp.concatenate([off_ij, off_ji, pad], axis=0)
    lblk = stacked[jnp.asarray(lsel)]                            # (nL, Lmax, v, v)
    fblk = stacked[jnp.asarray(fsel)]
    eye = jnp.eye(v, dtype=diag.dtype)
    dblk = jnp.where(valid[:, :, None, None], diag[node_idx], eye)

    # node -> (line, elem) scatter map (each node in <= 1 line)
    flat_nodes = np.where(lines < 0, -1, lines).reshape(-1)
    in_line = np.zeros(mesh.npoint, dtype=bool)
    slot_of = np.zeros(mesh.npoint, dtype=np.int64)
    for s, p in enumerate(flat_nodes):
        if p >= 0:
            in_line[p] = True
            slot_of[p] = s
    in_line_j = jnp.asarray(in_line)
    slot_j = jnp.asarray(slot_of)

    def apply(r):
        rl = jnp.where(valid[:, :, None], r[node_idx], 0.0)      # (nL,Lmax,v)

        def fwd(carry, inp):
            # padding slots carry zero L/F blocks and identity D, so no
            # masking is needed: u_e = eye, y_e = 0 flow through unchanged
            u_prev, y_prev = carry
            d_e, l_e, f_e, r_e = inp
            inv_u = _inv_blocks(u_prev)
            lb = jnp.einsum("kij,kjl->kil", l_e, inv_u)
            u_e = d_e - jnp.einsum("kij,kjl->kil", lb, f_e)
            y_e = r_e - jnp.einsum("kij,kj->ki", lb, y_prev)
            return (u_e, y_e), (u_e, y_e)

        # element 0 initialization
        u0 = dblk[:, 0]
        y0 = rl[:, 0]
        ins = (jnp.swapaxes(dblk[:, 1:], 0, 1),
               jnp.swapaxes(lblk[:, 1:], 0, 1),
               jnp.swapaxes(fblk[:, 1:], 0, 1),
               jnp.swapaxes(rl[:, 1:], 0, 1))
        _, (us, ys) = jax.lax.scan(fwd, (u0, y0), ins)
        us = jnp.concatenate([u0[None], us], axis=0)             # (Lmax,nL,v,v)
        ys = jnp.concatenate([y0[None], ys], axis=0)

        # backward substitution; each line's real terminal element sees a
        # zero F block toward its padded successor, so z = inv(U) y there
        inv_last = _inv_blocks(us[-1])
        z_last = jnp.einsum("kij,kj->ki", inv_last, ys[-1])

        def bwd(z_next, inp):
            u_e, y_e, f_next = inp
            rhs = y_e - jnp.einsum("kij,kj->ki", f_next, z_next)
            z_e = jnp.einsum("kij,kj->ki", _inv_blocks(u_e), rhs)
            return z_e, z_e

        ins_b = (us[:-1][::-1], ys[:-1][::-1],
                 jnp.swapaxes(fblk[:, 1:], 0, 1)[::-1])
        _, zs_rev = jax.lax.scan(bwd, z_last, ins_b)
        zs = jnp.concatenate([zs_rev[::-1], z_last[None]], axis=0)
        zflat = jnp.swapaxes(zs, 0, 1).reshape(nl * lmax, v)

        jac = jnp.einsum("nij,nj->ni", dinv, r)
        return jnp.where(in_line_j[:, None], zflat[slot_j], jac)

    return apply
