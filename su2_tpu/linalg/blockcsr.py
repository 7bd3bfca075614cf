"""Block-sparse Jacobian in edge-coordinate form + preconditioners.

Device-array replacement for CSysMatrix (reference:
Common/src/matrix_structure.cpp — block-CSR with AddBlock/SubtractBlock,
Jacobi/ILU0/LU-SGS preconditioners).  Instead of CSR, blocks live in the
natural mesh layout:

  diag:   (nP, v, v)   diagonal blocks
  off_ij: (nE, v, v)   row i, column j block of edge e = (i, j)
  off_ji: (nE, v, v)   row j, column i block

The matvec gathers neighbor values through the padded node->edge adjacency —
deterministic, no atomics.  LU-SGS is inherently sequential over an ordering,
so the preconditioner here is block-Jacobi (exact batched block inverse)
optionally wrapped in a few symmetric block-Gauss-Seidel-like sweeps done
Jacobi-style; outer FGMRES tolerance governs accuracy, matching the
reference's convergence contract (linear tol, outer residual history).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from su2_tpu.geometry.mesh_data import MeshArrays


@dataclass(frozen=True)
class BlockJacobian:
    diag: jax.Array     # (nP, v, v)
    off_ij: jax.Array   # (nE, v, v)
    off_ji: jax.Array   # (nE, v, v)


jax.tree_util.register_dataclass(
    BlockJacobian, data_fields=["diag", "off_ij", "off_ji"], meta_fields=[])


@dataclass(frozen=True)
class FamilyJacobian:
    """Block Jacobian assembled on the family-major virtual edge set
    (MeshArrays.fam_gather_*): slot (k, p) is the (p, p+fam_offsets[k])
    edge.  off_ij[k*nP+p] is the row-p/column-(p+o_k) block; off_ji the
    row-(p+o_k)/column-p block stored at the same slot.  Padding slots
    carry zero blocks, so converting to the static-stencil sel form is
    pure reshapes and rolls (no gather)."""
    diag: jax.Array     # (nP, v, v)
    off_ij: jax.Array   # (Kh*nP, v, v)
    off_ji: jax.Array   # (Kh*nP, v, v)


jax.tree_util.register_dataclass(
    FamilyJacobian, data_fields=["diag", "off_ij", "off_ji"], meta_fields=[])


def family_sel(mesh: MeshArrays, jac: FamilyJacobian) -> jax.Array:
    """(K, nP, v, v) static-stencil sel from family-major blocks: offset
    +o_k rows read off_ij[k] in place; offset -o_k rows read off_ji[k]
    shifted to the j node (roll by +o_k; wrapped rows are zero padding)."""
    n = mesh.npoint
    kh = len(mesh.fam_offsets)
    v = jac.diag.shape[-1]
    oij = jac.off_ij.reshape(kh, n, v, v)
    oji = jac.off_ji.reshape(kh, n, v, v)
    by_off = {}
    for k, o in enumerate(mesh.fam_offsets):
        by_off[o] = oij[k]
        by_off[-o] = jnp.roll(oji[k], o, axis=0)
    return jnp.stack([by_off[o] for o in mesh.stencil_offsets], axis=0)



def _bmv(blocks: jax.Array, vecs: jax.Array) -> jax.Array:
    """Batched small-block matvec sum: ("...ij,...j->...i") as elementwise
    mul + reduce.  For tiny v (2-13 wide) dot_general forces dim-ordered
    layouts and XLA inserts relayout copies around every gather feeding it
    (~0.08 ms each on the 9k-cell case); an elementwise fusion is
    layout-agnostic and free to fuse with the gather itself."""
    return (blocks * vecs[..., None, :]).sum(axis=-1)

def matvec(mesh: MeshArrays, jac: BlockJacobian, x: jax.Array,
           offdiag: jax.Array | None = None) -> jax.Array:
    """y = A x with x, y of shape (nP, v).

    Pass ``offdiag`` (from :func:`gather_offdiag`) to reuse the gathered
    per-(node, slot) neighbor blocks across repeated matvecs — the gather is
    the memory-bound part of the product, so Krylov solvers should hoist it.
    """
    y = _bmv(jac.diag, x)
    # neighbor contributions: node p with sign +1 on edge e=(p, q) uses
    # off_ij[e] @ x[q]; with sign -1 (p == j) uses off_ji[e] @ x[q].
    sel = gather_offdiag(mesh, jac) if offdiag is None else offdiag
    return y + _offdiag_apply(mesh, sel, x)


def block_jacobi_factor(jac: BlockJacobian) -> jax.Array:
    return block_diag_inv(jac.diag)


def block_diag_inv(diag: jax.Array) -> jax.Array:
    """Batched inverse of (nP, v, v) diagonal blocks.

    Via the vectorized Gauss-Jordan solver against identity —
    jnp.linalg.inv lowers to per-matrix LU (slow for huge batches of small
    blocks, same pathology as linalg.solve)."""
    from su2_tpu.linalg.smallsolve import gauss_solve

    jac = BlockJacobian(diag=diag, off_ij=diag, off_ji=diag)
    v = jac.diag.shape[-1]
    if v == 2:
        # closed-form adjugate: the Gauss-Jordan path's .at[].set rows
        # lower to scatters that dominate the 2x2 turbulence factor
        a = jac.diag[:, 0, 0]
        b = jac.diag[:, 0, 1]
        c = jac.diag[:, 1, 0]
        d = jac.diag[:, 1, 1]
        det = a * d - b * c
        det = jnp.where(det == 0.0, 1.0, det)
        inv = jnp.stack([d, -b, -c, a], axis=-1) / det[:, None]
        return inv.reshape(jac.diag.shape)
    # lane-major Gauss-Jordan: the node-major form ran ~10x off roofline
    # on v>=7 blocks (see smallsolve.gauss_inv_t)
    from su2_tpu.linalg.smallsolve import gauss_inv_t
    return gauss_inv_t(jac.diag)


def block_jacobi_apply(dinv: jax.Array, r: jax.Array) -> jax.Array:
    return _bmv(dinv, r)


def sgs_like_apply(mesh: MeshArrays, jac: BlockJacobian, dinv: jax.Array,
                   r: jax.Array, sweeps: int = 2) -> jax.Array:
    """Jacobi-style symmetric sweeps approximating LU-SGS smoothing:
    x_{k+1} = D^{-1} (r - (L+U) x_k), x_0 = D^{-1} r."""
    x = block_jacobi_apply(dinv, r)

    def body(_, x):
        off = matvec(mesh, jac, x) - _bmv(jac.diag, x)
        return block_jacobi_apply(dinv, r - off)

    return jax.lax.fori_loop(0, sweeps, body, x)


# --------------------------------------------------------------------------
# Multicolor symmetric block-Gauss-Seidel (the data-parallel form of LU_SGS)
# --------------------------------------------------------------------------

def greedy_coloring(node_nbrs) -> "np.ndarray":
    """Greedy graph coloring on the host (NumPy).  node_nbrs: (nP, D) padded
    with self.  Returns (nP,) int colors; planar duals need ~4-6 colors.

    Replaces the sequential ordering dependence of the reference's LU-SGS
    (matrix_structure.hpp:479) with color-parallel sweeps: nodes of one color
    share no edge, so each color updates in a single vectorized step.
    """
    import numpy as np

    nbrs = np.asarray(node_nbrs)
    n = nbrs.shape[0]
    colors = -np.ones(n, dtype=np.int64)
    for p in range(n):
        used = set(colors[q] for q in nbrs[p] if q != p and colors[q] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[p] = c
    return colors


def _offdiag_apply(mesh: MeshArrays, sel: jax.Array, x: jax.Array):
    """sum_d sel[p,d] @ x[nbr(p,d)] for sel from gather_offdiag: the static
    stencil (K, nP, v, v) form, the slot-major (D*nP, v, v) flat form, or
    the (nP, D, v, v) form."""
    n = mesh.npoint
    if (mesh.stencil_offsets is not None and sel.ndim == 4
            and sel.shape[0] == len(mesh.stencil_offsets)):
        # static-stencil: neighbor access is a lane shift, not a gather
        # (geometry/stencil.py) — kills the per-application gather relayout
        # copies that dominated the turb FGMRES/SGS cost
        parts = [_bmv(sel[k], jnp.roll(x, -o, axis=0))
                 for k, o in enumerate(mesh.stencil_offsets)]
        return sum(parts[1:], parts[0])
    if sel.ndim == 3:                       # slot-major flat
        xn = x[mesh.node_nbrs_t]                                  # (D*nP, v)
        prod = _bmv(sel, xn)                                      # (D*nP, v)
        parts = [prod[d * n:(d + 1) * n] for d in range(mesh.max_degree)]
        return sum(parts[1:], parts[0])
    xn = x[mesh.node_nbrs]                                        # (nP,D,v)
    return _bmv(sel, xn).sum(axis=1)


def gather_offdiag(mesh: MeshArrays, jac: BlockJacobian) -> jax.Array:
    """Per-(node, slot) neighbor blocks for matvec/SGS: the static-stencil
    (K, nP, v, v) form when the mesh has one (ONE gather per solve; every
    application is then gather-free), else slot-major (D*nP, v, v) for large
    meshes, else (nP, D, v, v)."""
    if mesh.stencil_sel is not None:
        pad = jnp.zeros((1,) + jac.off_ij.shape[1:], dtype=jac.off_ij.dtype)
        stacked = jnp.concatenate([jac.off_ij, jac.off_ji, pad], axis=0)
        return stacked[mesh.stencil_sel]                  # (K, nP, v, v)
    # the slot-major form wins once relayout-copy cost dominates the extra
    # slice/add ops (~16k nodes); small systems keep the fused reduce
    if mesh.node_edges_sel_t is not None and mesh.npoint >= 16384:
        pad = jnp.zeros((1,) + jac.off_ij.shape[1:], dtype=jac.off_ij.dtype)
        stacked = jnp.concatenate([jac.off_ij, jac.off_ji, pad], axis=0)
        return stacked[mesh.node_edges_sel_t]
    if mesh.node_edges_sel is not None:
        pad = jnp.zeros((1,) + jac.off_ij.shape[1:], dtype=jac.off_ij.dtype)
        stacked = jnp.concatenate([jac.off_ij, jac.off_ji, pad], axis=0)
        return stacked[mesh.node_edges_sel]
    pad = jnp.zeros((1,) + jac.off_ij.shape[1:], dtype=jac.off_ij.dtype)
    oij = jnp.concatenate([jac.off_ij, pad], axis=0)[mesh.node_edges]
    oji = jnp.concatenate([jac.off_ji, pad], axis=0)[mesh.node_edges]
    return jnp.where((mesh.node_sign > 0.5)[:, :, None, None], oij,
                     jnp.where((mesh.node_sign < -0.5)[:, :, None, None], oji,
                               jnp.zeros_like(oij)))


def multicolor_sgs_apply(mesh: MeshArrays, jac: BlockJacobian,
                         dinv: jax.Array, color_masks, r: jax.Array,
                         offdiag: jax.Array | None = None) -> jax.Array:
    """One symmetric multicolor block-Gauss-Seidel sweep z ~= A^{-1} r.

    Forward pass over colors then backward pass (the D+L / D+U halves of the
    reference's ComputeLU_SGSPreconditioner, matrix_structure.cpp), with each
    color updated as one dense masked batch.
    """
    sel = gather_offdiag(mesh, jac) if offdiag is None else offdiag
    z = jnp.zeros_like(r)

    def color_update(z, mask):
        nz = _offdiag_apply(mesh, sel, z)
        znew = _bmv(dinv, r - nz)
        return jnp.where(mask[:, None], znew, z)

    for mask in color_masks:
        z = color_update(z, mask)
    # The first backward color duplicates the last forward update exactly:
    # same-color nodes share no edge, so its off-diagonal inputs are
    # unchanged — skip it (one full sel read saved per application).
    for mask in list(reversed(color_masks))[1:]:
        z = color_update(z, mask)
    return z


def make_solver_ops(mesh: MeshArrays, jac, kind: str = "JACOBI",
                    color_masks=None, linelets=None):
    """(matvec, precond) closures for a Krylov solve of a BlockJacobian or
    FamilyJacobian system: the multicolor SGS sweep for the LU_SGS class,
    block Jacobi otherwise.

    linelets: (nL, Lmax) host index matrix from linelet.build_linelets —
    with kind == "LINELET" enables the true block-Thomas line
    preconditioner (ComputeLineletPreconditioner parity); without it
    LINELET falls back to the multicolor SGS sweep (same smoothing role).
    """
    if kind == "LU_SGS_SEQ":
        # reference-exact sequential natural-order sweep via host callback
        # (linalg/seq_sgs.py) — validation only: attributes parity gaps of
        # UNDER-CONVERGED solves (max_iter hit before tol) to the
        # preconditioner ordering.  Env knob: SU2_TPU_SEQ_SGS_FLOW=1.
        from su2_tpu.linalg import seq_sgs
        if isinstance(jac, FamilyJacobian):
            sel = family_sel(mesh, jac)
            mv = lambda x: _bmv(jac.diag, x) + _offdiag_apply(mesh, sel, x)
            pcf = seq_sgs.fam_preconditioner(mesh, jac.diag.shape[-1])
            pc = lambda r: pcf(jac.diag, sel, r)
        else:
            sel = gather_offdiag(mesh, jac)
            mv = lambda x: matvec(mesh, jac, x, sel)
            pce = seq_sgs.edge_preconditioner(mesh, jac.diag.shape[-1])
            pc = lambda r: pce(jac.diag, jac.off_ij, jac.off_ji, r)
        return mv, pc
    if kind == "LU_SGS_WAVE":
        # device-resident sequential-equivalent LU-SGS (wavefront levels in
        # natural order, linalg/wavefront.py) — the device-side form of
        # LU_SGS_SEQ: same sweep semantics, no host callback
        from su2_tpu.linalg import wavefront
        if mesh.stencil_offsets is None:
            raise ValueError("LU_SGS_WAVE needs a structured-ordered mesh "
                             "(stencil offsets)")
        if isinstance(jac, FamilyJacobian):
            sel = family_sel(mesh, jac)
        else:
            if mesh.stencil_sel is None:
                raise ValueError("LU_SGS_WAVE: stencil_sel unavailable")
            sel = gather_offdiag(mesh, jac)
        diag = jac.diag
        mv = lambda x: _bmv(diag, x) + _offdiag_apply(mesh, sel, x)
        pcw = wavefront.make_wavefront_pc(mesh, diag.shape[-1])
        pc = lambda r: pcw(diag, sel, r)
        return mv, pc
    if kind == "LINELET" and linelets is not None:
        from su2_tpu.linalg import linelet as ll
        fam = isinstance(jac, FamilyJacobian)
        dinv = block_diag_inv(jac.diag)
        pc = ll.make_linelet_apply(mesh, linelets, jac.diag, jac.off_ij,
                                   jac.off_ji, dinv, family=fam)
        if fam:
            sel = family_sel(mesh, jac)
            mv = lambda x: _bmv(jac.diag, x) + _offdiag_apply(mesh, sel, x)
        else:
            sel = gather_offdiag(mesh, jac)
            mv = lambda x: matvec(mesh, jac, x, sel)
        return mv, pc
    if isinstance(jac, FamilyJacobian):
        return make_solver_ops_fam(mesh, jac.diag, family_sel(mesh, jac),
                                   kind, color_masks)
    dinv = block_jacobi_factor(jac)
    sgs = kind in ("LU_SGS", "ILU0", "LINELET") and color_masks is not None
    sel = gather_offdiag(mesh, jac)
    mv = lambda x: matvec(mesh, jac, x, sel)
    if sgs:
        pc = lambda r: multicolor_sgs_apply(mesh, jac, dinv, color_masks, r,
                                            offdiag=sel)
    else:
        pc = lambda r: block_jacobi_apply(dinv, r)
    return mv, pc


def make_solver_ops_fam(mesh: MeshArrays, diag: jax.Array, sel: jax.Array,
                        kind: str = "JACOBI", color_masks=None):
    """(matvec, precond) from off-diagonal blocks already in the
    static-stencil layout sel (K, nP, v, v) — sel[k, p] multiplies
    x[p + offsets[k]] in row p — skipping BlockJacobian + gather_offdiag
    entirely (the per-solve stacked gather was ~0.2 ms of the 9k coupled
    step)."""
    if kind == "LU_SGS_WAVE":
        from su2_tpu.linalg import wavefront
        mv = lambda x: _bmv(diag, x) + _offdiag_apply(mesh, sel, x)
        pcw = wavefront.make_wavefront_pc(mesh, diag.shape[-1])
        return mv, (lambda r: pcw(diag, sel, r))
    dinv = block_diag_inv(diag)
    sgs = kind in ("LU_SGS", "ILU0", "LINELET") and color_masks is not None
    mv = lambda x: _bmv(diag, x) + _offdiag_apply(mesh, sel, x)
    if sgs:
        z_jac = BlockJacobian(diag=diag, off_ij=diag, off_ji=diag)
        pc = lambda r: multicolor_sgs_apply(mesh, z_jac, dinv, color_masks,
                                            r, offdiag=sel)
    else:
        pc = lambda r: block_jacobi_apply(dinv, r)
    return mv, pc


def make_preconditioner(mesh: MeshArrays, jac: BlockJacobian,
                        kind: str = "JACOBI", color_masks=None):
    """Factor once, return the apply closure (CSysSolve preconditioner
    selection, linear_solvers_structure.cpp:606-650).  ILU0/LINELET fall
    back to the SGS sweep (same smoothing role)."""
    dinv = block_jacobi_factor(jac)
    if kind in ("LU_SGS", "ILU0", "LINELET") and color_masks is not None:
        sel = gather_offdiag(mesh, jac)
        return lambda r: multicolor_sgs_apply(
            mesh, jac, dinv, color_masks, r, offdiag=sel)
    return lambda r: block_jacobi_apply(dinv, r)
