"""Device-resident sequential-equivalent LU-SGS: wavefront (level-scheduled)
sweeps in natural node order.

The reference's LU-SGS preconditioner sweeps nodes SEQUENTIALLY in natural
order (CSysMatrix::ComputeLU_SGSPreconditioner,
Common/src/matrix_structure.cpp:1673):

    (D + L) x* = b        forward, node 0 .. n-1
    (D + U) z  = D x*     backward, node n-1 .. 0

Round 3 proved (linalg/seq_sgs.py host-callback experiment) that the
flat-plate production-path deviation is exactly this ordering on
UNDER-CONVERGED solves.  This module makes the sequential-equivalent
ordering reachable ON DEVICE, with no host callback and no env knob
(LINEAR_SOLVER_PREC= LU_SGS_WAVE): nodes are grouped into wavefront
levels — level(p) = 1 + max over lower-neighbors q<p of level(q) — and a
whole level updates as one batched gather/blockmul/scatter, which is
mathematically identical to the sequential sweep because no node depends
on a same-level node.  Level count ~ O(sqrt(n)) on banded structured
orderings (anti-diagonal-like fronts), so the sweep is a lax.scan of
O(sqrt(n)) small batched steps: slow relative to the multicolor sweep but
device-resident, jit-compatible, and usable in validation AND production
configs.

Supports the family-major static-stencil layout (sel (K, nP, v, v),
neighbor of p at p + offsets[k]) used by every implicit path on
structured-ordered meshes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def build_levels(n: int, offsets) -> tuple[np.ndarray, np.ndarray]:
    """(levels_fwd, levels_bwd) index matrices (nlev, Lmax) padded with n.

    levels_fwd: topological levels of the lower-triangular dependency
    graph (edges q -> p for q = p + o, o < 0); within a level, nodes are
    mutually independent so a batched update equals the sequential one.
    levels_bwd: same for the upper graph (o > 0), used back-to-front.

    Structural levels (every in-range offset counts, zero block or not):
    extra dependencies only split levels further, never break equivalence.
    """
    neg = sorted({int(o) for o in offsets if int(o) < 0})
    lev = np.zeros(n, dtype=np.int64)
    for p in range(n):
        m = -1
        for o in neg:
            q = p + o
            if q >= 0 and lev[q] > m:
                m = lev[q]
        lev[p] = m + 1

    def pack(levels):
        nlev = int(levels.max()) + 1 if n else 0
        order = np.argsort(levels, kind="stable")
        counts = np.bincount(levels, minlength=nlev)
        lmax = int(counts.max()) if n else 0
        out = np.full((nlev, lmax), n, dtype=np.int32)
        start = 0
        for li in range(nlev):
            c = counts[li]
            out[li, :c] = order[start:start + c]
            start += c
        return out

    fwd = pack(lev)
    # backward graph: dependencies q = p + o, o > 0, processed n-1 .. 0.
    # By symmetry of the offset set this equals the forward levels of the
    # reversed ordering; compute directly for generality.
    pos = sorted({int(o) for o in offsets if int(o) > 0})
    levb = np.zeros(n, dtype=np.int64)
    for p in range(n - 1, -1, -1):
        m = -1
        for o in pos:
            q = p + o
            if q < n and levb[q] > m:
                m = levb[q]
        levb[p] = m + 1
    bwd = pack(levb)
    return fwd, bwd


def make_wavefront_pc(mesh, v: int, levels=None):
    """pc(diag, sel, r) applying the natural-order LU-SGS via wavefront
    levels; sel in the family-major stencil layout (K, nP, v, v)."""
    from su2_tpu.linalg.blockcsr import block_diag_inv

    offsets = [int(o) for o in mesh.stencil_offsets]
    n = int(mesh.npoint)
    if levels is None:
        levels = build_levels(n, offsets)
    lev_f = jnp.asarray(levels[0])
    lev_b = jnp.asarray(levels[1])
    neg = [(k, o) for k, o in enumerate(offsets) if o < 0]
    pos = [(k, o) for k, o in enumerate(offsets) if o > 0]

    def pc(diag, sel, r):
        dtype = r.dtype
        dinv = block_diag_inv(diag)
        # D^-1-scaled off-diagonal blocks: (I + D^-1 L) x = D^-1 b,
        # (I + D^-1 U) z = x  — the scalar expansion seq_sgs.py uses
        scaled = jnp.einsum("pvw,kpwx->kpvx", dinv, sel)
        b = jnp.einsum("pvw,pw->pv", dinv, r)
        # pad row n: gathers of pad indices read zeros, scatters drop
        zrow = jnp.zeros((1, v), dtype)
        bp = jnp.concatenate([b, zrow], axis=0)
        sp = jnp.concatenate([scaled,
                              jnp.zeros((len(offsets), 1, v, v), dtype)],
                             axis=1)

        def sweep(levmat, terms, x0):
            def step(x, idx):
                acc = bp[idx]
                for k, o in terms:
                    # neighbor p+o: in-range for every node whose block is
                    # structurally nonzero; clamp keeps pad/edge gathers
                    # in bounds (their blocks are zero)
                    nb = jnp.clip(idx + o, 0, n)
                    acc = acc - jnp.einsum("lvw,lw->lv", sp[k, idx], x[nb])
                return x.at[idx].set(acc, mode="drop"), None

            x, _ = jax.lax.scan(step, x0, levmat)
            return x

        x = sweep(lev_f, neg, jnp.zeros((n + 1, v), dtype))
        # backward: z = x - D^-1 U z, seeded with x (bp := x)
        xp = x

        def bstep(z, idx):
            acc = xp[idx]
            for k, o in pos:
                nb = jnp.clip(idx + o, 0, n)
                acc = acc - jnp.einsum("lvw,lw->lv", sp[k, idx], z[nb])
            return z.at[idx].set(acc, mode="drop"), None

        z, _ = jax.lax.scan(bstep, jnp.zeros((n + 1, v), dtype), lev_b)
        return z[:n]

    return pc
