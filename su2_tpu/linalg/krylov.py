"""Matrix-free Krylov solvers: FGMRES, BCGSTAB, CG.

Device-side CSysSolve (reference: Common/src/linear_solvers_structure.cpp —
CG :202, FGMRES :309, BCGSTAB :465).  Solvers are pure functions over
(nP, v)-shaped vectors with a caller-supplied matvec and (right)
preconditioner; iteration counts are static (the reference's
LINEAR_SOLVER_ITER is small: 5 in the shipped cfgs), with converged
components frozen by masking so behavior under jit is deterministic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _dot(a, b):
    return jnp.vdot(a, b)


def _norm(a):
    return jnp.sqrt(jnp.real(_dot(a, a)))


def _pow2_scale(b):
    """Power-of-two magnitude of b, for overflow-safe solves.

    The SST system can carry residual entries ~1e21 in f32 (omega ~ 1/d^2
    near walls); ||b||^2 then overflows and the Krylov iteration turns the
    whole solution to NaN.  Dividing b by an exact power of two introduces
    NO rounding (exponent shift only), so f64 validation trajectories are
    bit-identical while f32 stays inside range."""
    absmax = jnp.max(jnp.abs(b))
    ex = jnp.floor(jnp.log2(jnp.maximum(absmax, 1e-300)))
    s = jnp.exp2(jnp.clip(ex, -120.0, 120.0)).astype(b.dtype)
    return jnp.where(absmax > 0, s, jnp.ones_like(s))


def fgmres(matvec, precond, b, x0=None, max_iter: int = 5, tol: float = 1e-6):
    """Flexible GMRES (right preconditioning), single cycle of `max_iter`
    Krylov vectors (matches the reference usage: FGMRES with a small fixed
    iteration budget, tolerance `tol` relative to ||b||).

    Returns (x, final_relative_residual, iters_used).
    """
    s = _pow2_scale(b)
    b = b / s
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0 / s
        r = b - matvec(x)
    beta = _norm(r)
    norm0 = jnp.maximum(_norm(b), 1e-300)
    m = max_iter

    # Arnoldi with modified Gram-Schmidt (unrolled: m is small & static).
    # The per-iteration residual comes from the classical Givens-rotation
    # recurrence on the Hessenberg column (|g_{j+1}| — the same quantity
    # the reference's FGMRES tracks, linear_solvers_structure.cpp:309):
    # pure scalar bookkeeping that XLA fuses into a handful of ops, where
    # a per-iteration dense lstsq was ~70 tiny device ops per solve.
    vs = [r / jnp.maximum(beta, 1e-300)]
    zs = []
    cols = []                    # unrotated Hessenberg columns (scalars)
    cs, sn = [], []
    g = [beta]
    active = beta / norm0 >= tol
    iters = jnp.asarray(0, dtype=jnp.int32)
    res_hist = beta
    one = jnp.ones_like(beta)
    zero = jnp.zeros_like(beta)
    for j in range(m):
        z = precond(vs[j])
        w = matvec(z)
        zs.append(z)
        col = []
        for i in range(j + 1):
            hij = _dot(vs[i], w)
            hij = jnp.where(active, hij, one * (i == j))
            col.append(hij)
            w = w - jnp.where(active, hij, 0.0) * vs[i]
        hj1 = _norm(w)
        hj1 = jnp.where(active, hj1, 0.0)
        vs.append(jnp.where(active, w / jnp.maximum(hj1, 1e-300), vs[j]))
        iters = iters + active.astype(jnp.int32)
        rc = list(col) + [hj1]
        for i in range(j):
            t = cs[i] * rc[i] + sn[i] * rc[i + 1]
            rc[i + 1] = -sn[i] * rc[i] + cs[i] * rc[i + 1]
            rc[i] = t
        denom = jnp.sqrt(rc[j] * rc[j] + rc[j + 1] * rc[j + 1])
        safe = jnp.maximum(denom, 1e-300)
        cj = jnp.where(denom == 0.0, one, rc[j] / safe)
        sj = jnp.where(denom == 0.0, zero, rc[j + 1] / safe)
        cs.append(cj)
        sn.append(sj)
        gj1 = -sj * g[j]
        g[j] = cj * g[j]
        g.append(gj1)
        cur = jnp.abs(gj1)
        res_hist = jnp.where(active, cur, res_hist)
        active = active & (cur / norm0 >= tol)
        # fully-rotated upper-triangular column of R: entries rc[0..j-1]
        # carry the previous rotations, the diagonal is the new rotation's
        # annihilated magnitude (R_jj = cj*rc[j] + sj*rc[j+1] = denom)
        cols.append(rc[:j] + [cj * rc[j] + sj * rc[j + 1]])

    # y from back-substitution on the Givens-rotated R y = g — the exact
    # least-squares solution via the QR factors already built above (the
    # same recurrence the reference's FGMRES uses: SolveReduced,
    # linear_solvers_structure.cpp:309).  Replaces a pivoted dense solve of
    # the normal equations (~450 scalar HLO ops per call).
    y = [zero] * m
    for j in range(m - 1, -1, -1):
        acc = g[j]
        for i in range(j + 1, m):
            acc = acc - cols[i][j] * y[i]
        rjj = cols[j][j]
        y[j] = acc / jnp.where(rjj == 0.0, 1.0, rjj)
        y[j] = jnp.where(rjj == 0.0, zero, y[j])
    dx = sum(y[j] * zs[j] for j in range(m))
    x = x + dx
    return x * s, res_hist / norm0, iters


def bcgstab(matvec, precond, b, x0=None, max_iter: int = 5, tol: float = 1e-6):
    """Preconditioned BiCGSTAB (CSysSolve::BCGSTAB_LinSolver)."""
    s = _pow2_scale(b)
    b = b / s
    x = jnp.zeros_like(b) if x0 is None else x0 / s
    r = b - matvec(x)
    r0 = r
    norm0 = jnp.maximum(_norm(b), 1e-300)
    rho = alpha = omega = jnp.asarray(1.0, dtype=b.dtype)
    v = p = jnp.zeros_like(b)

    def body(_, carry):
        x, r, rho, alpha, omega, v, p, done = carry
        rho_new = _dot(r0, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * \
               (alpha / jnp.where(omega == 0, 1.0, omega))
        p = r + beta * (p - omega * v)
        ph = precond(p)
        v = matvec(ph)
        denom = _dot(r0, v)
        alpha_n = rho_new / jnp.where(denom == 0, 1.0, denom)
        s = r - alpha_n * v
        sh = precond(s)
        t = matvec(sh)
        tt = _dot(t, t)
        omega_n = _dot(t, s) / jnp.where(tt == 0, 1.0, tt)
        x_new = x + alpha_n * ph + omega_n * sh
        r_new = s - omega_n * t
        conv = _norm(r_new) / norm0 < tol
        keep = ~done
        return (jnp.where(keep, x_new, x), jnp.where(keep, r_new, r),
                rho_new, alpha_n, omega_n, v, p, done | conv)

    x, r, *_ = jax.lax.fori_loop(
        0, max_iter, body,
        (x, r, rho, alpha, omega, v, p, jnp.asarray(False)))
    return x * s, _norm(r) / norm0, jnp.asarray(max_iter, jnp.int32)


def cg(matvec, precond, b, x0=None, max_iter: int = 5, tol: float = 1e-6):
    """Preconditioned conjugate gradient (CSysSolve::CG_LinSolver) — for SPD
    systems (not the flow Jacobian; provided for capability parity)."""
    s = _pow2_scale(b)
    b = b / s
    x = jnp.zeros_like(b) if x0 is None else x0 / s
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    norm0 = jnp.maximum(_norm(b), 1e-300)

    def body(_, carry):
        x, r, p, rz, done = carry
        ap = matvec(p)
        denom = _dot(p, ap)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        rz_new = _dot(r_new, z_new)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p_new = z_new + beta * p
        conv = _norm(r_new) / norm0 < tol
        keep = ~done
        return (jnp.where(keep, x_new, x), jnp.where(keep, r_new, r),
                jnp.where(keep, p_new, p), jnp.where(keep, rz_new, rz),
                done | conv)

    x, r, *_ = jax.lax.fori_loop(0, max_iter, body,
                                 (x, r, p, rz, jnp.asarray(False)))
    return x * s, _norm(r) / norm0, jnp.asarray(max_iter, jnp.int32)
