"""Multispecies AUSM+-up convective flux with approximate Jacobians.

Vectorized re-implementation of CUpwReactiveAUSM::ComputeResidual
(reference: SU2_CFD/src/numerics_direct_reactive.cpp:53-383) over all edges at
once.  The upwinded vector Phi carries [1, u_dim..., H_tot, Y_s...]; the mass
flux is M12 = a_mean (mLF rho_i + mRF rho_j) with the AUSM+-up pressure- and
velocity-diffusion corrections (Kp=0.25, sigma=1, Ku=0.75, beta=1/8).

Jacobians take dP/dU vectors (``s_i``/``s_j``, the reference's Secondary) and
reproduce the reference's hand-written approximate derivatives.
"""

from __future__ import annotations

import jax.numpy as jnp

from su2_tpu.state import Layout

EPS = 1e-16
KP = 0.25
SIGMA = 1.0
KU = 0.75
BETA = 0.125



def _cat_nonempty(parts, axis):
    # Mosaic rejects zero-size vector slices; drop empty pieces
    return jnp.concatenate([p for p in parts if p.shape[axis] > 0], axis=axis)


def _set_cols(x, start, vals):
    """x[:, start:start+w] = vals via concatenate (a fusible elementwise
    form instead of a scatter)."""
    w = 1 if vals.ndim == 1 else vals.shape[1]
    v2 = vals[:, None] if vals.ndim == 1 else vals
    return _cat_nonempty([x[:, :start], v2, x[:, start + w:]], 1)


def _add_cols(x, start, vals):
    w = 1 if vals.ndim == 1 else vals.shape[1]
    v2 = vals[:, None] if vals.ndim == 1 else vals
    return _cat_nonempty(
        [x[:, :start], x[:, start:start + w] + v2, x[:, start + w:]], 1)


def _add_rows3(x, start, vals):
    """x[:, start:start+w, :] += vals for (nE, nvar, nvar) blocks."""
    w = 1 if vals.ndim == 2 else vals.shape[1]
    v3 = vals[:, None, :] if vals.ndim == 2 else vals
    return _cat_nonempty(
        [x[:, :start, :], x[:, start:start + w, :] + v3, x[:, start + w:, :]],
        1)


def _split_mach(m):
    """Split Mach polynomials (beta=1/8) and pressure polynomials (alpha set
    by caller). Returns (mP, mM) without pressure polys."""
    sub = jnp.abs(m) < 1.0
    m_p = jnp.where(sub, 0.25 * (m + 1.0) ** 2 + BETA * (m * m - 1.0) ** 2,
                    0.5 * (m + jnp.abs(m)))
    m_m = jnp.where(sub, -0.25 * (m - 1.0) ** 2 - BETA * (m * m - 1.0) ** 2,
                    0.5 * (m - jnp.abs(m)))
    return m_p, m_m


def _press_polys(m, alpha):
    sub = jnp.abs(m) < 1.0
    safe_m = jnp.where(m == 0.0, 1.0, m)
    p_p = jnp.where(sub, 0.25 * (m + 1.0) ** 2 * (2.0 - m)
                    + alpha * m * (m * m - 1.0) ** 2,
                    0.5 * (1.0 + jnp.abs(m) / safe_m))
    p_m = jnp.where(sub, 0.25 * (m - 1.0) ** 2 * (2.0 + m)
                    - alpha * m * (m * m - 1.0) ** 2,
                    0.5 * (1.0 - jnp.abs(m) / safe_m))
    return p_p, p_m


def ausm_flux(lay: Layout, v_i: jnp.ndarray, v_j: jnp.ndarray,
              normal: jnp.ndarray, m_infty: float,
              s_i: jnp.ndarray | None = None, s_j: jnp.ndarray | None = None):
    """AUSM+-up flux over a batch of faces.

    v_i, v_j: (nE, nPrim) primitives; normal: (nE, d) area normals.
    s_i, s_j: (nE, nVar) dP/dU vectors — if given, Jacobians are returned.
    Returns residual (nE, nVar) [, jac_i, jac_j each (nE, nVar, nVar)].
    """
    nd = lay.ndim
    ns = lay.ns
    nvar = lay.nvar
    # sqrt/div guards: family-padded slots carry zero normals; their rows
    # are masked downstream, but 0/0 NaNs here poison the REVERSE pass of
    # the masked rows (d(x/y) cotangents divide by y) — the adjoint
    # differentiates through this kernel
    area2 = jnp.sum(normal * normal, axis=-1)
    area = jnp.sqrt(jnp.maximum(area2, 1e-60))
    unit = normal / area[:, None]

    rho_i = v_i[:, lay.PRHO]
    rho_j = v_j[:, lay.PRHO]
    p_i = v_i[:, lay.P]
    p_j = v_j[:, lay.P]
    h_i = v_i[:, lay.H]
    h_j = v_j[:, lay.H]
    a_i = v_i[:, lay.A]
    a_j = v_j[:, lay.A]
    vel_i = v_i[:, lay.VX:lay.VX + nd]
    vel_j = v_j[:, lay.VX:lay.VX + nd]

    proj_i = jnp.sum(vel_i * unit, axis=-1)
    proj_j = jnp.sum(vel_j * unit, axis=-1)

    a_mean = 0.5 * (a_i + a_j)
    m_l = proj_i / a_mean
    m_r = proj_j / a_mean

    m_f2 = 0.5 * (m_l * m_l + m_r * m_r)
    m_ref2 = jnp.minimum(1.0, jnp.maximum(m_f2, m_infty * m_infty))
    # sqrt'(0) = inf: wall-wall edges carry m_f2 == 0 exactly and the
    # masked rows must stay NaN-free in the REVERSE pass (adjoint)
    m_f = jnp.sqrt(jnp.maximum(m_f2, 1e-60))
    m_ref = jnp.sqrt(m_ref2)

    fa = m_ref * (2.0 - m_ref)
    alpha = 3.0 / 16.0 * (5.0 * fa * fa - 4.0)

    m_lp, _ = _split_mach(m_l)
    _, m_rm = _split_mach(m_r)
    p_lp, _ = _press_polys(m_l, alpha)
    _, p_rm = _press_polys(m_r, alpha)

    rho_mean = 0.5 * (rho_i + rho_j)
    factor = jnp.maximum(1.0 - SIGMA * m_f2, 0.0)
    m12 = m_lp + m_rm - KP / fa * factor * (p_j - p_i) / (rho_mean * a_mean * a_mean)
    m_lf = 0.5 * (m12 + jnp.abs(m12))
    m_rf = 0.5 * (m12 - jnp.abs(m12))
    mass12 = a_mean * (m_lf * rho_i + m_rf * rho_j)          # M12

    # Phi = [1, u..., H, Y...]
    phi_i = jnp.concatenate(
        [jnp.ones_like(rho_i)[:, None], vel_i, h_i[:, None],
         v_i[:, lay.YS:lay.YS + ns]], axis=1)                 # (nE, nVar)
    phi_j = jnp.concatenate(
        [jnp.ones_like(rho_j)[:, None], vel_j, h_j[:, None],
         v_j[:, lay.YS:lay.YS + ns]], axis=1)

    res = 0.5 * (mass12[:, None] * (phi_i + phi_j)
                 + jnp.abs(mass12)[:, None] * (phi_i - phi_j)) * area[:, None]

    p_lf = p_lp * p_i + p_rm * p_j \
        - KU * p_lp * p_rm * (rho_i + rho_j) * fa * a_mean * (proj_j - proj_i)
    res = _add_cols(res, lay.RHOVX, (p_lf * area)[:, None] * unit)

    if s_i is None:
        return res

    # ------------------------------------------------------------ Jacobians
    # Mach number derivatives w.r.t. conserved variables
    zer = jnp.zeros((v_i.shape[0], nvar), dtype=v_i.dtype)
    mld = _set_cols(zer, lay.RHO, -m_l / rho_i)
    mld = _set_cols(mld, lay.RHOVX, unit / (rho_i * a_mean)[:, None])
    mrd = _set_cols(zer, lay.RHO, -m_r / rho_j)
    mrd = _set_cols(mrd, lay.RHOVX, unit / (rho_j * a_mean)[:, None])

    sub_l = (jnp.abs(m_l) < 1.0)[:, None]
    sub_r = (jnp.abs(m_r) < 1.0)[:, None]
    safe_ml = jnp.where(m_l == 0.0, 1.0, m_l)
    safe_mr = jnp.where(m_r == 0.0, 1.0, m_r)
    mpol_ld = jnp.where(
        sub_l, mld * (0.5 * (m_l + 1.0) + 4.0 * BETA * m_l * (m_l * m_l - 1.0))[:, None],
        mld * (0.5 * (1.0 + jnp.abs(m_l) / safe_ml))[:, None])
    mpol_rd = jnp.where(
        sub_r, mrd * (0.5 * (1.0 - m_r) + 4.0 * BETA * m_r * (1.0 - m_r * m_r))[:, None],
        mrd * (0.5 * (1.0 - jnp.abs(m_r) / safe_mr))[:, None])

    # scaling-factor (fa) derivatives: nonzero only when mF2 == mRef2
    at_ref = (m_f2 == m_ref2)[:, None]
    safe_mf = jnp.where(m_f <= 1e-30, 1.0, m_f)
    scal_ld = jnp.where(at_ref, mld * (m_l * (1.0 - m_f) / safe_mf)[:, None], 0.0)
    scal_rd = jnp.where(at_ref, mrd * (m_r * (1.0 - m_f) / safe_mf)[:, None], 0.0)

    # convective extra-term (pressure diffusion) derivatives
    fpos = (factor > 0.0).astype(v_i.dtype)
    c0 = KP / (a_mean * a_mean * fa * fa * rho_mean * rho_mean)
    mext_ld = -c0[:, None] * (
        (fpos * SIGMA * m_l * (p_j - p_i) * fa * rho_mean)[:, None] * mld
        + (factor * fa * rho_mean)[:, None] * s_i
        + (factor * (p_j - p_i) * rho_mean)[:, None] * scal_ld)
    mext_rd = c0[:, None] * (
        (fpos * SIGMA * m_r * (p_i - p_j) * fa * rho_mean)[:, None] * mrd
        + (factor * fa * rho_mean)[:, None] * s_j
        - (factor * (p_j - p_i) * rho_mean)[:, None] * scal_rd)
    c1 = KP / (a_mean * a_mean * fa * rho_mean * rho_mean) * 0.5 * factor * (p_j - p_i)
    mext_ld = _add_cols(mext_ld, lay.RHO, -c1)
    mext_rd = _add_cols(mext_rd, lay.RHO, -c1)

    sign_m12 = jnp.where(m12 == 0.0, 0.0, jnp.abs(m12) / jnp.where(m12 == 0.0, 1.0, m12))
    sp = (1.0 + sign_m12)[:, None]
    sm = (1.0 - sign_m12)[:, None]
    mass_p_ld = 0.5 * (mpol_ld - mext_ld) * sp
    mass_m_ld = 0.5 * (mpol_ld - mext_ld) * sm
    mass_p_rd = 0.5 * (mpol_rd - mext_rd) * sp
    mass_m_rd = 0.5 * (mpol_rd - mext_rd) * sm

    # convective part
    jac_i = a_mean[:, None, None] * (
        (rho_i[:, None] * phi_i)[:, :, None] * mass_p_ld[:, None, :]
        + (rho_j[:, None] * phi_j)[:, :, None] * mass_m_ld[:, None, :])
    jac_j = a_mean[:, None, None] * (
        (rho_i[:, None] * phi_i)[:, :, None] * mass_p_rd[:, None, :]
        + (rho_j[:, None] * phi_j)[:, :, None] * mass_m_rd[:, None, :])

    eye = jnp.eye(nvar, dtype=v_i.dtype)
    jac_i = jac_i + (a_mean * m_lf)[:, None, None] * eye
    jac_j = jac_j + (a_mean * m_rf)[:, None, None] * eye

    # pressure contribution to the energy row
    jac_i = _add_rows3(jac_i, lay.RHOE, (a_mean * m_lf)[:, None] * s_i)
    jac_j = _add_rows3(jac_j, lay.RHOE, (a_mean * m_rf)[:, None] * s_j)

    # pressure polynomial derivatives
    ppol_ld = jnp.where(
        sub_l,
        (0.25 * (m_l + 1.0) * (3.0 * (1.0 - m_l)
         + 4.0 * alpha * (5.0 * m_l * m_l - 1.0) * (m_l - 1.0)))[:, None] * mld
        + (15.0 / 8.0 * m_l * (m_l * m_l - 1.0) ** 2)[:, None] * scal_ld,
        jnp.zeros_like(mld))
    ppol_rd = jnp.where(
        sub_r,
        (0.25 * (m_r - 1.0) * (3.0 * (1.0 + m_r)
         + 4.0 * alpha * (1.0 - 5.0 * m_r * m_r) * (m_r + 1.0)))[:, None] * mrd
        - (15.0 / 8.0 * m_r * (m_r * m_r - 1.0) ** 2)[:, None] * scal_rd,
        jnp.zeros_like(mrd))

    # pressure extra-term (velocity diffusion) derivatives
    rho_sum = rho_i + rho_j
    dproj = proj_j - proj_i
    pext_ld = (KU * p_rm * a_mean)[:, None] * (
        (rho_sum * fa * dproj)[:, None] * ppol_ld
        + (p_lp * rho_sum * dproj)[:, None] * scal_ld)
    pext_rd = (KU * p_lp * a_mean)[:, None] * (
        (rho_sum * fa * dproj)[:, None] * ppol_rd
        + (p_rm * rho_sum * dproj)[:, None] * scal_rd)
    pext_ld = _add_cols(
        pext_ld, lay.RHO,
        KU * p_rm * a_mean * p_lp * fa * (dproj + rho_sum * proj_i / rho_i))
    pext_rd = _add_cols(
        pext_rd, lay.RHO,
        KU * p_lp * a_mean * p_rm * fa * (dproj - rho_sum * proj_j / rho_j))
    pext_ld = _add_cols(
        pext_ld, lay.RHOVX,
        -(KU * p_rm * a_mean * p_lp * fa * rho_sum / rho_i)[:, None] * unit)
    pext_rd = _add_cols(
        pext_rd, lay.RHOVX,
        (KU * p_lp * a_mean * p_rm * fa * rho_sum / rho_j)[:, None] * unit)

    press_ld = p_lp[:, None] * s_i + p_i[:, None] * ppol_ld - pext_ld
    press_rd = p_rm[:, None] * s_j + p_j[:, None] * ppol_rd - pext_rd

    jac_i = _add_rows3(jac_i, lay.RHOVX,
                       unit[:, :, None] * press_ld[:, None, :])
    jac_j = _add_rows3(jac_j, lay.RHOVX,
                       unit[:, :, None] * press_rd[:, None, :])

    jac_i = jac_i * area[:, None, None]
    jac_j = jac_j * area[:, None, None]
    return res, jac_i, jac_j
