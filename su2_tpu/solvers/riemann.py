"""Characteristic (Riemann) boundary conditions.

Reference: CEulerSolver::BC_Riemann (SU2_CFD/src/solver_direct_mean.cpp:
10550-10998).  The reference builds an exterior state u_e from the marker
data, computes the eigenvector matrices P / P^-1 of the normal flux
Jacobian at the interior state, selects the incoming characteristics
(lambda < 0) and forms

    u_b = u_i + P 1_{lambda<0} P^-1 (u_e - u_i),

then evaluates the plain projected inviscid flux at u_b
(GetInviscidProjFlux) and, implicitly, dF(u_b)/du_b * DubDu.

Design: batched over the marker's faces with the projection
written in the closed characteristic-jump form (no eigenvector matrices):

    dp   = dP/dU . du                     (exact pressure jump row)
    dv   = (dm - vel drho)/rho,  dvn = dv.n,  dvt = dv - dvn n
    a+-  = (dp +- rho a dvn)/(2 a^2)      (acoustic amplitudes)
    a0   = drho - dp/a^2                  (entropy amplitude)

    u_b = u_i + [un<0]   (a0 [1, vel, |vel|^2/2] + rho [0, dvt, vel.dvt])
              + [un+a<0]  a+ [1, vel + a n, H + a un]
              + [un-a<0]  a-  [1, vel - a n, H - a un]

which equals the P 1 P^-1 product for the (effective-gamma) normal
Jacobian.  Species densities ride the convective characteristic:
Y_b = Y_e where un < 0 else Y_i, rho_s,b = Y_b rho_b (exactly the
single-species behavior when ns = 1, the reference's only use).  The
boundary thermodynamic state is then recovered with the full
secant/bisection Cons2Prim (SetTDState_rhoe equivalent) and the residual
is the projected flux at u_b.  The implicit contribution uses the
closed-form effective-gamma pressure (AD-friendly; the reference's
Jacobian is likewise approximate)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu import state as st
from su2_tpu.chemistry import library as cl
from su2_tpu.chemistry.spline import spline_eval
from su2_tpu.ops import bgather as bg


def species_entropy(lib, t):
    """(..., S) specific entropies s_s(T) [J/(kg K)] from the thermo-table
    splines (same tables ComputeKeq reads, reacting_model_library.cpp:810)."""
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.s_y, lib.s_y2, t) / lib.mm


def mixture_entropy(lib, t, ys, p):
    """Ideal-mixture specific entropy s(T, P) = sum Y_s s_s(T) - R ln P
    (pressure datum cancels between the total-state evaluation and the
    h-s inversion, so P rides in Pa with datum 1)."""
    ysc = cl.clip_mass_fractions(ys)
    s0 = jnp.einsum("...s,...s->...", ysc, species_entropy(lib, t))
    return s0 - cl.mixture_rgas(lib, ysc) * jnp.log(p)


def _t_from_h(lib, ys, h_target, t0, n_iter: int = 12):
    """Newton solve h(T) = h_target (batched); cp = dh/dT."""
    t = t0
    for _ in range(n_iter):
        f = cl.mixture_enthalpy(lib, t, ys) - h_target
        t = t - f / cl.mixture_cp(lib, t, ys)
        t = jnp.clip(t, lib.t0 + 1.0, lib.t0 + lib.dt * (lib.nt - 2))
    return t


def _t_from_hs(lib, ys, h_stat, s_target, t0, n_iter: int = 20):
    """Invert (h, s) -> (T, P): T from h, then P from the entropy datum
    (FluidModel::SetTDState_hs equivalent for the spline library)."""
    t = _t_from_h(lib, ys, h_stat, t0)
    rgas = cl.mixture_rgas(lib, cl.clip_mass_fractions(ys))
    s0 = jnp.einsum("...s,...s->...", cl.clip_mass_fractions(ys),
                    species_entropy(lib, t))
    p = jnp.exp((s0 - s_target) / rgas)
    return t, p


def exterior_state(lib, lay, bc, v_rows, unit, tke_inf):
    """(rho_e, vel_e, energy_e, ys_e) from the marker's Riemann data kind
    and the interior rows (BC_Riemann's switch, :10653-10830)."""
    kind = bc.params["riemann_kind"]
    v1 = bc.params["v1"]
    v2 = bc.params["v2"]
    fdir = bc.params["flow_dir"]
    ys = jnp.broadcast_to(bc.params["ys"], (v_rows.shape[0], lay.ns))
    nd = lay.ndim
    vel_i = v_rows[:, lay.VX:lay.VX + nd]
    ones = jnp.ones(v_rows.shape[0], v_rows.dtype)

    if kind == "TOTAL_CONDITIONS_PT":
        p_tot = v1 * ones
        t_tot = v2 * ones
        h_tot = cl.mixture_enthalpy(lib, t_tot, ys)
        s_tot = mixture_entropy(lib, t_tot, ys, p_tot)
        vel2 = jnp.sum(vel_i * vel_i, axis=1)
        vmag = jnp.sqrt(vel2)
        if nd == 2:
            # the reference's 2D normal/tangential convention (:10678)
            vn = -vmag * fdir[0]
            vt = -vmag * fdir[1]
            vel_e = jnp.stack([unit[:, 0] * vn - unit[:, 1] * vt,
                               unit[:, 1] * vn + unit[:, 0] * vt], axis=1)
        else:
            vel_e = vmag[:, None] * jnp.broadcast_to(fdir[:nd],
                                                     (vmag.shape[0], nd))
        h_stat = h_tot - 0.5 * vel2
        t_e, p_e = _t_from_hs(lib, ys, h_stat, s_tot, v_rows[:, lay.T])
        rgas = cl.mixture_rgas(lib, ys)
        rho_e = p_e / (rgas * t_e)
        e_stat = h_stat - p_e / rho_e
        energy_e = e_stat + 0.5 * vel2 + tke_inf
        return rho_e, vel_e, energy_e, ys

    if kind in ("STATIC_SUPERSONIC_INFLOW_PT", "STATIC_SUPERSONIC_INFLOW_PD"):
        p_st = v1 * ones
        if kind.endswith("PT"):
            t_st = v2 * ones
            rgas = cl.mixture_rgas(lib, ys)
            rho_e = p_st / (rgas * t_st)
        else:
            rho_e = v2 * ones
            rgas = cl.mixture_rgas(lib, ys)
            t_st = p_st / (rgas * rho_e)
        _, a_e = cl.frozen_gamma_sound(lib, t_st, ys)
        mach = jnp.asarray(fdir[:nd], v_rows.dtype)
        vel_e = a_e[:, None] * jnp.broadcast_to(mach, (a_e.shape[0], nd))
        vel2 = jnp.sum(vel_e * vel_e, axis=1)
        e_stat = cl.mixture_enthalpy(lib, t_st, ys) - p_st / rho_e
        energy_e = e_stat + 0.5 * vel2 + tke_inf
        return rho_e, vel_e, energy_e, ys

    if kind == "DENSITY_VELOCITY":
        rho_e = v1 * ones
        vel_e = v2 * jnp.broadcast_to(jnp.asarray(fdir[:nd], v_rows.dtype),
                                      (v_rows.shape[0], nd))
        # Energy extrapolated from the interior (:10795)
        rho_i = v_rows[:, lay.PRHO]
        energy_i = v_rows[:, lay.H] - v_rows[:, lay.P] / rho_i
        return rho_e, vel_e, energy_i, ys

    if kind == "STATIC_PRESSURE":
        p_e = v1 * ones
        rho_i = v_rows[:, lay.PRHO]
        rho_e = rho_i
        vel_e = vel_i
        vel2 = jnp.sum(vel_e * vel_e, axis=1)
        # SetTDState_Prho: T from (P, rho), energy from T
        rgas = cl.mixture_rgas(lib, ys)
        t_e = p_e / (rgas * rho_e)
        e_stat = cl.mixture_enthalpy(lib, t_e, ys) - p_e / rho_e
        return rho_e, vel_e, e_stat + 0.5 * vel2, ys

    raise NotImplementedError(f"Riemann data kind {kind}")


def _char_state(lay, v_rows, dpdu_rows, rho_e, vel_e, energy_e, ys_e, unit):
    """u_b core + species via the closed characteristic projection."""
    nd = lay.ndim
    rho_i = v_rows[:, lay.PRHO]
    vel_i = v_rows[:, lay.VX:lay.VX + nd]
    p_i = v_rows[:, lay.P]
    a_i = v_rows[:, lay.A]
    h_i = v_rows[:, lay.H]                      # total enthalpy
    ys_i = v_rows[:, lay.YS:lay.YS + lay.ns]
    rhoe_i = rho_i * h_i - p_i
    un = jnp.sum(vel_i * unit, axis=1)

    drho = rho_e - rho_i
    dm = rho_e[:, None] * vel_e - rho_i[:, None] * vel_i
    de = rho_e * energy_e - rhoe_i
    # exact pressure jump row: dP/dU . du (core part; species columns act
    # through Y_e below)
    gm1 = dpdu_rows[:, lay.RHOE]
    vel2_i = jnp.sum(vel_i * vel_i, axis=1)
    dp = gm1 * (de - jnp.sum(vel_i * dm, axis=1) + 0.5 * vel2_i * drho)
    dv = (dm - vel_i * drho[:, None]) / rho_i[:, None]
    dvn = jnp.sum(dv * unit, axis=1)
    dvt = dv - dvn[:, None] * unit
    a2 = a_i * a_i
    al_p = (dp + rho_i * a_i * dvn) / (2.0 * a2)
    al_m = (dp - rho_i * a_i * dvn) / (2.0 * a2)
    al_0 = drho - dp / a2

    sel0 = (un < 0.0).astype(v_rows.dtype)
    selp = (un + a_i < 0.0).astype(v_rows.dtype)
    selm = (un - a_i < 0.0).astype(v_rows.dtype)

    drho_b = sel0 * al_0 + selp * al_p + selm * al_m
    dm_b = sel0[:, None] * (al_0[:, None] * vel_i + rho_i[:, None] * dvt) \
        + selp[:, None] * al_p[:, None] * (vel_i + a_i[:, None] * unit) \
        + selm[:, None] * al_m[:, None] * (vel_i - a_i[:, None] * unit)
    de_b = sel0 * (al_0 * 0.5 * vel2_i
                   + rho_i * jnp.sum(vel_i * dvt, axis=1)) \
        + selp * al_p * (h_i + a_i * un) \
        + selm * al_m * (h_i - a_i * un)

    rho_b = rho_i + drho_b
    mom_b = rho_i[:, None] * vel_i + dm_b
    rhoe_b = rhoe_i + de_b
    ys_b = jnp.where((un < 0.0)[:, None], ys_e, ys_i)
    return rho_b, mom_b, rhoe_b, ys_b


def _proj_flux(lay, rho, vel, p, rhoe, rho_s, normal):
    """Projected inviscid flux over `normal` (GetInviscidProjFlux)."""
    qn = jnp.einsum("bd,bd->b", vel, normal)
    nvar = lay.nvar
    out = jnp.zeros((rho.shape[0], nvar), rho.dtype)
    out = out.at[:, lay.RHO].set(rho * qn)
    out = out.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(
        rho[:, None] * vel * qn[:, None] + p[:, None] * normal)
    out = out.at[:, lay.RHOE].set((rhoe + p) * qn)
    out = out.at[:, lay.RHOS:lay.RHOS + lay.ns].set(rho_s * qn[:, None])
    return out


def riemann_flux(lib, lay, bc, v, dpdu_full, tparams, tke_inf):
    """(nodes, flux, jac_diag) for one Riemann marker: characteristic
    boundary state + projected flux; jac via forward AD of the closed-form
    (effective-gamma pressure) flux w.r.t. the interior conserved rows."""
    nodes = bc.nodes
    nd = lay.ndim
    area = jnp.linalg.norm(bc.normal, axis=1)
    normal = -bc.normal                       # outward (reference :10612)
    unit = normal / area[:, None]
    v_rows = bg.rows(v, nodes)
    dpdu_rows = bg.rows(dpdu_full, nodes)
    rho_e, vel_e, energy_e, ys_e = exterior_state(lib, lay, bc, v_rows,
                                                  unit, tke_inf)
    rho_b, mom_b, rhoe_b, ys_b = _char_state(
        lay, v_rows, dpdu_rows, rho_e, vel_e, energy_e, ys_e, unit)

    # full thermodynamic recovery at u_b (SetTDState_rhoe): secant/
    # bisection Cons2Prim on the assembled conserved rows
    u_b = jnp.concatenate([
        rho_b[:, None], mom_b, rhoe_b[:, None],
        rho_b[:, None] * ys_b], axis=1)
    _, v_b, _ = st.cons2prim(lib, lay, u_b, v_rows[:, lay.T], tparams)
    vel_b = v_b[:, lay.VX:lay.VX + nd]
    flux = _proj_flux(lay, v_b[:, lay.PRHO], vel_b, v_b[:, lay.P],
                      rhoe_b, u_b[:, lay.RHOS:lay.RHOS + lay.ns], normal)

    # implicit: AD through the gamma-closed-form variant (exact wrt its
    # own construction; the reference's P/invP product is likewise an
    # approximation of the exact linearization)
    gm1 = dpdu_rows[:, lay.RHOE]

    # freeze the exterior state for the Jacobian (the reference's DubDu
    # treats u_e as data)
    rho_e_sg = jax.lax.stop_gradient(rho_e)
    vel_e_sg = jax.lax.stop_gradient(vel_e)
    energy_e_sg = jax.lax.stop_gradient(energy_e)
    ys_e_sg = jax.lax.stop_gradient(ys_e)
    u_i = jnp.concatenate([
        v_rows[:, lay.PRHO][:, None],
        v_rows[:, lay.PRHO][:, None] * v_rows[:, lay.VX:lay.VX + nd],
        (v_rows[:, lay.PRHO] * v_rows[:, lay.H] - v_rows[:, lay.P])[:, None],
        v_rows[:, lay.PRHO][:, None] * v_rows[:, lay.YS:lay.YS + lay.ns]],
        axis=1)

    def one_jac(u_row, dpdu_row, nrm, unt, gm1_row, re, ve, ee, ye):
        return jax.jacfwd(lambda u_r: _flux_row_closed(
            lib, lay, u_r, dpdu_row, nrm, unt, gm1_row, re, ve, ee,
            ye))(u_row)

    jac = jax.vmap(one_jac)(u_i, dpdu_rows, normal, unit, gm1,
                            rho_e_sg, vel_e_sg, energy_e_sg, ys_e_sg)
    return nodes, flux, jac


def _flux_row_closed(lib, lay, u_row, dpdu_row, nrm, unt, gm1_row,
                     rho_e, vel_e, energy_e, ys_e):
    """Single-face closed-form boundary flux (effective-gamma pressure) —
    the AD target for the implicit Jacobian."""
    nd = lay.ndim
    rho_i = u_row[lay.RHO]
    vel_i = u_row[lay.RHOVX:lay.RHOVX + nd] / rho_i
    rhoe_i = u_row[lay.RHOE]
    ys_i = u_row[lay.RHOS:lay.RHOS + lay.ns] / rho_i
    vel2 = jnp.sum(vel_i * vel_i)
    p_i = gm1_row * (rhoe_i - 0.5 * rho_i * vel2)
    a2 = jnp.maximum((gm1_row + 1.0) * p_i / rho_i, 1e-12)
    a_i = jnp.sqrt(a2)
    h_i = (rhoe_i + p_i) / rho_i
    t_i = jnp.asarray(300.0, u_row.dtype)      # unused by _char_state
    vr = jnp.concatenate([
        t_i[None], vel_i, p_i[None], rho_i[None], h_i[None], a_i[None],
        ys_i])[None]
    rb, mb, eb, yb = _char_state(
        lay, vr, dpdu_row[None], rho_e[None], vel_e[None], energy_e[None],
        ys_e[None], unt[None])
    rb, mb, eb, yb = rb[0], mb[0], eb[0], yb[0]
    velb = mb / rb
    pb = gm1_row * (eb - 0.5 * rb * jnp.sum(velb * velb))
    qn = jnp.sum(velb * nrm)
    out = jnp.zeros((lay.nvar,), u_row.dtype)
    out = out.at[lay.RHO].set(rb * qn)
    out = out.at[lay.RHOVX:lay.RHOVX + nd].set(rb * velb * qn + pb * nrm)
    out = out.at[lay.RHOE].set((eb + pb) * qn)
    out = out.at[lay.RHOS:lay.RHOS + lay.ns].set(rb * yb * qn)
    return out
