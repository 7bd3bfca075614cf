"""Reactive Navier-Stokes solver layer.

Extends the Euler assembly with viscous edge fluxes, viscous BC
contributions, strong no-slip wall conditions and the viscous time step
(reference: CReactiveNSSolver, SU2_CFD/src/solver_direct_reactive.cpp:4131-6354).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.chemistry import library as cl
from su2_tpu.chemistry.library import ChemLib
from su2_tpu.geometry.mesh_data import MeshArrays
from su2_tpu.linalg.blockcsr import BlockJacobian, FamilyJacobian
from su2_tpu.ops import gradients, limiters, viscous
from su2_tpu.ops.viscous import Transport, TurbFlowData
from su2_tpu.solvers import euler as es
from su2_tpu import state as st
from su2_tpu.state import Layout
from su2_tpu.ops import bgather as bg

EPS = 1e-16
K_V = 0.25   # viscous CFL coefficient (SU2 K_v)


@dataclass(frozen=True)
class NSParams(es.EulerParams):
    prandtl_lam: float = 0.72
    prandtl_turb: float = 0.90
    lewis_turb: float = 1.2
    viscous_limiter: bool = False


def _trans_rows(trans: Transport, idx, lib=None, lay=None, v=None):
    """Transport rows at `idx`; when trans.dij is deferred (fused interior
    path — the kernel evaluates D_ij in-kernel), the boundary rows are
    computed here from the gathered T, P instead of a full-mesh tensor."""
    if trans.dij is None:
        vr = bg.rows(v, idx)
        dij = cl.binary_diffusion(lib, vr[:, lay.T],
                                  vr[:, lay.P] / 101325.0) / 1.0e4
        return {"mu": bg.rows(trans.mu, idx),
                "kappa": bg.rows(trans.kappa, idx), "dij": dij}
    return {"mu": trans.mu[idx], "kappa": trans.kappa[idx],
            "dij": trans.dij[idx]}


def _turb_rows(turb: TurbFlowData | None, idx):
    if turb is None:
        return None
    return {"mu_t": turb.mu_t[idx], "tke": turb.tke[idx],
            "grad_tke": turb.grad_tke[idx]}


def _turb_rows_g(turb: TurbFlowData | None, g):
    """_turb_rows with a gather function (family tiles/rolls)."""
    if turb is None:
        return None
    return {"mu_t": g(turb.mu_t), "tke": g(turb.tke),
            "grad_tke": g(turb.grad_tke)}


def _trans_rows_g(trans: Transport, g, lib=None, lay=None, v=None):
    """_trans_rows with a gather function (family tiles/rolls)."""
    if trans.dij is None:
        vr = g(v)
        dij = cl.binary_diffusion(lib, vr[:, lay.T],
                                  vr[:, lay.P] / 101325.0) / 1.0e4
        return {"mu": g(trans.mu), "kappa": g(trans.kappa), "dij": dij}
    return {"mu": g(trans.mu), "kappa": g(trans.kappa), "dij": g(trans.dij)}


def _visc_lam12(prm: NSParams, turb_on: bool, mu, kappa, mut, gam, cv):
    """RANS: lam1 = 4/3 (mu + mu_t), lam2 = (1 + Pr_l/Pr_t mu_t/mu) gamma
    mu/Pr_l; laminar: lam1 = 4/3 mu, lam2 = kappa/Cv with Cv := Cp/gamma (the
    reference's Mean_CV uses Cp/(dPdU[rhoE]+1))."""
    if turb_on:
        lam1 = 4.0 / 3.0 * (mu + mut)
        lam2 = (1.0 + (prm.prandtl_lam / prm.prandtl_turb) * (mut / mu)) \
            * (gam * mu / prm.prandtl_lam)
    else:
        lam1 = 4.0 / 3.0 * mu
        lam2 = kappa / cv
    return lam1 + lam2


def viscous_lambda_boundary(lib: ChemLib, mesh: MeshArrays, lay: Layout,
                            prm: NSParams, v, trans, dpdu_full,
                            turb: TurbFlowData | None, lam):
    """Add boundary-vertex viscous spectral radii to lam (:5188-5214).

    The per-vertex term lam12(node fields) * area^2 / rho has no marker-
    normal dependence, so all markers merge into one static dense area^2
    weight and a single full-mesh elementwise pass (exact: corner vertices
    sum their per-marker area^2 like the reference's marker loop; interior
    vertices carry weight 0) — no gathers or scatters."""
    from su2_tpu.ops.timestep import _static_marker

    gamma = dpdu_full[:, lay.RHOE] + 1.0
    cpg = cl.mixture_cp(lib, v[:, lay.T], v[:, lay.YS:lay.YS + lay.ns]) / gamma
    n = v.shape[0]
    w2_dev = getattr(mesh, "dense_marker_cache", {}).get("_visc_w2")
    if w2_dev is not None:
        # setup-time device buffer (timestep.precompute_dense_markers)
        mut = turb.mu_t if turb is not None else None
        lamf = _visc_lam12(prm, turb is not None, trans.mu, trans.kappa,
                           mut, gamma, cpg) / v[:, lay.PRHO]
        return lam + lamf * w2_dev.astype(v.dtype)
    w2 = None
    for tag, (nodes, normal) in mesh.markers.items():
        stat = _static_marker(nodes, normal)
        if stat is None:
            w2 = None
            break
        sn, nm = stat
        if w2 is None:
            w2 = np.zeros((n,), np.float64)
        np.add.at(w2, sn, np.sum(nm.astype(np.float64) ** 2, axis=1))
    if w2 is not None:
        mut = turb.mu_t if turb is not None else None
        lamf = _visc_lam12(prm, turb is not None, trans.mu, trans.kappa,
                           mut, gamma, cpg) / v[:, lay.PRHO]
        return lam + lamf * jnp.asarray(w2, v.dtype)
    for tag, (nodes, normal) in mesh.markers.items():
        a = jnp.linalg.norm(normal, axis=1)
        mut_b = bg.rows(turb.mu_t, nodes) if turb is not None else None
        lam_b = _visc_lam12(prm, turb is not None, bg.rows(trans.mu, nodes),
                            bg.rows(trans.kappa, nodes), mut_b, bg.rows(gamma, nodes),
                            bg.rows(cpg, nodes)) * a * a / bg.rows(v, nodes)[:, lay.PRHO]
        lam = bg.add_rows(lam, nodes, lam_b)
    return lam


def viscous_lambda(lib: ChemLib, mesh: MeshArrays, lay: Layout, prm: NSParams,
                   v, trans, dpdu_full, turb: TurbFlowData | None):
    """Accumulated viscous spectral radius (SetTime_Step NS branch,
    solver_direct_reactive.cpp:5132-5152)."""
    gamma = dpdu_full[:, lay.RHOE] + 1.0
    cpg = cl.mixture_cp(lib, v[:, lay.T], v[:, lay.YS:lay.YS + lay.ns]) / gamma

    if mesh.fam_offsets is not None:
        # family rolls (see timestep.max_lambda_inv): node-local means with
        # static per-offset area^2, accumulated to both endpoints
        rho = v[:, lay.PRHO]
        lam = jnp.zeros_like(rho)
        for k, o in enumerate(mesh.fam_offsets):
            area2 = jnp.sum(mesh.fam_normal[k] ** 2, axis=1)
            mean = lambda x: 0.5 * (x + jnp.roll(x, -o, axis=0))
            mut = mean(turb.mu_t) if turb is not None else None
            lam_e = _visc_lam12(prm, turb is not None, mean(trans.mu),
                                mean(trans.kappa), mut, gamma,
                                mean(cpg)) * area2 / mean(rho)
            lam = lam + lam_e + jnp.roll(lam_e, o, axis=0)
        return viscous_lambda_boundary(lib, mesh, lay, prm, v, trans,
                                       dpdu_full, turb, lam)

    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    mean_rho = 0.5 * (v[i, lay.PRHO] + v[j, lay.PRHO])
    mean_mu = 0.5 * (trans.mu[i] + trans.mu[j])
    mean_k = 0.5 * (trans.kappa[i] + trans.kappa[j])
    mean_cv = 0.5 * (cpg[i] + cpg[j])
    mean_mut = 0.5 * (turb.mu_t[i] + turb.mu_t[j]) if turb is not None else None
    # the reference's RANS branch uses gamma at node i only (:5138)
    lam_e = _visc_lam12(prm, turb is not None, mean_mu, mean_k, mean_mut,
                        gamma[i], mean_cv) * mesh.edge_area ** 2 / mean_rho
    lam = mesh.sum_edges_abs(lam_e)
    return viscous_lambda_boundary(lib, mesh, lay, prm, v, trans, dpdu_full,
                                   turb, lam)


def ns_assemble(lib: ChemLib, lay: Layout, mesh: MeshArrays, prm: NSParams,
                bcs, v, dt=None, implicit=False,
                turb: TurbFlowData | None = None, omega_turb=None,
                sigma_k_edge=None, nsd=None, want_bc_states=False,
                dense_bc=None):
    """Full NS residual (and Jacobian when implicit): convective + viscous +
    BC + chemistry source + strong wall treatment.

    nsd: optional st.NodeState from the node-state pass — reuses its
    dP/dU, dT/dU, mu/kappa and mole fractions instead of recomputing.

    want_bc_states: additionally return the weak-BC ghost-state batch
    (es.flux_bc_batch tuple, or None) so the turbulence system can consume
    the flow-phase ghost states — the reference's CharacPrimVar handoff
    (flow BCs store them, turb BCs read them:
    solver_direct_turbulent.cpp:3293,3381)."""
    n = v.shape[0]
    nd, ns_ = lay.ndim, lay.ns

    # gradients of the NS variable set [T, u.., P, X..]
    q = viscous.ns_gradient_vars(lib, lay, v,
                                 xs=None if nsd is None else nsd.xs)
    grad = es.compute_gradients(mesh, prm, q)
    if prm.use_limiter:
        qlim = es.gradient_vars(lay, v)
        glim = grad[:, :2 + nd, :]
        if prm.limiter_kind == "BARTH_JESPERSEN":
            lim = limiters.barth_jespersen(mesh, qlim, glim)
        else:
            lim = limiters.venkatakrishnan(
                mesh, qlim, glim, prm.limiter_coeff, prm.ref_elem_length)
    else:
        lim = jnp.ones((n, 2 + nd), dtype=v.dtype)

    if nsd is None:
        dpdu_full = st.dpdu(lib, lay, v)
        dtdu_full = st.dtdu(lib, lay, v)
        trans = viscous.node_transport(lib, lay, v)
    else:
        dpdu_full = nsd.dpdu
        dtdu_full = nsd.dtdu
        trans = viscous.Transport(
            mu=nsd.mu, kappa=nsd.kappa,
            dij=cl.binary_diffusion(
                lib, v[:, lay.T], v[:, lay.P] / 101325.0) / 1.0e4)
    turb_ke = turb.tke if turb is not None else None

    # --- interior edges: convective + viscous (+ Jacobians if implicit) ---
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    # family-major implicit assembly: the off-diagonal Jacobian blocks
    # land directly in the static-stencil layout (blockcsr.
    # FamilyJacobian), skipping the edge gathers and the
    # gather_offdiag relayout copies that dominated the implicit step
    fam_imp = (implicit and mesh.fam_offsets is not None
               and mesh.stencil_sel is not None
               and prm.conv_method == "AUSM")
    # sharded explicit assembly: per-family rolls instead of edge
    # gathers, so GSPMD partitions every neighbor access into a
    # collective-permute slab exchange (dynamic gathers would force
    # full-field all-gathers on every device)
    fam_exp = (not implicit and mesh.fam_offsets is not None
               and mesh.stencil_sel is not None and mesh.n_shards > 1
               and prm.conv_method == "AUSM")
    grad_euler = grad[:, :2 + nd, :]
    if fam_imp:
        gi, gj = mesh.fam_gather_i, mesh.fam_gather_j
        cres, diag, off_ij, off_ji = es.convective_system_fam(
            lib, lay, mesh, prm, v, grad_euler, lim, dpdu_full)
        res = cres
        valid = mesh.fam_valid_flat
        kh = len(mesh.fam_offsets)
        sk_fam = gi(turb.sigma_k) if turb is not None else None
        vf_args = dict(
            coord_i=gi(mesh.coords), coord_j=gj(mesh.coords),
            corrected=True,
            turb_i=_turb_rows_g(turb, gi), turb_j=_turb_rows_g(turb, gj),
            sigma_k=sk_fam, prandtl_turb=prm.prandtl_turb,
            lewis_turb=prm.lewis_turb)
        vflux, vjac_i, vjac_j = viscous.viscous_flux(
            lib, lay, gi(v), gj(v), gi(grad), gj(grad),
            mesh.fam_normal_flat,
            _trans_rows_g(trans, gi, lib, lay, v),
            _trans_rows_g(trans, gj, lib, lay, v),
            s_i=gi(dtdu_full), s_j=gj(dtdu_full), **vf_args)
        vflux = jnp.where(valid[:, None], vflux, 0.0)
        vjac_i = jnp.where(valid[:, None, None], vjac_i, 0.0)
        vjac_j = jnp.where(valid[:, None, None], vjac_j, 0.0)
        diag = diag + mesh.fam_accum(-vjac_i, vjac_j)
        off_ij = off_ij - vjac_j
        off_ji = off_ji + vjac_i
        res = res - mesh.fam_scatter(vflux)
    elif fam_exp:
        diag = off_ij = off_ji = None
        res = jnp.zeros((n, lay.nvar), dtype=v.dtype)
        q = es.gradient_vars(lay, v)
        iden = lambda x: x
        for fk, o in enumerate(mesh.fam_offsets):
            rollj = lambda x, o=o: jnp.roll(x, -o, axis=0)
            nm_k = mesh.fam_normal[fk]
            ev_k = mesh.fam_evec[fk]
            valid_k = jnp.any(nm_k != 0.0, axis=-1)
            if prm.muscl:
                v_i = es._muscl_rows(
                    lib, lay, prm, v, q, grad_euler,
                    lim if prm.use_limiter else None, 0.5 * ev_k)
                v_j = es._muscl_rows(
                    lib, lay, prm, rollj(v), rollj(q), rollj(grad_euler),
                    rollj(lim) if prm.use_limiter else None, -0.5 * ev_k)
            else:
                v_i, v_j = v, rollj(v)
            cf = es.ausm.ausm_flux(lay, v_i, v_j, nm_k, prm.m_infty)
            cf = jnp.where(valid_k[:, None], cf, 0.0)
            vf = viscous.viscous_flux(
                lib, lay, v, rollj(v), grad, rollj(grad), nm_k,
                _trans_rows_g(trans, iden, lib, lay, v),
                _trans_rows_g(trans, rollj, lib, lay, v),
                coord_i=mesh.coords, coord_j=rollj(mesh.coords),
                corrected=True,
                turb_i=_turb_rows_g(turb, iden),
                turb_j=_turb_rows_g(turb, rollj),
                sigma_k=(turb.sigma_k if turb is not None else None),
                prandtl_turb=prm.prandtl_turb,
                lewis_turb=prm.lewis_turb)
            vf = jnp.where(valid_k[:, None], vf, 0.0)
            flux = cf - vf
            res = res + flux - jnp.roll(flux, o, axis=0)
    else:
        if implicit:
            cres, jac = es.convective_system(
                lib, lay, mesh, prm, v, grad_euler, lim, dpdu_full)
            diag, off_ij, off_ji = jac.diag, jac.off_ij, jac.off_ji
        else:
            cres = es.convective_residual(
                lib, lay, mesh, prm, v, grad_euler, lim)
            diag = off_ij = off_ji = None
        res = cres

        vf_args = dict(
            coord_i=mesh.coords[i], coord_j=mesh.coords[j], corrected=True,
            turb_i=_turb_rows(turb, i), turb_j=_turb_rows(turb, j),
            sigma_k=sigma_k_edge, prandtl_turb=prm.prandtl_turb,
            lewis_turb=prm.lewis_turb)
        if implicit:
            vflux, vjac_i, vjac_j = viscous.viscous_flux(
                lib, lay, v[i], v[j], grad[i], grad[j], mesh.edge_normal,
                _trans_rows(trans, i), _trans_rows(trans, j),
                s_i=dtdu_full[i], s_j=dtdu_full[j], **vf_args)
            diag = diag + mesh.accumulate_sides(-vjac_i, vjac_j)
            off_ij = off_ij - vjac_j
            off_ji = off_ji + vjac_i
        else:
            vflux = viscous.viscous_flux(
                lib, lay, v[i], v[j], grad[i], grad[j], mesh.edge_normal,
                _trans_rows(trans, i), _trans_rows(trans, j), **vf_args)
        res = res - mesh.scatter_edges(vflux)

    # --- flux BCs: convective + viscous contributions.  Sharded runs use
    # the dense masked passes of solvers/bc_dense.py (zero marker-scale
    # collectives under GSPMD); single-device runs keep the batched
    # gather path (es.flux_bc_batch). ---
    if dense_bc is not None:
        from su2_tpu.solvers import bc_dense as bcd

        ghost_layers = bcd.flux_ghost_layers(lib, lay, dense_bc, v,
                                             dpdu_full, prm.tke_inf)
        fb = ("dense", ghost_layers)
        if trans.dij is not None:
            dij_full = trans.dij
        else:
            dij_full = cl.binary_diffusion(
                lib, v[:, lay.T], v[:, lay.P] / 101325.0) / 1.0e4
        tr_n = {"mu": trans.mu, "kappa": trans.kappa, "dij": dij_full}
        tu_n = (None if turb is None else
                {"mu_t": turb.mu_t, "tke": turb.tke,
                 "grad_tke": turb.grad_tke})
        for layer, v_ghost, gamma, vel2, imposed in ghost_layers:
            m = layer.any_mask
            normal = layer.normal
            bargs = dict(coord_i=mesh.coords, coord_j=layer.coord_nn,
                         corrected=False, turb_i=tu_n, turb_j=tu_n,
                         sigma_k=(turb.sigma_k if turb is not None else None),
                         prandtl_turb=prm.prandtl_turb,
                         lewis_turb=prm.lewis_turb)
            if implicit:
                s_ghost = es.ghost_dpdu(lib, lay, v_ghost, gamma, vel2)
                cf, cj_i, _ = es.ausm.ausm_flux(
                    lay, v, v_ghost, -normal, prm.m_infty, dpdu_full,
                    s_ghost)
                vf, vj_i, _ = viscous.viscous_flux(
                    lib, lay, v, v_ghost, grad, grad, -normal, tr_n, tr_n,
                    s_i=dtdu_full, s_j=dtdu_full, **bargs)
                diag = diag + jnp.where(m[:, None, None], cj_i - vj_i, 0.0)
            else:
                cf = es.ausm.ausm_flux(lay, v, v_ghost, -normal,
                                       prm.m_infty)
                vf = viscous.viscous_flux(
                    lib, lay, v, v_ghost, grad, grad, -normal, tr_n, tr_n,
                    **bargs)
            res = res + jnp.where(m[:, None], cf - vf, 0.0)
    else:
        fb = es.flux_bc_batch(lib, lay, bcs, v, dpdu_full, prm.tke_inf,
                              mesh.coords)
    if dense_bc is None and fb is not None:
        nodes, nn, normal, v_ghost, gamma, vel2 = fb
        if implicit:
            s_ghost = es.ghost_dpdu(lib, lay, v_ghost, gamma, vel2)
            cf, cj_i, _ = es.ausm.ausm_flux(
                lay, bg.rows(v, nodes), v_ghost, -normal, prm.m_infty,
                bg.rows(dpdu_full, nodes), s_ghost)
        else:
            cf = es.ausm.ausm_flux(lay, bg.rows(v, nodes), v_ghost, -normal,
                                   prm.m_infty)
        # viscous contribution: domain/ghost states, node-i gradients both
        # sides, boundary (uncorrected) variant, subtracted
        bargs = dict(
            coord_i=bg.rows(mesh.coords, nodes),
            coord_j=bg.rows(mesh.coords, nn),
            corrected=False,
            turb_i=_turb_rows(turb, nodes), turb_j=_turb_rows(turb, nodes),
            sigma_k=(bg.rows(turb.sigma_k, nodes)
                     if turb is not None else None),
            prandtl_turb=prm.prandtl_turb, lewis_turb=prm.lewis_turb)
        tr_n = _trans_rows(trans, nodes, lib, lay, v)
        g_n = bg.rows(grad, nodes)
        if implicit:
            vf, vj_i, _ = viscous.viscous_flux(
                lib, lay, bg.rows(v, nodes), v_ghost, g_n, g_n,
                -normal, tr_n, tr_n,
                s_i=bg.rows(dtdu_full, nodes),
                s_j=bg.rows(dtdu_full, nodes), **bargs)
            diag = bg.add_rows(diag, nodes, cj_i - vj_i)
        else:
            vf = viscous.viscous_flux(
                lib, lay, bg.rows(v, nodes), v_ghost, g_n, g_n,
                -normal, tr_n, tr_n, **bargs)
        res = bg.add_rows(res, nodes, cf - vf)

    # --- characteristic (Riemann) markers: convective contribution only
    # (the reference adds a visc_numerics term too; far-field-like
    # characteristic markers sit in near-inviscid flow, so the viscous
    # face term is omitted here — documented deviation) ---
    if dense_bc is None:
        for bc in bcs:
            if bc.kind == "riemann":
                from su2_tpu.solvers import riemann as rie
                rn, rflux, rjac = rie.riemann_flux(
                    lib, lay, bc, v, dpdu_full, prm.tparams, prm.tke_inf)
                res = bg.add_rows(res, rn, rflux)
                if implicit:
                    diag = bg.add_rows(diag, rn, rjac)
    elif any(bc.kind == "riemann" for bc in bcs):
        raise NotImplementedError(
            "MARKER_RIEMANN on sharded (dense-BC) runs: no dense masked "
            "pass yet — run single-device or use the standard BC pair")

    # --- euler (slip) walls ---
    if dense_bc is not None:
        arange_n = np.arange(n)
        for el in dense_bc.euler_layers:
            r = es.euler_wall_residual(lib, lay, arange_n, el.normal, v,
                                       turb_ke)
            res = res + jnp.where(el.mask[:, None], r, 0.0)
            if implicit:
                jw = es.euler_wall_jacobian(lib, lay, arange_n, el.normal,
                                            v, dpdu_full)
                diag = diag + jnp.where(el.mask[:, None, None], jw, 0.0)
    else:
        wb = es.wall_bc_batch(bcs, kinds=("euler_wall",))
        if wb is not None:
            wn, wnorm = wb
            r = es.euler_wall_residual(lib, lay, wn, wnorm, v, turb_ke)
            res = bg.add_rows(res, wn, r)
            if implicit:
                diag = bg.add_rows(diag, wn,
                    es.euler_wall_jacobian(lib, lay, wn, wnorm, v, dpdu_full))

    # --- chemistry source ---
    if prm.reactive_sources:
        if implicit:
            sres, sdiag = es.chemistry_source_system(
                lib, lay, mesh, prm, v, dtdu_full, omega_turb)
            diag = diag + sdiag
        else:
            sres = es.chemistry_source_residual(lib, lay, mesh, prm, v, omega_turb)
        res = res + sres

    # --- axisymmetric / gravity point sources ---
    if prm.axisymmetric or prm.gravity:
        if implicit:
            bres, bsdiag = es.body_source_system(lay, mesh, prm, v,
                                                 dpdu_full)
            if bsdiag is not None:
                diag = diag + bsdiag
        else:
            bres = es.body_source_residual(lay, mesh, prm, v)
        res = res + bres

    # --- strong no-slip walls (isothermal / heatflux) ---
    if dense_bc is not None:
        # dense per marker: the nn access is a stencil roll
        # (collective-permute under GSPMD), everything else elementwise
        wall_mask = dense_bc.wall_mask
        for we in dense_bc.walls:
            if we.kind == "heatflux_wall":
                res = res.at[:, lay.RHOE].add(
                    jnp.where(we.mask, -we.qwall * we.area, 0.0))
                continue
            tj = jnp.roll(v[:, lay.T], -we.offset, axis=0)
            ktr = trans.kappa
            dtdn = (we.twall - tj) / we.dnn
            evisc = ktr * dtdn * we.area
            turb_ktr = jnp.zeros_like(evisc)
            if turb is not None:
                cp_s = cl.species_cp(lib, jnp.full_like(we.area, we.twall))
                rho_s = v[:, lay.PRHO, None] * v[:, lay.YS:lay.YS + ns_]
                coef = (turb.mu_t / prm.prandtl_turb)[:, None] * cp_s * rho_s
                evisc = evisc + coef.sum(-1) * dtdn * we.area
                turb_ktr = coef.sum(-1)
            res = res.at[:, lay.RHOE].add(jnp.where(we.mask, -evisc, 0.0))
            if implicit:
                dtdu_nn = jnp.roll(dtdu_full, -we.offset, axis=0)
                c = ktr / we.dnn * we.area
                jrow = jnp.zeros((n, lay.nvar), dtype=v.dtype)
                jrow = jrow.at[:, lay.RHO].set(c * dtdu_nn[:, lay.RHO])
                jrow = jrow.at[:, lay.RHOE].set(
                    c * dtdu_nn[:, lay.RHOE]
                    + turb_ktr / we.dnn * we.area * dtdu_nn[:, lay.RHOE])
                sl = jnp.arange(ns_)
                jrow = jrow.at[:, lay.RHOS + sl].set(
                    c[:, None] * dtdu_nn[:, lay.RHOS + sl])
                diag = diag.at[:, lay.RHOE, :].add(
                    jnp.where(we.mask[:, None], jrow, 0.0))
        bcs = ()                 # gather wall loop below skipped
    else:
        wall_mask = jnp.zeros(n, dtype=bool)
    for bc in bcs:
        if bc.kind not in ("isothermal_wall", "heatflux_wall"):
            continue
        nodes = bc.nodes
        area = jnp.linalg.norm(bc.normal, axis=1)
        wall_mask = bg.set_rows(wall_mask, nodes, True)
        if bc.kind == "isothermal_wall":
            twall = bc.params["twall"]
            tj = bg.rows(v, bc.nn)[:, lay.T]
            dij = jnp.linalg.norm(
                bg.rows(mesh.coords, bc.nn) - bg.rows(mesh.coords, nodes), axis=1)
            ktr = bg.rows(trans.kappa, nodes)
            dtdn = (twall - tj) / dij
            evisc = ktr * dtdn * area
            turb_ktr = jnp.zeros_like(evisc)
            if turb is not None:
                # ALTERNATIVE closure in the reference (:5516-5541):
                # sum_s mu_t/Pr_t Cp_s rho_s (Twall - Tj)/dij
                cp_s = cl.species_cp(lib, jnp.full_like(area, twall))
                rho_s = bg.rows(v, nodes)[:, lay.PRHO, None] * bg.rows(v, nodes)[:, lay.YS:lay.YS + ns_]
                coef = (bg.rows(turb.mu_t, nodes) / prm.prandtl_turb)[:, None] * cp_s * rho_s
                evisc = evisc + coef.sum(-1) * dtdn * area
                turb_ktr = coef.sum(-1)
            upd = jnp.zeros((nodes.shape[0], lay.nvar),
                            dtype=res.dtype).at[:, lay.RHOE].set(-evisc)
            res = bg.add_rows(res, nodes, upd)
            if implicit:
                # Jacobian energy row (SubtractBlock of -ktr*dTdU/dij*Area)
                dtdu_nn = bg.rows(dtdu_full, bc.nn)
                jrow = jnp.zeros((nodes.shape[0], lay.nvar), dtype=v.dtype)
                c = (ktr / dij * area)
                jrow = jrow.at[:, lay.RHO].set(c * dtdu_nn[:, lay.RHO])
                jrow = jrow.at[:, lay.RHOE].set(
                    c * dtdu_nn[:, lay.RHOE]
                    + turb_ktr / dij * area * dtdu_nn[:, lay.RHOE])
                sl = jnp.arange(ns_)
                jrow = jrow.at[:, lay.RHOS + sl].set(
                    c[:, None] * dtdu_nn[:, lay.RHOS + sl])
                dupd = jnp.zeros((nodes.shape[0], lay.nvar, lay.nvar),
                                 dtype=diag.dtype).at[:, lay.RHOE, :].set(jrow)
                diag = bg.add_rows(diag, nodes, dupd)
        else:
            qwall = bc.params["qwall"]
            upd = jnp.zeros((nodes.shape[0], lay.nvar),
                            dtype=res.dtype).at[:, lay.RHOE].set(-qwall * area)
            res = bg.add_rows(res, nodes, upd)

    # zero momentum residual rows at strong walls
    res = jnp.where(wall_mask[:, None],
                    res.at[:, lay.RHOVX:lay.RHOVX + nd].set(0.0), res)
    if mesh.pg_src is not None:
        # rotational-periodic ghost rows carry no equations
        res = res.at[mesh.pg_start:].set(0.0)

    if not implicit:
        if want_bc_states:
            return res, wall_mask, trans, grad, fb
        return res, wall_mask, trans, grad

    # momentum rows of wall nodes -> identity (DeleteValsRowi)
    mom_rows = jnp.zeros(lay.nvar, dtype=bool).at[
        lay.RHOVX:lay.RHOVX + nd].set(True)
    row_is_wall_mom = wall_mask[:, None] & mom_rows[None, :]      # (nP, nvar)
    eye = jnp.eye(lay.nvar, dtype=v.dtype)
    diag = jnp.where(row_is_wall_mom[:, :, None], eye[None], diag)
    # off-diagonal blocks: zero wall momentum rows
    if fam_imp:
        iw = mesh.fam_gather_i(wall_mask)
        jw = mesh.fam_gather_j(wall_mask)
    else:
        iw = wall_mask[mesh.edges[:, 0]]
        jw = wall_mask[mesh.edges[:, 1]]
    off_ij = jnp.where((iw[:, None] & mom_rows[None, :])[:, :, None],
                       0.0, off_ij)
    off_ji = jnp.where((jw[:, None] & mom_rows[None, :])[:, :, None],
                       0.0, off_ji)

    # time diagonal
    ok = dt > EPS
    delta = jnp.where(ok, mesh.volume / jnp.where(ok, dt, 1.0), 0.0)
    diag = diag + delta[:, None, None] * eye
    diag = jnp.where(ok[:, None, None], diag, eye[None])
    res = jnp.where(ok[:, None], res, 0.0)
    cls = FamilyJacobian if fam_imp else BlockJacobian
    jac = cls(diag=diag, off_ij=off_ij, off_ji=off_ji)
    if want_bc_states:
        return res, wall_mask, trans, grad, jac, fb
    return res, wall_mask, trans, grad, jac


def add_dual_time(lay: Layout, mesh: MeshArrays, res, jac, u, u_n, u_nm1,
                  dt_phys: float, order: int):
    """Dual-time source (SetResidual_DualTime, solver_direct_reactive.cpp
    :2172): BDF1/BDF2 physical-time derivative added to the pseudo-steady
    residual, plus the matching diagonal for the implicit solve."""
    vol = mesh.volume[:, None]
    if order == 1:
        src = vol * (u - u_n) / dt_phys
        diag_coef = mesh.volume / dt_phys
    else:
        src = vol * (3.0 * u - 4.0 * u_n + u_nm1) / (2.0 * dt_phys)
        diag_coef = 1.5 * mesh.volume / dt_phys
    res = res + src
    if jac is not None:
        eye = jnp.eye(lay.nvar, dtype=u.dtype)
        jac = replace(jac, diag=jac.diag + diag_coef[:, None, None] * eye)
    return res, jac


def enforce_wall_velocity(lay: Layout, u, wall_mask):
    """Strong no-slip: zero momentum at wall nodes (SetVelocity_Old(0))."""
    mom = u[:, lay.RHOVX:lay.RHOVX + lay.ndim]
    return u.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(
        jnp.where(wall_mask[:, None], 0.0, mom))
