"""Menter SST k-omega turbulence model.

Batched re-implementation of CTurbSSTSolver / CTurbSSTVariable and the SST
numerics (reference: SU2_CFD/src/solver_direct_turbulent.cpp:2700-3454,
numerics_direct_turbulent.cpp:865-1006 and :1183-1257,
variable_direct_turbulent.cpp:178-204), including the MANGOTURB coupling
conventions: density is read from the reactive primitive layout, mu/mu_t come
from the flow solver, and the blended sigma_k is exported to the mean-flow
viscous closure.

State: q = (k, omega) PRIMITIVE per node (the update is conservative:
k_new = (rho_old k_old + d(rho k))/rho_new, AddConservativeSolution).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.geometry.mesh_data import MeshArrays
from su2_tpu.linalg import blockcsr, krylov
from su2_tpu.linalg.blockcsr import BlockJacobian
from su2_tpu.ops import gradients
from su2_tpu.state import Layout
from su2_tpu.ops import bgather as bg

EPS = 1e-16

# constants[0..9] (solver_direct_turbulent.cpp:2716-2725)
SIGMA_K1 = 0.85
SIGMA_K2 = 1.0
SIGMA_OM1 = 0.5
SIGMA_OM2 = 0.856
BETA_1 = 0.075
BETA_2 = 0.0828
BETA_STAR = 0.09
A1 = 0.31
# float() keeps these WEAK-typed python scalars: np.sqrt returns a strong
# np.float64 that would promote the f32 source assembly to f64 under the
# x64 validation tier (a scan-carry dtype mismatch — caught by
# test_mesh_args)
ALFA_1 = float(BETA_1 / BETA_STAR - SIGMA_OM1 * 0.41 ** 2
               / np.sqrt(BETA_STAR))
ALFA_2 = float(BETA_2 / BETA_STAR - SIGMA_OM2 * 0.41 ** 2
               / np.sqrt(BETA_STAR))

LOWER = np.array([1.0e-10, 1.0e-4])
UPPER = np.array([1.0e10, 1.0e15])


def freestream(cfg, rho_inf, vel_inf, mu_inf):
    """kine/omega/muT freestream (:2751-2755)."""
    vel_mag2 = float(np.dot(vel_inf, vel_inf))
    intensity = cfg.freestream_turbulenceintensity
    visc_ratio = cfg.freestream_turb2lamviscratio
    kine = 1.5 * vel_mag2 * intensity ** 2
    omega = rho_inf * kine / (mu_inf * visc_ratio)
    mu_t = rho_inf * kine / omega
    return kine, omega, mu_t


def strain_and_vorticity(lay: Layout, grad: jnp.ndarray):
    """StrainMag and vorticity magnitude from the velocity gradient rows of
    the NS gradient set (rows 1..nd) (SetStrainMag/SetVorticity,
    variable_direct_reactive.cpp:1038-1095)."""
    g = grad[:, 1:1 + lay.ndim, :]           # (N, comp, dim)
    nd = g.shape[1]
    div = jnp.einsum("ndd->n", g)
    diag = sum((g[:, d, d] - div / 3.0) ** 2 for d in range(nd))
    off = sum(2.0 * (0.5 * (g[:, a, b] + g[:, b, a])) ** 2
              for a in range(nd) for b in range(a + 1, nd))
    strain = jnp.sqrt(jnp.maximum(2.0 * (diag + off), 1e-60))
    if nd == 2:
        vort = jnp.abs(g[:, 1, 0] - g[:, 0, 1])
    else:
        wx = g[:, 2, 1] - g[:, 1, 2]
        wy = g[:, 0, 2] - g[:, 2, 0]
        wz = g[:, 1, 0] - g[:, 0, 1]
        vort = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    return strain, vort


def blending(k, w, grad_k, grad_w, mu, rho, dist):
    """F1, F2, CDkw (SetBlendingFunc, variable_direct_turbulent.cpp:178-204)."""
    cdkw = 2.0 * rho * SIGMA_OM2 / w * jnp.einsum("nd,nd->n", grad_k, grad_w)
    cdkw = jnp.maximum(cdkw, 1e-20)
    # max floor 1e-30 (not 0): d sqrt/dk at k == 0 is inf, and wall rows
    # carry k == 0 exactly — the floored branch has zero derivative, so
    # the coupled adjoint stays finite; forward value is unchanged to
    # rounding (sqrt(1e-30) vs 0 against the ~1e29 wall denominators)
    arg2a = jnp.sqrt(jnp.maximum(k, 1e-30)) / (BETA_STAR * w * dist + EPS * EPS)
    arg2b = 500.0 * mu / (rho * dist * dist * w + EPS * EPS)
    arg2 = jnp.maximum(arg2a, arg2b)
    arg1 = jnp.minimum(arg2, 4.0 * rho * SIGMA_OM2 * k
                       / (cdkw * dist * dist + EPS * EPS))
    # clamp the tanh argument at ~20 (bit-exact: tanh rounds to 1.0 past
    # x ~ 19 in f64): the wall rows' arg ~ 1/EPS^2 would otherwise
    # overflow f32 in the ** 4
    f1 = jnp.tanh(jnp.minimum(arg1, 2.2) ** 4)
    f2 = jnp.tanh(jnp.minimum(jnp.maximum(2.0 * arg2a, arg2b), 4.5) ** 2)
    return f1, f2, cdkw


def eddy_viscosity(rho, k, w, strain_mag, f2):
    """muT (Postprocessing, solver_direct_turbulent.cpp:2994-3000).
    NOTE: the fork clips muT to [0, 1] (dimensional) — reproduced."""
    zeta = jnp.minimum(1.0 / w, A1 / (strain_mag * f2 + EPS))
    return jnp.clip(rho * k * zeta, 0.0, 1.0)


@dataclass(frozen=True)
class SSTConfig:
    grad_method: str
    cfl_red: float = 1.0
    relax: float = 1.0
    linear_solver: str = "FGMRES"
    linear_iter: int = 5
    linear_tol: float = 1e-6
    linear_prec: str = "JACOBI"
    color_masks: tuple | None = None


# diagnostics: set to a list to capture each sst_step's assembled RHS
# (meaningful for EAGER calls only — under jit the stash holds tracers)
_RHS_STASH = None

def sst_step(lay: Layout, mesh: MeshArrays, scfg: SSTConfig, bcs,
             q, v, flow_grad, mu, mu_t_node, strain_mag, dist,
             rho_old, dt, kine_inf, omega_inf,
             lib=None, dpdu_e=None, tke_inf: float = 0.0, gq=None,
             flow_fb=None, dense_bc=None, gq_prev=None, hb_src=None):
    """One implicit Euler iteration of the SST system.

    q: (N, 2) primitive (k, omega); v: flow primitives; flow_grad: NS
    gradient set; mu: laminar viscosity; mu_t_node: current eddy viscosity;
    rho_old: density used in the conservative update.  gq: optional
    precomputed (k, omega) gradients (the driver rides them in the flow
    gradient sweep when both use the same method).  flow_fb: the flow
    phase's weak-BC ghost-state batch (es.flux_bc_batch tuple) — the
    reference's CharacPrimVar handoff: flow BCs store the ghost states,
    turb BCs read them (solver_direct_turbulent.cpp:3293,3381), so the
    turb system must NOT rebuild them from the updated state.

    gq_prev: the PREVIOUS step's (k, omega) gradients (N, 2, d).  The
    reference's assembly consumes F1/F2/CDkw STORED by the previous
    iteration's Postprocessing (SetBlendingFunc,
    variable_direct_turbulent.cpp:177-201, called at
    solver_direct_turbulent.cpp:2989 with the gradients computed in that
    iteration's turb Preprocessing) — so the blending entering the
    diffusion coefficients and source terms is one gradient-vintage older
    than the q being assembled.  Omit to evaluate blending from this
    step's gradients (standalone use).  Returns (q_new, rms, outs) with
    outs["gq"] = this step's gradients, i.e. next step's gq_prev.
    """
    n = q.shape[0]
    dtype = q.dtype
    rho = v[:, lay.PRHO]
    vel = v[:, lay.VX:lay.VX + lay.ndim]

    # gradients of (k, omega)
    if gq is None:
        if scfg.grad_method == "GREEN_GAUSS":
            gq = gradients.pg_fix(mesh, gradients.green_gauss(mesh, q))
        else:
            gq = gradients.pg_fix(mesh,
                              gradients.weighted_least_squares(mesh, q))
    grad_k = gq[:, 0, :]
    grad_w = gq[:, 1, :]

    # blending entering the assembly: previous-iteration gradient vintage
    # (reference-stored F1/F2/CDkw), this-iteration mu/rho
    bk, bw = (gq_prev[:, 0, :], gq_prev[:, 1, :]) if gq_prev is not None \
        else (grad_k, grad_w)
    f1, f2, cdkw = blending(q[:, 0], q[:, 1], bk, bw, mu, rho, dist)

    sigma_k_blend = f1 * SIGMA_K1 + (1.0 - f1) * SIGMA_K2
    sigma_w_blend = f1 * SIGMA_OM1 + (1.0 - f1) * SIGMA_OM2

    # ---- convective + viscous edges (CUpwSca_TurbSST + CAvgGrad_TurbSST,
    #      uncorrected variant).  All node fields ride in ONE stacked
    #      (nP, K) matrix gathered once per edge side: one multi-column
    #      gather instead of six scalar (nE,) gathers. ----
    d = lay.ndim
    diff_k = mu + sigma_k_blend * mu_t_node
    diff_w = mu + sigma_w_blend * mu_t_node
    eye2 = jnp.eye(2, dtype=dtype)
    fam_off = None
    if mesh.gg_snormal is not None:
        # static-stencil meshes: enumerate per-node edge SIDES by offset.
        # With the signed face mass flux qt = 0.5 (u_p + u_{p+o}) . n_signed
        # both edge sides reduce to the same formulas, so the sweep is K
        # rolls + FMAs (no gather/scatter) and the off-diagonal Jacobian
        # blocks come out directly in the family-major layout the fused
        # stencil solve consumes.  stencil_pvec is the side-invariant
        # (dx . n)/|dx|^2 edge-projection factor.
        rhoq = rho[:, None] * q
        dkw = jnp.stack([diff_k, diff_w], axis=1)                # (nP, 2)
        res = None
        diag_c = None
        offs = []
        for k, o in enumerate(mesh.stencil_offsets):
            ns = mesh.gg_snormal[k]                              # (nP, d)
            pv = mesh.stencil_pvec[k]                            # (nP,)
            qt = 0.5 * jnp.sum((vel + jnp.roll(vel, -o, axis=0)) * ns,
                               axis=1)
            a0p = 0.5 * (qt + jnp.abs(qt))
            a1p = 0.5 * (qt - jnp.abs(qt))
            conv = a0p[:, None] * rhoq + a1p[:, None] \
                * jnp.roll(rhoq, -o, axis=0)
            dm = 0.5 * (dkw + jnp.roll(dkw, -o, axis=0))         # (nP, 2)
            gmean = 0.5 * (gq + jnp.roll(gq, -o, axis=0))        # (nP, 2, d)
            # CORRECTED projected gradient (CAvgGradCorrected_TurbSST,
            # numerics_direct_turbulent.cpp:1183-1257 — the reference uses
            # the corrected kernel on interior turb edges):
            #   g.n - (g.e) pv + (q_j - q_i) pv,  pv = (e.n)/|e|^2
            # wrap rows carry ns = 0 and pv = 0, so they contribute nothing
            evec = jnp.roll(mesh.coords, -o, axis=0) - mesh.coords
            gm_e = jnp.sum(gmean * evec[:, None, :], axis=2)     # (nP, 2)
            dq = jnp.roll(q, -o, axis=0) - q
            vflux = dm * (jnp.sum(gmean * ns[:, None, :], axis=2)
                          + pv[:, None] * (dq - gm_e))
            dvp = dm * (pv / rho)[:, None]
            dvn = dm * (pv / jnp.roll(rho, -o))[:, None]
            part = conv - vflux
            res = part if res is None else res + part
            dpart = a0p[:, None] + dvp
            diag_c = dpart if diag_c is None else diag_c + dpart
            offs.append(a1p[:, None] - dvn)
        fam_off = jnp.stack(offs)                                # (K, nP, 2)
        diag = diag_c[:, :, None] * eye2
    else:
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        feats = jnp.concatenate([
            vel,                                   # [0:d]
            rho[:, None],                          # [d]
            rho[:, None] * q,                      # [d+1 : d+3]
            gq.reshape(q.shape[0], 2 * d),         # [d+3 : 3d+3]
            diff_k[:, None], diff_w[:, None],      # [3d+3], [3d+4]
            mesh.coords,                           # [3d+5 : 4d+5]
        ], axis=1)
        fi, fj = feats[i], feats[j]
        qij = 0.5 * jnp.einsum("ed,ed->e", fi[:, :d] + fj[:, :d],
                               mesh.edge_normal)
        a0 = 0.5 * (qij + jnp.abs(qij))
        a1c = 0.5 * (qij - jnp.abs(qij))
        flux = a0[:, None] * fi[:, d + 1:d + 3] \
            + a1c[:, None] * fj[:, d + 1:d + 3]
        jac_ci = a0[:, None, None] * eye2
        jac_cj = a1c[:, None, None] * eye2

        dk = 0.5 * (fi[:, 3 * d + 3] + fj[:, 3 * d + 3])
        dw = 0.5 * (fi[:, 3 * d + 4] + fj[:, 3 * d + 4])
        gmean = 0.5 * (fi[:, d + 3:3 * d + 3]
                       + fj[:, d + 3:3 * d + 3]).reshape(-1, 2, d)
        evec = fj[:, 3 * d + 5:4 * d + 5] - fi[:, 3 * d + 5:4 * d + 5]
        dist2 = jnp.sum(evec * evec, axis=1)
        pvec = jnp.einsum("ed,ed->e", evec, mesh.edge_normal) / \
            jnp.where(dist2 == 0.0, 1.0, dist2)
        # CORRECTED projected gradient (CAvgGradCorrected_TurbSST,
        # numerics_direct_turbulent.cpp:1183-1257):
        #   g.n - (g.e) pv + (q_j - q_i) pv
        proj = jnp.einsum("egd,ed->eg", gmean, mesh.edge_normal)
        gm_e = jnp.einsum("egd,ed->eg", gmean, evec)
        dq = fj[:, d + 1:d + 3] / fj[:, d:d + 1] \
            - fi[:, d + 1:d + 3] / fi[:, d:d + 1]
        proj = proj + pvec[:, None] * (dq - gm_e)
        vflux = jnp.stack([dk * proj[:, 0], dw * proj[:, 1]], axis=1)
        # one edge scatter for conv - visc
        res = mesh.scatter_edges(flux - vflux)
        dvi = jnp.stack([dk * pvec / fi[:, d], dw * pvec / fi[:, d]], axis=1)
        dvj = jnp.stack([dk * pvec / fj[:, d], dw * pvec / fj[:, d]], axis=1)
        # viscous jacobians: J_i = -diag(dvi), J_j = +diag(dvj); residual is
        # subtracted, so diag gets +diag(dvi) at i etc.
        vji = dvi[:, :, None] * eye2
        vjj = dvj[:, :, None] * eye2
        # one side-accumulation for the convective + viscous diagonal blocks
        acc = mesh.accumulate_sides(
            jnp.concatenate([a0[:, None], dvi], axis=1),
            jnp.concatenate([-a1c[:, None], dvj], axis=1))       # (nP, 3)
        diag = acc[:, 0, None, None] * eye2 + acc[:, 1:, None] * eye2
        off_ij = jac_cj - vjj
        off_ji = -jac_ci - vji

    # ---- source (CSourcePieceWise_TurbSST) ----
    gvel = flow_grad[:, 1:1 + lay.ndim, :]
    diverg = jnp.einsum("ndd->n", gvel)
    k_, w_ = q[:, 0], q[:, 1]
    alfa_b = f1 * ALFA_1 + (1.0 - f1) * ALFA_2
    beta_b = f1 * BETA_1 + (1.0 - f1) * BETA_2
    pk = mu_t_node * strain_mag ** 2 - 2.0 / 3.0 * rho * k_ * diverg
    pk = jnp.clip(pk, 0.0, 20.0 * BETA_STAR * rho * w_ * k_)
    zeta = jnp.maximum(w_, strain_mag * f2 / A1)
    pw = jnp.maximum(strain_mag ** 2 - 2.0 / 3.0 * zeta * diverg, 0.0)
    active = dist > 1e-10
    src_k = jnp.where(active, pk - BETA_STAR * rho * w_ * k_, 0.0)
    src_w = jnp.where(active,
                      alfa_b * rho * pw - beta_b * rho * w_ * w_
                      + (1.0 - f1) * cdkw, 0.0)
    vol = mesh.volume
    res = res - jnp.stack([src_k * vol, src_w * vol], axis=1)
    sj00 = jnp.where(active, -BETA_STAR * w_ * vol, 0.0)
    sj11 = jnp.where(active, -2.0 * beta_b * w_ * vol, 0.0)
    diag = diag.at[:, 0, 0].add(-sj00)
    diag = diag.at[:, 1, 1].add(-sj11)
    if hb_src is not None:
        # harmonic-balance spectral source (N, 2): stored per node like
        # the reference's SetHarmonicBalance_Source and added to the
        # residual times Volume (solver_direct_turbulent.cpp:1590, no
        # Jacobian contribution)
        res = res + hb_src * vol[:, None]

    # ---- boundary conditions ----
    # walls (strong): k=0, w = 60 mu/(rho beta1 d^2) at nearest neighbor dist
    dense_fb = (isinstance(flow_fb, tuple) and len(flow_fb) == 2
                and flow_fb[0] == "dense")
    if dense_bc is not None:
        # sharded runs: dense masked walls (nn access = stencil roll), see
        # solvers/bc_dense.py
        wall_mask = dense_bc.wall_mask
        q_wall = jnp.zeros((n, 2), dtype=dtype)
        for we in dense_bc.walls:
            mu_nn = jnp.roll(mu, -we.offset, axis=0)
            rho_nn = jnp.roll(rho, -we.offset, axis=0)
            w_wall = 60.0 * mu_nn / (rho_nn * BETA_1 * we.dnn * we.dnn)
            q_wall = q_wall.at[:, 1].set(
                jnp.where(we.mask, w_wall, q_wall[:, 1]))
    else:
        wall_mask = jnp.zeros(n, dtype=bool)
        q_wall = jnp.zeros((n, 2), dtype=dtype)
        for bc in bcs:
            nodes = bc.nodes
            if bc.kind in ("isothermal_wall", "heatflux_wall"):
                dnn = jnp.linalg.norm(bg.rows(mesh.coords, bc.nn) - bg.rows(mesh.coords, nodes), axis=1)
                w_wall = 60.0 * bg.rows(mu, bc.nn) / (bg.rows(rho, bc.nn) * BETA_1 * dnn * dnn)
                wall_mask = bg.set_rows(wall_mask, nodes, True)
                q_wall = bg.set_col_rows(q_wall, nodes, 1, w_wall)
    # upwind flux between the domain state and the FLOW ghost state
    # (the reference's turb BCs consume GetCharacPrimVar: BC_Inlet :3264,
    # BC_Outlet :3360); inlets impose (kine_Inf, omega_Inf) on the incoming
    # characteristic, outlets extrapolate.  Per-marker ghost construction,
    # ONE batched flux + scatter over the concatenated marker face set —
    # or, sharded, one dense masked pass per bc_dense flux layer.
    if dense_fb:
        for layer, v_ghost, gamma_g, vel2_g, imposed in flow_fb[1]:
            area_n = -layer.normal
            vel_g = v_ghost[:, lay.VX:lay.VX + lay.ndim]
            rho_g = v_ghost[:, lay.PRHO]
            qb = 0.5 * jnp.sum((vel + vel_g) * area_n, axis=1)
            a0b = 0.5 * (qb + jnp.abs(qb))
            a1b = 0.5 * (qb - jnp.abs(qb))
            q_inf = jnp.stack([jnp.full_like(qb, kine_inf),
                               jnp.full_like(qb, omega_inf)], axis=1)
            qin = jnp.where(imposed[:, None], q_inf, q)
            bflux = a0b[:, None] * rho[:, None] * q \
                + a1b[:, None] * rho_g[:, None] * qin
            m = layer.any_mask
            res = res + jnp.where(m[:, None], bflux, 0.0)
            diag = diag + jnp.where(m[:, None, None],
                                    a0b[:, None, None] * eye2, 0.0)
    else:
        wk = _weak_bc_batch(lay, bcs, q, v, vel, rho, kine_inf, omega_inf,
                            lib, dpdu_e, tke_inf, flow_fb)
        if wk is not None:
            bn, bflux, a0b = wk
            res = bg.add_rows(res, bn, bflux)
            diag = bg.add_rows(diag, bn, a0b[:, None, None] * eye2)

    # strong wall rows
    res = jnp.where(wall_mask[:, None], 0.0, res)
    diag = jnp.where(wall_mask[:, None, None], jnp.eye(2, dtype=dtype)[None],
                     diag)
    if fam_off is None:
        iw = wall_mask[mesh.edges[:, 0]]
        jw = wall_mask[mesh.edges[:, 1]]
        off_ij = jnp.where(iw[:, None, None], 0.0, off_ij)
        off_ji = jnp.where(jw[:, None, None], 0.0, off_ji)
    else:
        fam_off = jnp.where(wall_mask[None, :, None], 0.0, fam_off)

    # ---- implicit solve ----
    ok = dt > EPS
    delta = jnp.where(ok, mesh.volume / (scfg.cfl_red * jnp.where(ok, dt, 1.0)),
                      0.0)
    diag = diag + delta[:, None, None] * eye2
    rhs = -res
    if _RHS_STASH is not None:
        _RHS_STASH.append(rhs)          # diagnostics hook (eager calls)
    if scfg.linear_prec == "LU_SGS_SEQ":
        # reference-exact natural-order sweep via host callback — validation
        # only (linalg/seq_sgs.py; demonstrates the multicolor-SGS parity
        # deviation is purely the sweep ordering)
        from su2_tpu.linalg import seq_sgs
        if fam_off is not None:
            sel = fam_off[:, :, :, None] * eye2
            mv = lambda x: (blockcsr._bmv(diag, x)
                            + blockcsr._offdiag_apply(mesh, sel, x))
            pcf = seq_sgs.fam_preconditioner(mesh, 2)
            pc = lambda r: pcf(diag, sel, r)
        else:
            jac = BlockJacobian(diag=diag, off_ij=off_ij, off_ji=off_ji)
            sel_g = blockcsr.gather_offdiag(mesh, jac)
            mv = lambda x: blockcsr.matvec(mesh, jac, x, sel_g)
            pce = seq_sgs.edge_preconditioner(mesh, 2)
            pc = lambda r: pce(diag, off_ij, off_ji, r)
    elif fam_off is not None:
        # off-diagonal 2x2 blocks are diagonal: (K, nP, 2) -> stencil sel
        mv, pc = blockcsr.make_solver_ops_fam(
            mesh, diag, fam_off[:, :, :, None] * eye2, scfg.linear_prec,
            scfg.color_masks)
    else:
        jac = BlockJacobian(diag=diag, off_ij=off_ij, off_ji=off_ji)
        mv, pc = blockcsr.make_solver_ops(
            mesh, jac, scfg.linear_prec, scfg.color_masks)
    if scfg.linear_solver == "BCGSTAB":
        sol, _, _ = krylov.bcgstab(mv, pc, rhs, max_iter=scfg.linear_iter,
                                   tol=scfg.linear_tol)
    else:
        sol, _, _ = krylov.fgmres(mv, pc, rhs, max_iter=scfg.linear_iter,
                                  tol=scfg.linear_tol)

    # conservative update: q_new = (rho_old q_old + relax*d(rho q))/rho_new
    lower = jnp.asarray(LOWER, dtype=dtype)
    upper = jnp.asarray(UPPER, dtype=dtype)
    q_new = (rho_old[:, None] * q + scfg.relax * sol) / rho[:, None]
    q_new = jnp.clip(q_new, lower, upper)
    # enforce wall values strongly.  The BC stores q_wall into Solution_Old
    # and the conservative update then rescales EVERY row by
    # rho_old/rho_new and clips (AddConservativeSolution,
    # variable_structure.cpp) — so wall omega picks up the density ratio
    # (visible at marker-junction corners where the first flow updates
    # move rho by ~5e-4) and wall k lands on the 1e-10 lower clip, not 0
    q_new = jnp.where(
        wall_mask[:, None],
        jnp.clip(q_wall * (rho_old / rho)[:, None], lower, upper), q_new)

    rms = jnp.sqrt(jnp.mean(rhs * rhs, axis=0))

    # outputs for the mean-flow coupling (Postprocessing: blending stored
    # from THIS step's gradients + the updated q — next step's assembly
    # consumes it via gq_prev)
    f1n, f2n, cdkwn = blending(q_new[:, 0], q_new[:, 1], grad_k, grad_w,
                               mu, rho, dist)
    mu_t_new = eddy_viscosity(rho, q_new[:, 0], q_new[:, 1], strain_mag, f2n)
    outs = dict(f1=f1n, f2=f2n, cdkw=cdkwn, mu_t=mu_t_new,
                sigma_k=f1n * SIGMA_K1 + (1.0 - f1n) * SIGMA_K2,
                grad_k=grad_k, grad_w=grad_w, gq=gq)
    return q_new, rms, outs


def _weak_bc_batch(lay, bcs, q, v, vel, rho, kine_inf, omega_inf,
                   lib, dpdu_e, tke_inf, flow_fb):
    """Concatenated weak-BC face batch: (bn, bflux (nb, 2), a0b (nb,)) or
    None (see sst_step's BC comment — the reference's CharacPrimVar
    handoff)."""
    from su2_tpu.solvers import euler as es
    _SST_BC_KINDS = ("inlet", "supersonic_inlet", "outlet",
                     "supersonic_outlet", "far_field")
    # static row offsets of each weak marker inside the flow-phase
    # ghost-state batch (flux_bc_batch concatenates in bcs order, walls
    # skipped)
    fb_pos = {}
    if flow_fb is not None:
        pos = 0
        for k, bc in enumerate(bcs):
            if bc.kind in ("euler_wall", "isothermal_wall", "heatflux_wall"):
                continue
            fb_pos[k] = pos
            pos += int(np.asarray(bc.nodes).shape[0])
    bn_l, bnorm_l, velg_l, rhog_l, imp_l = [], [], [], [], []
    for k, bc in enumerate(bcs):
        if bc.kind not in _SST_BC_KINDS:
            continue
        nodes = bc.nodes
        nv = int(np.asarray(nodes).shape[0])
        if flow_fb is not None:
            v_ghost = jax.lax.slice_in_dim(flow_fb[3], fb_pos[k],
                                           fb_pos[k] + nv, axis=0)
            vel_g = v_ghost[:, lay.VX:lay.VX + lay.ndim]
            rho_g = v_ghost[:, lay.PRHO]
        elif lib is not None and bc.kind == "inlet":
            v_ghost, _, _ = es.inlet_state(lib, lay, bc, v, dpdu_e, tke_inf)
            vel_g = v_ghost[:, lay.VX:lay.VX + lay.ndim]
            rho_g = v_ghost[:, lay.PRHO]
        elif lib is not None and bc.kind == "outlet":
            v_ghost, _, _, _ = es.outlet_state(lib, lay, bc, v, dpdu_e,
                                               tke_inf)
            vel_g = v_ghost[:, lay.VX:lay.VX + lay.ndim]
            rho_g = v_ghost[:, lay.PRHO]
        elif lib is not None and bc.kind == "supersonic_inlet":
            v_ghost, _, _ = es.supersonic_inlet_state(lib, lay, bc, v,
                                                      tke_inf)
            vel_g = v_ghost[:, lay.VX:lay.VX + lay.ndim]
            rho_g = v_ghost[:, lay.PRHO]
        else:
            vel_g = bg.rows(vel, nodes)
            rho_g = bg.rows(rho, nodes)
        bn_l.append(np.asarray(nodes))
        bnorm_l.append(bc.normal)
        velg_l.append(vel_g)
        rhog_l.append(rho_g)
        imp_l.append(np.full(nv, bc.kind in ("inlet", "supersonic_inlet",
                                             "far_field")))
    if not bn_l:
        return None
    bn = np.concatenate(bn_l)
    area_n = -jnp.concatenate(bnorm_l, axis=0)
    vel_g = jnp.concatenate(velg_l, axis=0)
    rho_g = jnp.concatenate(rhog_l)
    imposed = jnp.asarray(np.concatenate(imp_l))
    qb = 0.5 * jnp.einsum("ed,ed->e", bg.rows(vel, bn) + vel_g, area_n)
    a0b = 0.5 * (qb + jnp.abs(qb))
    a1b = 0.5 * (qb - jnp.abs(qb))
    q_inf = jnp.stack([jnp.full_like(qb, kine_inf),
                       jnp.full_like(qb, omega_inf)], axis=1)
    qin = jnp.where(imposed[:, None], q_inf, bg.rows(q, bn))
    bflux = a0b[:, None] * bg.rows(rho, bn)[:, None] * bg.rows(q, bn) \
        + a1b[:, None] * rho_g[:, None] * qin
    return bn, bflux, a0b


def wall_distance(coords: np.ndarray, wall_points: np.ndarray) -> np.ndarray:
    """Distance of every node to the nearest no-slip wall vertex
    (SU2 ComputeWall_Distance equivalent, point-based), by a k-d tree
    query: O(N log W) on the host instead of the O(N W) pairwise scan."""
    from scipy.spatial import cKDTree

    if wall_points.shape[0] == 0:
        return np.full(coords.shape[0], 1e10)
    dist, _ = cKDTree(wall_points).query(coords, k=1)
    return np.asarray(dist, dtype=np.float64)
