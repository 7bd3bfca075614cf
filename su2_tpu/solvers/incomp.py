"""Incompressible Euler / Navier-Stokes (artificial compressibility).

Reference capability: the INCOMPRESSIBLE regime of CEulerSolver/CNSSolver
(SU2_CFD/src/solver_direct_mean.cpp incompressible branches; numerics
GetInviscidArtCompProjFlux/Jac, numerics_structure.cpp:818-930;
CCentLaxArtComp_Flow / CUpwRoeArtComp_Flow).

State U = [P, rho0 u, rho0 v(, rho0 w)]; constant density rho0; artificial
sound speed a = sqrt(q_n^2 + betainc2 Area^2).  Convective scheme: central
flux with scalar (Rusanov/Lax) dissipation scaled by the ArtComp spectral
radius; exact ArtComp Jacobians for the implicit solve.  Viscous terms use
the corrected average-gradient stress like the compressible path.

Self-contained IncSimulation driver (the compressible Simulation drives the
reactive machinery; the incompressible state layout is different enough
that sharing would obscure both).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.geometry.dual_grid import build_dual_grid
from su2_tpu.geometry.mesh_data import MeshArrays, mesh_arrays
from su2_tpu.io.mesh import read_su2_mesh
from su2_tpu.linalg import blockcsr, krylov
from su2_tpu.linalg.blockcsr import BlockJacobian


def art_comp_flux(vel_i, vel_j, p_i, p_j, rho0, beta2, normal):
    """Central ArtComp flux + Rusanov dissipation; per-face Jacobians.

    Returns flux (nF, nv), jac_i, jac_j with nv = 1 + ndim.
    """
    nd = vel_i.shape[1]
    nv = 1 + nd
    vel = 0.5 * (vel_i + vel_j)
    p = 0.5 * (p_i + p_j)
    qn = jnp.einsum("fd,fd->f", vel, normal)
    area2 = jnp.einsum("fd,fd->f", normal, normal)

    flux = jnp.zeros((vel.shape[0], nv), dtype=vel.dtype)
    flux = flux.at[:, 0].set(beta2 * qn)
    flux = flux.at[:, 1:].set(rho0 * vel * qn[:, None]
                              + p[:, None] * normal)

    # scalar dissipation with the ArtComp spectral radius
    lam = jnp.abs(qn) + jnp.sqrt(qn * qn + beta2 * area2)
    du = jnp.concatenate([(p_i - p_j)[:, None],
                          rho0 * (vel_i - vel_j)], axis=1)
    flux = flux + 0.5 * lam[:, None] * du

    # exact central Jacobian (GetInviscidArtCompProjJac, scale = 0.5)
    def jac(velk, sgn):
        qk = jnp.einsum("fd,fd->f", velk, normal)
        j = jnp.zeros((vel.shape[0], nv, nv), dtype=vel.dtype)
        j = j.at[:, 0, 1:].set(0.5 * beta2 / rho0 * normal)
        for d in range(nd):
            j = j.at[:, 1 + d, 0].set(0.5 * normal[:, d])
            for e in range(nd):
                j = j.at[:, 1 + d, 1 + e].set(
                    0.5 * (velk[:, d] * normal[:, e]
                           + (qk if d == e else jnp.zeros_like(qk))))
        eye = jnp.eye(nv, dtype=vel.dtype)
        return j + sgn * 0.5 * lam[:, None, None] * eye[None]

    return flux, jac(vel_i, +1.0), jac(vel_j, -1.0)


@dataclass(frozen=True)
class IncBC:
    kind: str            # euler_wall | inlet | outlet | noslip_wall | far
    nodes: jax.Array
    normal: jax.Array
    params: dict


jax.tree_util.register_dataclass(
    IncBC, data_fields=["nodes", "normal", "params"], meta_fields=["kind"])


class IncSimulation:
    """Incompressible zone (REGIME_TYPE= INCOMPRESSIBLE capability)."""

    def __init__(self, cfg, raw_mesh=None, dtype=jnp.float64):
        self.cfg = cfg
        raw = raw_mesh if raw_mesh is not None else read_su2_mesh(
            cfg.resolve(cfg.mesh_filename))
        self.grid = build_dual_grid(raw)
        self.mesh = mesh_arrays(self.grid, dtype)
        self.nd = self.grid.ndim
        self.nv = 1 + self.nd
        self.rho0 = cfg.freestream_density
        self.beta2 = cfg.artcomp_factor
        self.mu = cfg.viscosity_constant
        self.viscous = cfg.viscous or self.mu > 0.0
        f = lambda x: jnp.asarray(x, dtype=dtype)

        bcs = []
        for tag in cfg.marker_euler:
            nodes, normal = self.mesh.markers[tag]
            bcs.append(IncBC("euler_wall", nodes, normal, {}))
        for tag, flux in cfg.marker_heatflux.items():
            nodes, normal = self.mesh.markers[tag]
            bcs.append(IncBC("noslip_wall", nodes, normal, {}))
        for tag, (v1, v2, fdir) in cfg.marker_inlet.items():
            nodes, normal = self.mesh.markers[tag]
            bcs.append(IncBC("inlet", nodes, normal,
                             {"vel": f(v2) * f(fdir[:self.nd])}))
        for tag, pback in cfg.marker_outlet.items():
            nodes, normal = self.mesh.markers[tag]
            bcs.append(IncBC("outlet", nodes, normal, {"p": f(pback)}))
        for tag in cfg.marker_far:
            nodes, normal = self.mesh.markers[tag]
            vel_inf = f(cfg.freestream_velocity[:self.nd])
            bcs.append(IncBC("far", nodes, normal,
                             {"vel": vel_inf, "p": f(0.0)}))
        self.bcs = tuple(bcs)
        self._step = jax.jit(self._make_step())

    # ------------------------------------------------------------------
    def freestream_state(self):
        u = np.zeros((self.mesh.npoint, self.nv))
        vel = np.asarray(self.cfg.freestream_velocity[:self.nd])
        u[:, 1:] = self.rho0 * vel
        return jnp.asarray(u, dtype=self.mesh.volume.dtype)

    def _assemble(self, u):
        mesh, rho0, beta2 = self.mesh, self.rho0, self.beta2
        nd, nv = self.nd, self.nv
        p = u[:, 0]
        vel = u[:, 1:] / rho0
        i, j = mesh.edges[:, 0], mesh.edges[:, 1]
        flux, jac_i, jac_j = art_comp_flux(
            vel[i], vel[j], p[i], p[j], rho0, beta2, mesh.edge_normal)
        res = mesh.scatter_edges(flux)
        diag = mesh.accumulate_sides(jac_i, -jac_j)
        off_ij, off_ji = jac_j, -jac_i

        # viscous stress (constant mu, corrected two-point gradient)
        if self.viscous:
            from su2_tpu.ops import gradients
            gvel = gradients.green_gauss(mesh, vel)           # (nP, nd, nd)
            gmean = 0.5 * (gvel[i] + gvel[j])
            d = mesh.coords[j] - mesh.coords[i]
            dist2 = jnp.maximum(jnp.einsum("ed,ed->e", d, d), 1e-300)
            # corrected normal gradient
            dvel = (vel[j] - vel[i])
            gcorr = gmean + (dvel - jnp.einsum("eij,ej->ei", gmean, d)
                             )[:, :, None] * (d / dist2[:, None])[:, None, :]
            tau = self.mu * (gcorr + jnp.swapaxes(gcorr, 1, 2))
            vflux = jnp.einsum("eij,ej->ei", tau, mesh.edge_normal)
            res = res.at[:, 1:].add(-mesh.scatter_edges(vflux))
            # Jacobian: mu |n|^2/dist / rho0 on the velocity block
            coef = self.mu * jnp.einsum("ed,ed->e", mesh.edge_normal,
                                        mesh.edge_normal) / jnp.sqrt(dist2) \
                / jnp.sqrt(dist2) / rho0
            eyev = jnp.zeros((nv, nv)).at[1:, 1:].set(jnp.eye(nd))
            diag = diag + mesh.accumulate_sides(
                coef[:, None, None] * eyev, coef[:, None, None] * eyev)
            off_ij = off_ij - coef[:, None, None] * eyev
            off_ji = off_ji - coef[:, None, None] * eyev

        # ---- BCs (weak fluxes on the outward normal) ----
        wall_mask = jnp.zeros(mesh.npoint, dtype=bool)
        for bc in self.bcs:
            nodes = bc.nodes
            out_n = -bc.normal
            if bc.kind == "euler_wall":
                bf = jnp.zeros((nodes.shape[0], nv), dtype=u.dtype)
                bf = bf.at[:, 1:].set(p[nodes, None] * out_n)
                res = res.at[nodes].add(bf)
                jb = jnp.zeros((nodes.shape[0], nv, nv), dtype=u.dtype)
                jb = jb.at[:, 1:, 0].set(out_n)
                diag = diag.at[nodes].add(jb)
            elif bc.kind in ("inlet", "far"):
                vg = jnp.broadcast_to(bc.params["vel"][None],
                                      (nodes.shape[0], nd))
                bf, jbi, _ = art_comp_flux(
                    vel[nodes], vg, p[nodes], p[nodes], rho0, beta2, out_n)
                res = res.at[nodes].add(bf)
                diag = diag.at[nodes].add(jbi)
            elif bc.kind == "outlet":
                pg = jnp.full((nodes.shape[0],), bc.params["p"],
                              dtype=u.dtype)
                bf, jbi, _ = art_comp_flux(
                    vel[nodes], vel[nodes], p[nodes], pg, rho0, beta2, out_n)
                res = res.at[nodes].add(bf)
                diag = diag.at[nodes].add(jbi)
            elif bc.kind == "noslip_wall":
                wall_mask = wall_mask.at[nodes].set(True)

        # strong no-slip: zero velocity rows, identity Jacobian rows
        mom_rows = jnp.zeros(nv, dtype=bool).at[1:].set(True)
        row_wall = wall_mask[:, None] & mom_rows[None, :]
        res = jnp.where(row_wall, 0.0, res)
        eye = jnp.eye(nv, dtype=u.dtype)
        diag = jnp.where(row_wall[:, :, None], eye[None], diag)
        iw, jw = wall_mask[i], wall_mask[j]
        off_ij = jnp.where((iw[:, None] & mom_rows[None, :])[:, :, None],
                           0.0, off_ij)
        off_ji = jnp.where((jw[:, None] & mom_rows[None, :])[:, :, None],
                           0.0, off_ji)
        return res, BlockJacobian(diag=diag, off_ij=off_ij, off_ji=off_ji), \
            wall_mask

    def _make_step(self):
        cfg, mesh = self.cfg, self.mesh

        def step(u):
            res, jac, wall_mask = self._assemble(u)
            # local time step from the ArtComp spectral radius
            p = u[:, 0]
            vel = u[:, 1:] / self.rho0
            i, j = mesh.edges[:, 0], mesh.edges[:, 1]
            qn = jnp.einsum("ed,ed->e", 0.5 * (vel[i] + vel[j]),
                            mesh.edge_normal)
            area2 = jnp.einsum("ed,ed->e", mesh.edge_normal, mesh.edge_normal)
            lam_e = jnp.abs(qn) + jnp.sqrt(qn * qn + self.beta2 * area2)
            lam = mesh.sum_edges_abs(lam_e)
            dt = cfg.cfl_number * mesh.volume / jnp.maximum(lam, 1e-300)
            eye = jnp.eye(self.nv, dtype=u.dtype)
            diag = jac.diag + (mesh.volume / dt)[:, None, None] * eye
            jac = BlockJacobian(diag=diag, off_ij=jac.off_ij,
                                off_ji=jac.off_ji)
            dinv = blockcsr.block_jacobi_factor(jac)
            _sel = blockcsr.gather_offdiag(mesh, jac)
            sol, _, _ = krylov.fgmres(
                lambda x: blockcsr.matvec(mesh, jac, x, _sel),
                lambda r: blockcsr.block_jacobi_apply(dinv, r),
                -res, max_iter=cfg.linear_solver_iter,
                tol=cfg.linear_solver_error)
            u_new = u + cfg.relaxation_factor_flow * sol
            u_new = u_new.at[:, 1:].set(
                jnp.where(wall_mask[:, None], 0.0, u_new[:, 1:]))
            rms = jnp.sqrt(jnp.mean(res * res, axis=0))
            return u_new, rms

        return step

    def run(self, niter: int, u=None, quiet=True):
        u = self.freestream_state() if u is None else u
        hist = []
        for it in range(niter):
            u, rms = self._step(u)
            lr = np.log10(np.maximum(np.asarray(rms, np.float64), 1e-300))
            hist.append(lr)
            if not quiet and it % 20 == 0:
                print(f"{it:5d}  Res[P]: {lr[0]: .6f}  Res[rhoU]: {lr[1]: .6f}")
        return u, np.array(hist)
