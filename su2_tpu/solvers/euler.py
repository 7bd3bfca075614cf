"""Reactive Euler solver: residual assembly, weak BCs, explicit update.

Data-parallel re-design of CReactiveEulerSolver
(reference: SU2_CFD/src/solver_direct_reactive.cpp:24-4129).  The per-edge /
per-vertex loops become batched kernels; the whole step jits into one XLA
program.  Sign convention follows the reference: LinSysRes R(U) accumulates
edge fluxes (+ for edge node i, - for node j), weak-BC fluxes, and source
terms; the explicit update is U <- clip(U - (R + trunc) * dt / Vol).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.chemistry import library as cl
from su2_tpu.chemistry.library import ChemLib
from su2_tpu.config import Config
from su2_tpu.geometry.dual_grid import build_dual_grid
from su2_tpu.geometry.mesh_data import MeshArrays, mesh_arrays
from su2_tpu.io.mesh import read_su2_mesh
from su2_tpu.ops import ausm, gradients, limiters, timestep
from su2_tpu import state as st
from su2_tpu.state import Layout, TSolveParams
from su2_tpu.ops import bgather as bg

EPS = 1e-16


# --------------------------------------------------------------------------
# Boundary marker data
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BCMarker:
    kind: str                 # euler_wall | inlet | outlet | supersonic_inlet
    #                         | supersonic_outlet | isothermal_wall
    #                         | heatflux_wall | far_field
    tag: str
    inlet_mode: str           # TOTAL_CONDITIONS | MASS_FLOW | TEMPERATURE_IMPOSE
    nodes: jax.Array          # (nV,) int32
    normal: jax.Array         # (nV, d) stored (inward) vertex normals
    params: dict              # kind-specific jnp arrays / scalars
    nn: jax.Array | None = None  # (nV,) normal-neighbor node ids


jax.tree_util.register_dataclass(
    BCMarker, data_fields=["nodes", "normal", "params", "nn"],
    meta_fields=["kind", "tag", "inlet_mode"])


def build_bc_markers(cfg: Config, lib: ChemLib, mesh: MeshArrays,
                     lay: Layout, dtype) -> tuple[BCMarker, ...]:
    out = []
    f = lambda x: jnp.asarray(x, dtype=dtype)

    def geom(tag):
        nodes, normal = mesh.markers[tag]
        return dict(nodes=nodes, normal=normal, nn=mesh.marker_nn[tag])

    for tag in cfg.marker_euler:
        out.append(BCMarker("euler_wall", tag, "", params={}, **geom(tag)))
    for tag in cfg.marker_sym:
        # symmetry plane == slip wall in this FV scheme (BC_Sym_Plane
        # forwards to BC_Euler_Wall, solver_direct_mean.cpp:13194-13201);
        # previously parsed but silently untreated
        out.append(BCMarker("euler_wall", tag, "", params={}, **geom(tag)))
    for tag, temp in cfg.marker_isothermal.items():
        out.append(BCMarker("isothermal_wall", tag, "",
                            params={"twall": f(temp)}, **geom(tag)))
    for tag, flux in cfg.marker_heatflux.items():
        out.append(BCMarker("heatflux_wall", tag, "",
                            params={"qwall": f(flux)}, **geom(tag)))
    for tag, (v1, v2, fdir) in cfg.marker_inlet.items():
        ys = cfg.inlet_mass_frac.get(tag, cfg.freestream_mass_frac)
        out.append(BCMarker(
            "inlet", tag, cfg.inlet_type,
            params={"v1": f(v1), "v2": f(v2), "flow_dir": f(fdir[:lay.ndim]),
                    "ys": f(ys)}, **geom(tag)))
    for tag, pback in cfg.marker_outlet.items():
        out.append(BCMarker("outlet", tag, "",
                            params={"p_exit": f(pback)}, **geom(tag)))
    for tag, (t, p, vel) in cfg.marker_supersonic_inlet.items():
        ys = cfg.inlet_mass_frac.get(tag, cfg.freestream_mass_frac)
        out.append(BCMarker("supersonic_inlet", tag, "",
                            params={"t": f(t), "p": f(p),
                                    "vel": f(vel[:lay.ndim]), "ys": f(ys)},
                            **geom(tag)))
    for tag in cfg.marker_supersonic_outlet:
        out.append(BCMarker("supersonic_outlet", tag, "", params={}, **geom(tag)))
    for tag, (kind, v1, v2, fdir) in cfg.marker_riemann.items():
        # characteristic BC (BC_Riemann, solver_direct_mean.cpp:10550);
        # kinds handled in solvers/riemann.py
        ys = cfg.inlet_mass_frac.get(tag, cfg.freestream_mass_frac)
        out.append(BCMarker(
            "riemann", tag, "",
            params={"riemann_kind": kind, "v1": f(v1), "v2": f(v2),
                    "flow_dir": f(fdir), "ys": f(ys)}, **geom(tag)))
    for tag, (tt, pt) in cfg.marker_engine_exhaust.items():
        # standard nacelle exhaust (BC_Engine_Exhaust,
        # solver_direct_mean.cpp:12944): a total-conditions inflow with
        # the GIVEN (Tt, Pt) targets — the reference overwrites its own
        # iterative pressure estimate with the static targets (:12991-
        # 12996) — and the flow direction along the inward surface normal
        # (Flow_Dir = -UnitNormal, :13032).  Our marker normals point
        # OUTWARD-negated already per the dual-grid convention used by the
        # inlet math, so the per-vertex unit normal is the flow direction.
        g = geom(tag)
        nrm = np.asarray(g["normal"], dtype=np.float64)
        unit = nrm / np.maximum(
            np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
        ys = cfg.inlet_mass_frac.get(tag, cfg.freestream_mass_frac)
        out.append(BCMarker(
            "inlet", tag, "TOTAL_CONDITIONS",
            params={"v1": f(tt), "v2": f(pt), "flow_dir": f(unit),
                    "ys": f(ys)}, **g))
    if cfg.marker_engine_inflow and not cfg.reactive:
        # standard nacelle fan-face inflow (BC_Engine_Inflow,
        # solver_direct_mean.cpp:12726): the ghost state is EXACTLY the
        # subsonic pressure-outlet characteristic update with the fan-face
        # back pressure imposed (:12800-12830 == BC_Outlet).
        # FAN_FACE_PRESSURE imposes the cfg target directly; the
        # FAN_FACE_MACH/MDOT modes wrap the same BC in a damped scalar
        # controller fed by the PREVIOUS iteration's marker-integrated
        # Mach/mass flow (:12743-12766) — a host-loop feature not yet
        # threaded through the jitted step (raises loudly).
        if cfg.engine_inflow_type != "FAN_FACE_PRESSURE":
            raise NotImplementedError(
                "ENGINE_INFLOW_TYPE= FAN_FACE_MACH/MDOT (damped fan-face "
                "controller) is not implemented; use FAN_FACE_PRESSURE "
                "with the target back pressure")
        for tag, target in cfg.marker_engine_inflow.items():
            out.append(BCMarker("outlet", tag, "",
                                params={"p_exit": f(target)}, **geom(tag)))
    for tag in (cfg.marker_engine_inflow if cfg.reactive else ()):
        # fuel-regression inflow (BC_Engine_Inflow,
        # solver_direct_reactive.cpp:5947; data options
        # config_structure.cpp:569-588)
        from su2_tpu.io.tables import read_fuel_data
        import os as _os
        fpath = cfg.fuel_data_file
        if cfg.library_path:
            fpath = _os.path.join(cfg.library_path, fpath)
        fuel = {k: f(val) for k, val in read_fuel_data(
            cfg.resolve(fpath)).items()}
        ys_fuel = cfg.inflow_mass_frac.get(tag, cfg.freestream_mass_frac)
        out.append(BCMarker(
            "engine_inflow", tag, "",
            params={"ys_fuel": f(ys_fuel),
                    "flow_dir": f(cfg.inflow_velocity_dir[:lay.ndim]),
                    "fuel": fuel,
                    "rho_s": f(cfg.fuel_density),
                    "cp_s": f(cfg.fuel_specific_heat),
                    "h_pf": f(cfg.fuel_enthalpy),
                    "kappa_s": f(cfg.fuel_conductivity),
                    "t0": f(cfg.fuel_temperature),
                    "tmin": f(cfg.temperature_min),
                    "tmax": f(cfg.temperature_max)}, **geom(tag)))
    if cfg.marker_far:
        ys_inf = jnp.asarray(cfg.freestream_mass_frac, dtype=dtype)
        rgas = float(cl.mixture_rgas(lib, ys_inf[None])[0])
        rho_inf = cfg.freestream_pressure / (rgas * cfg.freestream_temperature)
        ff = {"p_inf": f(cfg.freestream_pressure), "rho_inf": f(rho_inf),
              "vel_inf": f(cfg.freestream_velocity[:lay.ndim]), "ys": ys_inf}
        for tag in cfg.marker_far:
            out.append(BCMarker("far_field", tag, "", params=ff, **geom(tag)))
    return tuple(out)


# --------------------------------------------------------------------------
# Boundary states (the "characteristic" V_boundary per vertex)
# --------------------------------------------------------------------------

def _prim_row(lay, t, vel, p, rho, h, a, ys):
    """Assemble (nV, nPrim) primitive rows."""
    return jnp.concatenate([
        t[:, None], vel, p[:, None], rho[:, None], h[:, None], a[:, None], ys,
    ], axis=1)


def _rowfill(area, p):
    """Per-row marker parameter: scalar (ordinary markers) or (nV,) dense
    field (bc_dense sharded path) — broadcast either to (nV,)."""
    return jnp.broadcast_to(jnp.asarray(p, area.dtype), area.shape)


def euler_wall_residual(lib, lay, nodes, normal, v, turb_ke=None,
                        grid_vel=None):
    """Weak slip-wall: pressure (+ 2/3 rho k) flux on momentum
    (BC_Euler_Wall, solver_direct_reactive.cpp:2881-2995).  Moving walls
    add the p * (u_g . n) work term on energy (the reference's
    BC_Euler_Wall grid_movement branch)."""
    area = jnp.linalg.norm(normal, axis=1)
    unit = -normal / area[:, None]                        # outward
    p = bg.rows(v, nodes)[:, lay.P]
    rho = bg.rows(v, nodes)[:, lay.PRHO]
    tke = bg.rows(turb_ke, nodes) if turb_ke is not None else 0.0
    coeff = (p + 2.0 / 3.0 * rho * tke) * area
    res = jnp.zeros((nodes.shape[0], lay.nvar), dtype=v.dtype)
    res = res.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(coeff[:, None] * unit)
    if grid_vel is not None:
        qg_out = jnp.einsum("ed,ed->e", bg.rows(grid_vel, nodes),
                            -normal)                      # area-weighted
        res = res.at[:, lay.RHOE].set(p * qg_out)
    return res


def inlet_state(lib, lay, bc: BCMarker, v, dpdu_e, tke_inf):
    """V_inlet ghost state for the three subsonic inlet modes
    (BC_Inlet, solver_direct_reactive.cpp:3226-3580)."""
    nodes = bc.nodes
    nd = lay.ndim
    area = jnp.linalg.norm(bc.normal, axis=1)
    unit = -bc.normal / area[:, None]                     # outward
    vd = bg.rows(v, nodes)
    ys = jnp.broadcast_to(bc.params["ys"], (nodes.shape[0], lay.ns))
    fdir = bc.params["flow_dir"]

    fdir_r = jnp.broadcast_to(fdir, (nodes.shape[0], nd))
    if bc.inlet_mode == "TEMPERATURE_IMPOSE":
        temp = _rowfill(area, bc.params["v1"])
        vel_mag = _rowfill(area, bc.params["v2"])
        velb = vel_mag[:, None] * fdir_r
        p = vd[:, lay.P]
        rgas = cl.mixture_rgas(lib, ys)
        rho = p / (rgas * temp)
        h = cl.mixture_enthalpy(lib, temp, ys) + tke_inf + 0.5 * vel_mag ** 2
        gamma, a = cl.frozen_gamma_sound(lib, temp, ys)
        return _prim_row(lay, temp, velb, p, rho, h, a, ys), gamma, vel_mag ** 2

    if bc.inlet_mode == "MASS_FLOW":
        # impose density + velocity, extrapolate pressure
        # (BC_Inlet MASS_FLOW branch, solver_direct_reactive.cpp:3490-3560)
        rho = _rowfill(area, bc.params["v1"])
        vel_mag = _rowfill(area, bc.params["v2"])
        velb = vel_mag[:, None] * fdir_r
        p = vd[:, lay.P]
        rgas = cl.mixture_rgas(lib, ys)
        temp = p / (rgas * rho)
        h = cl.mixture_enthalpy(lib, temp, ys) + tke_inf + 0.5 * vel_mag ** 2
        gamma, a = cl.frozen_gamma_sound(lib, temp, ys)
        return _prim_row(lay, temp, velb, p, rho, h, a, ys), gamma, \
            vel_mag ** 2

    if bc.inlet_mode == "TOTAL_CONDITIONS":
        ttot = bc.params["v1"]
        ptot = bc.params["v2"]
        vel_d = vd[:, lay.VX:lay.VX + nd]
        vn = jnp.sum(vel_d * unit, axis=1)
        a_d = vd[:, lay.A]
        gamma_node = bg.rows(dpdu_e, nodes) + 1.0                   # dPdU[rhoE] + 1
        gamma_tot = cl.frozen_gamma_sound(
            lib, _rowfill(area, ttot), ys)[0]
        gamma = 2.0 / (1.0 / gamma_node + 1.0 / gamma_tot)
        gm1 = gamma - 1.0
        riemann = vn + 2.0 * a_d / gm1
        tot_enthalpy = cl.mixture_enthalpy(
            lib, _rowfill(area, ttot), ys)
        alpha = jnp.sum(unit * fdir, axis=1)
        rgas = cl.mixture_rgas(lib, ys)

        def f_of(t):
            hb = cl.mixture_enthalpy(lib, t, ys)
            cb = jnp.sqrt(gamma * rgas * t)
            vb = (riemann - 2.0 * cb / gm1) / alpha
            return hb + 0.5 * vb * vb - tot_enthalpy

        # secant (15 its, tol 1e-9) + bisection fallback (100 its, tol 1e-6)
        t = _rowfill(area, ttot)
        t_old = t + 1.0
        done = jnp.zeros_like(t, dtype=bool)

        def sec(_, carry):
            t, t_old, done = carry
            fv = f_of(t)
            df = fv - f_of(t_old)
            safe = jnp.where(df == 0.0, 1.0, df)
            t_new = t - fv * (t - t_old) / safe
            conv = jnp.abs(t_new - t) < 1.0e-9
            return (jnp.where(done | conv, t, t_new),
                    jnp.where(done, t_old, t), done | conv)

        t, _, done = jax.lax.fori_loop(0, 15, sec, (t, t_old, done))

        ta = jnp.full_like(t, 300.0)
        tb = _rowfill(t, ttot)
        tm = 0.5 * (ta + tb)
        bdone = jnp.zeros_like(t, dtype=bool)

        def bis(_, carry):
            ta, tb, tm, bdone = carry
            tmid = 0.5 * (ta + tb)
            fv = f_of(tmid)
            conv = jnp.abs(fv) < 1.0e-6
            hi = fv > 0.0
            return (jnp.where(bdone | conv, ta, jnp.where(hi, tmid, ta)),
                    jnp.where(bdone | conv, tb, jnp.where(hi, tb, tmid)),
                    jnp.where(bdone, tm, tmid), bdone | conv)

        ta, tb, tm, bdone = jax.lax.fori_loop(0, 100, bis, (ta, tb, tm, bdone))
        tb_final = jnp.where(done, t, tm)

        htot = tot_enthalpy + tke_inf
        rho_tot = ptot / (rgas * ttot)
        rho = rho_tot * (tb_final / ttot) ** (1.0 / gm1)
        p = rho * rgas * tb_final
        a = jnp.sqrt(tb_final * gamma * rgas)
        vel_mag = jnp.abs((riemann - 2.0 * a / gm1) / alpha)
        velb = vel_mag[:, None] * fdir
        vrow = _prim_row(lay, tb_final, velb, p, rho, htot, a, ys)
        return vrow, gamma, vel_mag ** 2

    raise NotImplementedError(f"inlet mode {bc.inlet_mode}")


def outlet_state(lib, lay, bc: BCMarker, v, dpdu_e, tke_inf):
    """V_outlet ghost state (BC_Outlet, solver_direct_reactive.cpp:3808-3935):
    supersonic exit copies the domain state; subsonic imposes back pressure
    via entropy + Riemann invariant extrapolation."""
    nodes = bc.nodes
    nd = lay.ndim
    area = jnp.linalg.norm(bc.normal, axis=1)
    unit = -bc.normal / area[:, None]
    vd = bg.rows(v, nodes)
    rho_d = vd[:, lay.PRHO]
    p_d = vd[:, lay.P]
    vel_d = vd[:, lay.VX:lay.VX + nd]
    vel2_d = jnp.sum(vel_d * vel_d, axis=1)
    gamma = bg.rows(dpdu_e, nodes) + 1.0
    a_d = jnp.sqrt(gamma * p_d / rho_d)
    mach = jnp.sqrt(vel2_d) / a_d
    supersonic = mach >= 1.0

    gm1 = gamma - 1.0
    entropy = p_d * (1.0 / rho_d) ** gamma
    vn = jnp.sum(vel_d * unit, axis=1)
    riemann = vn + 2.0 * a_d / gm1
    p_exit = bc.params["p_exit"]
    rho_b = (p_exit / entropy) ** (1.0 / gamma)
    a_b = jnp.sqrt(gamma * p_exit / rho_b)
    vn_exit = riemann - 2.0 * a_b / gm1
    vel_b = vel_d + (vn_exit - vn)[:, None] * unit
    vel2_b = jnp.sum(vel_b * vel_b, axis=1)
    ys = vd[:, lay.YS:lay.YS + lay.ns]
    rgas = cl.mixture_rgas(lib, ys)
    t_b = p_exit / (rho_b * rgas)
    h_b = cl.mixture_enthalpy(lib, t_b, ys) + tke_inf + 0.5 * vel2_b
    p_full = _rowfill(p_d, p_exit)
    v_sub = _prim_row(lay, t_b, vel_b, p_full, rho_b, h_b, a_b, ys)
    v_out = jnp.where(supersonic[:, None], vd, v_sub)
    return v_out, gamma, jnp.where(supersonic, vel2_d, vel2_b), supersonic


def supersonic_inlet_state(lib, lay, bc: BCMarker, v, tke_inf):
    nodes = bc.nodes
    nd = lay.ndim
    n = nodes.shape[0]
    ys = jnp.broadcast_to(bc.params["ys"], (n, lay.ns))
    area_ss = jnp.zeros((n,), dtype=v.dtype)
    t = _rowfill(area_ss, bc.params["t"])
    p = _rowfill(area_ss, bc.params["p"])
    vel = jnp.broadcast_to(bc.params["vel"], (n, nd))
    rgas = cl.mixture_rgas(lib, ys)
    rho = p / (rgas * t)
    vel2 = jnp.sum(vel * vel, axis=1)
    h = cl.mixture_enthalpy(lib, t, ys) + 0.5 * vel2
    gamma, a = cl.frozen_gamma_sound(lib, t, ys)
    return _prim_row(lay, t, vel, p, rho, h, a, ys), gamma, vel2


def far_field_state(lib, lay, bc: BCMarker, v, dpdu_e):
    """Characteristic far-field ghost state (standard-solver capability; the
    reference's REACTIVE BC_Far_Field raises NotImplemented,
    solver_direct_reactive.cpp:3215 — implemented here as a superset using
    the classic Riemann-invariant construction of CEulerSolver::BC_Far_Field).
    """
    nodes = bc.nodes
    nd = lay.ndim
    area = jnp.linalg.norm(bc.normal, axis=1)
    unit = -bc.normal / area[:, None]                 # outward
    vd = bg.rows(v, nodes)
    gamma = bg.rows(dpdu_e, nodes) + 1.0
    gm1 = gamma - 1.0

    rho_d = vd[:, lay.PRHO]
    p_d = vd[:, lay.P]
    a_d = vd[:, lay.A]
    vel_d = vd[:, lay.VX:lay.VX + nd]
    un_d = jnp.sum(vel_d * unit, axis=1)

    p_inf = bc.params["p_inf"]
    rho_inf = bc.params["rho_inf"]
    vel_inf = jnp.broadcast_to(bc.params["vel_inf"], (nodes.shape[0], nd))
    ys_inf = jnp.broadcast_to(bc.params["ys"], (nodes.shape[0], lay.ns))
    a_inf = jnp.sqrt(gamma * p_inf / rho_inf)
    un_inf = jnp.sum(vel_inf * unit, axis=1)

    r_plus = un_d + 2.0 * a_d / gm1                   # from inside
    r_minus = un_inf - 2.0 * a_inf / gm1              # from outside
    un_b = 0.5 * (r_plus + r_minus)
    a_b = 0.25 * gm1 * (r_plus - r_minus)

    inflow = un_b < 0.0
    sup_in = un_d < -a_d
    sup_out = un_d > a_d

    # upwind side for entropy / tangential velocity / composition
    vel_up = jnp.where(inflow[:, None], vel_inf, vel_d)
    un_up = jnp.where(inflow, un_inf, un_d)
    rho_up = jnp.where(inflow, rho_inf, rho_d)
    p_up = jnp.where(inflow, p_inf, p_d)
    ys_up = jnp.where(inflow[:, None], ys_inf,
                      vd[:, lay.YS:lay.YS + lay.ns])

    entropy = p_up / rho_up ** gamma
    rho_b = (a_b * a_b / (gamma * entropy)) ** (1.0 / gm1)
    p_b = rho_b * a_b * a_b / gamma
    vel_b = vel_up + (un_b - un_up)[:, None] * unit

    # supersonic overrides
    rho_b = jnp.where(sup_in, rho_inf, jnp.where(sup_out, rho_d, rho_b))
    p_b = jnp.where(sup_in, p_inf, jnp.where(sup_out, p_d, p_b))
    vel_b = jnp.where(sup_in[:, None], vel_inf,
                      jnp.where(sup_out[:, None], vel_d, vel_b))
    ys_b = jnp.where(sup_out[:, None], vd[:, lay.YS:lay.YS + lay.ns], ys_up)

    rgas = cl.mixture_rgas(lib, ys_b)
    t_b = p_b / (rho_b * rgas)
    vel2 = jnp.sum(vel_b * vel_b, axis=1)
    h_b = cl.mixture_enthalpy(lib, t_b, ys_b) + 0.5 * vel2
    gam_b, _ = cl.frozen_gamma_sound(lib, t_b, ys_b)
    a_out = jnp.sqrt(gam_b * p_b / rho_b)
    return _prim_row(lay, t_b, vel_b, p_b, rho_b, h_b, a_out, ys_b), gam_b, vel2


def ghost_dpdu(lib, lay, v_ghost, gamma, vel2):
    """dP/dU of a ghost state with known gamma (the BC 'Secondary')."""
    t = v_ghost[:, lay.T]
    e_s = cl.species_energy(lib, t)
    out = jnp.zeros((v_ghost.shape[0], lay.nvar), dtype=v_ghost.dtype)
    out = out.at[:, lay.RHO].set((gamma - 1.0) * 0.5 * vel2)
    out = out.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(
        (1.0 - gamma)[:, None] * v_ghost[:, lay.VX:lay.VX + lay.ndim])
    out = out.at[:, lay.RHOE].set(gamma - 1.0)
    out = out.at[:, lay.RHOS:lay.RHOS + lay.ns].set(
        lib.ri * t[:, None] - (gamma - 1.0)[:, None] * e_s)
    return out


# --------------------------------------------------------------------------
# Residual assembly
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class EulerParams:
    lay: Layout
    tparams: TSolveParams
    m_infty: float
    cfl: float
    max_dt: float
    muscl: bool
    use_limiter: bool
    limiter_kind: str
    limiter_coeff: float
    ref_elem_length: float
    grad_method: str           # GREEN_GAUSS | WEIGHTED_LEAST_SQUARES
    reactive_sources: bool
    pasr: bool
    pasr_lb: float
    conv_method: str = "AUSM"  # AUSM | ROE | HLLC | JST | LAX-FRIEDRICH
    #                            (Roe/HLLC use AUSM Jacobians implicitly)
    c_mu: float = 0.09
    tke_inf: float = 0.0
    jst_coeff: tuple = (0.5, 0.02)   # JST_SENSOR_COEFF (kappa_2, kappa_4)
    lax_coeff: float = 0.15          # LAX_SENSOR_COEFF (kappa_0)
    entropy_fix: float = 0.001       # ENTROPY_FIX_COEFF (Roe Harten fix)
    # moving grids (ALE / rotating frame, su2_tpu/motion.py): per-node grid
    # velocity (N, d) entering the ROE fluxes, wall BCs, and the time step;
    # rotating_source adds the absolute-velocity-form momentum source
    grid_vel: object = None
    rotation_rate: tuple = (0.0, 0.0, 0.0)
    rotating_source: bool = False
    # AXISYMMETRIC / GRAVITY_FORCE point sources (CSourceAxisymmetric_Flow
    # numerics_direct_mean.cpp:4104, CSourceGravity :4166)
    axisymmetric: bool = False
    gravity: bool = False


def gradient_vars(lay: Layout, v: jnp.ndarray) -> jnp.ndarray:
    """[T, u, v, (w), P] — the Euler gradient/limiter variable set."""
    return jnp.concatenate([
        v[:, lay.T:lay.T + 1], v[:, lay.VX:lay.VX + lay.ndim],
        v[:, lay.P:lay.P + 1]], axis=1)


def compute_gradients(mesh, prm: EulerParams, q, vel_rows="flow"):
    """GG/WLS gradients; with a rotational-periodic ghost layer the ghost
    rows are overwritten by the rotated donor gradients (the reference's
    Set_MPI_Solution_Gradient rotation).  vel_rows: "flow" treats rows
    1..1+ndim as vector components (the [T, u.., ...] sets); None for
    scalar-only sets (turbulence variables)."""
    mode = gradients.GRAD_METHOD_MODE.get(prm.grad_method, "WLS")
    if mode == "GG":
        grad = gradients.green_gauss(mesh, q)
    else:
        grad = gradients.weighted_least_squares(mesh, q)
    return gradients.pg_fix(
        mesh, grad,
        vel_rows=(1, 1 + mesh.ndim) if vel_rows == "flow" else None)


def _muscl_rows(lib, lay, prm, vrow, qrow, gradrow, limrow, dx):
    """MUSCL-reconstructed face state from pre-gathered node rows.

    vrow/qrow/gradrow/limrow: node quantities at the edge endpoint (any
    gather — index or family roll); dx: signed node->midpoint vector."""
    proj = jnp.einsum("ed,egd->eg", dx, gradrow)
    if prm.use_limiter:
        proj = proj * limrow
    qr = qrow + proj
    t_r = qr[:, 0]
    vel_r = qr[:, 1:1 + lay.ndim]
    p_r = qr[:, 1 + lay.ndim]
    bad = (t_r <= EPS) | (p_r <= EPS)
    ys = vrow[:, lay.YS:lay.YS + lay.ns]
    rgas = cl.mixture_rgas(lib, ys)
    rho_r = p_r / (rgas * t_r)
    h_r = cl.mixture_enthalpy(lib, t_r, ys) \
        + 0.5 * jnp.sum(vel_r * vel_r, axis=1)
    gamma_r, _ = cl.frozen_gamma_sound(lib, t_r, ys)
    a_r = jnp.sqrt(gamma_r * p_r / rho_r)
    vrow_r = _prim_row(lay, t_r, vel_r, p_r, rho_r, h_r, a_r, ys)
    return jnp.where(bad[:, None], vrow, vrow_r)


def muscl_reconstruct(lib, lay, mesh, prm, v, grad, lim):
    """2nd-order face states with thermodynamic re-consistency
    (Upwind_Residual, solver_direct_reactive.cpp:2553-2687):
    reconstruct [T, u.., P], keep Y from the node, recompute rho, h, a from
    the library; fall back to the node state if T or P go non-positive."""
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    dx = 0.5 * (mesh.coords[j] - mesh.coords[i])          # Vector_i
    q = gradient_vars(lay, v)
    v_i = _muscl_rows(lib, lay, prm, v[i], q[i], grad[i],
                      lim[i] if prm.use_limiter else None, dx)
    v_j = _muscl_rows(lib, lay, prm, v[j], q[j], grad[j],
                      lim[j] if prm.use_limiter else None, -dx)
    return v_i, v_j


def muscl_reconstruct_fam(lib, lay, mesh, prm, v, grad, lim):
    """Family-major MUSCL face states: endpoint rows are tiles/rolls of the
    node arrays, the midpoint vector is +-0.5*fam_evec."""
    gi, gj = mesh.fam_gather_i, mesh.fam_gather_j
    kh = len(mesh.fam_offsets)
    evec = mesh.fam_evec.reshape(kh * mesh.npoint, -1)
    q = gradient_vars(lay, v)
    v_i = _muscl_rows(lib, lay, prm, gi(v), gi(q), gi(grad),
                      gi(lim) if prm.use_limiter else None, 0.5 * evec)
    v_j = _muscl_rows(lib, lay, prm, gj(v), gj(q), gj(grad),
                      gj(lim) if prm.use_limiter else None, -0.5 * evec)
    return v_i, v_j


def _centered_parts(lib, lay, mesh, prm, v, dpdu_full, implicit):
    """JST / Lax-Friedrichs edge flux via the node precomputes
    (Centered_Residual path, solver_direct_mean.cpp:4490-4530)."""
    from su2_tpu import state as st
    from su2_tpu.ops import centered

    u = st.prim2cons(lib, lay, v)
    bmask = centered.boundary_mask(mesh, v.shape[0])
    lam = centered.spectral_radius(lay, mesh, v)
    lapl, sensor = centered.und_laplacian_and_sensor(lay, mesh, u, v, bmask)
    n_neigh = jnp.maximum(mesh.nbr_mask.sum(axis=1), 1.0)
    kind = "JST" if prm.conv_method == "JST" else "LAX"
    s = dpdu_full
    if s is None:
        s = st.dpdu(lib, lay, v)
    return centered.centered_flux(
        lay, mesh, v, u, s, lam, lapl, sensor, n_neigh, kind,
        prm.jst_coeff[0], prm.jst_coeff[1], prm.lax_coeff, implicit)


def convective_residual(lib, lay, mesh, prm, v, grad, lim):
    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    if prm.conv_method in ("JST", "LAX-FRIEDRICH"):
        flux = _centered_parts(lib, lay, mesh, prm, v, None, False)
        return mesh.scatter_edges(flux)
    if prm.muscl:
        v_i, v_j = muscl_reconstruct(lib, lay, mesh, prm, v, grad, lim)
    else:
        v_i, v_j = v[i], v[j]
    if prm.conv_method == "ROE":
        from su2_tpu.ops import roe
        qg = None
        if prm.grid_vel is not None:
            ug = prm.grid_vel
            qg = 0.5 * jnp.einsum("ed,ed->e", ug[i] + ug[j],
                                  mesh.edge_normal) / mesh.edge_area
        flux = roe.roe_flux(lay, v_i, v_j, mesh.edge_normal, qg=qg,
                            entropy_fix=prm.entropy_fix)
    elif prm.conv_method == "HLLC":
        from su2_tpu.ops import hllc
        flux = hllc.hllc_flux(lay, v_i, v_j, mesh.edge_normal)
    else:
        flux = ausm.ausm_flux(lay, v_i, v_j, mesh.edge_normal, prm.m_infty)
    return mesh.scatter_edges(flux)


def axisymmetric_source(lay, mesh, v, dpdu_full=None):
    """AXISYMMETRIC= YES point source (CSourceAxisymmetric_Flow,
    numerics_direct_mean.cpp:4104-4166, applied at
    solver_direct_mean.cpp:5121-5152: residual ADDED to LinSysRes,
    Jacobian ADDED to the diagonal block when implicit).

    S_i = (Vol_i / y_i) * v_y * [rho, rho u, rho v, rho H, rho_s]
    with 1/y := 0 on the axis (Coord_i[1] <= 0).  The species rows are the
    natural multispecies generalization (rho_s v/y); the reference only
    registers this source for the standard solver, where ns == 1.

    Returns res (N, nvar); with dpdu_full also the analytic diagonal
    Jacobian (N, nvar, nvar).  NOTE the reference's energy-row Jacobian
    drops a whole term through C++ integer division (`1/2*(Gamma-1)*...`
    == 0, numerics_direct_mean.cpp:4156) — a miscompiled preconditioner
    quality bug we deliberately do not copy (TODO.md "known reference
    bugs"); the residual (and so the converged solution) is unaffected.
    """
    nd, ns = lay.ndim, lay.ns
    y = mesh.coords[:, 1]
    yinv = jnp.where(y > 0.0, 1.0 / jnp.where(y > 0.0, y, 1.0), 0.0)
    w = yinv * mesh.volume                               # (N,)
    rho = v[:, lay.PRHO]
    vel = v[:, lay.VX:lay.VX + nd]
    vy = vel[:, 1]
    h_tot = v[:, lay.H]
    ys = v[:, lay.YS:lay.YS + ns]
    res = jnp.zeros((v.shape[0], lay.nvar), v.dtype)
    res = res.at[:, lay.RHO].set(rho * vy)
    for d in range(nd):
        res = res.at[:, lay.RHOVX + d].set(rho * vel[:, d] * vy)
    res = res.at[:, lay.RHOE].set(rho * h_tot * vy)
    res = res.at[:, lay.RHOS:].set(ys * (rho * vy)[:, None])
    res = res * w[:, None]
    if dpdu_full is None:
        return res
    # analytic dS/dU (rows scaled by w at the end); im = rho*v_y slot
    im = lay.RHOVX + 1
    n = v.shape[0]
    jac = jnp.zeros((n, lay.nvar, lay.nvar), v.dtype)
    jac = jac.at[:, lay.RHO, im].set(1.0)
    for d in range(nd):
        r = lay.RHOVX + d
        if d == 1:
            jac = jac.at[:, r, lay.RHO].add(-vy * vy)
            jac = jac.at[:, r, im].add(2.0 * vy)
        else:
            ud = vel[:, d]
            jac = jac.at[:, r, lay.RHO].add(-ud * vy)
            jac = jac.at[:, r, lay.RHOVX + d].add(vy)
            jac = jac.at[:, r, im].add(ud)
    # d(rho H v_y)/dU = v_y*(e_E + dP/dU) + H*(e_im - v_y e_RHO)
    jac = jac.at[:, lay.RHOE, :].add(vy[:, None] * dpdu_full)
    jac = jac.at[:, lay.RHOE, lay.RHOE].add(vy)
    jac = jac.at[:, lay.RHOE, im].add(h_tot)
    jac = jac.at[:, lay.RHOE, lay.RHO].add(-h_tot * vy)
    for s in range(ns):
        r = lay.RHOS + s
        jac = jac.at[:, r, lay.RHO].add(-ys[:, s] * vy)
        jac = jac.at[:, r, im].add(ys[:, s])
        jac = jac.at[:, r, r].add(vy)
    return res, jac * w[:, None, None]


def gravity_source(lay, mesh, v):
    """GRAVITY_FORCE= YES body force (CSourceGravity,
    numerics_direct_mean.cpp:4166-4190): Vol * rho * g added to the LAST
    momentum row (y in 2D, z in 3D), no Jacobian contribution — the
    reference adds none (solver_direct_mean.cpp:5154-5173)."""
    STANDARD_GRAVITY = 9.80665          # option_structure.hpp:132
    rho = v[:, lay.PRHO]
    res = jnp.zeros((v.shape[0], lay.nvar), v.dtype)
    row = lay.RHOVX + lay.ndim - 1
    return res.at[:, row].set(mesh.volume * rho * STANDARD_GRAVITY)


def body_source_residual(lay, mesh, prm, v):
    """Sum of the enabled point sources (axisymmetric + gravity)."""
    res = None
    if prm.axisymmetric:
        res = axisymmetric_source(lay, mesh, v)
    if prm.gravity:
        g = gravity_source(lay, mesh, v)
        res = g if res is None else res + g
    return res


def body_source_system(lay, mesh, prm, v, dpdu_full):
    """(res, diag) of the enabled point sources for the implicit path."""
    res = diag = None
    if prm.axisymmetric:
        res, diag = axisymmetric_source(lay, mesh, v, dpdu_full)
    if prm.gravity:
        g = gravity_source(lay, mesh, v)
        res = g if res is None else res + g
    return res, diag


def chemistry_source_residual(lib, lay, mesh, prm, v, omega_turb=None):
    """CSourceReactive::ComputeChemistry residual part
    (numerics_direct_reactive.cpp:1728-1824): R_s = -omega_s * Vol."""
    t = v[:, lay.T]
    rho = v[:, lay.PRHO]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    rf, rb, kc = cl.reaction_rates(lib, t, rho, ys)
    om = cl.omega_tensor(lib, rf, rb)
    if prm.pasr and omega_turb is not None:
        dfr = cl.dfr_drho(lib, rf, rb, rho, ys)
        k = cl.pasr_constants(lib, dfr, omega_turb, prm.c_mu, prm.pasr_lb)
        omega = cl.mass_production(lib, om, k)
    else:
        omega = cl.mass_production(lib, om)
    res = jnp.zeros((v.shape[0], lay.nvar), dtype=v.dtype)
    res = res.at[:, lay.RHOS:lay.RHOS + lay.ns].set(
        -omega * mesh.volume[:, None])
    return res


def wall_bc_batch(bcs, kinds=("euler_wall", "isothermal_wall",
                              "heatflux_wall")):
    """Concatenated (nodes, normal) over all wall-kind markers, or None.

    nodes stays static numpy, so the downstream gathers and scatters
    (ops/bgather.py) index with compile-time constants."""
    sel = [bc for bc in bcs if bc.kind in kinds]
    if not sel:
        return None
    nodes = np.concatenate([np.asarray(bc.nodes) for bc in sel])
    normal = jnp.concatenate([bc.normal for bc in sel], axis=0)
    return nodes, normal


def flux_bc_batch(lib, lay, bcs, v, dpdu_full, tke_inf, coords=None):
    """Ghost states of ALL weak flux-BC markers as one concatenated batch.

    The kind-specific ghost-state constructions stay per marker (cheap
    elementwise work on ~100-vertex arrays), but the expensive AUSM /
    viscous flux kernels and the residual/Jacobian scatters downstream run
    ONCE over the concatenated boundary face set instead of once per
    marker.  (The reference loops markers then vertices,
    integration_structure.cpp:95-193; per-marker kernel launches on tiny
    row counts waste dispatch and bloat the XLA program.)

    Returns None when there are no flux BCs, else the tuple
    (nodes, nn, normal, v_ghost, gamma, vel2) with nodes/nn static numpy.
    """
    dpdu_e = dpdu_full[:, lay.RHOE]
    nodes_l, nn_l, norm_l, vg_l, gam_l, vel2_l = [], [], [], [], [], []
    for bc in bcs:
        if bc.kind in ("euler_wall", "isothermal_wall", "heatflux_wall",
                       "riemann"):
            # riemann markers evaluate a DIRECT projected flux at the
            # characteristic boundary state (solvers/riemann.py), not an
            # upwind flux against a ghost state — handled separately in
            # bc_residuals / bc_system
            continue
        if bc.kind == "inlet":
            v_ghost, gamma, vel2 = inlet_state(lib, lay, bc, v, dpdu_e,
                                               tke_inf)
        elif bc.kind == "outlet":
            v_ghost, gamma, vel2, _ = outlet_state(lib, lay, bc, v, dpdu_e,
                                                   tke_inf)
        elif bc.kind == "supersonic_inlet":
            v_ghost, gamma, vel2 = supersonic_inlet_state(lib, lay, bc, v,
                                                          tke_inf)
        elif bc.kind == "supersonic_outlet":
            v_ghost = bg.rows(v, bc.nodes)
            gamma = bg.rows(dpdu_e, bc.nodes) + 1.0
            vel_d = v_ghost[:, lay.VX:lay.VX + lay.ndim]
            vel2 = jnp.sum(vel_d * vel_d, axis=1)
        elif bc.kind == "far_field":
            v_ghost, gamma, vel2 = far_field_state(lib, lay, bc, v, dpdu_e)
        elif bc.kind == "engine_inflow":
            from su2_tpu.solvers import engine_inflow as ei
            v_ghost, gamma, vel2 = ei.engine_inflow_state(
                lib, lay, bc, v, coords)
        else:
            raise NotImplementedError(f"BC kind {bc.kind}")
        nv = int(np.asarray(bc.nodes).shape[0])
        nodes_l.append(np.asarray(bc.nodes))
        nn_l.append(np.asarray(bc.nn))
        norm_l.append(bc.normal)
        vg_l.append(v_ghost)
        gam_l.append(jnp.broadcast_to(jnp.asarray(gamma, v.dtype), (nv,)))
        vel2_l.append(jnp.broadcast_to(jnp.asarray(vel2, v.dtype), (nv,)))
    if not nodes_l:
        return None
    nodes = np.concatenate(nodes_l)
    nn = np.concatenate(nn_l)
    normal = jnp.concatenate(norm_l, axis=0)
    v_ghost = jnp.concatenate(vg_l, axis=0)
    gamma = jnp.concatenate(gam_l)
    vel2 = jnp.concatenate(vel2_l)
    return nodes, nn, normal, v_ghost, gamma, vel2


def bc_residuals(lib, lay, mesh, prm, bcs, v, dpdu_full, turb_ke=None):
    """Sum of weak-BC convective residual contributions, scattered to nodes.

    Walls and flux BCs are each assembled as ONE batched call over the
    concatenated marker face sets (see flux_bc_batch)."""
    res = jnp.zeros((v.shape[0], lay.nvar), dtype=v.dtype)
    # inviscid contribution of no-slip walls = weak pressure wall
    wb = wall_bc_batch(bcs)
    if wb is not None:
        wn, wnorm = wb
        r = euler_wall_residual(lib, lay, wn, wnorm, v, turb_ke,
                                grid_vel=prm.grid_vel)
        res = bg.add_rows(res, wn, r)
    fb = flux_bc_batch(lib, lay, bcs, v, dpdu_full, prm.tke_inf, mesh.coords)
    if fb is not None:
        nodes, _, normal, v_ghost, _, _ = fb
        if prm.grid_vel is not None:
            # moving grids route boundary fluxes through the ALE Roe kernel
            from su2_tpu.ops import roe
            area_b = jnp.linalg.norm(normal, axis=1)
            qg_b = jnp.einsum("ed,ed->e", bg.rows(prm.grid_vel, nodes),
                              -normal) / area_b
            flux = roe.roe_flux(lay, bg.rows(v, nodes), v_ghost, -normal,
                                qg=qg_b, entropy_fix=prm.entropy_fix)
        else:
            # flux BCs: AUSM between domain and ghost over -vertex normal
            flux = ausm.ausm_flux(lay, bg.rows(v, nodes), v_ghost, -normal,
                                  prm.m_infty)
        res = bg.add_rows(res, nodes, flux)
    for bc in bcs:
        if bc.kind == "riemann":
            from su2_tpu.solvers import riemann as rie
            rn, rflux, _ = rie.riemann_flux(lib, lay, bc, v, dpdu_full,
                                            prm.tparams, prm.tke_inf)
            res = bg.add_rows(res, rn, rflux)
    return res


def total_residual(lib, lay, mesh, prm, bcs, v, omega_turb=None, turb_ke=None):
    q = gradient_vars(lay, v)
    grad = compute_gradients(mesh, prm, q)
    if prm.use_limiter:
        if prm.limiter_kind == "BARTH_JESPERSEN":
            lim = limiters.barth_jespersen(mesh, q, grad)
        else:
            lim = limiters.venkatakrishnan(
                mesh, q, grad, prm.limiter_coeff, prm.ref_elem_length)
    else:
        lim = jnp.ones_like(q)
    res = convective_residual(lib, lay, mesh, prm, v, grad, lim)
    dpdu_full = st.dpdu(lib, lay, v)
    res = res + bc_residuals(lib, lay, mesh, prm, bcs, v, dpdu_full, turb_ke)
    if prm.reactive_sources:
        res = res + chemistry_source_residual(lib, lay, mesh, prm, v, omega_turb)
    if prm.rotating_source:
        from su2_tpu import motion as mo
        res = res + mo.rotating_frame_source(lay, v, prm.rotation_rate,
                                             mesh.volume)
    if prm.axisymmetric or prm.gravity:
        res = res + body_source_residual(lay, mesh, prm, v)
    if mesh.pg_src is not None:
        # rotational-periodic ghost rows carry no equations (their state is
        # refreshed from the donors every iteration)
        res = res.at[mesh.pg_start:].set(0.0)
    return res, grad


# --------------------------------------------------------------------------
# Implicit system assembly
# --------------------------------------------------------------------------

def _row_gamma_vel2(lay, vrow):
    """gamma = a^2 rho / P and |v|^2 from a primitive row batch."""
    gamma = vrow[:, lay.A] ** 2 * vrow[:, lay.PRHO] / vrow[:, lay.P]
    vel = vrow[:, lay.VX:lay.VX + lay.ndim]
    return gamma, jnp.sum(vel * vel, axis=1)


def convective_system(lib, lay, mesh, prm, v, grad, lim, dpdu_full):
    """Convective residual + edge Jacobian blocks (Upwind_Residual implicit
    path, solver_direct_reactive.cpp:2687-2768)."""
    from su2_tpu.linalg.blockcsr import BlockJacobian

    i, j = mesh.edges[:, 0], mesh.edges[:, 1]
    if prm.conv_method in ("JST", "LAX-FRIEDRICH"):
        flux, jac_i, jac_j = _centered_parts(
            lib, lay, mesh, prm, v, dpdu_full, True)
        res = mesh.scatter_edges(flux)
        diag = mesh.accumulate_sides(jac_i, -jac_j)
        return res, BlockJacobian(diag=diag, off_ij=jac_j, off_ji=-jac_i)
    if prm.muscl:
        v_i, v_j = muscl_reconstruct(lib, lay, mesh, prm, v, grad, lim)
        g_i, vel2_i = _row_gamma_vel2(lay, v_i)
        g_j, vel2_j = _row_gamma_vel2(lay, v_j)
        s_i = ghost_dpdu(lib, lay, v_i, g_i, vel2_i)
        s_j = ghost_dpdu(lib, lay, v_j, g_j, vel2_j)
    else:
        v_i, v_j = v[i], v[j]
        s_i, s_j = dpdu_full[i], dpdu_full[j]
    flux, jac_i, jac_j = ausm.ausm_flux(
        lay, v_i, v_j, mesh.edge_normal, prm.m_infty, s_i, s_j)
    if prm.conv_method == "ROE":
        # Roe residual with the AUSM approximate linearization (defect
        # correction: the outer Newton converges to the Roe solution).
        # ALE face speed rides the Roe flux exactly like the explicit
        # path (round-4 fix: the implicit assembly previously dropped
        # grid_vel on interior edges, so implicit moving-grid runs —
        # gust FVM, aeroelastic, implicit HB pitching — saw the mesh
        # displacement but not the mesh velocity)
        from su2_tpu.ops import roe
        qg = None
        if prm.grid_vel is not None:
            ug = prm.grid_vel
            qg = 0.5 * jnp.einsum("ed,ed->e", ug[i] + ug[j],
                                  mesh.edge_normal) / mesh.edge_area
        flux = roe.roe_flux(lay, v_i, v_j, mesh.edge_normal, qg=qg,
                            entropy_fix=prm.entropy_fix)
    elif prm.conv_method == "HLLC":
        # HLLC residual, AUSM linearization (same defect-correction idea)
        from su2_tpu.ops import hllc
        flux = hllc.hllc_flux(lay, v_i, v_j, mesh.edge_normal)
    res = mesh.scatter_edges(flux)
    # diag: +jac_i at i, -jac_j at j; off-diagonals: (i,j)=+jac_j, (j,i)=-jac_i
    diag = mesh.accumulate_sides(jac_i, -jac_j)
    return res, BlockJacobian(diag=diag, off_ij=jac_j, off_ji=-jac_i)


def convective_system_fam(lib, lay, mesh, prm, v, grad, lim, dpdu_full):
    """Family-major convective residual + edge Jacobians (AUSM only).

    Assembles on the virtual (Kh*nP) family edge set so the off-diagonal
    blocks land directly in the static-stencil layout (see
    blockcsr.FamilyJacobian) — no edge gathers, no gather_offdiag relayout
    copies.  Returns (res, diag, jac_ij, jac_ji) with jac_* (Kh*nP, v, v)
    masked to zero on padding slots."""
    gi, gj = mesh.fam_gather_i, mesh.fam_gather_j
    normal = mesh.fam_normal_flat
    valid = mesh.fam_valid_flat
    if prm.muscl:
        v_i, v_j = muscl_reconstruct_fam(lib, lay, mesh, prm, v, grad, lim)
        g_i, vel2_i = _row_gamma_vel2(lay, v_i)
        g_j, vel2_j = _row_gamma_vel2(lay, v_j)
        s_i = ghost_dpdu(lib, lay, v_i, g_i, vel2_i)
        s_j = ghost_dpdu(lib, lay, v_j, g_j, vel2_j)
    else:
        v_i, v_j = gi(v), gj(v)
        s_i, s_j = gi(dpdu_full), gj(dpdu_full)
    flux, jac_i, jac_j = ausm.ausm_flux(
        lay, v_i, v_j, normal, prm.m_infty, s_i, s_j)
    # null padding slots (zero-normal rows can produce NaN through the
    # unit-normal division; where() selects the zero)
    flux = jnp.where(valid[:, None], flux, 0.0)
    jac_i = jnp.where(valid[:, None, None], jac_i, 0.0)
    jac_j = jnp.where(valid[:, None, None], jac_j, 0.0)
    res = mesh.fam_scatter(flux)
    diag = mesh.fam_accum(jac_i, -jac_j)
    # off (i,j) = +jac_j, (j,i) = -jac_i (same signs as convective_system)
    return res, diag, jac_j, -jac_i


def euler_wall_jacobian(lib, lay, nodes, normal, v, dpdu_full):
    """d(pressure wall flux)/dU (BC_Euler_Wall implicit part, :2950-2974)."""
    area = jnp.linalg.norm(normal, axis=1)
    unit = -normal / area[:, None]
    jac = jnp.zeros((nodes.shape[0], lay.nvar, lay.nvar), dtype=v.dtype)
    contrib = (unit * area[:, None])[:, :, None] * bg.rows(dpdu_full, nodes)[:, None, :]
    jac = jac.at[:, lay.RHOVX:lay.RHOVX + lay.ndim, :].set(contrib)
    return jac


def bc_system(lib, lay, mesh, prm, bcs, v, dpdu_full, turb_ke=None):
    """Weak-BC residual + diagonal Jacobian contributions (batched over the
    concatenated marker face sets, see flux_bc_batch)."""
    n = v.shape[0]
    res = jnp.zeros((n, lay.nvar), dtype=v.dtype)
    diag = jnp.zeros((n, lay.nvar, lay.nvar), dtype=v.dtype)
    wb = wall_bc_batch(bcs)
    if wb is not None:
        wn, wnorm = wb
        res = bg.add_rows(res, wn,
                          euler_wall_residual(lib, lay, wn, wnorm, v,
                                              turb_ke,
                                              grid_vel=prm.grid_vel))
        diag = bg.add_rows(diag, wn,
                           euler_wall_jacobian(lib, lay, wn, wnorm, v,
                                               dpdu_full))
    fb = flux_bc_batch(lib, lay, bcs, v, dpdu_full, prm.tke_inf, mesh.coords)
    if fb is not None:
        nodes, _, normal, v_ghost, gamma, vel2 = fb
        s_ghost = ghost_dpdu(lib, lay, v_ghost, gamma, vel2)
        flux, jac_i, _ = ausm.ausm_flux(
            lay, bg.rows(v, nodes), v_ghost, -normal, prm.m_infty,
            bg.rows(dpdu_full, nodes), s_ghost)
        if prm.grid_vel is not None:
            # moving grids: ALE Roe residual on the boundary faces (same
            # as bc_residuals' explicit path); AUSM linearization kept
            from su2_tpu.ops import roe
            area_b = jnp.linalg.norm(normal, axis=1)
            qg_b = jnp.einsum("ed,ed->e", bg.rows(prm.grid_vel, nodes),
                              -normal) / area_b
            flux = roe.roe_flux(lay, bg.rows(v, nodes), v_ghost, -normal,
                                qg=qg_b, entropy_fix=prm.entropy_fix)
        res = bg.add_rows(res, nodes, flux)
        diag = bg.add_rows(diag, nodes, jac_i)
    for bc in bcs:
        if bc.kind == "riemann":
            from su2_tpu.solvers import riemann as rie
            rn, rflux, rjac = rie.riemann_flux(lib, lay, bc, v, dpdu_full,
                                               prm.tparams, prm.tke_inf)
            res = bg.add_rows(res, rn, rflux)
            diag = bg.add_rows(diag, rn, rjac)
    return res, diag


def chemistry_source_system(lib, lay, mesh, prm, v, dtdu_full, omega_turb=None):
    """Source residual + diagonal Jacobian (CSourceReactive::ComputeChemistry
    implicit part, numerics_direct_reactive.cpp:1826-1878)."""
    t = v[:, lay.T]
    rho = v[:, lay.PRHO]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    rf, rb, kc = cl.reaction_rates(lib, t, rho, ys)
    om = cl.omega_tensor(lib, rf, rb)
    if prm.pasr and omega_turb is not None:
        dfr = cl.dfr_drho(lib, rf, rb, rho, ys)
        k = cl.pasr_constants(lib, dfr, omega_turb, prm.c_mu, prm.pasr_lb)
        omega = cl.mass_production(lib, om, k)
        sjac = cl.source_jacobian(lib, t, rho, ys, rf, rb, kc, k)
    else:
        omega = cl.mass_production(lib, om)
        sjac = cl.source_jacobian(lib, t, rho, ys, rf, rb, kc)
    vol = mesh.volume
    res = jnp.zeros((v.shape[0], lay.nvar), dtype=v.dtype)
    res = res.at[:, lay.RHOS:lay.RHOS + lay.ns].set(-omega * vol[:, None])
    # rows: species only.  J[s, col] = -fixed_s * dTdU[col] * Vol
    #                                  (- species-block for species cols)
    diag = jnp.zeros((v.shape[0], lay.nvar, lay.nvar), dtype=v.dtype)
    fixed = sjac[:, :, 0]                                    # d omega_s / dT
    rows = -(fixed[:, :, None] * dtdu_full[:, None, :]) * vol[:, None, None]
    diag = diag.at[:, lay.RHOS:lay.RHOS + lay.ns, :].add(rows)
    diag = diag.at[:, lay.RHOS:lay.RHOS + lay.ns,
                   lay.RHOS:lay.RHOS + lay.ns].add(
        -sjac[:, :, 1:] * vol[:, None, None])
    return res, diag


def assemble_system(lib, lay, mesh, prm, bcs, v, dt, omega_turb=None,
                    turb_ke=None):
    """Full residual + block Jacobian + time diagonal; returns (res, jac)."""
    from su2_tpu.linalg.blockcsr import BlockJacobian

    q = gradient_vars(lay, v)
    grad = compute_gradients(mesh, prm, q)
    if prm.use_limiter:
        if prm.limiter_kind == "BARTH_JESPERSEN":
            lim = limiters.barth_jespersen(mesh, q, grad)
        else:
            lim = limiters.venkatakrishnan(
                mesh, q, grad, prm.limiter_coeff, prm.ref_elem_length)
    else:
        lim = jnp.ones_like(q)
    dpdu_full = st.dpdu(lib, lay, v)
    res, jac = convective_system(lib, lay, mesh, prm, v, grad, lim, dpdu_full)
    bres, bdiag = bc_system(lib, lay, mesh, prm, bcs, v, dpdu_full, turb_ke)
    res = res + bres
    diag = jac.diag + bdiag
    if prm.reactive_sources:
        dtdu_full = st.dtdu(lib, lay, v)
        sres, sdiag = chemistry_source_system(
            lib, lay, mesh, prm, v, dtdu_full, omega_turb)
        res = res + sres
        diag = diag + sdiag
    if prm.axisymmetric or prm.gravity:
        bres, bsdiag = body_source_system(lay, mesh, prm, v, dpdu_full)
        res = res + bres
        if bsdiag is not None:
            diag = diag + bsdiag
    # time term: Vol/dt on the diagonal; frozen rows where dt ~ 0
    ok = dt > EPS
    delta = jnp.where(ok, mesh.volume / jnp.where(ok, dt, 1.0), 0.0)
    eye = jnp.eye(lay.nvar, dtype=v.dtype)
    diag = diag + delta[:, None, None] * eye
    diag = jnp.where(ok[:, None, None], diag, eye)
    res = jnp.where(ok[:, None], res, 0.0)
    return res, BlockJacobian(diag=diag, off_ij=jac.off_ij, off_ji=jac.off_ji)


def implicit_euler_update(lib, lay, mesh, prm, bcs, u, v, dt, lower, upper,
                          relax: float = 1.0, linear_solver: str = "FGMRES",
                          linear_iter: int = 5, linear_tol: float = 1e-6,
                          omega_turb=None, turb_ke=None,
                          precond: str = "JACOBI", color_masks=None,
                          hb_src=None):
    """One implicit Euler step (ImplicitEuler_Iteration,
    solver_direct_reactive.cpp:2336-2407): solve J dU = -R, clipped update.

    hb_src: harmonic-balance spectral source (N, nvar), added to the
    residual times Volume with NO Jacobian contribution (the reference's
    explicit HB-source semantics, solver_direct_mean.cpp:5174-5193)."""
    from su2_tpu.linalg import blockcsr, krylov

    res, jac = assemble_system(lib, lay, mesh, prm, bcs, v, dt,
                               omega_turb, turb_ke)
    if hb_src is not None:
        res = res + hb_src * mesh.volume[:, None]
    rhs = -res
    mv, pc = blockcsr.make_solver_ops(mesh, jac, precond, color_masks)
    if linear_solver == "BCGSTAB":
        sol, rel_res, iters = krylov.bcgstab(mv, pc, rhs,
                                             max_iter=linear_iter,
                                             tol=linear_tol)
    else:
        sol, rel_res, iters = krylov.fgmres(mv, pc, rhs,
                                            max_iter=linear_iter,
                                            tol=linear_tol)
    u_new = jnp.clip(u + relax * sol, lower, upper)
    rms = jnp.sqrt(jnp.mean(rhs * rhs, axis=0))
    rmax = jnp.abs(rhs).max(axis=0)
    return u_new, rms, rmax, iters


# --------------------------------------------------------------------------
# Explicit update
# --------------------------------------------------------------------------

def clip_limits(lay: Layout, dtype):
    """Per-variable solution bounds (solver_direct_reactive.cpp:298-302):
    rho, rhoE? -> see reference: momentum and energy unbounded below; density
    and species floored at 0."""
    lower = np.zeros(lay.nvar)
    lower[lay.RHOVX:lay.RHOVX + lay.ndim] = -1.0 / EPS
    lower[lay.RHOE] = -1.0 / EPS
    upper = np.full(lay.nvar, 1.0 / EPS)
    return jnp.asarray(lower, dtype=dtype), jnp.asarray(upper, dtype=dtype)


def explicit_euler_update(lay, mesh, u, res, dt, lower, upper, alpha=1.0):
    """U <- clip(U - alpha * R * dt/Vol) (ExplicitEuler_Iteration, :2414-2449);
    returns (U_new, RMS residual per variable)."""
    delta = jnp.where(mesh.volume > EPS, dt / mesh.volume, 0.0)
    u_new = u - alpha * res * delta[:, None]
    u_new = jnp.clip(u_new, lower, upper)
    rms = jnp.sqrt(jnp.mean(res * res, axis=0))
    rmax = jnp.abs(res).max(axis=0)
    return u_new, rms, rmax
