"""Debug instrumentation (the fork's DEBUG_* cfg flags, jit-compatible).

The reference gates ~27 'Debug structure' print blocks inside its hot loops
(config_structure.cpp:713-723; e.g. solver_direct_reactive.cpp:2819,
numerics_direct_reactive.cpp:1783).  Printing per-edge inside a jitted device
program is the wrong tool, so the equivalent here is a one-shot diagnostic
dump: given the current state, recompute every intermediate the reference
would print and return it as named host arrays.  Which groups are computed
follows the same cfg flags.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from su2_tpu import state as st
from su2_tpu.chemistry import library as cl
from su2_tpu.ops import viscous as vis
from su2_tpu.solvers import euler as es
from su2_tpu.solvers import ns as nssol
from su2_tpu.ops import timestep


def debug_dump(sim, u, t_guess, turb_state=None) -> dict:
    """Recompute and return the reference's debug quantities.

    Keys are grouped by the cfg flag that would print them:
      DEBUG_PRIM_VAR:     V, mu, kappa, mu_t
      DEBUG_TIME:         lambda_inv, dt
      DEBUG_SOURCE:       omega, pasr_k, dfr_drho, source_jacobian
      DEBUG_VISCOUS_FLOW: viscous edge flux
      DEBUG_TURB_VAR:     k, omega_t, F1, F2, muT
    Only groups whose flag is set in the cfg are computed (all if none set).
    """
    cfg = sim.cfg
    lib, lay, mesh, prm = sim.lib, sim.lay, sim.mesh, sim.params
    flags = dict(prim=cfg.debug_prim_var, time=cfg.debug_time,
                 source=cfg.debug_source, visc=cfg.debug_viscous_flow,
                 turb=cfg.debug_turb_var)
    if not any(flags.values()):
        flags = {k: True for k in flags}

    out: dict[str, np.ndarray] = {}
    tke = turb_state[0][:, 0] if turb_state is not None else None
    u2, v, nonphys = st.cons2prim(lib, lay, u, t_guess, sim.tparams,
                                  turb_ke=tke)
    if flags["prim"]:
        out["V"] = np.asarray(v)
        out["nonphysical"] = np.asarray(nonphys)
        if cfg.viscous:
            trans = vis.node_transport(lib, lay, v)
            out["laminar_viscosity"] = np.asarray(trans.mu)
            out["thermal_conductivity"] = np.asarray(trans.kappa)
            out["binary_diffusion"] = np.asarray(trans.dij)
    if flags["time"]:
        dt, min_dt, max_dt = timestep.local_time_step(
            mesh, lay, v, prm.cfl, prm.max_dt)
        out["dt"] = np.asarray(dt)
        out["min_dt"] = float(min_dt)
        out["max_dt"] = float(max_dt)
    if flags["source"] and sim.lib.nreactions > 0:
        t = v[:, lay.T]
        rho = v[:, lay.PRHO]
        ys = v[:, lay.YS:lay.YS + lay.ns]
        rf, rb, kc = cl.reaction_rates(lib, t, rho, ys)
        om = cl.omega_tensor(lib, rf, rb)
        out["forward_rates"] = np.asarray(rf)
        out["backward_rates"] = np.asarray(rb)
        out["omega_i_r"] = np.asarray(om)
        dfr = cl.dfr_drho(lib, rf, rb, rho, ys)
        out["dfr_drho"] = np.asarray(dfr)
        if turb_state is not None:
            k = cl.pasr_constants(lib, dfr, turb_state[0][:, 1],
                                  prm.c_mu, prm.pasr_lb)
            out["pasr_k"] = np.asarray(k)
            out["omega"] = np.asarray(cl.mass_production(lib, om, k))
        else:
            out["omega"] = np.asarray(cl.mass_production(lib, om))
        sjac = cl.source_jacobian(lib, t, rho, ys, rf, rb, kc)
        out["source_jacobian"] = np.asarray(sjac)
    if flags["turb"] and turb_state is not None:
        from su2_tpu.turbulence import sst
        q, mu_t = turb_state[0], turb_state[1]
        grad = es.compute_gradients(mesh, prm, vis.ns_gradient_vars(lib, lay, v))
        gq = es.compute_gradients(mesh, prm, q, vel_rows=None)
        trans = vis.node_transport(lib, lay, v)
        f1, f2, cdkw = sst.blending(q[:, 0], q[:, 1], gq[:, 0, :], gq[:, 1, :],
                                    trans.mu, v[:, lay.PRHO], sim.wall_dist)
        strain, vort = sst.strain_and_vorticity(lay, grad)
        out.update(tke=np.asarray(q[:, 0]), omega_turb=np.asarray(q[:, 1]),
                   F1=np.asarray(f1), F2=np.asarray(f2),
                   CDkw=np.asarray(cdkw), mu_t=np.asarray(mu_t),
                   strain_mag=np.asarray(strain), vorticity=np.asarray(vort))
    return out
