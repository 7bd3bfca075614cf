"""Flow state: conserved/primitive layouts and conversions.

Re-implements CReactiveEulerVariable / CReactiveNSVariable state handling
(reference: SU2_CFD/src/variable_direct_reactive.cpp) as batched pure
functions.

Layouts (variable_direct_reactive.cpp:339-341, index maps
variable_reactive.hpp:48-76):

  U = [rho, rho*u, rho*v, (rho*w), rho*E, rho_1, ..., rho_Ns]   nVar = Ns+nDim+2
  V = [T, u, v, (w), P, rho, h_tot, a, Y_1, ..., Y_Ns]          nPrim = Ns+nDim+5

Note V[H] stores TOTAL enthalpy (rhoE + P)/rho.  The temperature comes from a
fixed-iteration vectorized secant on the enthalpy spline with a masked
bisection fallback (reference: secant 7 its tol 1e-6 + bisection 32 its tol
1e-4, variable_direct_reactive.cpp:385-390), made branchless and masked
per cell.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from su2_tpu.chemistry import library as cl
from su2_tpu.chemistry.library import ChemLib

EPS = 1e-16


@dataclass(frozen=True)
class Layout:
    """Static index layout for a given (ndim, nspecies)."""
    ndim: int
    ns: int

    # conserved
    @property
    def RHO(self):
        return 0

    @property
    def RHOVX(self):
        return 1

    @property
    def RHOE(self):
        return 1 + self.ndim

    @property
    def RHOS(self):
        return 2 + self.ndim

    @property
    def nvar(self):
        return self.ns + self.ndim + 2

    # primitive
    @property
    def T(self):
        return 0

    @property
    def VX(self):
        return 1

    @property
    def P(self):
        return self.ndim + 1

    @property
    def PRHO(self):
        return self.ndim + 2

    @property
    def H(self):
        return self.ndim + 3

    @property
    def A(self):
        return self.ndim + 4

    @property
    def YS(self):
        return self.ndim + 5

    @property
    def nprim(self):
        return self.ns + self.ndim + 5


@dataclass(frozen=True)
class TSolveParams:
    tmin: float = 200.0
    tmax: float = 6000.0
    clip_temp: bool = False       # CLIPPING_TEMPRATURE cfg flag
    secant_iters: int = 7
    secant_tol: float = 1.0e-6
    bisect_iters: int = 32
    bisect_tol: float = 1.0e-4


def solve_temperature(lib: ChemLib, c1: jax.Array, c2: jax.Array, ys: jax.Array,
                      t_init: jax.Array, p: TSolveParams):
    """Solve T - C1 - C2*h(T,Y) = 0 per cell (Cons2PrimVar secant+bisection,
    variable_direct_reactive.cpp:398-502), branchless.

    c1 = (-rhoE + 0.5 rho |v|^2)/(rho R),  c2 = 1/R.
    Returns (T, converged_by_secant mask).
    """
    def f_of(t):
        return t - c1 - c2 * cl.mixture_enthalpy(lib, t, ys)

    # --- masked secant with early exit (while_loop: typically 2-4 rounds
    #     from the previous-step temperature, so the average cost is far
    #     below the reference's fixed 7-iteration budget) ---
    t0 = t_init
    t_old0 = t_init + 1.0
    done0 = jnp.zeros_like(t0, dtype=bool)

    def secant_cond(carry):
        it, t, t_old, h_old, done = carry
        return (it < p.secant_iters) & ~jnp.all(done)

    # the reference's 1e-6 K tolerance is unreachable in f32 (ulp at 300 K
    # is ~3e-5), which would push EVERY cell into the 32-round bisection
    # fallback; widen to a few ulps of T in low precision (no-op in f64)
    eps4 = 4.0 * float(jnp.finfo(t_init.dtype).eps)

    def secant_body(carry):
        it, t, t_old, h_old, done = carry
        f = t - c1 - c2 * cl.mixture_enthalpy(lib, t, ys)
        f_old = t_old - c1 - c2 * h_old
        df = f - f_old
        safe_df = jnp.where(df == 0.0, 1.0, df)
        t_new = t - f * (t - t_old) / safe_df
        t_new = jnp.where(df == 0.0, t, t_new)
        # bound the iterate to the representable spline domain: a blown-up
        # cell (rho at the clip floor, |e| ~ 1e22) otherwise drives t_new to
        # ~1e31 and the cubic's (a^3 - a) term overflows f32 to NaN; such
        # cells simply fail secant and land in the clipped bisection, which
        # is the reference's fallback for wild states too (:433)
        t_new = jnp.clip(t_new, -1.0e8, 1.0e8)
        converged = jnp.abs(t_new - t) \
            < jnp.maximum(p.secant_tol, eps4 * jnp.abs(t_new))
        new_done = done | converged
        t_next = jnp.where(done | converged, t, t_new)
        t_old_next = jnp.where(done, t_old, t)
        h_next = jnp.where(done, h_old, (t - c1 - f) / c2)  # h at t
        return it + 1, t_next, t_old_next, h_next, new_done

    h_old0 = cl.mixture_enthalpy(lib, t_old0, ys)
    _, t, t_old, _, done = jax.lax.while_loop(
        secant_cond, secant_body, (0, t0, t_old0, h_old0, done0))
    secant_ok = done

    # --- bisection fallback on [Tmin, Tmax], skipped entirely when every
    #     cell converged by secant (lax.cond executes one branch) ---
    def run_bisection(_):
        ta0 = jnp.full_like(t, p.tmin)
        tb0 = jnp.full_like(t, p.tmax)

        def bisect_body(_, carry):
            ta, tb, tbis, bis_done = carry
            tm = 0.5 * (ta + tb)
            f = f_of(tm)
            # |f| test is the reference criterion; the interval-collapse
            # test stops in low precision where the f-tolerance is below
            # roundoff of c2*h (f32: ~25 rounds would otherwise be no-ops)
            converged = (jnp.abs(f) < p.bisect_tol) \
                | ((tb - ta) < eps4 * jnp.abs(tm))
            go_low = f > 0.0
            ta_n = jnp.where(bis_done | converged, ta, jnp.where(go_low, tm, ta))
            tb_n = jnp.where(bis_done | converged, tb, jnp.where(go_low, tb, tm))
            tbis_n = jnp.where(bis_done, tbis, tm)
            return ta_n, tb_n, tbis_n, bis_done | converged

        _, _, tbis, _ = jax.lax.fori_loop(
            0, p.bisect_iters, bisect_body,
            (ta0, tb0, 0.5 * (ta0 + tb0), jnp.zeros_like(t, dtype=bool)))
        return tbis

    tbis = jax.lax.cond(jnp.all(secant_ok), lambda _: t, run_bisection,
                        operand=None)
    t_final = jnp.where(secant_ok, t, tbis)
    return t_final, secant_ok


def cons2prim(lib: ChemLib, lay: Layout, u: jax.Array, t_guess: jax.Array,
              p: TSolveParams, turb_ke: jax.Array | None = None,
              first_iter: bool = False):
    """Batched Cons2PrimVar (variable_direct_reactive.cpp:325-561).

    u: (N, nVar); t_guess: (N,) previous temperature (secant start).
    turb_ke: (N,) SST turbulent kinetic energy to subtract from rhoE
    (MANGOTURB overload, :596).  Returns (u_clipped, v, nonphys_mask).
    """
    n = u.shape[0]
    rho_s = u[:, lay.RHOS:lay.RHOS + lay.ns]
    nonphys = jnp.any(rho_s < 0.0, axis=1)
    rho_s = jnp.where(rho_s < 0.0, 1.0e-30, rho_s)

    rho = u[:, lay.RHO]
    nonphys = nonphys | (rho < EPS)
    rho = jnp.maximum(rho, EPS)

    ys = rho_s / rho[:, None]
    nonphys = nonphys | (jnp.abs(ys.sum(1) - 1.0) > 0.1)

    vel = u[:, lay.RHOVX:lay.RHOVX + lay.ndim] / rho[:, None]
    sqvel = jnp.sum(vel * vel, axis=1)

    rho_e = u[:, lay.RHOE]
    if turb_ke is not None:
        rho_e = rho_e - rho * turb_ke

    rgas = cl.mixture_rgas(lib, ys)
    c1 = (-rho_e + 0.5 * rho * sqvel) / (rho * rgas)
    c2 = 1.0 / rgas

    t, _ = solve_temperature(lib, c1, c2, ys, t_guess, p)

    # avoid too-large variation (CLIPPING_TEMPRATURE, :505-506)
    if p.clip_temp and not first_iter:
        t = jnp.clip(t, 0.95 * t_guess, 1.05 * t_guess)

    nonphys = nonphys | (t < p.tmin) | (t > p.tmax)
    t = jnp.clip(t, p.tmin, p.tmax)

    press = rho * rgas * t
    nonphys = nonphys | (press < EPS)
    press = jnp.maximum(press, EPS)

    gamma, _ = cl.frozen_gamma_sound(lib, t, ys)
    sound = jnp.sqrt(gamma * press / rho)
    nonphys = nonphys | (sound < EPS)
    sound = jnp.maximum(sound, EPS)

    htot = (u[:, lay.RHOE] + press) / rho

    v = jnp.zeros((n, lay.nprim), dtype=u.dtype)
    v = v.at[:, lay.T].set(t)
    v = v.at[:, lay.VX:lay.VX + lay.ndim].set(vel)
    v = v.at[:, lay.P].set(press)
    v = v.at[:, lay.PRHO].set(rho)
    v = v.at[:, lay.H].set(htot)
    v = v.at[:, lay.A].set(sound)
    v = v.at[:, lay.YS:lay.YS + lay.ns].set(ys)

    u_clipped = u.at[:, lay.RHOS:lay.RHOS + lay.ns].set(rho_s) \
                 .at[:, lay.RHO].set(rho)
    return u_clipped, v, nonphys


@dataclass(frozen=True)
class NodeState:
    """Bundle of all per-node derived state one preprocessing pass produces
    (SetPrimitive_Variables + CalcdTdU/CalcdPdU + transport properties,
    solver_direct_reactive.cpp:985-1038 + variable_direct_reactive.cpp)."""
    u: jax.Array        # clipped conserved (N, nVar)
    v: jax.Array        # primitives (N, nPrim)
    nonphys: jax.Array  # (N,) bool
    dtdu: jax.Array     # (N, nVar)
    dpdu: jax.Array     # (N, nVar)
    mu: jax.Array       # (N,) laminar viscosity
    kappa: jax.Array    # (N,) conductivity
    xs: jax.Array       # (N, S) mole fractions


jax.tree_util.register_dataclass(
    NodeState, data_fields=["u", "v", "nonphys", "dtdu", "dpdu", "mu",
                            "kappa", "xs"], meta_fields=[])


@dataclass
class NodeStateLite:
    """Reduced node-state bundle for the turbulence phase: the second
    Cons2Prim pass per outer iteration only feeds the turb system, which
    reads v, X_s, mu and dP/dU's RHOE entry (driver.py) — dT/dU, the rest
    of dP/dU and kappa are recomputed next iteration anyway (with the
    updated turbulent kinetic energy in the secant)."""
    u: jax.Array        # clipped conserved (N, nVar)
    v: jax.Array        # primitives (N, nPrim)
    nonphys: jax.Array  # (N,) bool
    gm1: jax.Array      # (N,) dP/dU[RHOE] = gamma - 1
    mu: jax.Array       # (N,) laminar viscosity
    xs: jax.Array       # (N, S) mole fractions


jax.tree_util.register_dataclass(
    NodeStateLite, data_fields=["u", "v", "nonphys", "gm1", "mu", "xs"],
    meta_fields=[])

def node_state(lib: ChemLib, lay: Layout, u: jax.Array, t_guess: jax.Array,
               p: TSolveParams, turb_ke: jax.Array | None = None
               ) -> NodeState:
    """One preprocessing pass: Cons2Prim + dT/dU + dP/dU + Wilke transport +
    mole fractions.  Under jit, unused fields are dead-code-eliminated, so
    callers can always use this entry point."""
    uc, v, nonphys = cons2prim(lib, lay, u, t_guess, p, turb_ke=turb_ke)
    t = v[:, lay.T]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    return NodeState(
        uc, v, nonphys, dtdu(lib, lay, v), dpdu(lib, lay, v),
        cl.mixture_viscosity(lib, t, ys), cl.mixture_conductivity(lib, t, ys),
        cl.molar_from_mass(lib, ys))


def node_state_lite(lib: ChemLib, lay: Layout, u: jax.Array,
                    t_guess: jax.Array, p: TSolveParams,
                    turb_ke: jax.Array | None = None) -> NodeStateLite:
    """Reduced preprocessing pass for the turbulence phase (see
    NodeStateLite); jit's dead-code elimination trims the unused chains."""
    uc, v, nonphys = cons2prim(lib, lay, u, t_guess, p, turb_ke=turb_ke)
    t = v[:, lay.T]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    return NodeStateLite(
        uc, v, nonphys, dpdu(lib, lay, v)[:, lay.RHOE],
        cl.mixture_viscosity(lib, t, ys), cl.molar_from_mass(lib, ys))


def prim2cons(lib: ChemLib, lay: Layout, v: jax.Array) -> jax.Array:
    """Prim2ConsVar (variable_direct_reactive.cpp:861-880)."""
    n = v.shape[0]
    rho = v[:, lay.PRHO]
    u = jnp.zeros((n, lay.nvar), dtype=v.dtype)
    u = u.at[:, lay.RHO].set(rho)
    u = u.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(
        rho[:, None] * v[:, lay.VX:lay.VX + lay.ndim])
    u = u.at[:, lay.RHOE].set(rho * v[:, lay.H] - v[:, lay.P])
    u = u.at[:, lay.RHOS:lay.RHOS + lay.ns].set(
        rho[:, None] * v[:, lay.YS:lay.YS + lay.ns])
    return u


def dtdu(lib: ChemLib, lay: Layout, v: jax.Array) -> jax.Array:
    """dT/dU (CalcdTdU, variable_direct_reactive.cpp:786-816). (N, nVar)."""
    t = v[:, lay.T]
    rho = v[:, lay.PRHO]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    cp = cl.mixture_cp(lib, t, ys)
    cv = cp - cl.mixture_rgas(lib, ys)
    rho_cv = rho * cv
    sqvel = jnp.sum(vel * vel, axis=1)
    e_s = cl.species_energy(lib, t)         # dT/dY_s numerators

    out = jnp.zeros((v.shape[0], lay.nvar), dtype=v.dtype)
    out = out.at[:, lay.RHO].set(0.5 * sqvel / rho_cv)
    out = out.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(-vel / rho_cv[:, None])
    out = out.at[:, lay.RHOE].set(1.0 / rho_cv)
    out = out.at[:, lay.RHOS:lay.RHOS + lay.ns].set(-e_s / rho_cv[:, None])
    return out


def dpdu(lib: ChemLib, lay: Layout, v: jax.Array) -> jax.Array:
    """dP/dU (CalcdPdU, variable_direct_reactive.cpp:822-849). (N, nVar)."""
    t = v[:, lay.T]
    ys = v[:, lay.YS:lay.YS + lay.ns]
    vel = v[:, lay.VX:lay.VX + lay.ndim]
    gamma, _ = cl.frozen_gamma_sound(lib, t, ys)
    sqvel = jnp.sum(vel * vel, axis=1)
    e_s = cl.species_energy(lib, t)

    out = jnp.zeros((v.shape[0], lay.nvar), dtype=v.dtype)
    out = out.at[:, lay.RHO].set((gamma - 1.0) * 0.5 * sqvel)
    out = out.at[:, lay.RHOVX:lay.RHOVX + lay.ndim].set(
        (1.0 - gamma)[:, None] * vel)
    out = out.at[:, lay.RHOE].set(gamma - 1.0)
    out = out.at[:, lay.RHOS:lay.RHOS + lay.ns].set(
        cl_ri_t(lib, t) - (gamma - 1.0)[:, None] * e_s)
    return out


def cl_ri_t(lib: ChemLib, t: jax.Array) -> jax.Array:
    return lib.ri * t[:, None]
