"""Vectorized chemistry/thermo/transport library (ReactingModelLibrary).

Reimplements the capability surface of Framework::ReactingModelLibrary
(reference: Common/src/Framework/reacting_model_library.cpp) as pure functions
over batches of cells.  Where the reference evaluates splines / Arrhenius /
PaSR per cell inside scalar loops, every function here takes T (N,), rho (N,),
Ys (N, S) and returns batched arrays, so XLA fuses the whole chemistry source
into a handful of fused kernels.

All quantities are DIMENSIONAL (SI) exactly like the reference library; the
solver layer handles nondimensionalization.  Molar masses are kept in g/mol
(the reference's convention) so concentrations are c_s = 1e3*rho*Y_s/M_s
[mol/m^3] (reacting_model_library.cpp:701-705).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from su2_tpu.chemistry.spline import spline_eval, spline_second_derivatives
from su2_tpu.io.tables import (R_UNGAS, R_UNGAS_ATM, R_UNGAS_SCAL,
                               LibraryFiles, read_manifest)

# clipping constants from the reference
_Y_FLOOR = 1.0e-30          # vanishing-species clip (SetMassFractions, :73)
_Y_RATE_GUARD = 1.0e-15     # negative-exponent rate guard (:885)
_Y_JAC_GUARD = 1.0e-10      # Jacobian denominator guard (:133)
_KEQ_COMPLETE = 1.0e10      # "complete reaction" Kp threshold (:848)


@dataclass(frozen=True)
class ChemLib:
    """Static chemistry data as device arrays (a pytree; leaves are arrays)."""
    # species data
    mm: jax.Array            # (S,) molar masses [g/mol]
    ri: jax.Array            # (S,) specific gas constants R_ungas/M [J/(kg K)]
    diff_vol: jax.Array      # (S,) Fuller diffusion volumes
    h_form: jax.Array        # (S,) formation enthalpies (as shipped)
    # spline tables on the shared equispaced T grid (molar units, J/kmol...)
    cp_y: jax.Array          # (S, n)
    cp_y2: jax.Array
    h_y: jax.Array
    h_y2: jax.Array
    s_y: jax.Array
    s_y2: jax.Array
    mu_y: jax.Array
    mu_y2: jax.Array
    ka_y: jax.Array
    ka_y2: jax.Array
    # kinetics
    stoich_r: jax.Array      # (S, R)
    stoich_p: jax.Array      # (S, R)
    exp_f: jax.Array         # (R, S)
    exp_b: jax.Array         # (R, S)
    reversible: jax.Array    # (R,) float mask
    arr_a: jax.Array         # (R,)
    arr_beta: jax.Array
    arr_ta: jax.Array
    has_backward: jax.Array  # (R,) float mask
    arr_a_b: jax.Array
    arr_beta_b: jax.Array
    arr_ta_b: jax.Array
    # per-reaction equilibrium tables: ln Kc / ln Kp are pure functions of
    # T, so they are tabulated on the shared grid at setup (exact at the
    # knots where h, s equal their table values) — the runtime Keq becomes
    # one (R, n) spline lookup instead of two (S, n) lookups + Gibbs math
    lnkc_y: jax.Array = None     # (R, n)
    lnkc_y2: jax.Array = None
    lnkp_y: jax.Array = None
    lnkp_y2: jax.Array = None
    # grid metadata (static)
    t0: float = 0.0
    dt: float = 0.0
    nt: int = 0
    nspecies: int = 0
    nreactions: int = 0
    species: tuple = ()


jax.tree_util.register_dataclass(
    ChemLib,
    data_fields=["mm", "ri", "diff_vol", "h_form",
                 "cp_y", "cp_y2", "h_y", "h_y2", "s_y", "s_y2",
                 "mu_y", "mu_y2", "ka_y", "ka_y2",
                 "stoich_r", "stoich_p", "exp_f", "exp_b", "reversible",
                 "arr_a", "arr_beta", "arr_ta", "has_backward",
                 "arr_a_b", "arr_beta_b", "arr_ta_b",
                 "lnkc_y", "lnkc_y2", "lnkp_y", "lnkp_y2"],
    meta_fields=["t0", "dt", "nt", "nspecies", "nreactions", "species"],
)


def load_library(manifest_path: str, lib_path: str | None = None,
                 dtype=jnp.float64) -> ChemLib:
    files = read_manifest(manifest_path, lib_path)
    return build_library(files, dtype)


def ideal_gas_library(gamma: float = 1.4, r_gas: float = 287.058,
                      mu_ref: float = 1.716e-5, t_ref_mu: float = 273.15,
                      s_mu: float = 110.4, prandtl: float = 0.72,
                      viscosity_model: str = "SUTHERLAND",
                      mu_constant: float = 1.716e-5,
                      conductivity_model: str = "CONSTANT_PRANDTL",
                      kt_constant: float = 0.0257,
                      dtype=jnp.float64) -> ChemLib:
    """Single-species calorically-perfect gas as a ChemLib.

    Lets the reactive machinery run the STANDARD solvers (EULER /
    NAVIER_STOKES / RANS — CEulerSolver/CNSSolver capability in the
    reference) with constant cp, Sutherland viscosity and constant-Prandtl
    conductivity (fluid_model_pig.cpp / transport_model.cpp equivalents).
    """
    from su2_tpu.io.tables import (LibraryFiles, MixtureData, SpeciesTable)

    mm = R_UNGAS / r_gas * 1e-3          # g/mol so that R_UNGAS/mm = r_gas...
    # NOTE: library convention keeps molar masses in g/mol and
    # Ri = R_UNGAS / mm, so mm must satisfy R_UNGAS/mm == r_gas:
    mm = R_UNGAS / r_gas
    t = np.arange(50.0, 6005.0, 5.0)
    cp_mass = gamma / (gamma - 1.0) * r_gas
    cp_molar = cp_mass * mm
    h_molar = cp_molar * t
    s_molar = cp_molar * np.log(t)
    if viscosity_model == "CONSTANT_VISCOSITY":
        mu = mu_constant * np.ones_like(t)
    else:  # SUTHERLAND (transport_model.cpp CSutherland)
        mu = mu_ref * (t / t_ref_mu) ** 1.5 * (t_ref_mu + s_mu) / (t + s_mu)
    if conductivity_model == "CONSTANT_CONDUCTIVITY":
        kappa = kt_constant * np.ones_like(t)
    else:  # CONSTANT_PRANDTL (CConstantPrandtl)
        kappa = mu * cp_mass / prandtl
    mix = MixtureData(["AIR"], np.array([mm]), np.array([0.0]), np.array([19.7]))
    thermo = [SpeciesTable("AIR", t, {"cp": cp_molar * np.ones_like(t),
                                      "h": h_molar, "s": s_molar})]
    transp = [SpeciesTable("AIR", t, {"mu": mu, "kappa": kappa})]
    return build_library(LibraryFiles(mix, None, transp, thermo), dtype)


def build_library(files: LibraryFiles, dtype=jnp.float64) -> ChemLib:
    mix = files.mixture
    ns = mix.nspecies

    # shared T grid: the shipped tables all use the same equispaced grid;
    # assert and reuse.
    t = files.thermo[0].temps
    for tab in files.thermo + files.transport:
        assert tab.temps.shape == t.shape and np.allclose(tab.temps, t), \
            "species tables must share one equispaced temperature grid"
    h_step = t[1] - t[0]
    assert np.allclose(np.diff(t), h_step)

    def stack(tabs, col):
        return np.stack([tab.cols[col] for tab in tabs])  # (S, n)

    cp = stack(files.thermo, "cp")
    hh = stack(files.thermo, "h")
    ss = stack(files.thermo, "s")
    mu = stack(files.transport, "mu")
    ka = stack(files.transport, "kappa")

    def spl(yy):
        return spline_second_derivatives(t, yy)

    chem = files.chemistry
    if chem is None:
        nr = 0
        z_sr = np.zeros((ns, 0))
        z_rs = np.zeros((0, ns))
        z_r = np.zeros((0,))
        kin = dict(stoich_r=z_sr, stoich_p=z_sr.copy(), exp_f=z_rs, exp_b=z_rs.copy(),
                   reversible=z_r, arr_a=z_r, arr_beta=z_r, arr_ta=z_r,
                   has_backward=z_r, arr_a_b=z_r, arr_beta_b=z_r, arr_ta_b=z_r)
    else:
        nr = chem.nreactions
        kin = dict(stoich_r=chem.stoich_r, stoich_p=chem.stoich_p,
                   exp_f=chem.exp_f, exp_b=chem.exp_b,
                   reversible=chem.reversible.astype(np.float64),
                   arr_a=chem.arr_a, arr_beta=chem.arr_beta, arr_ta=chem.arr_ta,
                   has_backward=chem.has_backward.astype(np.float64),
                   arr_a_b=chem.arr_a_b, arr_beta_b=chem.arr_beta_b,
                   arr_ta_b=chem.arr_ta_b)

    # ln Kc / ln Kp tables (exact at the knots: h, s are their table values
    # there), splined on the same grid.  ComputeKeq (reacting_model_library
    # .cpp:803-829) evaluated through h/s splines agrees to O(dt^4).
    dcoeff = kin["stoich_p"] - kin["stoich_r"]                     # (S, R)
    g = hh - t[None, :] * ss                                       # (S, n)
    dg = np.einsum("sn,sr->rn", g, dcoeff)
    dnu = dcoeff.sum(0)                                            # (R,)
    lnkp = -dg / (R_UNGAS * t[None, :])
    lnkc = lnkp - dnu[:, None] * np.log(R_UNGAS_ATM * t[None, :])

    # host numpy: the Simulation moves the tables to the device once
    # (driver.py); standalone callers may close over them as constants
    a = lambda x: np.asarray(x, dtype=np.dtype(dtype))
    return ChemLib(
        mm=a(mix.molar_masses), ri=a(R_UNGAS / mix.molar_masses),
        diff_vol=a(mix.diff_volumes), h_form=a(mix.formation_enthalpies),
        cp_y=a(cp), cp_y2=a(spl(cp)), h_y=a(hh), h_y2=a(spl(hh)),
        s_y=a(ss), s_y2=a(spl(ss)), mu_y=a(mu), mu_y2=a(spl(mu)),
        ka_y=a(ka), ka_y2=a(spl(ka)),
        **{k: a(v) for k, v in kin.items()},
        lnkc_y=a(lnkc), lnkc_y2=a(spl(lnkc)),
        lnkp_y=a(lnkp), lnkp_y2=a(spl(lnkp)),
        t0=float(t[0]), dt=float(h_step), nt=int(t.shape[0]),
        nspecies=ns, nreactions=nr, species=tuple(mix.species),
    )


# --------------------------------------------------------------------------
# thermo (per-species splines are molar [J/kmol...]; /M gives specific [J/kg])
# --------------------------------------------------------------------------

def clip_mass_fractions(ys: jax.Array) -> jax.Array:
    """Vanishing-species clip (SetMassFractions, reacting_model_library.cpp:70-75)."""
    return jnp.where(ys < 0.0, _Y_FLOOR, ys)


def species_cp(lib: ChemLib, t: jax.Array) -> jax.Array:
    """(..., S) specific heats [J/(kg K)]."""
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.cp_y, lib.cp_y2, t) / lib.mm


def species_enthalpy(lib: ChemLib, t: jax.Array) -> jax.Array:
    """(..., S) static enthalpies [J/kg] (SetPartialEnthalpy, :503)."""
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.h_y, lib.h_y2, t) / lib.mm


def species_energy(lib: ChemLib, t: jax.Array) -> jax.Array:
    """(..., S) internal energies e_s = h_s - R_s T (SetPartialEnergy, :529)."""
    return species_enthalpy(lib, t) - lib.ri * t[..., None]


def mixture_rgas(lib: ChemLib, ys: jax.Array) -> jax.Array:
    return jnp.einsum("...s,s->...", clip_mass_fractions(ys), lib.ri)


def mixture_cp(lib: ChemLib, t: jax.Array, ys: jax.Array) -> jax.Array:
    return jnp.einsum("...s,...s->...", clip_mass_fractions(ys), species_cp(lib, t))


def mixture_enthalpy(lib: ChemLib, t: jax.Array, ys: jax.Array) -> jax.Array:
    return jnp.einsum("...s,...s->...", clip_mass_fractions(ys), species_enthalpy(lib, t))


def frozen_gamma_sound(lib: ChemLib, t: jax.Array, ys: jax.Array):
    """gamma and frozen sound speed a = sqrt(gamma R T) (:387-394)."""
    cp = mixture_cp(lib, t, ys)
    rg = mixture_rgas(lib, ys)
    gamma = cp / (cp - rg)
    return gamma, jnp.sqrt(gamma * rg * t)


def molar_from_mass(lib: ChemLib, ys: jax.Array) -> jax.Array:
    """X_i = (Y_i/M_i) * sum(Y)/sum(Y_j/M_j) (SetMolarFromMass, :84-93)."""
    ysc = clip_mass_fractions(ys)
    xs = ysc / lib.mm
    return xs * (ysc.sum(-1, keepdims=True) / xs.sum(-1, keepdims=True))


def mass_from_molar(lib: ChemLib, xs: jax.Array) -> jax.Array:
    ysr = xs * lib.mm
    return ysr * (xs.sum(-1, keepdims=True) / ysr.sum(-1, keepdims=True))


def dp_dys(lib: ChemLib, t: jax.Array, gamma: jax.Array, ys=None) -> jax.Array:
    """dP/dY_s = R_s T - (gamma-1) e_s (ComputedP_dYs, :546-551)."""
    return lib.ri * t[..., None] - (gamma[..., None] - 1.0) * species_energy(lib, t)


# --------------------------------------------------------------------------
# transport: Wilke mixture rules, Fuller binary diffusion, Stefan-Maxwell Gamma
# --------------------------------------------------------------------------

def species_viscosity(lib: ChemLib, t: jax.Array) -> jax.Array:
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.mu_y, lib.mu_y2, t)


def species_conductivity(lib: ChemLib, t: jax.Array) -> jax.Array:
    return spline_eval(lib.t0, lib.dt, lib.nt, lib.ka_y, lib.ka_y2, t)


def _wilke_phi_term(lib: ChemLib, mu_s: jax.Array) -> jax.Array:
    """(.., i, j) pair term: (1+sqrt(mu_i/mu_j)(M_j/M_i)^(1/4))^2 / sqrt(8(1+M_i/M_j)).

    The molar-mass factors are static; only sqrt(mu) is per-state (computed
    once per species, not per pair) — the naive form costs O(N S^2)
    transcendentals, this one O(N S).
    """
    c_mass = (lib.mm[None, :] / lib.mm[:, None]) ** 0.25      # static (S, S)
    c_den = 1.0 / jnp.sqrt(8.0 * (1.0 + lib.mm[:, None] / lib.mm[None, :]))
    r = jnp.sqrt(mu_s)                                        # (.., S)
    ratio = r[..., :, None] / r[..., None, :]
    num = 1.0 + ratio * c_mass
    return num * num * c_den


def mixture_viscosity(lib: ChemLib, t: jax.Array, ys: jax.Array) -> jax.Array:
    """Wilke rule (ComputeEta, :634-663)."""
    mu_s = species_viscosity(lib, t)
    ysc = clip_mass_fractions(ys)
    yom = ysc / lib.mm                                   # (.., S)
    phi = jnp.einsum("...ij,...j->...i", _wilke_phi_term(lib, mu_s), yom)
    return jnp.sum(mu_s * yom / phi, axis=-1)


def mixture_conductivity(lib: ChemLib, t: jax.Array, ys: jax.Array) -> jax.Array:
    """Wasilewska-style rule with the 1.065 off-diagonal factor
    (ComputeLambda, :670-696)."""
    mu_s = species_viscosity(lib, t)
    ka_s = species_conductivity(lib, t)
    ysc = clip_mass_fractions(ys)
    yom = ysc / lib.mm
    pair = _wilke_phi_term(lib, mu_s)
    off = 1.065 * pair * (1.0 - jnp.eye(lib.nspecies, dtype=pair.dtype))
    phi = jnp.einsum("...ij,...j->...i", off, yom) + yom
    return jnp.sum(ka_s * yom / phi, axis=-1)


def binary_diffusion(lib: ChemLib, t: jax.Array, p: jax.Array) -> jax.Array:
    """Fuller empirical D_ij = 1e-3 T^1.75/(P Mij (v_i^(1/3)+v_j^(1/3))^2)
    (GetDij_SM, :751-766). Returns (..., S, S)."""
    mij = jnp.sqrt(lib.mm[:, None] * lib.mm[None, :]
                   / (lib.mm[:, None] + lib.mm[None, :]))
    cbr = jnp.cbrt(lib.diff_vol)
    den = mij * (cbr[:, None] + cbr[None, :]) ** 2
    return 1.0e-3 * t[..., None, None] ** 1.75 / (p[..., None, None] * den)


def stefan_maxwell_gamma(lib: ChemLib, rho: jax.Array, xs: jax.Array,
                         ys: jax.Array, dij: jax.Array) -> jax.Array:
    """Gamma matrix of the Stefan-Maxwell system (GetGamma, :771-798).

    Gamma_ij = -sigma*mtot*x_i/(rho M_j D_ij)   (i != j)
    Gamma_ii = sigma*mtot/(rho M_i) * sum_{k!=i} x_k/D_ik
    with sigma = sum(Y), mtot = 1/sum(Y_k/M_k).
    """
    sigma = ys.sum(-1)
    mtot = 1.0 / (ys / lib.mm).sum(-1)
    pref = (sigma * mtot / rho)[..., None, None]
    inv_d = 1.0 / dij
    off = -pref * xs[..., :, None] / (lib.mm[None, :] * dij)
    eye = jnp.eye(lib.nspecies, dtype=xs.dtype)
    sum_terms = jnp.einsum("...ik,...k->...i", inv_d * (1.0 - eye), xs)
    diag = pref[..., 0] * sum_terms / lib.mm
    return off * (1.0 - eye) + eye * diag[..., :, None]


def effective_diffusion(lib: ChemLib, t: jax.Array, p: jax.Array,
                        ys: jax.Array) -> jax.Array:
    """Mean effective diffusion D_m,i = (1-X_i)/sum_{j!=i} X_j/D_ij
    (GetDiffCoeffs, :728-746)."""
    dij = binary_diffusion(lib, t, p)
    xs = molar_from_mass(lib, ys)
    eye = jnp.eye(lib.nspecies, dtype=xs.dtype)
    denom = jnp.einsum("...ij,...j->...i", (1.0 - eye) / dij, xs)
    return (1.0 - xs) / denom


# --------------------------------------------------------------------------
# kinetics
# --------------------------------------------------------------------------

def concentrations(lib: ChemLib, rho: jax.Array, ys: jax.Array) -> jax.Array:
    """c_s = 1e3 rho Y_s / M_s [mol/m^3] (SetConcentration, :701-705)."""
    return 1.0e3 * rho[..., None] * clip_mass_fractions(ys) / lib.mm


def equilibrium_constants(lib: ChemLib, t: jax.Array):
    """(Kc, Kp) from Gibbs (ComputeKeq, :803-829). Returns (..., R) arrays.

    Via the per-reaction ln-K tables when the library carries them (one
    small lookup; exact at the knots), else through the h, s splines.
    """
    if lib.lnkc_y is not None:
        ln_kc = spline_eval(lib.t0, lib.dt, lib.nt, lib.lnkc_y, lib.lnkc_y2, t)
        ln_kp = spline_eval(lib.t0, lib.dt, lib.nt, lib.lnkp_y, lib.lnkp_y2, t)
        return jnp.exp(ln_kc), jnp.exp(ln_kp)
    h_mol = spline_eval(lib.t0, lib.dt, lib.nt, lib.h_y, lib.h_y2, t)   # (..,S)
    s_mol = spline_eval(lib.t0, lib.dt, lib.nt, lib.s_y, lib.s_y2, t)
    dcoeff = lib.stoich_p - lib.stoich_r                                 # (S,R)
    g = h_mol - t[..., None] * s_mol
    dg = jnp.einsum("...s,sr->...r", g, dcoeff)
    dnu = dcoeff.sum(0)
    ln_kp = -dg / (R_UNGAS * t[..., None])
    ln_kc = ln_kp - dnu * jnp.log(R_UNGAS_ATM * t[..., None])
    return jnp.exp(ln_kc), jnp.exp(ln_kp)


def rate_constants(lib: ChemLib, t: jax.Array):
    """(kf, kb, Kc) per reaction (ComputeRateConstants, :835-866).

    kb = 0 for irreversible or 'complete' (Kp > 1e10) reactions; otherwise
    kf/Kc from Gibbs, unless explicit backward Arrhenius data exists.
    """
    tt = t[..., None]
    kf = lib.arr_a * tt ** lib.arr_beta * jnp.exp(-lib.arr_ta / tt)
    kc_gibbs, kp = equilibrium_constants(lib, t)
    kb_gibbs = jnp.where(
        (lib.reversible > 0.5) & (kp <= _KEQ_COMPLETE), kf / kc_gibbs, 0.0)
    kb_arr = lib.arr_a_b * tt ** lib.arr_beta_b * jnp.exp(-lib.arr_ta_b / tt)
    use_b = lib.has_backward > 0.5
    kb = jnp.where(use_b, kb_arr, kb_gibbs)
    kc = jnp.where(use_b, kf / jnp.where(kb_arr != 0.0, kb_arr, 1.0), kc_gibbs)
    return kf, kb, kc


def _conc_power_product(cs: jax.Array, exps: jax.Array, ys: jax.Array) -> jax.Array:
    """prod_s c_s^exp[r,s] with the negative-exponent vanishing-species guard
    (SetReactionRates, :880-916). cs: (..., S); exps: (R, S) -> (..., R)."""
    # c^e with e==0 must be exactly 1 even for c==0
    c = cs[..., None, :]                                   # (..., 1, S)
    powed = jnp.where(exps == 0.0, 1.0, c ** exps)         # (..., R, S)
    prod = jnp.prod(powed, axis=-1)
    neg_guard = jnp.any((exps < 0.0) & (ys[..., None, :] < _Y_RATE_GUARD), axis=-1)
    return jnp.where(neg_guard, 0.0, prod)


def reaction_rates(lib: ChemLib, t: jax.Array, rho: jax.Array, ys: jax.Array):
    """(Rf, Rb, Kc) forward/backward rates (SetReactionRates, :872-920)."""
    ysc = clip_mass_fractions(ys)
    cs = concentrations(lib, rho, ysc)
    kf, kb, kc = rate_constants(lib, t)
    rf = kf * _conc_power_product(cs, lib.exp_f, ysc)
    rb = kb * _conc_power_product(cs, lib.exp_b, ysc)
    return rf, rb, kc


def omega_tensor(lib: ChemLib, rf: jax.Array, rb: jax.Array) -> jax.Array:
    """omega_{i,r} = 1e-3 M_i (nu''-nu')_{i,r} (Rf - Rb)_r [kg/(m^3 s)]
    (SetSourceTerm, :99-114). Returns (..., S, R)."""
    dcoeff = lib.stoich_p - lib.stoich_r
    return 1.0e-3 * lib.mm[:, None] * dcoeff * (rf - rb)[..., None, :]


def dfr_drho(lib: ChemLib, rf: jax.Array, rb: jax.Array, rho: jax.Array,
             ys: jax.Array) -> jax.Array:
    """Df_r/Drho_j tensor (Set_DfrDrhos, :122-136). Returns (..., S, R);
    entry [j, r] = (Rf_r ef[r,j] - Rb_r eb[r,j])/(rho Y_j) for Y_j > 1e-10."""
    num = (rf[..., None, :] * lib.exp_f.T - rb[..., None, :] * lib.exp_b.T)
    den = (rho[..., None] * ys)[..., None]
    guard = (ys > _Y_JAC_GUARD)[..., None]
    return jnp.where(guard, num / jnp.where(guard, den, 1.0), 0.0)


def pasr_constants(lib: ChemLib, dfr: jax.Array, omega_turb: jax.Array,
                   c_mu: float, pasr_lb: float) -> jax.Array:
    """PaSR constant k_r per reaction (AssemblePaSRConstant, :161-190 and
    GetTimeCombustion_r, :208-227). Returns (..., R).

    tau_mix = 1/(C_mu omega_turb); tau_c,r = 1/max_i |Dfr_{i,r} M_i| over the
    species participating in reaction r; k = tau_c/(tau_c+tau_mix) clipped to
    [pasr_lb, 1], with k = 1 when tau_c = inf.
    """
    participates = ((lib.stoich_r != 0.0) | (lib.stoich_p != 0.0))   # (S, R)
    mag = jnp.abs(dfr * lib.mm[:, None]) * participates
    highest = mag.max(axis=-2)                                        # (..., R)
    tau_mix = 1.0 / (c_mu * omega_turb)[..., None]
    # k = tau_c/(tau_c + tau_mix) = 1/(1 + tau_mix*highest)
    k = 1.0 / (1.0 + tau_mix * highest)
    k = jnp.where(highest <= 0.0, 1.0, jnp.maximum(k, pasr_lb))
    return k


def mass_production(lib: ChemLib, omega_ir: jax.Array,
                    pasr_k: jax.Array | None = None) -> jax.Array:
    """omega_i = sum_r [k_r] omega_{i,r} (GetMassProductionTerm, :143-154
    turbulent / :196-202 laminar). Returns (..., S)."""
    if pasr_k is None:
        return omega_ir.sum(-1)
    return jnp.einsum("...sr,...r->...s", omega_ir, pasr_k)


def backfor_contributions(lib: ChemLib, t: jax.Array, rf: jax.Array,
                          rb: jax.Array, kc: jax.Array):
    """d(rates)/dT composite terms (Set_BackFor_Contr, :233-289).

    Returns (back_contr, for_contr), each (..., R):
      for_contr  = Rf (beta + Ta/T)/T
      back_contr = Rb (beta + Ta/T)/T - Rb dKc/dT / Kc     [Gibbs-Kc case]
                 = Rb (beta_b + Ta_b/T)/T                  [explicit-backward case]
    dKc/dT via the same relative FD perturbation eps=1e-6 as the reference.
    """
    eps = 1.0e-6
    tp = t + eps * t
    kc_gibbs_p, _ = equilibrium_constants(lib, tp)
    kf_p = lib.arr_a * tp[..., None] ** lib.arr_beta * jnp.exp(-lib.arr_ta / tp[..., None])
    kb_p = lib.arr_a_b * tp[..., None] ** lib.arr_beta_b * jnp.exp(-lib.arr_ta_b / tp[..., None])
    use_b = lib.has_backward > 0.5
    dtp = (tp - t)[..., None]
    # Gibbs case: Kc_pert = Kc (deriv 0) when Rb == 0 — also avoids inf-inf
    # for 'complete' reactions whose Gibbs Kc overflows to inf.
    kc_deriv_gibbs = jnp.where(rb > 0.0, (kc_gibbs_p - kc) / dtp, 0.0)
    kc_deriv_arr = (kf_p / jnp.where(kb_p != 0.0, kb_p, 1.0) - kc) / dtp
    kc_deriv = jnp.where(use_b, kc_deriv_arr, kc_deriv_gibbs)

    tt = t[..., None]
    tmp = (lib.arr_beta + lib.arr_ta / tt) / tt
    for_contr = rf * tmp
    back_gibbs = rb * (tmp - kc_deriv / jnp.where(kc != 0.0, kc, 1.0))
    back_arr = rb * (lib.arr_beta_b + lib.arr_ta_b / tt) / tt
    back_contr = jnp.where(use_b, back_arr, back_gibbs)
    return back_contr, for_contr


def source_jacobian(lib: ChemLib, t: jax.Array, rho: jax.Array, ys: jax.Array,
                    rf: jax.Array, rb: jax.Array, kc: jax.Array,
                    pasr_k: jax.Array | None = None) -> jax.Array:
    """Chemistry source Jacobian [dT column | species block], (..., S, S+1).

    GetTurbSourceJacobian (:295-319) when pasr_k is given, GetSourceJacobian
    (:325-350) otherwise (laminar: k_r = 1).
    """
    back, forw = backfor_contributions(lib, t, rf, rb, kc)
    if pasr_k is None:
        pasr_k = jnp.ones_like(rf)
    dcoeff = lib.stoich_p - lib.stoich_r                      # (S, R)
    fixed = 1.0e-3 * lib.mm[:, None] * dcoeff                 # (S, R)
    # temperature column
    dT = jnp.einsum("sr,...r->...s", fixed, (forw - back) * pasr_k)
    # species block: sum_r fixed[i,r] k_r Dfr[j,r]
    dfr = dfr_drho(lib, rf, rb, rho, ys)                      # (..., S=j, R)
    dY = jnp.einsum("ir,...r,...jr->...ij", fixed, pasr_k, dfr)
    return jnp.concatenate([dT[..., :, None], dY], axis=-1)


def regression_rate(fuel: dict, t: jax.Array) -> jax.Array:
    """Empirical fuel regression rate rb(T) (ComputeRegressionRate,
    reacting_model_library.cpp:1511-1516): Arrhenius branch switched at Tbar,
    with the reference's kcal-based gas constant R_ungas_scal."""
    lo = fuel["A2"] * jnp.exp(fuel["EA2"] / (R_UNGAS_SCAL * t))
    hi = fuel["A1"] * jnp.exp(fuel["EA1"] / (R_UNGAS_SCAL * t))
    return jnp.where(t < fuel["Tbar"], lo, hi)
