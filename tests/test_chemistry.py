import os

import numpy as np
import jax.numpy as jnp
import pytest

from su2_tpu.io import tables
from su2_tpu.chemistry import library as cl
from su2_tpu.chemistry.spline import spline_eval, spline_second_derivatives


@pytest.fixture(scope="module")
def lib(standin_lib):
    return standin_lib


@pytest.fixture(scope="module")
def files(standin_dir):
    return tables.read_manifest(os.path.join(standin_dir, "library.txt"))


# ------------------------------------------------------------------ parsing

def test_mixture_parse(files):
    from su2_tpu import testcase
    mix = files.mixture
    assert mix.species == ["C4H6", "H2O", "O2", "CO", "CO2", "H2", "O", "OH", "H"]
    for k, name in enumerate(mix.species):
        mm, hf, _s, _cp, dv = testcase.SPECIES[name]
        assert mix.molar_masses[k] == mm
        assert mix.formation_enthalpies[k] == hf
        assert mix.diff_volumes[k] == dv


def test_chemistry_parse(files):
    chem = files.chemistry
    sp = {s: i for i, s in enumerate(files.mixture.species)}
    assert chem.nreactions == 2
    assert chem.cgs_units
    # reaction 1: C4H6_1.0 + 3.5O2_1.0 => 4CO + 3H2O
    assert chem.stoich_r[sp["C4H6"], 0] == 1.0
    assert chem.stoich_r[sp["O2"], 0] == 3.5
    assert chem.stoich_p[sp["CO"], 0] == 4.0
    assert chem.stoich_p[sp["H2O"], 0] == 3.0
    assert chem.exp_f[0, sp["C4H6"]] == 1.0
    assert chem.exp_f[0, sp["O2"]] == 1.0     # explicit _1.0, not 3.5
    assert not chem.reversible[0]
    assert (chem.exp_b[0] == 0).all()
    # CGS->SI: A *= 10^(6*(1-sum_f)) with sum_f = 2
    assert np.isclose(chem.arr_a[0], 8.80e11 * 1e-6)
    assert np.isclose(chem.arr_ta[0], 30000.0 / tables.R_UNGAS_SCAL)
    # reaction 2: CO_1.0 + 0.5O2_0.5 <=> CO2_1.0 with explicit backward
    assert chem.reversible[1] and chem.has_backward[1]
    assert chem.stoich_r[sp["CO"], 1] == 1.0
    assert chem.stoich_r[sp["O2"], 1] == 0.5
    assert chem.exp_f[1, sp["O2"]] == 0.5
    assert chem.exp_b[1, sp["CO2"]] == 1.0
    assert np.isclose(chem.arr_a[1], 3.98e14 * 10 ** (6 * (1 - 1.5)))
    assert np.isclose(chem.arr_a_b[1], 5.00e8)  # sum exp_b = 1 -> no change
    assert np.isclose(chem.arr_ta_b[1], 40000.0 / tables.R_UNGAS_SCAL)


def test_auto_backward_exponents():
    """Reversible reaction without explicit backward data gets
    exp_b = exp_f + nu_p - nu_r (reacting_model_library.cpp:1113)."""
    import tempfile
    chem_text = """//
2

//Units
SI

//
A_2.0 + B <=> 2C
1.0e3 0 1000.0

A => C
1.0 0 0.0

STOP
"""
    mix_text = """//
3
A 1.0 0.0 1.0
B 2.0 0.0 1.0
C 3.0 0.0 1.0
STOP
"""
    with tempfile.TemporaryDirectory() as d:
        mp = os.path.join(d, "mix.txt")
        cp = os.path.join(d, "chem.txt")
        open(mp, "w").write(mix_text)
        open(cp, "w").write(chem_text)
        mix = tables.read_mixture(mp)
        chem = tables.read_chemistry(cp, mix.species)
    # A_2.0: stoich 1 (coeff empty -> 1? no: "A_2.0" has no leading coeff -> 1)
    assert chem.stoich_r[0, 0] == 1.0
    assert chem.exp_f[0, 0] == 2.0            # explicit exponent
    assert chem.stoich_r[1, 0] == 1.0
    assert chem.exp_f[0, 1] == 1.0            # defaulted to stoich coeff
    assert chem.stoich_p[2, 0] == 2.0
    # exp_b = exp_f + nu_p - nu_r
    np.testing.assert_allclose(chem.exp_b[0], [2 - 1, 1 - 1, 0 + 2])


# ------------------------------------------------------------------ splines

def test_spline_matches_nodes_and_ref_algo(files):
    tab = files.thermo[2]  # O2
    t = tab.temps
    y = tab.cols["cp"][None, :]
    y2 = spline_second_derivatives(t, y)
    # exact at nodes
    vals = spline_eval(t[0], t[1] - t[0], len(t), jnp.asarray(y), jnp.asarray(y2),
                       jnp.asarray(t))
    np.testing.assert_allclose(np.asarray(vals)[:, 0], y[0], rtol=1e-12)
    # midpoint value close to linear interp but not equal (cubic)
    tm = 0.5 * (t[3] + t[4])
    vm = spline_eval(t[0], t[1] - t[0], len(t), jnp.asarray(y), jnp.asarray(y2),
                     jnp.asarray([tm]))
    lin = 0.5 * (y[0, 3] + y[0, 4])
    assert abs(float(vm[0, 0]) - lin) / lin < 1e-3


def test_scalar_spline_against_reference_formula(files):
    """Independent scalar implementation of GetSpline (spline.cpp:62-76)."""
    tab = files.transport[2]
    x = tab.temps
    y = tab.cols["mu"]
    y2 = spline_second_derivatives(x, y[None])[0]
    h = x[1] - x[0]
    for value in [233.7, 512.2, 1501.9, 2999.0]:
        klo = int((value - x[0]) / h) + 1
        a = (x[klo] - value) / h
        b = (value - x[klo - 1]) / h
        ref = a * y[klo - 1] + b * y[klo] + \
            ((a**3 - a) * y2[klo - 1] + (b**3 - b) * y2[klo]) * h * h / 6.0
        got = float(spline_eval(x[0], h, len(x), jnp.asarray(y[None]),
                                jnp.asarray(y2[None]), jnp.asarray([value]))[0, 0])
        assert np.isclose(got, ref, rtol=1e-12)


# ------------------------------------------------------------------ thermo

def test_thermo_basics(lib):
    t = jnp.array([300.0, 1500.0])
    ys = jnp.zeros((2, 9)).at[:, 2].set(1.0)  # pure O2
    cp = cl.mixture_cp(lib, t, ys)
    # O2 cp(300K) ~ 29.39e3 J/kmolK / 31.9988 ~ 918 J/kgK
    assert 890 < float(cp[0]) < 950
    rg = cl.mixture_rgas(lib, ys)
    np.testing.assert_allclose(np.asarray(rg), tables.R_UNGAS / 31.9988, rtol=1e-6)
    gamma, a = cl.frozen_gamma_sound(lib, t, ys)
    assert 1.2 < float(gamma[0]) < 1.45
    assert 300 < float(a[0]) < 360  # O2 sound speed at 300K ~ 330 m/s


def test_molar_mass_roundtrip(lib):
    ys = jnp.array([[0.1, 0.2, 0.3, 0.05, 0.05, 0.1, 0.1, 0.05, 0.05]])
    xs = cl.molar_from_mass(lib, ys)
    back = cl.mass_from_molar(lib, xs)
    np.testing.assert_allclose(np.asarray(back), np.asarray(ys), rtol=1e-12)


def test_wilke_single_species_limit(lib):
    t = jnp.array([500.0])
    ys = jnp.zeros((1, 9)).at[:, 2].set(1.0)
    mu_mix = cl.mixture_viscosity(lib, t, ys)
    mu_s = cl.species_viscosity(lib, t)[0, 2]
    # other species have Y=1e-30 -> negligible contribution
    np.testing.assert_allclose(float(mu_mix[0]), float(mu_s), rtol=1e-6)
    ka_mix = cl.mixture_conductivity(lib, t, ys)
    ka_s = cl.species_conductivity(lib, t)[0, 2]
    np.testing.assert_allclose(float(ka_mix[0]), float(ka_s), rtol=1e-6)


# ------------------------------------------------------------------ kinetics

def _numpy_rates_oracle(files, T, rho, Y):
    """Straightforward scalar recomputation of SetReactionRates."""
    mix, chem = files.mixture, files.chemistry
    mm = mix.molar_masses
    Y = np.where(Y < 0, 1e-30, Y)
    cs = 1e3 * rho * Y / mm
    # thermo splines for Keq
    t = files.thermo[0].temps
    h = np.stack([tb.cols["h"] for tb in files.thermo])
    s = np.stack([tb.cols["s"] for tb in files.thermo])
    h2 = spline_second_derivatives(t, h)
    s2 = spline_second_derivatives(t, s)

    def ev(y, y2, val):
        hstep = t[1] - t[0]
        klo = int((val - t[0]) / hstep) + 1
        a = (t[klo] - val) / hstep
        b = (val - t[klo - 1]) / hstep
        return a * y[:, klo - 1] + b * y[:, klo] + \
            ((a**3 - a) * y2[:, klo - 1] + (b**3 - b) * y2[:, klo]) * hstep**2 / 6

    rf = np.zeros(chem.nreactions)
    rb = np.zeros(chem.nreactions)
    for r in range(chem.nreactions):
        kf = chem.arr_a[r] * T ** chem.arr_beta[r] * np.exp(-chem.arr_ta[r] / T)
        if chem.has_backward[r]:
            kb = chem.arr_a_b[r] * T ** chem.arr_beta_b[r] * np.exp(-chem.arr_ta_b[r] / T)
        else:
            dco = chem.stoich_p[:, r] - chem.stoich_r[:, r]
            hs = ev(h, h2, T)
            se = ev(s, s2, T)
            dg = (dco * (hs - T * se)).sum()
            dnu = dco.sum()
            lnkp = -dg / (tables.R_UNGAS * T)
            lnkc = lnkp - dnu * np.log(tables.R_UNGAS_ATM * T)
            kp = np.exp(lnkp)
            if (not chem.reversible[r]) or kp > 1e10:
                kb = 0.0
            else:
                kb = kf / np.exp(lnkc)
        rf[r] = kf * np.prod(cs ** chem.exp_f[r], where=chem.exp_f[r] != 0,
                             initial=1.0)
        rb[r] = kb * np.prod(cs ** chem.exp_b[r], where=chem.exp_b[r] != 0,
                             initial=1.0)
    return rf, rb


def test_reaction_rates_vs_oracle(lib, files):
    T, rho = 1800.0, 0.35
    Y = np.array([0.05, 0.1, 0.2, 0.1, 0.3, 0.01, 0.04, 0.1, 0.1])
    rf, rb, kc = cl.reaction_rates(lib, jnp.array([T]), jnp.array([rho]),
                                   jnp.asarray(Y)[None])
    orf, orb = _numpy_rates_oracle(files, T, rho, Y)
    np.testing.assert_allclose(np.asarray(rf)[0], orf, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(rb)[0], orb, rtol=1e-10)
    assert float(rf[0, 0]) > 0 and float(rb[0, 0]) == 0.0   # irreversible
    assert float(rb[0, 1]) > 0                               # explicit backward


def test_omega_conserves_mass(lib):
    """sum_i omega_i = 0: chemistry conserves total mass."""
    T = jnp.array([2000.0])
    rho = jnp.array([0.5])
    ys = jnp.asarray(np.full((1, 9), 1 / 9.0))
    rf, rb, kc = cl.reaction_rates(lib, T, rho, ys)
    om = cl.omega_tensor(lib, rf, rb)
    total = np.asarray(cl.mass_production(lib, om))
    assert abs(total.sum()) < 1e-10 * np.abs(np.asarray(om)).max()


def test_pasr_constants(lib):
    T = jnp.array([2000.0])
    rho = jnp.array([0.5])
    ys = jnp.asarray(np.full((1, 9), 1 / 9.0))
    rf, rb, _ = cl.reaction_rates(lib, T, rho, ys)
    dfr = cl.dfr_drho(lib, rf, rb, rho, ys)
    # huge turbulence frequency -> tau_mix -> 0 -> k -> 1
    k_fast = cl.pasr_constants(lib, dfr, jnp.array([1e30]), 0.09, 0.2)
    np.testing.assert_allclose(np.asarray(k_fast), 1.0, rtol=1e-12)
    # tiny turbulence frequency -> tau_mix huge -> k clipped at lower bound
    k_slow = cl.pasr_constants(lib, dfr, jnp.array([1e-30]), 0.09, 0.2)
    np.testing.assert_allclose(np.asarray(k_slow), 0.2, rtol=1e-12)
    # k monotone in [lb, 1]
    k_mid = cl.pasr_constants(lib, dfr, jnp.array([1e4]), 0.09, 0.2)
    assert ((np.asarray(k_mid) >= 0.2) & (np.asarray(k_mid) <= 1.0)).all()


def test_source_jacobian_fd(lib):
    """Species-block of the analytic source Jacobian vs finite differences
    of omega (laminar case). The reference forms d(omega_i)/drho_j via the
    Df_r/Drho_j tensor; FD of our omega should agree to ~1e-5."""
    T = 1900.0
    rho = 0.4
    Y = np.array([0.05, 0.1, 0.5, 0.1, 0.1, 0.05, 0.04, 0.03, 0.03])

    def omega_of_rhos(rhos):
        rr = rhos.sum()
        yy = rhos / rr
        rf, rb, _ = cl.reaction_rates(lib, jnp.array([T]), jnp.array([rr]),
                                      jnp.asarray(yy)[None])
        return np.asarray(cl.mass_production(lib, cl.omega_tensor(lib, rf, rb)))[0]

    rhos0 = rho * Y
    rf, rb, kc = cl.reaction_rates(lib, jnp.array([T]), jnp.array([rho]),
                                   jnp.asarray(Y)[None])
    jac = np.asarray(cl.source_jacobian(lib, jnp.array([T]), jnp.array([rho]),
                                        jnp.asarray(Y)[None], rf, rb, kc))[0]
    # NOTE: the reference Jacobian (GetSourceJacobian) holds rho*Y_j variations
    # at fixed T and fixed OTHER partial densities but also fixed total rho in
    # the rate prefactor; FD matching the same definition:
    base = omega_of_rhos(rhos0)
    for j in [2, 3]:
        eps = rhos0[j] * 1e-7
        pert = rhos0.copy()
        pert[j] += eps
        # fixed-rho FD is not exactly the reference derivative; compare the
        # dominant concentration sensitivity instead
        fd = (omega_of_rhos(pert) - base) / eps
        ana = jac[:, 1 + j]
        mask = np.abs(ana) > 1e-6 * np.abs(ana).max()
        np.testing.assert_allclose(fd[mask], ana[mask], rtol=2e-1)
