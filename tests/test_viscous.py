import os

import numpy as np
import jax.numpy as jnp
import pytest

from su2_tpu.chemistry import library as cl
from su2_tpu.config import Config
from su2_tpu.driver import Simulation
from su2_tpu.ops import viscous
from su2_tpu.state import Layout


@pytest.fixture(scope="module")
def airlib(tmp_path_factory):
    """An inert 3-species library (O2, H2O, CO2) from su2_tpu.testcase."""
    from su2_tpu import testcase
    d = tmp_path_factory.mktemp("lib3")
    return cl.load_library(testcase.write_library(
        str(d), species=("O2", "H2O", "CO2")))


def test_stefan_maxwell_mass_conservation(airlib):
    """Diffusion fluxes from the SM system satisfy the zero-net-species-flux
    property approximately (sum Jd small vs individual fluxes) and solve the
    regularized system exactly."""
    lib = airlib
    rng = np.random.default_rng(0)
    n = 16
    rho = jnp.asarray(rng.uniform(0.5, 2.0, n))
    ys = jnp.asarray(rng.dirichlet(np.ones(3), n))
    xs = cl.molar_from_mass(lib, ys)
    t = jnp.asarray(rng.uniform(300, 1500, n))
    p = jnp.asarray(rng.uniform(5e4, 2e5, n))
    dij = cl.binary_diffusion(lib, t, p / 101325.0) / 1e4
    grad = jnp.asarray(rng.normal(0, 1.0, (n, 3)))
    jd, alpha = viscous._stefan_maxwell_jd(lib, rho, xs, ys, dij, grad)
    gamma = cl.stefan_maxwell_gamma(lib, rho, xs, ys, dij)
    gt = gamma + (alpha[..., None] * ys)[..., :, None]
    resid = jnp.einsum("nij,nj->ni", gt, jd) + grad
    assert float(jnp.abs(resid).max()) < 1e-8 * float(jnp.abs(grad).max())


def test_viscous_flux_zero_gradient(airlib):
    """Uniform state + zero gradients -> zero viscous flux."""
    lib = airlib
    lay = Layout(2, 3)
    n = 4
    ys = jnp.tile(jnp.asarray([[0.2197, 0.0302, 0.7501]]), (n, 1))
    t = jnp.full((n,), 300.0)
    p = jnp.full((n,), 1e5)
    rgas = cl.mixture_rgas(lib, ys)
    rho = p / (rgas * t)
    vel = jnp.zeros((n, 2))
    h = cl.mixture_enthalpy(lib, t, ys)
    gamma, a = cl.frozen_gamma_sound(lib, t, ys)
    v = jnp.concatenate([t[:, None], vel, p[:, None], rho[:, None],
                         h[:, None], a[:, None], ys], axis=1)
    trans = viscous.node_transport(lib, lay, v)
    rows = {"mu": trans.mu, "kappa": trans.kappa, "dij": trans.dij}
    grad = jnp.zeros((n, 2 + 2 + 3, 2))
    normal = jnp.tile(jnp.asarray([[0.0, 1.0]]), (n, 1))
    flux = viscous.viscous_flux(
        lib, lay, v, v, grad, grad, normal, rows, rows,
        coord_i=jnp.zeros((n, 2)), coord_j=jnp.ones((n, 2)), corrected=False)
    assert float(jnp.abs(flux).max()) < 1e-12


def test_couette_shear_flux(airlib):
    """Pure shear du/dy -> momentum flux tau_xy = mu du/dy through a y-normal
    face; energy flux = tau.u; no species flux."""
    lib = airlib
    lay = Layout(2, 3)
    ys = jnp.asarray([[0.2197, 0.0302, 0.7501]])
    t = jnp.asarray([350.0])
    p = jnp.asarray([1e5])
    rgas = cl.mixture_rgas(lib, ys)
    rho = p / (rgas * t)
    u0 = 10.0
    vel = jnp.asarray([[u0, 0.0]])
    h = cl.mixture_enthalpy(lib, t, ys) + 0.5 * u0 ** 2
    gamma, a = cl.frozen_gamma_sound(lib, t, ys)
    v = jnp.concatenate([t[:, None], vel, p[:, None], rho[:, None],
                         h[:, None], a[:, None], ys], axis=1)
    trans = viscous.node_transport(lib, lay, v)
    rows = {"mu": trans.mu, "kappa": trans.kappa, "dij": trans.dij}
    dudy = 100.0
    grad = jnp.zeros((1, 7, 2)).at[0, 1, 1].set(dudy)   # du/dy
    area = 2.0
    normal = jnp.asarray([[0.0, area]])
    flux = np.asarray(viscous.viscous_flux(
        lib, lay, v, v, grad, grad, normal, rows, rows,
        coord_i=jnp.zeros((1, 2)), coord_j=jnp.ones((1, 2)), corrected=False))[0]
    mu = float(trans.mu[0])
    np.testing.assert_allclose(flux[lay.RHOVX], mu * dudy * area, rtol=1e-10)
    np.testing.assert_allclose(flux[lay.RHOE], mu * dudy * u0 * area, rtol=1e-10)
    np.testing.assert_allclose(flux[lay.RHO], 0.0, atol=1e-12)


def test_flatplate_implicit_steps(flatplate_dir):
    """End-to-end: implicit viscous MUSCL flat plate runs and the density
    residual decreases."""
    cfg = Config(os.path.join(flatplate_dir, "my_turbulent_flatplate_air.cfg"))
    sim = Simulation(cfg)
    u, t, hist, turb = sim.run(niter=5, quiet=True)
    assert np.isfinite(np.asarray(u)).all()
    assert hist[-1][sim.lay.RHO] < hist[0][sim.lay.RHO]
    # strong no-slip: wall momentum exactly zero
    wall_nodes = np.asarray(sim.mesh.markers["wall"][0])
    mom = np.asarray(u)[wall_nodes][:, sim.lay.RHOVX:sim.lay.RHOVX + 2]
    assert np.abs(mom).max() == 0.0


def _random_state(lib, lay, n, seed=3):
    rng = np.random.default_rng(seed)
    ys = jnp.asarray(rng.dirichlet(np.ones(lay.ns), n))
    t = jnp.asarray(rng.uniform(280.0, 340.0, n))
    p = jnp.asarray(rng.uniform(9e4, 1.1e5, n))
    rgas = cl.mixture_rgas(lib, ys)
    rho = p / (rgas * t)
    vel = jnp.asarray(rng.normal(0.0, 25.0, (n, lay.ndim)))
    h = cl.mixture_enthalpy(lib, t, ys) \
        + 0.5 * jnp.sum(vel * vel, axis=1)
    _, a = cl.frozen_gamma_sound(lib, t, ys)
    return jnp.concatenate([t[:, None], vel, p[:, None], rho[:, None],
                            h[:, None], a[:, None], ys], axis=1)


def test_molar2mass_woodbury_matches_dense(airlib):
    """The rank-2 Woodbury molar->mass solve equals a dense Gauss-Jordan on
    the materialized Get_Molar2MassGrad_Operator M_tilde."""
    from su2_tpu.linalg.smallsolve import gauss_solve

    rng = np.random.default_rng(7)
    s = airlib.nspecies
    nf, d = 23, 2
    ys = rng.random((nf, s)) + 0.05
    ys = ys / ys.sum(-1, keepdims=True)
    xs = np.asarray(cl.molar_from_mass(airlib, jnp.asarray(ys)))
    b = rng.standard_normal((nf, s, d))
    m = viscous._molar2mass_operator(airlib, jnp.asarray(ys), jnp.asarray(xs))
    ref = gauss_solve(m, jnp.asarray(b), pivot=False)
    got = viscous._molar2mass_solve(airlib, jnp.asarray(ys), jnp.asarray(xs),
                                    jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)
