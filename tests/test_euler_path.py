import os

import numpy as np
import jax.numpy as jnp
import pytest

from su2_tpu.chemistry import library as cl
from su2_tpu.config import Config
from su2_tpu.driver import Simulation
from su2_tpu.geometry.dual_grid import build_dual_grid
from su2_tpu.geometry.mesh_data import mesh_arrays
from su2_tpu.io.mesh import read_su2_mesh
from su2_tpu.ops import ausm, gradients, limiters
from su2_tpu import state as st
from su2_tpu.state import Layout, TSolveParams


@pytest.fixture(scope="module")
def lib(standin_lib):
    return standin_lib


@pytest.fixture(scope="module")
def combustion_mesh():
    """The stand-in combustor's wall-stretched channel, without the seeded
    jitter (a smooth stretched mesh, on which median-dual GG is near-exact
    for linear fields)."""
    from su2_tpu import testcase
    return mesh_arrays(build_dual_grid(testcase.graded_channel(41, 21,
                                                               seed=None)))


def _state_rows(lib, lay, t, p, vel, ys):
    n = t.shape[0]
    rgas = cl.mixture_rgas(lib, ys)
    rho = p / (rgas * t)
    h = cl.mixture_enthalpy(lib, t, ys) + 0.5 * jnp.sum(vel * vel, axis=1)
    gamma, _ = cl.frozen_gamma_sound(lib, t, ys)
    a = jnp.sqrt(gamma * p / rho)
    v = jnp.concatenate([t[:, None], vel, p[:, None], rho[:, None],
                         h[:, None], a[:, None], ys], axis=1)
    return v


def test_cons2prim_roundtrip(lib):
    lay = Layout(2, 9)
    rng = np.random.default_rng(1)
    n = 64
    t = jnp.asarray(rng.uniform(250, 2800, n))
    p = jnp.asarray(rng.uniform(5e4, 5e5, n))
    vel = jnp.asarray(rng.normal(0, 80, (n, 2)))
    ys = jnp.asarray(rng.dirichlet(np.ones(9), n))
    v = _state_rows(lib, lay, t, p, vel, ys)
    u = st.prim2cons(lib, lay, v)
    # T solve from scratch with a crude initial guess
    u2, v2, nonphys = st.cons2prim(lib, lay, u, jnp.full((n,), 600.0),
                                   TSolveParams())
    np.testing.assert_allclose(np.asarray(v2[:, lay.T]), np.asarray(t),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(v2[:, lay.P]), np.asarray(p),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(v2[:, lay.A]), np.asarray(v[:, lay.A]),
                               rtol=2e-5)
    assert not np.asarray(nonphys).any()


def test_ausm_consistency(lib):
    """AUSM flux of two identical states equals the exact projected flux."""
    lay = Layout(2, 9)
    rng = np.random.default_rng(2)
    n = 32
    t = jnp.asarray(rng.uniform(300, 2000, n))
    p = jnp.asarray(rng.uniform(8e4, 3e5, n))
    vel = jnp.asarray(rng.normal(0, 100, (n, 2)))
    ys = jnp.asarray(rng.dirichlet(np.ones(9), n))
    v = _state_rows(lib, lay, t, p, vel, ys)
    normal = jnp.asarray(rng.normal(0, 1, (n, 2)))
    flux = np.asarray(ausm.ausm_flux(lay, v, v, normal, 0.3))
    area = np.linalg.norm(np.asarray(normal), axis=1)
    unit = np.asarray(normal) / area[:, None]
    rho = np.asarray(v[:, lay.PRHO])
    vn = np.sum(np.asarray(vel) * unit, axis=1)
    mdot = rho * vn * area
    np.testing.assert_allclose(flux[:, lay.RHO], mdot, rtol=1e-10)
    for d in range(2):
        expect = mdot * np.asarray(vel)[:, d] + np.asarray(p) * unit[:, d] * area
        np.testing.assert_allclose(flux[:, lay.RHOVX + d], expect, rtol=1e-9,
                                   atol=1e-8 * np.abs(expect).max())
    np.testing.assert_allclose(flux[:, lay.RHOE],
                               mdot * np.asarray(v[:, lay.H]), rtol=1e-9)
    for s in range(9):
        np.testing.assert_allclose(flux[:, lay.RHOS + s],
                                   mdot * np.asarray(ys)[:, s], rtol=1e-9,
                                   atol=1e-10 * np.abs(mdot).max())


def test_ausm_upwinding(lib):
    """Supersonic left-moving flow -> flux is the exact flux of the left state."""
    lay = Layout(2, 9)
    ys = jnp.zeros((1, 9)).at[:, 2].set(1.0)   # pure O2: a(400K) ~ 380 m/s
    t = jnp.array([400.0])
    p = jnp.array([1e5])
    vel = jnp.array([[900.0, 0.0]])          # strongly supersonic
    v_l = _state_rows(lib, lay, t, p, vel, ys)
    v_r = _state_rows(lib, lay, t * 1.3, p * 1.5, vel * 1.1, ys)
    normal = jnp.array([[1.0, 0.0]])
    flux = np.asarray(ausm.ausm_flux(lay, v_l, v_r, normal, 0.3))[0]
    rho = float(v_l[0, lay.PRHO])
    mdot = rho * 900.0
    np.testing.assert_allclose(flux[lay.RHO], mdot, rtol=1e-10)
    np.testing.assert_allclose(flux[lay.RHOE], mdot * float(v_l[0, lay.H]),
                               rtol=1e-10)


def test_green_gauss_vs_reference_loops(combustion_mesh):
    """Parity of the batched GG gradient with a literal NumPy port of the
    reference edge/vertex loops (SetPrimitive_Gradient_GG,
    solver_direct_reactive.cpp:1086-1165).  Median-dual GG with edge-midpoint
    quadrature carries a stretching-dependent quadrature error, so exactness
    on a linear field is only checked loosely.
    """
    mesh = combustion_mesh
    coords = np.asarray(mesh.coords)
    a, b, c = 1.7, -2.3, 0.4
    qn = (a * coords[:, 0] + b * coords[:, 1] + c)[:, None]
    grad = np.asarray(gradients.green_gauss(mesh, jnp.asarray(qn)))[:, 0, :]

    # oracle: explicit loops
    edges = np.asarray(mesh.edges)
    en = np.asarray(mesh.edge_normal)
    acc = np.zeros((mesh.npoint, 2))
    for e in range(edges.shape[0]):
        i, j = edges[e]
        avg = 0.5 * (qn[i, 0] + qn[j, 0])
        acc[i] += avg * en[e]
        acc[j] -= avg * en[e]
    for tag, (nodes, normal) in mesh.markers.items():
        nodes = np.asarray(nodes)
        normal = np.asarray(normal)
        for k in range(nodes.shape[0]):
            acc[nodes[k]] -= qn[nodes[k], 0] * normal[k]
    oracle = acc / np.asarray(mesh.volume)[:, None]
    np.testing.assert_allclose(grad, oracle, rtol=1e-10, atol=1e-12)

    # loose exactness on the linear field (quadrature error < 1%)
    bnd = set()
    for tag, (nodes, _) in mesh.markers.items():
        bnd.update(np.asarray(nodes).tolist())
    interior = np.array([i for i in range(mesh.npoint) if i not in bnd])
    np.testing.assert_allclose(grad[interior, 0], a, rtol=1e-2)
    np.testing.assert_allclose(grad[interior, 1], b, rtol=1e-2)


def test_wls_linear_field(combustion_mesh):
    """WLS gradient of a linear field is exact everywhere (incl. boundary)."""
    mesh = combustion_mesh
    coords = np.asarray(mesh.coords)
    a, b, c = -0.9, 3.1, 2.0
    q = jnp.asarray((a * coords[:, 0] + b * coords[:, 1] + c)[:, None])
    grad = np.asarray(gradients.weighted_least_squares(mesh, q))[:, 0, :]
    np.testing.assert_allclose(grad[:, 0], a, rtol=1e-8)
    np.testing.assert_allclose(grad[:, 1], b, rtol=1e-8)


def test_venkatakrishnan_limiter_bounds(combustion_mesh):
    mesh = combustion_mesh
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.normal(0, 1, (mesh.npoint, 2)))
    grad = gradients.weighted_least_squares(mesh, q)
    lim = np.asarray(limiters.venkatakrishnan(mesh, q, grad, 0.5, 0.1))
    assert (lim > 0).all() and (lim <= 2.0).all()
    # smooth linear field -> limiter ~ 1 in the interior
    coords = np.asarray(mesh.coords)
    ql = jnp.asarray((coords[:, 0] * 10)[:, None])
    gl = gradients.weighted_least_squares(mesh, ql)
    ll = np.asarray(limiters.venkatakrishnan(mesh, ql, gl, 0.5, 0.1))
    assert np.median(ll) > 0.6


def test_simulation_explicit_steps(standin_dir):
    """End-to-end: 3 explicit steps of the full reactive path on the
    stand-in combustor (freestream init), residuals finite."""
    cfg = Config(os.path.join(standin_dir, "case.cfg"))
    sim = Simulation(cfg)
    u, t, hist, turb = sim.run(niter=3, quiet=True)
    assert np.isfinite(np.asarray(u)).all()
    assert np.isfinite(hist).all()
    # density stays positive
    assert (np.asarray(u)[:, sim.lay.RHO] > 0).all()
