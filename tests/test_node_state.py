"""The node-state pass (state.node_state): Cons2Prim with the
secant/bisection temperature solve, dT/dU, dP/dU, Wilke viscosity,
Wasilewska conductivity and mole fractions (reference:
variable_direct_reactive.cpp:325-561, reacting_model_library.cpp:634-696),
checked on seeded random 9-species mixtures of the stand-in library against
finite differences, a plain numpy Wilke rule, its own f64 result and its
unsharded result.  ``python chip_smoke.py`` runs the f32-vs-f64 check on the
card at 565,671 nodes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from su2_tpu import state as st, testcase
from su2_tpu.chemistry import library as cl
from su2_tpu.state import Layout, TSolveParams

LAY = Layout(2, 9)
NAMES = ("u", "v", "nonphys", "dtdu", "dpdu", "mu", "kappa", "xs")
# temperature solves to the f64 round-off floor, for finite differences
TIGHT = TSolveParams(secant_iters=40, secant_tol=1e-13, bisect_iters=64,
                     bisect_tol=1e-13)


def _colwise(a, b):
    """max over columns of max|a - b| / max|b|."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    sc = np.abs(b).max(axis=0)
    sc[sc == 0] = 1.0
    return (np.abs(a - b).max(axis=0) / sc).max()


def _inputs(lib, n, seed=0, dtype=jnp.float64):
    u, tg, tke = testcase.mixture_states(lib, LAY, n, seed)
    return tuple(jnp.asarray(x, dtype) for x in (u, tg, tke))


def _cast(lib, dtype):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, dtype) if hasattr(x, "dtype") else x, lib)


def _fd_check(lib, seed, col, jac):
    """jac (N, nVar) against central differences of v[:, col] over the
    conserved variables, on the nodes whose partial densities all exceed
    ten steps (a step past zero would hit the mass-fraction clip)."""
    u, tg, _ = _inputs(lib, 96, seed=seed)
    got = np.asarray(jac(u, tg))
    f = jax.jit(lambda u: st.cons2prim(lib, LAY, u, tg, TIGHT)[1][:, col])
    hs = 1e-5 * np.abs(np.asarray(u)).max(axis=0)
    fd = np.zeros(u.shape)
    for k in range(LAY.nvar):
        du = jnp.zeros_like(u).at[:, k].set(hs[k])
        fd[:, k] = (np.asarray(f(u + du)) - np.asarray(f(u - du))) \
            / (2 * hs[k])
    ok = (np.asarray(u)[:, LAY.RHOS:] > 10 * hs[LAY.RHOS:]).all(axis=1)
    assert ok.sum() >= 64
    assert _colwise(got[ok], fd[ok]) < 1e-6


def test_dtdu_matches_finite_differences(standin_lib):
    _fd_check(standin_lib, 0, LAY.T, lambda u, tg: st.node_state(
        standin_lib, LAY, u, tg, TIGHT).dtdu)


def test_dpdu_matches_finite_differences(standin_lib):
    _fd_check(standin_lib, 1, LAY.P, lambda u, tg: st.node_state(
        standin_lib, LAY, u, tg, TIGHT).dpdu)


def test_mixture_viscosity_is_wilke(standin_lib):
    """mu against the plain O(S^2) Wilke loop over the species viscosities
    at the solved temperature."""
    u, tg, tke = _inputs(standin_lib, 50, seed=2)
    ns = st.node_state(standin_lib, LAY, u, tg, TSolveParams(), turb_ke=tke)
    t = ns.v[:, LAY.T]
    mu_s = np.asarray(cl.species_viscosity(standin_lib, t))
    x = np.asarray(ns.xs)
    mm = np.asarray(standin_lib.mm)
    want = np.zeros(len(t))
    for i in range(LAY.ns):
        phi = np.zeros(len(t))
        for j in range(LAY.ns):
            phi += x[:, j] * (1.0 + np.sqrt(mu_s[:, i] / mu_s[:, j])
                              * (mm[j] / mm[i]) ** 0.25) ** 2 \
                / np.sqrt(8.0 * (1.0 + mm[i] / mm[j]))
        want += x[:, i] * mu_s[:, i] / phi
    np.testing.assert_allclose(np.asarray(ns.mu), want, rtol=1e-12)


def test_node_state_lite_matches_full(standin_lib):
    """The reduced turb-phase pass returns the full pass's u/v/nonphys/mu/xs
    and gm1 == dP/dU[RHOE]."""
    u, tg, tke = _inputs(standin_lib, 150, seed=3)
    tp = TSolveParams()
    full = st.node_state(standin_lib, LAY, u, tg, tp, turb_ke=tke)
    lite = st.node_state_lite(standin_lib, LAY, u, tg, tp, turb_ke=tke)
    for a, b in ((lite.u, full.u), (lite.v, full.v),
                 (lite.nonphys, full.nonphys), (lite.mu, full.mu),
                 (lite.xs, full.xs), (lite.gm1, full.dpdu[:, LAY.RHOE])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_node_state_bisection_path(standin_lib):
    """Every node through the bisection fallback (one secant round from a
    far initial guess) lands on the secant's temperature."""
    u, tg, tke = _inputs(standin_lib, 130, seed=4)
    ref = st.node_state(standin_lib, LAY, u, tg, TSolveParams(), turb_ke=tke)
    got = st.node_state(standin_lib, LAY, u, jnp.full_like(tg, 4999.0),
                        TSolveParams(secant_iters=1, secant_tol=1e-30),
                        turb_ke=tke)
    assert not np.asarray(got.nonphys).any()
    assert _colwise(got.v[:, LAY.T:LAY.T + 1], ref.v[:, LAY.T:LAY.T + 1]) \
        < 1e-7


def test_node_state_nonphys_flags(standin_lib):
    """Negative partial density, vanishing density and out-of-range
    temperatures are flagged."""
    u, tg, tke = _inputs(standin_lib, 140, seed=5)
    u = np.asarray(u).copy()
    u[3, LAY.RHOS] = -1.0e-4              # negative species density
    u[7, LAY.RHO] = 1.0e-20               # vanishing density
    u[11, LAY.RHOE] *= 50.0               # temperature past TEMPERATURE_MAX
    got = st.node_state(standin_lib, LAY, jnp.asarray(u), tg, TSolveParams(),
                        turb_ke=tke)
    assert set(np.flatnonzero(np.asarray(got.nonphys)).tolist()) == {3, 7, 11}


def test_node_state_f32_matches_f64(standin_lib):
    """float32 against float64 on the same states, within chip_smoke's
    bound (TOL_NODE_F64: the f32 rounding of the inputs times e/R, plus the
    f32 secant stop)."""
    import chip_smoke
    lib32 = _cast(standin_lib, jnp.float32)
    a64 = _inputs(standin_lib, 160, seed=6)
    a32 = tuple(jnp.asarray(x, jnp.float32) for x in a64)
    ref = st.node_state(standin_lib, LAY, a64[0], a64[1], TSolveParams(),
                        turb_ke=a64[2])
    got = st.node_state(lib32, LAY, a32[0], a32[1], TSolveParams(),
                        turb_ke=a32[2])
    for name, a, b in zip(NAMES, jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves(ref)):
        if name == "nonphys":
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert _colwise(a, b) < chip_smoke.TOL_NODE_F64, name


@pytest.mark.parametrize("n", [1, 128, 131])
def test_node_state_shapes(standin_lib, n):
    u, tg, tke = _inputs(standin_lib, n, seed=7)
    got = jax.tree_util.tree_leaves(
        st.node_state(standin_lib, LAY, u, tg, TSolveParams(), turb_ke=tke))
    shapes = [np.asarray(x).shape for x in got]
    assert shapes == [(n, LAY.nvar), (n, LAY.nprim), (n,), (n, LAY.nvar),
                      (n, LAY.nvar), (n,), (n,), (n, LAY.ns)]
    for name, x in zip(NAMES, got):
        assert np.isfinite(np.asarray(x, np.float64)).all(), name


def test_node_state_sharded_matches_single(standin_lib):
    """Inputs sharded over 8 devices: the pass stays sharded and equals the
    one-device call."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from su2_tpu.parallel.sharding import cells_mesh

    mesh = cells_mesh(n=8)
    u, tg, tke = _inputs(standin_lib, 8 * 24, seed=8)
    f = jax.jit(lambda u, t, k: st.node_state(standin_lib, LAY, u, t,
                                              TSolveParams(), turb_ke=k))
    one = f(u, tg, tke)
    sh = f(*(jax.device_put(x, NamedSharding(mesh, P("cells")))
             for x in (u, tg, tke)))
    for a, b in zip(jax.tree_util.tree_leaves(one),
                    jax.tree_util.tree_leaves(sh)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-13, atol=0)
    assert len(sh.v.sharding.device_set) == 8
