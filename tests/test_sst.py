import numpy as np
import jax.numpy as jnp

from su2_tpu.turbulence import sst


def test_blending_limits():
    """F1 -> 1 at the wall (small dist), -> 0 far away."""
    n = 4
    k = jnp.full((n,), 1.0)
    w = jnp.full((n,), 100.0)
    gk = jnp.zeros((n, 2))
    gw = jnp.zeros((n, 2))
    mu = jnp.full((n,), 1.8e-5)
    rho = jnp.full((n,), 1.2)
    f1_wall, f2_wall, _ = sst.blending(k, w, gk, gw, mu, rho,
                                       jnp.full((n,), 1e-6))
    f1_far, f2_far, _ = sst.blending(k, w, gk, gw, mu, rho,
                                     jnp.full((n,), 100.0))
    assert np.allclose(np.asarray(f1_wall), 1.0)
    assert np.asarray(f1_far).max() < 1e-3
    assert np.asarray(f2_far).max() < 1e-2


def test_eddy_viscosity_formula():
    rho = jnp.asarray([1.0])
    k = jnp.asarray([0.5])
    w = jnp.asarray([1000.0])
    # low strain: zeta = 1/w -> muT = rho k / w
    mut = sst.eddy_viscosity(rho, k, w, jnp.asarray([1.0]), jnp.asarray([1.0]))
    np.testing.assert_allclose(float(mut[0]), 0.5 / 1000.0, rtol=1e-12)
    # high strain limit: zeta = a1/(S F2)
    s = jnp.asarray([1e6])
    mut2 = sst.eddy_viscosity(rho, k, w, s, jnp.asarray([1.0]))
    np.testing.assert_allclose(float(mut2[0]), 0.5 * sst.A1 / 1e6, rtol=1e-6)
    # fork's dimensional clip at 1.0
    mut3 = sst.eddy_viscosity(jnp.asarray([10.0]), jnp.asarray([100.0]),
                              jnp.asarray([1.0]), jnp.asarray([0.0]),
                              jnp.asarray([1.0]))
    assert float(mut3[0]) == 1.0


def test_strain_vorticity():
    from su2_tpu.state import Layout
    lay = Layout(2, 3)
    # pure shear du/dy = s: strain = sqrt(2*(2*(s/2)^2 + ...)) with zero divergence
    s = 3.0
    grad = jnp.zeros((1, 8, 2)).at[0, 1, 1].set(s)
    strain, vort = sst.strain_and_vorticity(lay, grad)
    np.testing.assert_allclose(float(strain[0]), np.sqrt(2 * 2 * (s / 2) ** 2),
                               rtol=1e-12)
    np.testing.assert_allclose(float(vort[0]), s, rtol=1e-12)


def test_wall_distance():
    coords = np.array([[0.0, 0.0], [0.0, 1.0], [2.0, 2.0]])
    wall = np.array([[0.0, 0.0], [1.0, 0.0]])
    d = sst.wall_distance(coords, wall)
    np.testing.assert_allclose(d, [0.0, 1.0, np.sqrt(1 + 4)])


def test_sst_step_family_matches_gather_path():
    """The family-major (roll-based) SST edge assembly + solve on stencil
    meshes must match the gather/scatter path."""
    import dataclasses
    import jax.numpy as jnp
    from su2_tpu.geometry.dual_grid import build_dual_grid
    from su2_tpu.geometry.mesh_data import mesh_arrays
    from su2_tpu.state import Layout
    from su2_tpu.linalg import blockcsr
    from tests.test_stencil import _quad_grid

    mesh = _quad_grid(9, 7)
    grid = build_dual_grid(mesh)
    ma = mesh_arrays(grid)
    assert ma.gg_snormal is not None
    ma_g = ma.__class__(**{**{f: getattr(ma, f) for f in
                              ma.__dataclass_fields__},
                           "gg_snormal": None, "stencil_pvec": None,
                           "wls_coeff": None,
                           "stencil_sel": None, "stencil_offsets": None})

    lay = Layout(2, 3)
    n = ma.npoint
    rng = np.random.default_rng(11)
    q = jnp.asarray(np.abs(rng.normal(1.0, 0.2, (n, 2))) + 0.1)
    v = jnp.asarray(np.abs(rng.normal(1.0, 0.1, (n, lay.nprim))) + 0.5)
    flow_grad = jnp.asarray(rng.normal(0, 0.1, (n, lay.nprim - 2, 2)))
    mu = jnp.asarray(np.full(n, 1.8e-5))
    mu_t = jnp.asarray(np.abs(rng.normal(1e-4, 1e-5, n)))
    strain = jnp.asarray(np.abs(rng.normal(1.0, 0.2, n)))
    dist = jnp.asarray(np.full(n, 0.5))
    rho_old = v[:, lay.PRHO]
    dt = jnp.asarray(np.full(n, 1e-4))

    colors = blockcsr.greedy_coloring(np.asarray(ma.node_nbrs))
    masks = tuple(jnp.asarray(colors == c) for c in range(colors.max() + 1))
    for prec in ("JACOBI", "LU_SGS"):
        scfg = sst.SSTConfig(grad_method="WEIGHTED_LEAST_SQUARES",
                             linear_prec=prec,
                             color_masks=masks if prec != "JACOBI" else None)
        out_f = sst.sst_step(lay, ma, scfg, (), q, v, flow_grad, mu, mu_t,
                             strain, dist, rho_old, dt, 1e-3, 10.0)
        out_g = sst.sst_step(lay, ma_g, scfg, (), q, v, flow_grad, mu, mu_t,
                             strain, dist, rho_old, dt, 1e-3, 10.0)
        np.testing.assert_allclose(np.asarray(out_f[0]), np.asarray(out_g[0]),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(out_f[1]), np.asarray(out_g[1]),
                                   rtol=1e-9, atol=1e-12)


