"""3D viscous Jacobian validation.

The 3D branch of SetLaminarViscousProjJacs (reference:
SU2_CFD/src/numerics_direct_reactive.cpp:1337-1379) is the thin-shear-layer
matrix M = theta I + n (x) n / 3; on a face with no z-components it must
reduce EXACTLY to the 2D branch on the embedded rows/columns.  The 3D SST
closure branch (SST_Reactive_JacobianClosure :983-1075) intentionally
differs from the 2D one (species-species mass-closure diagonal active,
energy-species term without the Ys factor), so the embedding test for the
turbulent case adds the documented analytic delta.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from su2_tpu import state as st
from su2_tpu.chemistry import library as cl
from su2_tpu.ops import viscous
from su2_tpu.state import Layout


@pytest.fixture(scope="module")
def airlib(tmp_path_factory):
    """An inert 3-species library (O2, H2O, CO2) from su2_tpu.testcase."""
    from su2_tpu import testcase
    d = tmp_path_factory.mktemp("lib3")
    return cl.load_library(testcase.write_library(
        str(d), species=("O2", "H2O", "CO2")))


def _random_state(lib, lay, n, seed=3):
    rng = np.random.default_rng(seed)
    ys = jnp.asarray(rng.dirichlet(np.ones(lay.ns), n))
    t = jnp.asarray(rng.uniform(280.0, 340.0, n))
    p = jnp.asarray(rng.uniform(9e4, 1.1e5, n))
    rgas = cl.mixture_rgas(lib, ys)
    rho = p / (rgas * t)
    vel = jnp.asarray(rng.normal(0.0, 25.0, (n, lay.ndim)))
    h = cl.mixture_enthalpy(lib, t, ys) + 0.5 * jnp.sum(vel * vel, axis=1)
    _, a = cl.frozen_gamma_sound(lib, t, ys)
    return jnp.concatenate([t[:, None], vel, p[:, None], rho[:, None],
                            h[:, None], a[:, None], ys], axis=1)


def _embed_prim_3d(lay2, v2):
    """2D primitive rows -> 3D rows with w = 0."""
    n = v2.shape[0]
    w = jnp.zeros((n, 1), dtype=v2.dtype)
    return jnp.concatenate(
        [v2[:, :1 + lay2.ndim], w, v2[:, 1 + lay2.ndim:]], axis=1)


def _embed_grad_3d(g2, nd_row):
    """(n, nG, 2) -> (n, nG+1, 3): insert a zero w-gradient row after the
    velocity rows and a zero z column."""
    n, ng, _ = g2.shape
    g3 = jnp.concatenate([g2, jnp.zeros((n, ng, 1), dtype=g2.dtype)], axis=2)
    zrow = jnp.zeros((n, 1, 3), dtype=g2.dtype)
    return jnp.concatenate([g3[:, :nd_row], zrow, g3[:, nd_row:]], axis=1)


def _umap(lay2, lay3):
    """2D conserved index -> 3D conserved index (skip rho w)."""
    m = list(range(lay2.RHOVX + 2))                     # rho, rho u, rho v
    m += list(range(lay3.RHOE, lay3.nvar))              # rho E, species
    return np.asarray(m)


def _setup(airlib, with_turb, seed=7):
    lib = airlib
    lay2, lay3 = Layout(2, 3), Layout(3, 3)
    n = 48
    rng = np.random.default_rng(seed)
    v_i2 = _random_state(lib, lay2, n, seed=seed + 1)
    v_j2 = _random_state(lib, lay2, n, seed=seed + 2)
    ng2 = 2 + lay2.ndim + lay2.ns
    g_i2 = jnp.asarray(rng.normal(0, 1.0, (n, ng2, 2)))
    g_j2 = jnp.asarray(rng.normal(0, 1.0, (n, ng2, 2)))
    normal2 = jnp.asarray(rng.normal(0, 1.0, (n, 2)))
    ci2 = jnp.asarray(rng.normal(0, 1.0, (n, 2)))
    cj2 = ci2 + jnp.asarray(rng.normal(0, 0.1, (n, 2)))
    tr_i = viscous.node_transport(lib, lay2, v_i2)
    tr_j = viscous.node_transport(lib, lay2, v_j2)
    rows_i = {"mu": tr_i.mu, "kappa": tr_i.kappa, "dij": tr_i.dij}
    rows_j = {"mu": tr_j.mu, "kappa": tr_j.kappa, "dij": tr_j.dij}
    s_i2 = st.dtdu(lib, lay2, v_i2)
    s_j2 = st.dtdu(lib, lay2, v_j2)

    v_i3 = _embed_prim_3d(lay2, v_i2)
    v_j3 = _embed_prim_3d(lay2, v_j2)
    g_i3 = _embed_grad_3d(g_i2, 1 + lay2.ndim)
    g_j3 = _embed_grad_3d(g_j2, 1 + lay2.ndim)
    z = jnp.zeros((n, 1))
    normal3 = jnp.concatenate([normal2, z], axis=1)
    ci3 = jnp.concatenate([ci2, z], axis=1)
    cj3 = jnp.concatenate([cj2, z], axis=1)
    s_i3 = st.dtdu(lib, lay3, v_i3)
    s_j3 = st.dtdu(lib, lay3, v_j3)

    turb2 = turb3 = None
    sk = None
    if with_turb:
        def trand(s):
            r = np.random.default_rng(s)
            return {"tke": jnp.asarray(r.uniform(0.1, 5.0, n)),
                    "mu_t": jnp.asarray(r.uniform(1e-5, 1e-3, n)),
                    "grad_tke": jnp.asarray(r.normal(0, 1.0, (n, 2)))}
        t_i, t_j = trand(seed + 10), trand(seed + 11)
        turb2 = (t_i, t_j)
        turb3 = ({**t_i, "grad_tke": jnp.concatenate(
                    [t_i["grad_tke"], z], axis=1)},
                 {**t_j, "grad_tke": jnp.concatenate(
                    [t_j["grad_tke"], z], axis=1)})
        sk = jnp.asarray(np.random.default_rng(seed + 12).uniform(0.85, 1.0, n))

    args2 = dict(coord_i=ci2, coord_j=cj2, corrected=True,
                 s_i=s_i2, s_j=s_j2)
    args3 = dict(coord_i=ci3, coord_j=cj3, corrected=True,
                 s_i=s_i3, s_j=s_j3)
    if with_turb:
        args2.update(turb_i=turb2[0], turb_j=turb2[1], sigma_k=sk,
                     prandtl_turb=0.9, lewis_turb=1.2)
        args3.update(turb_i=turb3[0], turb_j=turb3[1], sigma_k=sk,
                     prandtl_turb=0.9, lewis_turb=1.2)

    out2 = viscous.viscous_flux(lib, lay2, v_i2, v_j2, g_i2, g_j2, normal2,
                                rows_i, rows_j, **args2)
    out3 = viscous.viscous_flux(lib, lay3, v_i3, v_j3, g_i3, g_j3, normal3,
                                rows_i, rows_j, **args3)
    return lib, lay2, lay3, out2, out3, dict(
        v_i2=v_i2, v_j2=v_j2, normal2=normal2, ci2=ci2, cj2=cj2,
        turb2=turb2, n=n)


def test_3d_laminar_jacobians_embed_2d(airlib):
    lib, lay2, lay3, (f2, ji2, jj2), (f3, ji3, jj3), aux = _setup(
        airlib, with_turb=False)
    m = _umap(lay2, lay3)
    np.testing.assert_allclose(np.asarray(f3)[:, m], np.asarray(f2),
                               rtol=1e-12, atol=1e-14)
    for j3, j2 in ((ji3, ji2), (jj3, jj2)):
        got = np.asarray(j3)[:, m][:, :, m]
        want = np.asarray(j2)
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13 * scale)


def test_3d_sst_closure_embeds_2d_plus_documented_delta(airlib):
    """Quasi-2D faces: the 3D turbulent Jacobian equals the 2D one plus the
    reference's intentional 3D-branch deltas (species-species diagonal
    + Ys-less energy-species term) propagated through dV/dU (identity on
    the species rows, so the delta maps through unchanged)."""
    lib, lay2, lay3, (f2, ji2, jj2), (f3, ji3, jj3), aux = _setup(
        airlib, with_turb=True)
    m = _umap(lay2, lay3)
    np.testing.assert_allclose(np.asarray(f3)[:, m], np.asarray(f2),
                               rtol=1e-12, atol=1e-14)

    v_i2, v_j2 = aux["v_i2"], aux["v_j2"]
    t_i, t_j = aux["turb2"]
    n = aux["n"]
    ns = lay2.ns
    mu_t = 2.0 / (1.0 / t_i["mu_t"] + 1.0 / t_j["mu_t"])
    vmean = 0.5 * (v_i2 + v_j2)
    ys = cl.clip_mass_fractions(vmean[:, lay2.YS:lay2.YS + ns])
    tmean = vmean[:, lay2.T]
    h_s = cl.species_enthalpy(lib, tmean)
    dist = jnp.linalg.norm(aux["cj2"] - aux["ci2"], axis=1)
    area = jnp.linalg.norm(aux["normal2"], axis=1)
    ce = mu_t / (0.9 * 1.2) / dist * area       # theta == 1 on unit normals
    rho_i = v_i2[:, lay2.PRHO]
    rho_j = v_j2[:, lay2.PRHO]

    d_j = np.zeros((n, lay2.nvar, lay2.nvar))
    d_i = np.zeros((n, lay2.nvar, lay2.nvar))
    for s in range(ns):
        # species-species diagonal: 2D commented out, 3D active
        d_j[:, lay2.RHOS + s, lay2.RHOS + s] += np.asarray(
            ce * ys[:, s] / rho_j)
        d_i[:, lay2.RHOS + s, lay2.RHOS + s] -= np.asarray(
            ce * ys[:, s] / rho_i)                      # dfdv_i -= add_i
        # energy-species: 3D h_s/rho vs 2D h_s*Ys/rho
        d_j[:, lay2.RHOE, lay2.RHOS + s] += np.asarray(
            ce * h_s[:, s] * (1.0 - ys[:, s]) / rho_j)
        d_i[:, lay2.RHOE, lay2.RHOS + s] += np.asarray(
            -ce * h_s[:, s] * (1.0 - ys[:, s]) / rho_i)
    for j3, j2, d in ((jj3, jj2, d_j), (ji3, ji2, d_i)):
        got = np.asarray(j3)[:, m][:, :, m]
        want = np.asarray(j2) + d
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12 * scale)
