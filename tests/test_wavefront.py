"""Wavefront (level-scheduled) sequential-equivalent LU-SGS
(linalg/wavefront.py, LINEAR_SOLVER_PREC= LU_SGS_WAVE): device-resident
natural-order sweeps must reproduce the host-callback reference-exact
sequential sweep (linalg/seq_sgs.py) on the same family-major system."""

import jax.numpy as jnp
import numpy as np
import pytest

from su2_tpu.linalg import blockcsr, seq_sgs, wavefront


class _Mesh:
    def __init__(self, n, offsets):
        self.npoint = n
        self.stencil_offsets = tuple(offsets)
        self.n_shards = 1


def _family_system(n, v, offsets, seed=0):
    rng = np.random.default_rng(seed)
    k = len(offsets)
    sel = rng.standard_normal((k, n, v, v)) * 0.1
    for kk, o in enumerate(offsets):
        p = np.arange(n)
        sel[kk, (p + o < 0) | (p + o >= n)] = 0.0
    diag = rng.standard_normal((n, v, v)) * 0.1 + 3.0 * np.eye(v)
    r = rng.standard_normal((n, v))
    return (jnp.asarray(sel), jnp.asarray(diag), jnp.asarray(r))


@pytest.mark.parametrize("v,offsets", [
    (2, (-10, -9, -8, -1, 1, 8, 9, 10)),
    (7, (-5, -4, -1, 1, 4, 5)),
])
def test_wavefront_matches_sequential_host(v, offsets):
    n = 300
    mesh = _Mesh(n, offsets)
    sel, diag, r = _family_system(n, v, offsets)

    pc_host = seq_sgs.fam_preconditioner(mesh, v)
    z_host = np.asarray(pc_host(diag, sel, r))

    pc_wave = wavefront.make_wavefront_pc(mesh, v)
    z_wave = np.asarray(pc_wave(diag, sel, r))

    np.testing.assert_allclose(z_wave, z_host, rtol=1e-11, atol=1e-13)


def test_levels_are_topologically_valid():
    n, offsets = 200, (-9, -8, -7, -1, 1, 7, 8, 9)
    fwd, bwd = wavefront.build_levels(n, offsets)
    lev_of = np.full(n + 1, -1)
    for li in range(fwd.shape[0]):
        for p in fwd[li]:
            if p < n:
                lev_of[p] = li
    assert (lev_of[:n] >= 0).all()
    for p in range(n):
        for o in offsets:
            if o < 0 <= p + o:
                assert lev_of[p + o] < lev_of[p]
    lev_b = np.full(n + 1, -1)
    for li in range(bwd.shape[0]):
        for p in bwd[li]:
            if p < n:
                lev_b[p] = li
    for p in range(n):
        for o in offsets:
            if o > 0 and p + o < n:
                assert lev_b[p + o] < lev_b[p]


def test_make_solver_ops_wave_kinds():
    """LU_SGS_WAVE reachable through the family and BlockJacobian entry
    points with consistent results."""
    n, v = 256, 2
    offsets = (-9, -8, -7, -1, 1, 7, 8, 9)
    mesh = _Mesh(n, offsets)
    sel, diag, r = _family_system(n, v, offsets, seed=3)
    mv, pc = blockcsr.make_solver_ops_fam(
        mesh, diag, sel, "LU_SGS_WAVE")
    z = np.asarray(pc(r))
    pc_host = seq_sgs.fam_preconditioner(mesh, v)
    np.testing.assert_allclose(z, np.asarray(pc_host(diag, sel, r)),
                               rtol=1e-11, atol=1e-13)
    # matvec sanity: A z consistent with dense assembly
    y = np.asarray(mv(r))
    dense = np.zeros((n * v, n * v))
    ds = np.asarray(diag)
    ss = np.asarray(sel)
    for p in range(n):
        dense[p * v:(p + 1) * v, p * v:(p + 1) * v] = ds[p]
        for kk, o in enumerate(offsets):
            q = p + o
            if 0 <= q < n:
                dense[p * v:(p + 1) * v, q * v:(q + 1) * v] = ss[kk, p]
    np.testing.assert_allclose(y, (dense @ np.asarray(r).ravel())
                               .reshape(n, v), rtol=1e-10, atol=1e-12)
