"""Natural cubic splines on equispaced grids.

Precompute runs on host (NumPy); evaluation is vectorized JAX used inside the
hot per-cell thermo kernels.  Mirrors MathTools::SetSpline / GetSpline
(reference: Common/src/Tools/spline.cpp) including the equispaced-grid fast
bin lookup, so table evaluations agree to rounding.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def spline_second_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Natural-BC second-derivative coefficients (SetSpline with yp1,ypn>1e30).

    Supports batched y of shape (..., n); x is the shared (n,) grid.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    assert y.shape[-1] == n
    y2 = np.zeros_like(y)
    u = np.zeros_like(y)
    # decomposition loop of the tridiagonal algorithm (natural BC: y2[0]=0)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[..., i - 1] + 2.0
        y2[..., i] = (sig - 1.0) / p
        du = (y[..., i + 1] - y[..., i]) / (x[i + 1] - x[i]) \
            - (y[..., i] - y[..., i - 1]) / (x[i] - x[i - 1])
        u[..., i] = (6.0 * du / (x[i + 1] - x[i - 1]) - sig * u[..., i - 1]) / p
    y2[..., n - 1] = 0.0
    for k in range(n - 2, -1, -1):
        y2[..., k] = y2[..., k] * y2[..., k + 1] + u[..., k]
    return y2


def spline_eval(x0: float, h: float, n: int, y: jnp.ndarray, y2: jnp.ndarray,
                t: jnp.ndarray) -> jnp.ndarray:
    """Evaluate species splines at temperatures ``t``.

    y, y2: (S, n) per-species tables on the shared equispaced grid
    x0 + k*h, k = 0..n-1.  t: any shape (...).  Returns (..., S).

    The equispaced lookup klo = (t - x0)/h + 1 matches GetSpline
    (spline.cpp:66-74); t is clamped into the table domain (the reference
    throws std::out_of_range and falls back to bisection — here we clamp
    and let the caller's Tmin/Tmax clipping handle out-of-domain states).
    """
    tc = jnp.clip(t, x0, x0 + (n - 1) * h)
    klo = jnp.clip(((tc - x0) / h).astype(jnp.int32) + 1, 1, n - 1)
    xk = x0 + klo.astype(y.dtype) * h
    a = (xk - tc) / h
    b = (tc - (xk - h)) / h
    yl = jnp.moveaxis(jnp.take(y, klo - 1, axis=-1), 0, -1)   # (..., S)
    yh = jnp.moveaxis(jnp.take(y, klo, axis=-1), 0, -1)
    y2l = jnp.moveaxis(jnp.take(y2, klo - 1, axis=-1), 0, -1)
    y2h = jnp.moveaxis(jnp.take(y2, klo, axis=-1), 0, -1)
    a = a[..., None]
    b = b[..., None]
    return a * yl + b * yh + ((a**3 - a) * y2l + (b**3 - b) * y2h) * (h * h) / 6.0
