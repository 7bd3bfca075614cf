"""Pure-host (numpy) mirrors of the library evaluations setup needs.

The driver's constructor needs a handful of freestream scalars (R_gas,
h(T_inf), mu(T_inf), gamma, a) before it can build the initial state;
evaluating them on the host avoids a compile and a device->host readback
per scalar at setup.  The ChemLib tables are host numpy arrays, so these formulas — the same math as
chemistry/library.py: mixture_rgas / mixture_enthalpy / mixture_viscosity /
frozen_gamma_sound (reacting_model_library.cpp:387-394, :503, :634-663) —
run entirely on the host in float64.
"""

from __future__ import annotations

import numpy as np

_Y_FLOOR = 1.0e-30


def spline_eval_np(x0: float, h: float, n: int, y, y2, t: float):
    """chemistry/spline.spline_eval for one scalar temperature (numpy).

    y, y2: (S, n) tables.  Returns (S,)."""
    y = np.asarray(y, np.float64)
    y2 = np.asarray(y2, np.float64)
    tc = min(max(float(t), x0), x0 + (n - 1) * h)
    klo = int(np.clip(int((tc - x0) / h) + 1, 1, n - 1))
    xk = x0 + klo * h
    a = (xk - tc) / h
    b = (tc - (xk - h)) / h
    return a * y[:, klo - 1] + b * y[:, klo] \
        + ((a ** 3 - a) * y2[:, klo - 1] + (b ** 3 - b) * y2[:, klo]) \
        * (h * h) / 6.0


def freestream_scalars(lib, t: float, ys):
    """(rgas, h_mix, mu_mix, gamma, sound) at one temperature/composition.

    Matches the jitted chain the driver used to run on device (library.py
    mixture_rgas/mixture_enthalpy/mixture_viscosity + frozen_gamma_sound)
    to float64 rounding."""
    ys = np.asarray(ys, np.float64)
    ys = np.where(ys < 0.0, _Y_FLOOR, ys)
    mm = np.asarray(lib.mm, np.float64)
    ri = np.asarray(lib.ri, np.float64)
    rgas = float(ys @ ri)

    h_s = spline_eval_np(lib.t0, lib.dt, lib.nt, lib.h_y, lib.h_y2, t) / mm
    cp_s = spline_eval_np(lib.t0, lib.dt, lib.nt, lib.cp_y, lib.cp_y2, t) / mm
    mu_s = spline_eval_np(lib.t0, lib.dt, lib.nt, lib.mu_y, lib.mu_y2, t)

    h_mix = float(ys @ h_s)
    cp_mix = float(ys @ cp_s)

    # Wilke rule (ComputeEta) — same pair term as library._wilke_phi_term
    yom = ys / mm
    c_mass = (mm[None, :] / mm[:, None]) ** 0.25
    c_den = 1.0 / np.sqrt(8.0 * (1.0 + mm[:, None] / mm[None, :]))
    r = np.sqrt(mu_s)
    ratio = r[:, None] / r[None, :]
    num = 1.0 + ratio * c_mass
    phi = (num * num * c_den) @ yom
    mu_mix = float(np.sum(mu_s * yom / phi))

    gamma = cp_mix / (cp_mix - rgas)
    sound = float(np.sqrt(gamma * rgas * float(t)))
    return rgas, h_mix, mu_mix, float(gamma), sound
