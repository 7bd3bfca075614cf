"""Stand-in for the flagship PaSR jet-combustor case, built from a seed.

The flagship case of the reference fork (reactive Navier-Stokes + SST +
PaSR on a 9-species, 2-reaction C4H6/O2 mechanism) ships its mesh and
chemistry tables outside this repository.  This module writes a case with
the same shapes from numbers held here, through the repository's own
writers, so every parser on the main path runs on it:

  - a wall-graded 2D channel (``geometry.structured.channel_mesh`` markers
    ``inlet``/``outlet``/``lower_wall``/``upper_wall``) written as ``.su2``;
  - a chemistry library in the manifest format of ``io.tables``: mixture,
    chemistry and per-species transport and thermo tables;
  - a cfg with the flagship's physics: REACTIVE_NAVIER_STOKES, SST, PaSR,
    AUSM, WLS gradients, explicit flow, implicit SST with FGMRES/LU_SGS.

Species data.  Molar masses and the 298.15 K formation enthalpies, entropies
and heat capacities are from the NIST-JANAF Thermochemical Tables (4th ed.,
1998), except C4H6 (1,3-butadiene), which JANAF does not list (see
ASSUMED).  Sutherland constants are from White, *Viscous Fluid Flow*
(3rd ed.), Table 1-2, where listed there.  Diffusion volumes are Fuller's
(Fuller, Schettler & Giddings 1966, as tabulated in Poling, Prausnitz &
O'Connell, *The Properties of Gases and Liquids*, Table 11-1).  The CO/CO2
rates are Westbrook & Dryer's (Combust. Sci. Tech. 27, 1981).  Everything
else is listed in ``ASSUMED``.

Usage::

    from su2_tpu import testcase
    cfg_path = testcase.write_case(out_dir, nx=1201, ny=471, seed=0)
    su2_tpu.driver.main([cfg_path, "50"])
"""

from __future__ import annotations

import os

import numpy as np

from su2_tpu.geometry.structured import channel_mesh
from su2_tpu.io.mesh import RawMesh, write_su2_mesh
from su2_tpu.io.tables import R_UNGAS

# name: (molar mass g/mol, formation enthalpy kJ/mol, S298 J/(mol K),
#        cp J/(mol K), Fuller diffusion volume)
SPECIES = {
    "C4H6": (54.0904, 110.0, 278.7, 79.5, 77.46),
    "H2O": (18.01528, -241.826, 188.834, 33.590, 13.1),
    "O2": (31.9988, 0.0, 205.147, 29.376, 16.3),
    "CO": (28.0101, -110.527, 197.653, 29.142, 18.0),
    "CO2": (44.0095, -393.522, 213.795, 37.129, 26.9),
    "H2": (2.01588, 0.0, 130.680, 28.836, 6.12),
    "O": (15.9994, 249.173, 161.058, 21.911, 6.11),
    "OH": (17.00734, 38.987, 183.737, 29.986, 8.42),
    "H": (1.00794, 217.999, 114.716, 20.786, 2.31),
}

# Sutherland viscosity mu = mu0 (T/T0)^1.5 (T0+S)/(T+S), T0 = 273 K:
# name: (mu0 Pa s, S K)
SUTHERLAND = {
    "C4H6": (6.9e-6, 300.0),
    "H2O": (1.12e-5, 1064.0),
    "O2": (1.919e-5, 139.0),
    "CO": (1.657e-5, 136.0),
    "CO2": (1.370e-5, 222.0),
    "H2": (8.411e-6, 97.0),
    "O": (1.8e-5, 120.0),
    "OH": (1.7e-5, 120.0),
    "H": (8.0e-6, 80.0),
}

ASSUMED = (
    "thermo: cp of every species is held at its 298.15 K value at all "
    "temperatures (h and s follow from it exactly)",
    "C4H6: formation enthalpy, S298 and cp are rounded NIST Chemistry "
    "WebBook values (not in JANAF)",
    "Sutherland constants of C4H6, O, OH and H",
    "conductivity from the Eucken relation kappa = mu (cp + 1.25 R/M)",
    "Fuller volumes of O, OH, H and C4H6 summed from atomic increments",
    "C4H6 oxidation C4H6 + 3.5 O2 => 4 CO + 3 H2O: A = 8.8e11 (CGS), "
    "Ea = 30 kcal/mol, first order in C4H6 and O2",
    "CO oxidation without the Westbrook-Dryer [H2O]^0.5 factor",
    "geometry: 5 cm x 1.5 cm channel (the flagship mesh's 7.5e-4 m^2 area), "
    "tanh wall grading, interior nodes jittered by the seed",
)

SPECIES_ORDER = tuple(SPECIES)
T_GRID = np.arange(100.0, 6000.0 + 0.5, 10.0)
_T0_SUTH = 273.0
_T_REF = 298.15

LX, LY = 0.05, 0.015

# mass fractions: the channel starts filled with a lean C4H6/O2 premix and
# is fed a richer one (stoichiometric Y_C4H6 is 0.235), so every node mixes
# two species and the inlet carries a composition gradient; both stay inert
# at the 300 K inlet and wall temperature (test_mixture_inert_at_inlet_
# temperature)
FILL_MIX = {"C4H6": 0.05, "O2": 0.95}
INLET_MIX = {"C4H6": 0.2, "O2": 0.8}

# one-card and four-card sizes: 565,671 and 2,259,341 nodes
SIZES = {"565k": (1201, 471), "2.26M": (2401, 941)}


def graded_channel(nx: int, ny: int, seed: int | None = 0,
                   beta: float = 1.5, jitter: float = 0.1) -> RawMesh:
    """Wall-graded quad channel: tanh clustering toward both walls, with
    interior nodes moved by up to ``jitter`` of the local spacing (seeded;
    ``seed=None`` keeps the lattice)."""
    raw = channel_mesh(nx, ny, LX, LY)
    eta = np.linspace(-1.0, 1.0, ny)
    yg = 0.5 * LY * (1.0 + np.tanh(beta * eta) / np.tanh(beta))
    xg = np.linspace(0.0, LX, nx)
    x = np.repeat(xg, ny)
    y = np.tile(yg, nx)
    if seed is not None:
        rng = np.random.default_rng(seed)
        dx = LX / (nx - 1)
        dy = np.minimum(np.diff(yg)[:-1], np.diff(yg)[1:])  # interior rows
        jx = rng.uniform(-jitter, jitter, (nx - 2, ny - 2)) * dx
        jy = rng.uniform(-jitter, jitter, (nx - 2, ny - 2)) * dy[None, :]
        x = x.reshape(nx, ny)
        y = y.reshape(nx, ny)
        x[1:-1, 1:-1] += jx
        y[1:-1, 1:-1] += jy
        x, y = x.ravel(), y.ravel()
    raw.coords = np.stack([x, y], axis=1)
    return raw


def mixture_states(lib, lay, n: int, seed: int = 0):
    """(u, t_guess, tke) float64 numpy: ``n`` seeded random mixtures of the
    library's species at 250-2500 K (Dirichlet mass fractions), with the
    energy taken from the library's enthalpy splines.  Node-state checks
    use them to cover all nine species and temperatures that the stand-in's
    cold two-species flow does not reach."""
    rng = np.random.default_rng(seed)
    ns = lay.ns
    ys = rng.dirichlet(np.full(ns, 0.5), n)
    t = rng.uniform(250.0, 2500.0, n)
    rho = rng.uniform(0.1, 3.0, n)
    vel = rng.normal(0.0, 30.0, (n, lay.ndim))
    tke = rng.uniform(0.0, 5.0, n)
    t0, h, nt = float(lib.t0), float(lib.dt), int(lib.nt)
    tc = np.clip(t, t0, t0 + (nt - 1) * h)
    klo = np.clip(((tc - t0) / h).astype(np.int64) + 1, 1, nt - 1)
    a = ((t0 + klo * h) - tc) / h
    b = 1.0 - a
    hy, hy2 = np.asarray(lib.h_y), np.asarray(lib.h_y2)
    hs = (a[:, None] * hy[:, klo - 1].T + b[:, None] * hy[:, klo].T
          + ((a ** 3 - a)[:, None] * hy2[:, klo - 1].T
             + (b ** 3 - b)[:, None] * hy2[:, klo].T) * h * h / 6.0)
    mm, ri = np.asarray(lib.mm), np.asarray(lib.ri)
    e = (ys * hs / mm).sum(1) - (ys * ri).sum(1) * t
    u = np.zeros((n, lay.nvar))
    u[:, lay.RHO] = rho
    u[:, lay.RHOVX:lay.RHOVX + lay.ndim] = rho[:, None] * vel
    u[:, lay.RHOE] = rho * (e + 0.5 * (vel ** 2).sum(1) + tke)
    u[:, lay.RHOS:lay.RHOS + ns] = rho[:, None] * ys
    t_guess = t * (1.0 + rng.uniform(-0.05, 0.05, n))
    return u, t_guess, tke


def _fmt_rows(rows: np.ndarray) -> str:
    return "\n".join(" " + " ".join(f"{v:.10e}" for v in r) for r in rows)


def write_library(out_dir: str, species=SPECIES_ORDER) -> str:
    """Write the chemistry library; returns the manifest path.  The full
    species set carries the two-step mechanism; a subset (in the order
    given) is an inert mixture, written without a chemistry file."""
    os.makedirs(out_dir, exist_ok=True)
    species = tuple(species)
    lines = [f"{len(species)}"]
    for name in species:
        mm, hf, _s, _cp, dv = SPECIES[name]
        lines.append(f"{name} {mm} {hf} {dv}")
    _write(out_dir, "mixture.txt",
           "% mixture: name, molar mass [g/mol], formation enthalpy "
           "[kJ/mol], Fuller diffusion volume\n" + "\n".join(lines)
           + "\nSTOP\n")
    manifest = ["mixture.txt"]
    if species == SPECIES_ORDER:
        _write(out_dir, "reactions.txt", f"""% two-step C4H6/O2 mechanism
2
CGS
C4H6_1.0 + 3.5O2_1.0 => 4CO + 3H2O
 8.80e11 0.0 {30.0e3}
CO_1.0 + 0.5O2_0.5 <=> CO2_1.0
 3.98e14 0.0 {40.0e3}
Available Backward Rate reaction 2: 5.00e8 0.0 {40.0e3}
STOP
""")
        manifest.append("reactions.txt")
    t = T_GRID
    for name in species:
        mm, hf, s298, cp, _dv = SPECIES[name]
        # molar tables in J/kmol units (io.tables convention)
        cp_k = np.full_like(t, cp * 1e3)
        h_k = hf * 1e6 + cp_k * (t - _T_REF)
        s_k = s298 * 1e3 + cp_k * np.log(t / _T_REF)
        mu0, suth = SUTHERLAND[name]
        mu = mu0 * (t / _T0_SUTH) ** 1.5 * (_T0_SUTH + suth) / (t + suth)
        kappa = mu * (cp_k / mm + 1.25 * R_UNGAS / mm)
        _write(out_dir, f"{name}_transport.txt",
               f"% T mu kappa\n{name}\n"
               + _fmt_rows(np.stack([t, mu, kappa], 1)) + "\nSTOP\n")
        _write(out_dir, f"{name}_thermo.txt",
               f"% T cp h s (molar)\n{name}\n"
               + _fmt_rows(np.stack([t, cp_k, h_k, s_k], 1)) + "\nSTOP\n")
        manifest += [f"{name}_transport.txt", f"{name}_thermo.txt"]
    return _write(out_dir, "library.txt", "\n".join(manifest) + "\n")


def _fracs(mix: dict) -> str:
    return ", ".join(repr(float(mix.get(name, 0.0))) for name in SPECIES_ORDER)


def cfg_text(mesh_file: str = "mesh.su2", lib_file: str = "library.txt",
             niter: int = 50) -> str:
    """The flagship's physics, with the freestream pressure at the outlet
    pressure so that a cold start has no pressure transient."""
    return f"""% stand-in for the flagship PaSR jet combustor (su2_tpu.testcase)
PHYSICAL_PROBLEM= REACTIVE_NAVIER_STOKES
KIND_TURB_MODEL= SST
CONFIG_LIB_FILE= {lib_file}
SPECIES_ORDER= ({", ".join(SPECIES_ORDER)})
FREESTREAM_MASS_FRAC= ({_fracs(FILL_MIX)})
MACH_NUMBER= 0.02
FREESTREAM_TEMPERATURE= 300.0
FREESTREAM_VELOCITY= (6.0, 0.0, 0.0)
FREESTREAM_PRESSURE= 101325.0
INLET_TYPE= TEMPERATURE_IMPOSE
MARKER_INLET= ( inlet, 300.0, 6.0, 1.0, 0.0, 0.0 )
INLET_MASS_FRAC= (inlet, {_fracs(INLET_MIX)})
MARKER_OUTLET= ( outlet, 101325.0 )
MARKER_ISOTHERMAL= ( upper_wall, 300.0, lower_wall, 300.0 )
MARKER_PLOTTING= ( lower_wall )
NUM_METHOD_GRAD= WEIGHTED_LEAST_SQUARES
CFL_NUMBER= 0.1
CONV_NUM_METHOD_FLOW= AUSM
SPATIAL_ORDER_FLOW= 1ST_ORDER
TIME_DISCRE_FLOW= EULER_EXPLICIT
TIME_DISCRE_TURB= EULER_IMPLICIT
LINEAR_SOLVER= FGMRES
LINEAR_SOLVER_PREC= LU_SGS
LINEAR_SOLVER_ERROR= 1E-6
LINEAR_SOLVER_ITER= 5
PASR_LB= 0.2
EXT_ITER= {niter}
MESH_FILENAME= {mesh_file}
MESH_FORMAT= SU2
OUTPUT_FORMAT= TECPLOT_BINARY
CONV_FILENAME= history
RESTART_FLOW_FILENAME= restart_flow.dat
VOLUME_FLOW_FILENAME= flow
SURFACE_FLOW_FILENAME= surface_flow
"""


def write_case(out_dir: str, nx: int = 1201, ny: int = 471,
               seed: int | None = 0, niter: int = 50,
               mesh: RawMesh | None = None) -> str:
    """Write mesh, chemistry library and cfg into ``out_dir``; returns the
    cfg path.  ``mesh`` skips building the channel (reuse across cases)."""
    os.makedirs(out_dir, exist_ok=True)
    write_library(out_dir)
    raw = graded_channel(nx, ny, seed) if mesh is None else mesh
    write_su2_mesh(raw, os.path.join(out_dir, "mesh.su2"))
    return _write(out_dir, "case.cfg", cfg_text(niter=niter))


def _write(out_dir: str, name: str, text: str) -> str:
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(text)
    return path
