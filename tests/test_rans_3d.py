"""3D implicit reactive RANS end-to-end (VERDICT round-2 item 1).

A 3D channel (box mesh) with the flat-plate 3-species air chemistry:
REACTIVE_NAVIER_STOKES + SST, MUSCL AUSM, implicit Euler flow + implicit
turb, no-slip heatflux wall at z_min.  Exercises the 3D viscous Jacobians
(ops/viscous.py 3D branch), 3D SST coupling and 3D weak/strong BCs that the
reference supports nDim-generically (solver_direct_reactive.cpp:4953,
numerics_direct_reactive.cpp:1337).
"""

import os
import textwrap

import numpy as np
import pytest

from su2_tpu.config import Config
from su2_tpu.driver import Simulation
from su2_tpu.geometry.structured import box_mesh

CFG = textwrap.dedent("""
    CONFIG_LIB_FILE = test_air.txt
    FREESTREAM_MASS_FRAC = (0.2197, 0.0302, 0.7501)
    SPECIES_ORDER = (O2, CO2, N2)
    PHYSICAL_PROBLEM= REACTIVE_NAVIER_STOKES
    KIND_TURB_MODEL= SST
    MACH_NUMBER= 0.2
    FREESTREAM_TEMPERATURE= 297.62
    FREESTREAM_VELOCITY= (69.1687, 0.0, 0.0)
    FREESTREAM_PRESSURE= 113303.0
    REYNOLDS_LENGTH= 1.000
    REYNOLDS_NUMBER= 500000
    FREESTREAM_TURBULENCEINTENSITY = 0.05
    FREESTREAM_TURB2LAMVISCRATIO = 10.0
    MARKER_HEATFLUX = (z_min, 0.0)
    MARKER_EULER= ( z_max, y_min, y_max )
    MARKER_INLET= ( inlet, 300.0, 100000.0, 1.0, 0.0, 0.0 )
    INLET_MASS_FRAC = (inlet, 0.2197, 0.0302, 0.7501)
    MARKER_OUTLET= ( outlet, 97250.0 )
    NUM_METHOD_GRAD= WEIGHTED_LEAST_SQUARES
    CFL_NUMBER= 2.0
    LINEAR_SOLVER= FGMRES
    LINEAR_SOLVER_PREC= LU_SGS
    LINEAR_SOLVER_ERROR= 1E-6
    LINEAR_SOLVER_ITER= 5
    CONV_NUM_METHOD_FLOW= AUSM
    SPATIAL_ORDER_FLOW= 2ND_ORDER
    SLOPE_LIMITER_FLOW= VENKATAKRISHNAN
    LIMITER_COEFF= 0.05
    TIME_DISCRE_FLOW= EULER_IMPLICIT
    CONV_NUM_METHOD_TURB= SCALAR_UPWIND
    TIME_DISCRE_TURB= EULER_IMPLICIT
    MESH_FILENAME= unused.su2
""")


@pytest.mark.slow
def test_implicit_rans_3d_channel(flatplate_dir, tmp_path):
    cfg_path = tmp_path / "case3d.cfg"
    cfg_path.write_text(CFG)
    cwd = os.getcwd()
    os.chdir(flatplate_dir)  # chemistry manifest paths
    try:
        sim = Simulation(Config(str(cfg_path)),
                         raw_mesh=box_mesh(9, 5, 7, 2.0, 0.5, 0.5))
        u, _, hist, turb = sim.run(5, quiet=True)
    finally:
        os.chdir(cwd)
    hist = np.asarray(hist)
    assert np.isfinite(np.asarray(u)).all()
    assert np.isfinite(hist).all()
    assert (np.asarray(u)[:, sim.lay.RHO] > 0).all()
    # implicit 3D RANS converges from the freestream transient
    assert hist[-1][sim.lay.RHO] < hist[0][sim.lay.RHO] - 0.2
    # turbulence state stays physical
    q = np.asarray(turb[0] if isinstance(turb, tuple) else turb)
    assert np.isfinite(q).all()


