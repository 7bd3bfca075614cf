"""Rigid mesh motion and rotating frame (ALE).

Reference capability: CVolumetricMovement rigid motions
(Common/src/grid_movement_structure.cpp — Rigid_Rotation :1955,
Rigid_Translation :2440, Rigid_Pitching, Rigid_Plunging) plus the
ROTATING_FRAME steady formulation (absolute-velocity form: convective
fluxes evaluated with the relative velocity u - u_g plus the rotating-frame
momentum source CSourceRotatingFrame_Flow, SU2_CFD/src/numerics_source
path; driver hookup iteration_structure.cpp SetGrid_Movement).

Design: motions are PURE FUNCTIONS of time — coordinates,
rotation matrices, and grid velocities are computed analytically (the
reference also uses the analytic forms for rigid motion).  Unsteady motion
runs through the differentiable remesh path (geometry/diffgeo.py): the
coupled step takes coords(t) and grid_vel(t) as runtime ARGUMENTS, so the
whole time loop is ONE compiled program — no per-step retracing, unlike a
host-side metric rebuild.

Rigid-motion mesh metrics satisfy the GCL trivially (volumes constant in
time), so the analytic grid velocities are discretely consistent.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class Motion:
    kind: str                 # ROTATING_FRAME | RIGID_MOTION | NONE
    origin: tuple             # (x, y, z)
    rotation_rate: tuple      # (wx, wy, wz) [rad/s]  (rotating frame / rigid)
    pitching_omega: tuple     # (wx, wy, wz) [rad/s]
    pitching_ampl: tuple      # degrees
    pitching_phase: tuple     # degrees
    translation_rate: tuple   # (vx, vy, vz) [m/s]


def from_config(cfg) -> Motion | None:
    if not getattr(cfg, "grid_movement", False):
        return None
    return Motion(
        kind=cfg.grid_movement_kind,
        origin=(cfg.motion_origin_x, cfg.motion_origin_y,
                cfg.motion_origin_z),
        rotation_rate=(cfg.rotation_rate_x, cfg.rotation_rate_y,
                       cfg.rotation_rate_z),
        pitching_omega=(cfg.pitching_omega_x, cfg.pitching_omega_y,
                        cfg.pitching_omega_z),
        pitching_ampl=(cfg.pitching_ampl_x, cfg.pitching_ampl_y,
                       cfg.pitching_ampl_z),
        pitching_phase=(cfg.pitching_phase_x, cfg.pitching_phase_y,
                        cfg.pitching_phase_z),
        translation_rate=(cfg.translation_rate_x, cfg.translation_rate_y,
                          cfg.translation_rate_z),
    )


def rotating_frame_velocity(motion: Motion, coords) -> jnp.ndarray:
    """Steady rotating-frame grid velocity u_g = omega x (x - origin).

    2D meshes use omega_z only (rotation in the plane)."""
    nd = coords.shape[1]
    ox, oy, oz = motion.origin
    wx, wy, wz = motion.rotation_rate
    if nd == 2:
        rx = coords[:, 0] - ox
        ry = coords[:, 1] - oy
        return jnp.stack([-wz * ry, wz * rx], axis=1)
    r = coords - jnp.asarray([ox, oy, oz], coords.dtype)
    w = jnp.asarray([wx, wy, wz], coords.dtype)
    return jnp.cross(jnp.broadcast_to(w, r.shape), r)


def pitch_angle(motion: Motion, t):
    """Pitch angle (radians) about z at time t (Rigid_Pitching):
    theta(t) = ampl * sin(omega t + phase)."""
    ampl = np.deg2rad(motion.pitching_ampl[2])
    phase = np.deg2rad(motion.pitching_phase[2])
    w = motion.pitching_omega[2]
    return ampl * jnp.sin(w * t + phase)


def pitch_rate(motion: Motion, t):
    """d(theta)/dt at time t (analytic, matches the reference's
    Rigid_Pitching grid velocities)."""
    ampl = np.deg2rad(motion.pitching_ampl[2])
    phase = np.deg2rad(motion.pitching_phase[2])
    w = motion.pitching_omega[2]
    return ampl * w * jnp.cos(w * t + phase)


def rigid_coords_2d(motion: Motion, coords0, t):
    """coords(t) for 2D rigid motion: rotation (constant rate + pitching)
    about the origin plus constant translation."""
    ox, oy = motion.origin[0], motion.origin[1]
    theta = pitch_angle(motion, t) + motion.rotation_rate[2] * t
    c, s = jnp.cos(theta), jnp.sin(theta)
    rx = coords0[:, 0] - ox
    ry = coords0[:, 1] - oy
    x = ox + c * rx - s * ry + motion.translation_rate[0] * t
    y = oy + s * rx + c * ry + motion.translation_rate[1] * t
    return jnp.stack([x, y], axis=1)


def rigid_grid_velocity_2d(motion: Motion, coords_t, t):
    """Analytic u_g(x, t) for the 2D rigid motion: omega(t) x r + v_t,
    evaluated at the CURRENT (moved) coordinates."""
    ox = motion.origin[0] + motion.translation_rate[0] * t
    oy = motion.origin[1] + motion.translation_rate[1] * t
    wz = motion.rotation_rate[2] + pitch_rate(motion, t)
    rx = coords_t[:, 0] - ox
    ry = coords_t[:, 1] - oy
    return jnp.stack([-wz * ry + motion.translation_rate[0],
                      wz * rx + motion.translation_rate[1]], axis=1)


def rotating_frame_source(lay, v, rotation_rate, volume):
    """Momentum source of the rotating frame in absolute-velocity form
    (CSourceRotatingFrame_Flow): residual += (omega x (rho u)) * Vol.
    Returns an (N, nvar) residual contribution (ADDED to the residual,
    matching the reference's LinSysRes.AddBlock sign)."""
    nd = lay.ndim
    rho = v[:, lay.PRHO]
    vel = v[:, lay.VX:lay.VX + nd]
    m = rho[:, None] * vel
    res = jnp.zeros((v.shape[0], lay.nvar), dtype=v.dtype)
    wz = rotation_rate[2]
    if nd == 2:
        sx = -wz * m[:, 1]
        sy = wz * m[:, 0]
        res = res.at[:, lay.RHOVX].set(sx * volume)
        res = res.at[:, lay.RHOVX + 1].set(sy * volume)
    else:
        wx, wy = rotation_rate[0], rotation_rate[1]
        sx = wy * m[:, 2] - wz * m[:, 1]
        sy = wz * m[:, 0] - wx * m[:, 2]
        sz = wx * m[:, 1] - wy * m[:, 0]
        res = res.at[:, lay.RHOVX].set(sx * volume)
        res = res.at[:, lay.RHOVX + 1].set(sy * volume)
        res = res.at[:, lay.RHOVX + 2].set(sz * volume)
    return res
