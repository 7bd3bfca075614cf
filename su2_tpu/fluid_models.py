"""Fluid models: ideal gas, van der Waals, Peng-Robinson.

Reference capability: CFluidModel hierarchy (SU2_CFD/src/fluid_model.cpp,
fluid_model_pig.cpp, fluid_model_pvdw.cpp, fluid_model_ppr.cpp) used by the
standard compressible solver with FLUID_MODEL= IDEAL_GAS / VW_GAS / PR_GAS.

All state calls are vectorized over node batches (rho, e are arrays), and
the cubic-EoS Newton iterations run a fixed masked budget — the batched form of
the reference's do/while loops.  The reactive path uses the chemistry
library instead; these models back the single-species solvers and are unit
consistency-tested against their own inverse maps.
"""

from __future__ import annotations

import jax.numpy as jnp


class IdealGas:
    """CIdealGas (fluid_model_pig.cpp): P = (gamma-1) rho e."""

    def __init__(self, gamma: float, r_gas: float):
        self.gamma = gamma
        self.r = r_gas
        self.g1 = gamma - 1.0

    def state_rhoe(self, rho, e):
        p = self.g1 * rho * e
        t = self.g1 * e / self.r
        a2 = self.gamma * self.g1 * e
        s = self.r / self.g1 * jnp.log(t) + self.r * jnp.log(1.0 / rho)
        return {"P": p, "T": t, "a2": a2, "s": s,
                "dPdrho_e": self.g1 * e, "dPde_rho": self.g1 * rho,
                "Zed": jnp.ones_like(p)}

    def state_pt(self, p, t):
        rho = p / (self.r * t)
        e = t * self.r / self.g1
        return self.state_rhoe(rho, e) | {"rho": rho, "e": e}

    def state_prho(self, p, rho):
        e = p / (self.g1 * rho)
        return self.state_rhoe(rho, e) | {"rho": rho, "e": e}


class VanDerWaalsGas(IdealGas):
    """CVanDerWaalsGas (fluid_model_pvdw.cpp): a, b from critical state."""

    def __init__(self, gamma, r_gas, p_crit, t_crit):
        super().__init__(gamma, r_gas)
        self.a = 27.0 / 64.0 * r_gas * r_gas * t_crit * t_crit / p_crit
        self.b = 1.0 / 8.0 * r_gas * t_crit / p_crit

    def state_rhoe(self, rho, e):
        a, b, g1, r = self.a, self.b, self.g1, self.r
        p = g1 * rho / (1.0 - rho * b) * (e + rho * a) - a * rho * rho
        t = (p + rho * rho * a) * (1.0 - rho * b) / (rho * r)
        s = r * (jnp.log(t) / g1 + jnp.log(1.0 / rho - b))
        dpde = rho * g1 / (1.0 - rho * b)
        dpdrho = g1 / (1.0 - rho * b) * (
            (e + 2.0 * rho * a)
            + rho * b * (e + rho * a) / (1.0 - rho * b)) - 2.0 * rho * a
        a2 = dpdrho + p / (rho * rho) * dpde
        return {"P": p, "T": t, "a2": a2, "s": s,
                "dPdrho_e": dpdrho, "dPde_rho": dpde,
                "Zed": p / (r * t * rho)}

    def state_pt(self, p, t, n_newton: int = 20):
        """Cubic compressibility solve Z^3 - Z^2(B+1) + ZA - AB = 0
        (SetTDState_PT with the reference's 0.7-damped Newton)."""
        a_c = self.a * p / (t * self.r) ** 2
        b_c = self.b * p / (t * self.r)
        z = jnp.full_like(jnp.asarray(p, dtype=jnp.result_type(p, 1.0)), 0.99)
        for _ in range(n_newton):
            f = z ** 3 - z * z * (b_c + 1.0) + z * a_c - a_c * b_c
            f1 = 3.0 * z * z - 2.0 * z * (b_c + 1.0) + a_c
            z = z - 0.7 * f / f1
        rho = p / (z * self.r * t)
        e = t * self.r / self.g1 - self.a * rho
        return self.state_rhoe(rho, e) | {"rho": rho, "e": e}

    def state_prho(self, p, rho):
        e = (p + self.a * rho * rho) * (1.0 - rho * self.b) \
            / (rho * self.g1) - self.a * rho
        return self.state_rhoe(rho, e) | {"rho": rho, "e": e}


class PengRobinsonGas(IdealGas):
    """CPengRobinson (fluid_model_ppr.cpp): acentric-factor alpha function."""

    def __init__(self, gamma, r_gas, p_crit, t_crit, omega):
        super().__init__(gamma, r_gas)
        self.a = 0.45724 * r_gas * r_gas * t_crit * t_crit / p_crit
        self.b = 0.0778 * r_gas * t_crit / p_crit
        self.t_crit = t_crit
        if omega <= 0.49:
            self.k = 0.37464 + 1.54226 * omega - 0.26992 * omega ** 2
        else:
            self.k = (0.379642 + 1.48503 * omega - 0.164423 * omega ** 2
                      + 0.016666 * omega ** 3)

    def _alpha2(self, t):
        s = 1.0 + self.k * (1.0 - jnp.sqrt(t / self.t_crit))
        return s * s

    def state_rhoe(self, rho, e):
        a, b, k, r, g1 = self.a, self.b, self.k, self.r, self.g1
        sqrt2 = jnp.sqrt(2.0)
        x = rho * b * sqrt2 / (1.0 + rho * b)
        fv = 0.5 * (jnp.log(1.0 + x) - jnp.log(1.0 - x))
        big_a = r / g1
        big_b = a * k * (k + 1.0) * fv / (b * sqrt2 * jnp.sqrt(self.t_crit))
        big_c = a * (k + 1.0) ** 2 * fv / (b * sqrt2) + e
        t = ((-big_b + jnp.sqrt(big_b * big_b + 4.0 * big_a * big_c))
             / (2.0 * big_a)) ** 2
        a2t = self._alpha2(t)
        den_a = 1.0 / rho ** 2 + 2.0 * b / rho - b * b
        den_b = 1.0 / rho - b
        p = t * r / den_b - a * a2t / den_a
        s = r / g1 * jnp.log(t) + r * jnp.log(den_b) \
            - a * jnp.sqrt(a2t) * k * fv / (b * sqrt2
                                            * jnp.sqrt(t * self.t_crit))
        dpdd_t = (t * r / den_b ** 2
                  - 2.0 * a * a2t * (1.0 / rho + b) / den_a ** 2) / rho ** 2
        dpdt_d = r / den_b + a * k / den_a * jnp.sqrt(
            a2t / (t * self.t_crit))
        cv = r / g1 + a * k * (k + 1.0) * fv / (
            2.0 * b * jnp.sqrt(2.0 * t * self.t_crit))
        dpde = dpdt_d / cv
        dedd_t = -a * (1.0 + k) * jnp.sqrt(a2t) / den_a / rho ** 2
        dpdrho = dpdd_t - dpde * dedd_t
        a2 = dpdrho + p / rho ** 2 * dpde
        return {"P": p, "T": t, "a2": a2, "s": s,
                "dPdrho_e": dpdrho, "dPde_rho": dpde,
                "Zed": p / (r * t * rho), "Cv": cv}

    def state_prho(self, p, rho):
        """T from P, rho (T_P_rho) then e from the alpha-function energy
        (SetEnergy_Prho)."""
        a, b, k, r = self.a, self.b, self.k, self.r
        vb1 = 1.0 / rho - b
        vb2 = 1.0 / rho ** 2 + 2.0 * b / rho - b * b
        big_a = r / vb1 - a * k * k / self.t_crit / vb2
        big_b = 2.0 * a * k * (k + 1.0) / jnp.sqrt(self.t_crit) / vb2
        big_c = -p - a * (1.0 + k) ** 2 / vb2
        t = ((-big_b + jnp.sqrt(big_b * big_b - 4.0 * big_a * big_c))
             / (2.0 * big_a)) ** 2
        sqrt2 = jnp.sqrt(2.0)
        x = rho * b * sqrt2 / (1.0 + rho * b)
        fv = 0.5 * (jnp.log(1.0 + x) - jnp.log(1.0 - x))
        # SetEnergy_Prho (:315): e = T R/(g-1) - a(1+k) sqrt(alpha2) fv/(b s2)
        e = t * r / self.g1 \
            - a * (1.0 + k) * jnp.sqrt(self._alpha2(t)) * fv / (b * sqrt2)
        return self.state_rhoe(rho, e) | {"rho": rho, "e": e}


def make_fluid_model(cfg):
    """FLUID_MODEL dispatch (CDriver fluid-model selection)."""
    kind = getattr(cfg, "fluid_model", "IDEAL_GAS")
    if kind in ("IDEAL_GAS", "STANDARD_AIR"):
        return IdealGas(cfg.gamma_value, cfg.gas_constant)
    if kind == "VW_GAS":
        return VanDerWaalsGas(cfg.gamma_value, cfg.gas_constant,
                              cfg.critical_pressure, cfg.critical_temperature)
    if kind == "PR_GAS":
        return PengRobinsonGas(cfg.gamma_value, cfg.gas_constant,
                               cfg.critical_pressure,
                               cfg.critical_temperature,
                               cfg.acentric_factor)
    raise NotImplementedError(kind)
