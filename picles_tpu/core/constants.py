"""Physics constants and ODE parameter packs.

JAX re-implementation of the parameter layer of PiCLES
(reference: src/ParticleSystems/particle_waves_v5.jl:83-196).  All structures
are frozen dataclasses of plain Python floats so they hash, making them usable
as static arguments to jitted functions; the numbers themselves only enter
traced code as compile-time constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

G_GRAVITY = 9.81


def magic_fractions(q: float = -0.25) -> Tuple[float, float, float]:
    """Universal exponent relations (reference particle_waves_v5.jl:87-92).

    Returns (p, q, n) with p = (-1 - 10 q)/2 and n = 2 q / (p + 4 q).
    """
    p = (-1.0 - 10.0 * q) / 2.0
    n = 2.0 * q / (p + 4.0 * q)
    return p, q, n


@dataclasses.dataclass(frozen=True)
class IDConstants:
    """Input/dissipation constants (reference particle_waves_v5.jl:107-128).

    ``C_e = r_w * c_beta * c_D / r_g`` and
    ``gamma = 1 - (p - q) / (c_alpha^4 * C_e * 2)``.
    """

    c_D: float = 2e-3
    c_beta: float = 4e-2
    c_e: float = 1.3e-6
    c_alpha: float = 11.8
    r_w: float = 2.35
    C_e: float = 0.0
    gamma: float = 0.0
    p: float = 0.0
    q: float = -0.25
    n: float = 0.0

    @classmethod
    def create(cls, r_g: float = 0.85, c_D: float = 2e-3, c_beta: float = 4e-2,
               c_e: float = 1.3e-6, c_alpha: float = 11.8, r_w: float = 2.35,
               q: float = -0.25) -> "IDConstants":
        p, q, n = magic_fractions(q)
        C_e = r_w * c_beta * c_D / r_g
        gamma = 1.0 - (p - q) / (c_alpha ** 4 * C_e * 2.0)
        return cls(c_D=c_D, c_beta=c_beta, c_e=c_e, c_alpha=c_alpha, r_w=r_w,
                   C_e=C_e, gamma=gamma, p=p, q=q, n=n)


@dataclasses.dataclass(frozen=True)
class ScgConstants:
    """Peak-shift constants (reference particle_waves_v5.jl:154-161)."""

    C_alpha: float = -1.41
    C_varphi: float = 1.81e-5


def e_T_func(gamma: float, p: float, q: float, n: float, *,
             c_beta: float = 2.16e-4, c_D: float = 2e-3, c_e: float = 1.3e-6,
             c_alpha: float = 11.8) -> float:
    """Equilibrium wave-energy scale, eq. A2.4 Kudryavtsev et al. 2021
    (reference particle_waves_v5.jl:271)."""
    return math.sqrt(c_e * c_alpha ** (-p / q) / (gamma * c_beta * c_D) ** (1.0 / n))


@dataclasses.dataclass(frozen=True)
class ODEParameters:
    """The parameter NamedTuple fed to the particle RHS
    (reference particle_waves_v5.jl:184-196): (r_g, C_alpha, C_varphi, C_e, g)."""

    r_g: float = 0.85
    C_alpha: float = -1.41
    C_varphi: float = 1.81e-5
    C_e: float = 0.0
    g: float = G_GRAVITY

    @classmethod
    def create(cls, r_g: float = 0.85, q: float = -0.25,
               g: float = G_GRAVITY) -> Tuple["ODEParameters", IDConstants, ScgConstants]:
        cid = IDConstants.create(r_g=r_g, q=q)
        scg = ScgConstants()
        pars = cls(r_g=r_g, C_alpha=scg.C_alpha, C_varphi=scg.C_varphi,
                   C_e=cid.C_e, g=g)
        return pars, cid, scg


@dataclasses.dataclass(frozen=True)
class ODESettings:
    """Solver configuration (reference particle_waves_v5.jl:34-75).

    ``timestep`` is the remeshing step DT of the model; the adaptive solver
    sub-steps within it.  ``dt`` is the initial sub-step, ``dtmin`` the
    smallest allowed one.  ``log_energy_maximum`` defaults to log(17).
    """

    log_energy_minimum: float = -20.0
    log_energy_maximum: float = math.log(17.0)
    wind_min_squared: float = 4.0
    saving_step: float = 600.0
    timestep: float = 600.0
    abstol: float = 1e-4
    reltol: float = 1e-3
    maxiters: int = 10_000
    adaptive: bool = True
    dt: float = 60.0 * 6       # initial sub-step (seconds)
    dtmin: float = 1e-4        # smallest allowed sub-step (seconds)
    force_dtmin: bool = True
    total_time: float = 60.0 * 60.0 * 24.0
    # embedded-RK method: "tsit5" (the reference's AutoTsit5 family,
    # particle_waves_v5.jl:47) or "bosh3" (Bogacki–Shampine 3(2) — half the
    # RHS evals per substep at the same error tolerances)
    solver: str = "tsit5"

    def __post_init__(self):
        from ..ops.tsit5 import METHODS

        if self.solver not in METHODS:
            raise ValueError(
                f"unknown solver {self.solver!r}; valid choices: "
                f"{sorted(METHODS)}")
