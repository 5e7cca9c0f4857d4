"""Particle-wave ODE right-hand sides (Kudryavtsev et al. 2021 closures).

JAX re-implementation of the reference ``particle_equations`` factory
(src/ParticleSystems/particle_waves_v5.jl:382-563 for 2D, :584-652 for 1D).

Design: the reference builds one mutable closure per particle; here the RHS is
a single pure function evaluated on stacked state arrays ``z[..., 5]`` so the
whole grid of particles advances in one fused VPU pass.  All reference
``IfElse.ifelse`` branches map to ``jnp.where``; the ``max()`` clamps around
the c_g conversions are kept bit-for-bit (g/(4 max(c_gp^2, 1e-2)) etc.).

The wind is sampled at the *node* position carried in the per-particle
parameters, not the advected position — this mirrors the reference, where
``params.x/params.y`` override the state coordinates inside the RHS
(particle_waves_v5.jl:488-495).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp

from ..core.constants import (IDConstants, ODEParameters, e_T_func,
                              magic_fractions)

ALPHA_THRESH = 0.85  # reference particle_waves_v5.jl:274-275


class RHSParams(NamedTuple):
    """Per-particle dynamic parameters fed to the RHS.

    All fields broadcast against the particle batch:
      x, y        : node coordinates (wind-sampling location)
      M           : projection matrix [..., 2, 2], m/s -> grid-index/s
      pc          : great-circle correction coefficient (tan(lat)/R, clamped)
    """

    x: jnp.ndarray
    y: jnp.ndarray
    M: jnp.ndarray
    pc: jnp.ndarray


def speed(cx, cy):
    return jnp.sqrt(cx ** 2 + cy ** 2)


def alpha_p(u, v, cx, cy):
    """Projected wave age: (u cx + v cy) / (2 max(|c|,1e-4)^2)
    (reference particle_waves_v5.jl:212)."""
    return (u * cx + v * cy) / (2.0 * jnp.maximum(speed(cx, cy), 1e-4) ** 2)


def alpha_func(u_speed, c_gp_speed):
    """Wave age u/(2 c_gp), clamped at 500 (reference :215-225)."""
    a = u_speed / (2.0 * c_gp_speed)
    return jnp.where(a > 500.0, 500.0, a)


def sin2_a_min_b(ux, uy, cx, cy):
    """sin(2(phi_u - phi_c)) via components (reference :242-249)."""
    denom = speed(ux, uy) * speed(cx, cy)
    safe = jnp.where(denom == 0, 1.0, denom)
    val = (2.0 / safe ** 2) * (ux * uy * (2.0 * cy ** 2 - speed(cx, cy) ** 2)
                               - cx * cy * (2.0 * uy ** 2 - speed(ux, uy) ** 2))
    return jnp.where(denom == 0, 0.0, val)


def H_beta(alpha, p):
    """Input window 0.5 (1 + tanh(p (alpha - 0.85))) (reference :274)."""
    return 0.5 * (1.0 + jnp.tanh(p * (alpha - ALPHA_THRESH)))


def Delta_beta(alpha):
    """Peak-shift window 1 - 1.25 sech^2(10 (alpha - 0.85)) (reference :275).

    sech is written via one exponential: stable for large |x|, and the
    same elementwise ops lower inside the Pallas advance kernel."""
    ax = jnp.abs(10.0 * (alpha - ALPHA_THRESH))
    e = jnp.exp(-ax)
    sech = 2.0 * e / (1.0 + e * e)
    return 1.0 - 1.25 * sech ** 2


def c_g_conversions(c_bar, r_g, g):
    """(c_gp, k_p, omega_p) from mean group speed (reference :281-295)."""
    c_gp = c_bar / r_g
    k_p = g / (4.0 * jnp.maximum(c_gp ** 2, 1e-2))
    omega_p = g / (2.0 * jnp.maximum(jnp.abs(c_gp), 0.1))
    return c_gp, k_p, omega_p


def I_tilde(alpha, H_p, C_e):
    """Wind input C_e H_p alpha^2 (reference :317-321)."""
    return C_e * H_p * alpha ** 2


def D_tilde_lne(lne, k_p, e_T, n):
    """Dissipation exp(n lne) (k_p/e_T)^(2n) (reference :331-335)."""
    return jnp.exp(n * lne) * (k_p / e_T) ** (2.0 * n)


def S_cg(lne, Delta_p, k_p, C_alpha):
    """Peak downshift C_alpha Delta_p k_p^4 e^(2 lne) (reference :340)."""
    return C_alpha * Delta_p * k_p ** 4 * jnp.exp(2.0 * lne)


def S_dir(u, v, cx, cy, C_varphi, H_p):
    """Peak-direction shift (reference :345-351)."""
    return (alpha_func(speed(u, v), speed(cx, cy)) ** 2
            * C_varphi * H_p * sin2_a_min_b(u, v, cx, cy))


@dataclasses.dataclass(frozen=True)
class TermFlags:
    """Source-term switches (reference particle_equations kwargs :382-390)."""

    propagation: bool = True
    input: bool = True
    dissipation: bool = True
    peak_shift: bool = True
    direction: bool = True


class RHSConsts(NamedTuple):
    """Scalar constants baked into the RHS (hashable, pallas-safe)."""

    r_g: float
    C_alpha: float
    C_e: float
    C_varphi: float
    g: float
    p: float
    n: float
    e_T: float


def make_rhs_consts(gamma: float = 0.88, q: float = -0.25,
                    constants: Optional[IDConstants] = None,
                    params: Optional[ODEParameters] = None) -> RHSConsts:
    if params is None:
        params, constants, _ = ODEParameters.create(q=q)
    if constants is None:
        constants = IDConstants.create(r_g=params.r_g, q=q)
    p_, q_, n_ = magic_fractions(q)
    e_T = e_T_func(gamma, p_, q_, n_, c_beta=constants.c_beta,
                   c_D=constants.c_D, c_e=constants.c_e,
                   c_alpha=constants.c_alpha)
    return RHSConsts(r_g=params.r_g, C_alpha=params.C_alpha, C_e=params.C_e,
                     C_varphi=params.C_varphi, g=params.g, p=p_, n=n_,
                     e_T=e_T)


def rhs_core_2d(lne, cg_x, cg_y, u, v, M00, M01, M10, M11, pc,
                c: RHSConsts, flags: TermFlags = TermFlags()):
    """Component-wise 2D RHS — elementwise ops only, usable inside Pallas
    kernels as well as the stacked-array wrapper.  Returns the 5 tendencies
    (dlne, dcg_x, dcg_y, dx, dy).

    Transcendental economy (this is ~60% of the step's VPU time, evaluated
    8x per model step): every formula below is algebraically identical to
    the module-level helpers but avoids redundant sqrt/pow —
      - alpha only ever enters squared (I ~ alpha^2, S_dir ~ alpha^2), so
        the wave-age clamp is applied to alpha^2 = u^2/(2 c_gp)^2 <= 500^2
        with no square roots,
      - alpha_p's denominator max(|c|, 1e-4)^2 == max(c^2, 1e-8),
      - sin(2(phi_u - phi_c)) needs only squared norms (sin2_a_min_b's
        |u||c| appears squared),
      - D_tilde's e^(n lne) (k_p/e_T)^(2n) fuses into one
        exp(n (lne + 2 log(k_p/e_T))) — one exp+log instead of exp+pow.
    One sqrt remains (|c_gp| for omega_p)."""
    c2 = cg_x ** 2 + cg_y ** 2
    u2 = u ** 2 + v ** 2
    rg2 = c.r_g * c.r_g
    cgp2_raw = c2 / rg2                       # |c_gp|^2, unclamped

    k_p = c.g / (4.0 * jnp.maximum(cgp2_raw, 1e-2))  # c_g_conversions clamp
    omega_p = c.g / (2.0 * jnp.maximum(jnp.sqrt(c2) / c.r_g, 0.1))
    c_gp_x = cg_x / c.r_g
    c_gp_y = cg_y / c.r_g

    # alpha^2 with alpha_func's 500 clamp (alpha = u/(2 c_gp), unclamped
    # denominator: u/0 -> inf -> clamp, exactly like the helper)
    alpha2 = jnp.where(u2 / (4.0 * cgp2_raw) > 250000.0, 250000.0,
                       u2 / (4.0 * cgp2_raw))
    # alpha_p: (u c_gp_x + v c_gp_y) / (2 max(|c_gp|, 1e-4)^2)
    a_p = (u * c_gp_x + v * c_gp_y) / (2.0 * jnp.maximum(cgp2_raw, 1e-8))
    H_p = H_beta(a_p, c.p)
    Delta_p = Delta_beta(a_p)

    I_t = c.C_e * H_p * alpha2 if flags.input else 0.0
    if flags.dissipation:
        D_t = jnp.exp(c.n * (lne + 2.0 * jnp.log(k_p / c.e_T)))
    else:
        D_t = 0.0
    S_cg_t = S_cg(lne, Delta_p, k_p, c.C_alpha) if flags.peak_shift else 0.0
    if flags.direction:
        # sin(2(phi_u - phi_c)) via squared norms only
        prod = u2 * cgp2_raw
        safe = jnp.where(prod == 0, 1.0, prod)
        sin2 = jnp.where(prod == 0, 0.0,
                         (2.0 / safe) * (u * v * (2.0 * c_gp_y ** 2 - cgp2_raw)
                                         - c_gp_x * c_gp_y * (2.0 * v ** 2 - u2)))
        S_dir_t = alpha2 * c.C_varphi * H_p * sin2
    else:
        S_dir_t = 0.0
    S_sphere_t = pc * cg_x

    dlne = omega_p * c.r_g * S_cg_t + omega_p * (I_t - D_t)
    dcg_x = -cg_x * omega_p * c.r_g * S_cg_t + cg_y * S_dir_t + cg_y * S_sphere_t
    dcg_y = -cg_y * omega_p * c.r_g * S_cg_t - cg_x * S_dir_t - cg_x * S_sphere_t

    if flags.propagation:
        dx = M00 * cg_x + M01 * cg_y
        dy = M10 * cg_x + M11 * cg_y
    else:
        dx = jnp.zeros_like(cg_x)
        dy = jnp.zeros_like(cg_y)
    return dlne, dcg_x, dcg_y, dx, dy


def particle_equations(u_wind: Callable, v_wind: Callable, *,
                       gamma: float = 0.88, q: float = -0.25,
                       constants: Optional[IDConstants] = None,
                       params: Optional[ODEParameters] = None,
                       flags: TermFlags = TermFlags()) -> Callable:
    """Build the 2D particle RHS ``rhs(t, z, aux: RHSParams) -> dz``.

    ``z[..., 5] = [lne, cg_x, cg_y, x, y]`` with positions in grid-index units
    relative to the home node (mesh grids) — the projection matrix in
    ``aux.M`` performs the m/s -> index/s conversion (reference :536).

    Mirrors reference particle_waves_v5.jl:479-558 (the in-place variant used
    by the models; note its dz[3] carries ``- cg_x * S_sphere``).
    """
    consts = make_rhs_consts(gamma=gamma, q=q, constants=constants,
                             params=params)

    def rhs(t, z, aux: RHSParams):
        lne, cg_x, cg_y = z[..., 0], z[..., 1], z[..., 2]

        u = u_wind(aux.x, aux.y, t)
        v = v_wind(aux.x, aux.y, t)
        u = jnp.broadcast_to(jnp.asarray(u, lne.dtype), lne.shape)
        v = jnp.broadcast_to(jnp.asarray(v, lne.dtype), lne.shape)

        dlne, dcg_x, dcg_y, dx, dy = rhs_core_2d(
            lne, cg_x, cg_y, u, v,
            aux.M[..., 0, 0], aux.M[..., 0, 1],
            aux.M[..., 1, 0], aux.M[..., 1, 1],
            aux.pc, consts, flags)
        return jnp.stack([dlne, dcg_x, dcg_y, dx, dy], axis=-1)

    return rhs


def particle_equations_1d(u_wind: Callable, *, gamma: float = 0.88,
                          q: float = -0.25,
                          constants: Optional[IDConstants] = None,
                          params: Optional[ODEParameters] = None,
                          flags: TermFlags = TermFlags()) -> Callable:
    """Build the 1D particle RHS ``rhs(t, z, aux) -> dz``.

    ``z[..., 3] = [lne, cg_x, x]`` with x in *absolute* meters (the 1D model
    keeps the legacy absolute-coordinate grid).  Mirrors reference
    particle_waves_v5.jl:584-652: no direction terms, alpha (not alpha_p)
    feeds the H/Delta windows, and ``dx = cg_x``.

    ``aux`` only needs ``x`` (wind-sampling position).
    """
    if params is None:
        params, constants, _ = ODEParameters.create(q=q)
    if constants is None:
        constants = IDConstants.create(r_g=params.r_g, q=q)
    p_, q_, n_ = magic_fractions(q)
    e_T = e_T_func(gamma, p_, q_, n_, c_beta=constants.c_beta,
                   c_D=constants.c_D, c_e=constants.c_e,
                   c_alpha=constants.c_alpha)
    r_g, C_alpha, C_e, g = params.r_g, params.C_alpha, params.C_e, params.g

    def rhs(t, z, aux):
        lne, cg_x = z[..., 0], z[..., 1]
        x_node = aux.x if hasattr(aux, "x") else aux

        u = u_wind(x_node, t)
        u = jnp.broadcast_to(jnp.asarray(u, lne.dtype), lne.shape)

        u_speed = jnp.abs(u)
        c_gp_speed, k_p, omega_p = c_g_conversions(jnp.abs(cg_x), r_g, g)

        alpha = alpha_func(u_speed, c_gp_speed)
        H_p = H_beta(alpha, p_)
        Delta_p = Delta_beta(alpha)

        I_t = I_tilde(alpha, H_p, C_e) if flags.input else 0.0
        D_t = D_tilde_lne(lne, k_p, e_T, n_) if flags.dissipation else 0.0
        S_cg_t = S_cg(lne, Delta_p, k_p, C_alpha) if flags.peak_shift else 0.0

        dlne = omega_p * r_g * S_cg_t + omega_p * (I_t - D_t)
        dcg_x = -cg_x * omega_p * r_g * S_cg_t
        dx = cg_x if flags.propagation else jnp.zeros_like(cg_x)

        return jnp.stack([dlne, dcg_x, dx], axis=-1)

    return rhs


def particle_rays():
    """Constant-velocity ray tracer (reference particle_waves_v5.jl:662-680)."""

    def rhs(t, z, aux):
        zero = jnp.zeros_like(z[..., 0])
        return jnp.stack([zero, zero, z[..., 1]], axis=-1)

    return rhs
