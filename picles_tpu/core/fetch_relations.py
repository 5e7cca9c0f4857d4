"""Fetch relations and windsea initialization — pure, jit-able jnp functions.

JAX re-implementation of the physics closures in the reference
``src/FetchRelations.jl``.  Every function here works elementwise on scalars
or arrays of any shape, so the same code seeds a single particle on the host
and reseeds a whole ``[Nx, Ny]`` grid inside the jitted model step.

Deviations from the reference (documented):
 - ``MinimalWindsea`` replaces the reference's random sign for exactly-zero
   wind components (FetchRelations.jl:365) with a deterministic ``+1`` so the
   kernel stays reproducible and jit-able.
 - Dict returns become NamedTuples (pytrees).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from .constants import G_GRAVITY

# Dulov et al. 2020 time->fetch constants (reference FetchRelations.jl:107-115)
DULOV_Q_X = 0.2748
DULOV_A = 22.8013
DULOV_XI_0X = 2.4097

U_MIN = 1.0  # reference FetchRelations.jl:364


# ---------------------------------------------------------------------------
# non-dimensionalizations (reference FetchRelations.jl:19-70)
# ---------------------------------------------------------------------------

def X_tilde(X, U10):
    """Dimensionless fetch distance: g X / U10^2."""
    return G_GRAVITY * X / U10 ** 2


def t_tilde(t, U10):
    """Dimensionless time: g t / U10."""
    return t * G_GRAVITY / U10


def E_tilde(E, U10):
    """Dimensionless energy: g^2 E / U10^4."""
    return E * G_GRAVITY ** 2 / U10 ** 4


def f_p_tilde(f_p, U10):
    """Dimensionless peak frequency: f_p U10 / g."""
    return f_p * U10 / G_GRAVITY


# ---------------------------------------------------------------------------
# Dulov time <-> fetch (reference FetchRelations.jl:128-139)
# ---------------------------------------------------------------------------

def X_tilde_from_tau(tau):
    """Non-dimensional fetch from non-dimensional duration tau."""
    return (tau / (DULOV_A * DULOV_XI_0X)) ** (1.0 / (1.0 - DULOV_Q_X))


def tau_from_X_tilde(X):
    """Non-dimensional duration tau from non-dimensional fetch."""
    return DULOV_A * DULOV_XI_0X * X ** (1.0 - DULOV_Q_X)


# ---------------------------------------------------------------------------
# JONSWAP pieces (reference FetchRelations.jl:157-203)
# ---------------------------------------------------------------------------

def f_m_from_X_tilde(U10, X_tilde_, fgp: float = 3.5):
    """JONSWAP peak-frequency scale given U10 and non-dim fetch."""
    return fgp * (G_GRAVITY / U10) * X_tilde_ ** (-0.33)


def alpha_j(U10, f_m):
    """JONSWAP spectral-peak enhancement factor 0.033 (f_m U / g)^0.67."""
    return 0.033 * (f_m * U10 / G_GRAVITY) ** 0.67


def E_JONSWAP(f_m, alpha_j_):
    """JONSWAP wave energy 0.31 g^2 alpha_j (2 pi f_m)^-4."""
    return 0.31 * G_GRAVITY ** 2 * alpha_j_ * (f_m * 2.0 * math.pi) ** (-4.0)


# ---------------------------------------------------------------------------
# static fetch laws (reference FetchRelations.jl:209-227, 442-450)
# ---------------------------------------------------------------------------

def min_fetch(X_tilde_, X_t_0: float = 2.2e4):
    return jnp.minimum(jnp.asarray(X_tilde_) / X_t_0, 1.0)


def c_p_fetch(X_tilde_, U10, X_t_0: float = 2.2e4):
    return U10 * 1.2 * min_fetch(X_tilde_, X_t_0) ** 0.33


def H_s_fetch(X_tilde_, U10, X_t_0: float = 2.2e4):
    return 0.26 * U10 ** 2 * min_fetch(X_tilde_, X_t_0) ** 0.5 / G_GRAVITY


def E_fetch(X_tilde_, U10, X_t_0: float = 2.2e4):
    return 4.23e-3 * U10 ** 4 * min_fetch(X_tilde_, X_t_0) / G_GRAVITY ** 2


def E_fetch_tilde(X_tilde_, X_t_0: float = 2.2e4):
    return 4.23e-3 * min_fetch(X_tilde_, X_t_0)


def X_tilde_time_and_fetch(t, U10, X):
    """Double-limited (duration or fetch) non-dimensional fetch
    (reference FetchRelations.jl:442-450)."""
    Tt = t_tilde(t, U10)
    Xt = X_tilde(X, U10)
    return jnp.where(Tt < 1e5, jnp.minimum(Xt, X_tilde_from_tau(Tt)), Xt)


# ---------------------------------------------------------------------------
# windsea initialization (reference FetchRelations.jl:254-415)
# ---------------------------------------------------------------------------

class WindSea(NamedTuple):
    """Initial windsea bundle (pytree analog of the reference Dict return)."""

    E: jnp.ndarray
    lne: jnp.ndarray
    Hs: jnp.ndarray
    cg_bar_x: jnp.ndarray
    cg_bar_y: jnp.ndarray
    cg_bar: jnp.ndarray
    f_peak: jnp.ndarray
    T_bar: jnp.ndarray
    X_tilde: jnp.ndarray
    m_x: jnp.ndarray
    m_y: jnp.ndarray


def get_initial_windsea(U10, V10, time_scale, type: str = "JONSWAP") -> WindSea:
    """Initial windsea parameters from wind components and a duration scale.

    Reference FetchRelations.jl:314-359.  The wind speed is floored at
    0.1 m/s; ``type`` selects JONSWAP or Pierson-Moskowitz ("PM") seeds.
    Works elementwise on arrays (used inside the reseed kernel).
    """
    U10 = jnp.asarray(U10, dtype=jnp.result_type(float))
    V10 = jnp.asarray(V10, dtype=U10.dtype)
    U_amp = jnp.sqrt(U10 ** 2 + V10 ** 2)
    U_amp = jnp.where(U_amp < 0.1, 0.1, U_amp)

    time_scale = jnp.abs(jnp.asarray(time_scale, dtype=U10.dtype))
    tau = G_GRAVITY * time_scale / U_amp

    X_tilde_ = X_tilde_from_tau(tau)
    f_m_ = f_m_from_X_tilde(U_amp, X_tilde_)
    alpha_j_ = alpha_j(U_amp, f_m_)

    if type == "JONSWAP":
        E_ = E_JONSWAP(f_m_, alpha_j_)
        Hs_ = 4.0 * jnp.sqrt(E_)
        # from Bouws 1998, eq. 4.2 (reference FetchRelations.jl:332)
        f_peak = f_m_ * G_GRAVITY / U_amp
    elif type == "PM":
        f_peak = 0.816 * G_GRAVITY / (2.0 * math.pi * U_amp)
        Hs_ = 0.0246 * U_amp ** 2
        E_ = (Hs_ / 4.0) ** 2
    else:
        raise ValueError(f"unknown windsea type {type!r}")

    T_bar = 0.9 * (1.0 / f_peak)
    cg_bar_amp = G_GRAVITY * T_bar / (4.0 * math.pi)
    cg_bar_x = cg_bar_amp * U10 / U_amp
    cg_bar_y = cg_bar_amp * V10 / U_amp

    mom_x = (U10 / U_amp) * E_ / (2.0 * cg_bar_amp)
    mom_y = (V10 / U_amp) * E_ / (2.0 * cg_bar_amp)

    return WindSea(E=E_, lne=jnp.log(E_), Hs=Hs_, cg_bar_x=cg_bar_x,
                   cg_bar_y=cg_bar_y, cg_bar=cg_bar_amp, f_peak=f_peak,
                   T_bar=T_bar, X_tilde=X_tilde_, m_x=mom_x, m_y=mom_y)


def get_initial_windsea_particle_state(U10, V10, time_scale,
                                       type: str = "JONSWAP"):
    """[lne, cg_x, cg_y, 0, 0] stacked along a trailing axis
    (reference ``particle_state=true`` branch, FetchRelations.jl:347-348)."""
    ws = get_initial_windsea(U10, V10, time_scale, type)
    zero = jnp.zeros_like(ws.lne)
    return jnp.stack([ws.lne, ws.cg_bar_x, ws.cg_bar_y, zero, zero], axis=-1)


def _nonzero_sign(x):
    """sign(x) but +1 at x == 0 (deterministic stand-in for the reference's
    random sign, FetchRelations.jl:365)."""
    return jnp.where(jnp.asarray(x) < 0, -1.0, 1.0)


def MinimalWindsea(U10, V10, time_scale, type: str = "JONSWAP") -> WindSea:
    """Windsea of a |U| = 1 m/s wind in the direction of (U10, V10)
    (reference FetchRelations.jl:381-386)."""
    U10 = jnp.asarray(U10, dtype=jnp.result_type(float))
    V10 = jnp.asarray(V10, dtype=U10.dtype)
    U10 = jnp.where(U10 == 0, _nonzero_sign(U10), U10)
    V10 = jnp.where(V10 == 0, _nonzero_sign(V10), V10)
    Uamp = jnp.sqrt(U10 ** 2 + V10 ** 2)
    return get_initial_windsea(U_MIN * U10 / Uamp, U_MIN * V10 / Uamp,
                               time_scale, type)


def MinimalParticle(U10, V10, time_scale, type: str = "JONSWAP"):
    """[lne, cg_x, cg_y, 0, 0] for the minimal windsea
    (reference FetchRelations.jl:401-404)."""
    ws = MinimalWindsea(U10, V10, time_scale, type)
    zero = jnp.zeros_like(ws.lne)
    return jnp.stack([ws.lne, ws.cg_bar_x, ws.cg_bar_y, zero, zero], axis=-1)


def MinimalState(U10, V10, time_scale, type: str = "JONSWAP"):
    """[minimal energy, minimal momentum^2] for the minimal windsea
    (reference FetchRelations.jl:412-415)."""
    ws = MinimalWindsea(U10, V10, time_scale, type)
    return jnp.stack([ws.E, ws.m_x ** 2 + ws.m_y ** 2], axis=-1)


def get_initial_windsea_1d(U10, time_scale, type: str = "JONSWAP"):
    """1D variant (reference FetchRelations.jl:254-287): signed U10, returns
    a WindSea with cg_bar_y = m_y = 0."""
    U10 = jnp.asarray(U10, dtype=jnp.result_type(float))
    ws = get_initial_windsea(U10, jnp.zeros_like(U10), time_scale, type)
    return ws


def MinimalWindsea_1d(U10, time_scale, type: str = "JONSWAP"):
    """Reference FetchRelations.jl:371-374."""
    U10 = jnp.asarray(U10, dtype=jnp.result_type(float))
    U10 = jnp.where(U10 == 0, _nonzero_sign(U10), U10)
    return get_initial_windsea_1d(_nonzero_sign(U10) * U_MIN, time_scale, type)


def PMParameters(U10):
    """Pierson-Moskowitz parameters (reference FetchRelations.jl:612-617).

    Documented reference bug fix: the reference computes ``E = (Hs/4)^4``
    in this function it marks "never tested!!"; the PM variance is
    ``E = (Hs/4)^2 = Hs^2/16`` (and that is what the reference's own PM
    branch of get_initial_windsea uses via Hs = 4 sqrt(E))."""
    f_peak = 0.816 * G_GRAVITY / (2.0 * math.pi * U10)
    Hs = 0.0246 * U10 ** 2
    E = (Hs / 4.0) ** 2
    return dict(f_peak=f_peak, Hs=Hs, E=E)


def PMlimits():
    """Reference FetchRelations.jl:620-622."""
    return dict(E_tilde=0.00402, f_p_tilde=0.123)


# ---------------------------------------------------------------------------
# legacy JONSWAP helpers (reference FetchRelations.jl:457-608, the "old
# functions" block).  Kept for API parity; the reference versions contain
# several latent bugs in code paths it never executes — fixes are documented
# per function.
# ---------------------------------------------------------------------------

FETCH_GROWTH_PARAMETER = 3.5  # reference FetchRelations.jl:151 (fgp)


def f_m_from_X(U10, X, fgp: float = FETCH_GROWTH_PARAMETER):
    """JONSWAP peak frequency from dimensional fetch
    (reference FetchRelations.jl:154-159)."""
    return fgp * (G_GRAVITY / U10) * X_tilde(X, U10) ** (-0.33)


def X_tilde_j_U_freq(U10, f_max, fgp: float = FETCH_GROWTH_PARAMETER):
    """Non-dimensional JONSWAP fetch from peak frequency
    (reference X̃_j_U_freq, FetchRelations.jl:457-463)."""
    return fgp ** 3.0815 * G_GRAVITY ** 3 / (U10 ** 3 * f_max ** 3)


def X_j_U_freq(U10, f_max, fgp: float = FETCH_GROWTH_PARAMETER):
    """Dimensional JONSWAP fetch (meters) from peak frequency
    (reference X_j_U_freq, FetchRelations.jl:465-471)."""
    return fgp ** 3.0815 * G_GRAVITY ** 2 / (U10 * f_max ** 3)


def X_tilde_j_U_tau(U10, tau):
    """Non-dimensional JONSWAP fetch from duration tau (seconds)
    (reference X̃_j_U_tau, FetchRelations.jl:473-480)."""
    return (tau * G_GRAVITY / (14.0 * math.pi * U10)) ** 1.5


def tau_j(U10, X):
    """Equivalent JONSWAP fetch duration (seconds) from fetch (meters)
    (reference τ_j, FetchRelations.jl:489-495; its body calls
    ``X_tilde(U, X)`` with swapped arguments — corrected here to
    ``X_tilde(X, U10)``, the inverse of :py:func:`X_tilde_j_U_tau`)."""
    return 14.0 * math.pi * (U10 / G_GRAVITY) * X_tilde(X, U10) ** (2.0 / 3.0)


def f_m_given_U_tau(U10, tau):
    """JONSWAP peak frequency from wind and duration, including the
    reference's empirical 1.035 adjustment (fₘ_given_U_tau,
    FetchRelations.jl:520-528)."""
    Xt = X_tilde_j_U_tau(U10, tau)
    f_max = FETCH_GROWTH_PARAMETER * (G_GRAVITY / U10) * Xt ** (-1.0 / 3.0)
    return f_max * 1.035


def c_g_U_tau(U10, tau):
    """Peak group speed g / (4 pi f_m) from wind and duration
    (reference c_g_U_tau, FetchRelations.jl:530-537)."""
    return G_GRAVITY / (4.0 * math.pi * f_m_given_U_tau(U10, tau))


def E_j(U10, tau):
    """JONSWAP wave energy from wind and duration
    (reference Eⱼ, FetchRelations.jl:540-548)."""
    f_max = f_m_given_U_tau(U10, tau)
    return E_JONSWAP(f_max, alpha_j(U10, f_max))


def JONSWAP_omega(U10, omega_p, omega):
    """JONSWAP spectral density S(omega) with the 3.3^Gamma peak enhancement
    (reference JONSWAP_omega, FetchRelations.jl:552-563).

    The reference body references an undefined global ``U`` and feeds the
    angular peak frequency straight into ``alpha_j`` (which expects Hz);
    here ``U10`` is the argument and ``alpha_j`` receives f_p = omega_p/2pi.
    """
    omega = jnp.asarray(omega, dtype=jnp.result_type(float))
    a_j = alpha_j(U10, omega_p / (2.0 * math.pi))
    S = (2.0 * math.pi * a_j * G_GRAVITY ** 2) / omega ** 5 \
        * jnp.exp(-(5.0 / 4.0) * (omega_p / omega) ** 4)
    sigma = jnp.where(omega > omega_p, 0.09, 0.07)
    Gamma_j = jnp.exp(-(omega - omega_p) ** 2
                      / (2.0 * sigma ** 2 * omega_p ** 2))
    return S * 3.3 ** Gamma_j


def JONSWAP_frequency(U10, f_p, freq):
    """JONSWAP spectral density over frequency (Hz) (reference
    JONSWAP_frequency, FetchRelations.jl:575-580; its body forwards the
    undefined global ``ω`` instead of the ``freq`` argument — fixed)."""
    return JONSWAP_omega(U10, 2.0 * math.pi * f_p,
                         2.0 * math.pi * jnp.asarray(freq)) * 2.0 * math.pi


def PMSpectrum(U10, f):
    """Pierson-Moskowitz spectrum S(f) (reference PMSpectrum,
    FetchRelations.jl:586-601, Massel eq. 3.79-3.80; the reference body
    calls Python's ``np.exp`` from Julia — never runnable)."""
    f = jnp.asarray(f, dtype=jnp.result_type(float))
    wp = 0.879 * G_GRAVITY / U10
    w = 2.0 * math.pi * f
    sigma = 0.04 * G_GRAVITY / wp ** 2
    alpha = 5.0 * (wp ** 2 * sigma / G_GRAVITY) ** 2
    return alpha * w ** (-5.0) * G_GRAVITY ** 2 \
        * jnp.exp(-5.0 / 4.0 * (w / wp) ** (-4.0))
