"""Batched adaptive Tsit5 ODE integrator.

This replaces the reference's per-particle mutable ``ODEIntegrator`` objects
(DifferentialEquations.jl ``AutoTsit5(Rosenbrock23())`` with abstol=1e-4,
reltol=1e-3; reference src/Operators/core_2D.jl:164-195 and
src/ParticleSystems/particle_waves_v5.jl:34-75) with a single SPMD kernel:
every particle's 5-variable ODE advances together as stacked ``[..., D]``
arrays inside one ``lax.while_loop``.  Each lane carries its own clock ``t``,
step size ``dt`` and done/failed flags; lanes that finish early are masked
out.  The loop cost is the max substep count over the batch — pure VPU work,
no MXU, no gather/scatter.

Semantics kept from the reference:
 - steps land exactly on ``t + DT`` (``step!(integ, DT, true)``),
 - ``dtmin``/``force_dtmin``: below dtmin the step is either forced
   (accepted regardless of error) or the lane is marked failed,
 - ``maxiters`` bounds the substep count; exceeding it marks the lane failed
   (the analog of a MarkedParticleInstance, custom_structures.jl:30-35),
 - the adapted ``dt`` persists across model steps (carried per particle),
 - ``auto_dt`` reproduces ``auto_dt_reset!`` (Hairer's automatic initial
   step-size estimate) for freshly reseeded particles.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class RKMethod(NamedTuple):
    """Explicit embedded RK tableau with the FSAL property.

    ``c``/``a`` define stages 2..S, ``b`` the Sth-order solution weights
    over stages 1..S, and ``bt = b - bhat`` the embedded error weights over
    stages 1..S **plus** the FSAL evaluation ``k_{S+1} = f(t+dt, z_new)``
    (which doubles as the next substep's ``k1``).
    """

    name: str
    c: Tuple[float, ...]
    a: Tuple[Tuple[float, ...], ...]
    b: Tuple[float, ...]
    bt: Tuple[float, ...]
    order: float


# Tsitouras 2011 coefficients (the Tsit5 tableau of OrdinaryDiffEq.jl) —
# the reference's solver family (AutoTsit5, particle_waves_v5.jl:47).
TSIT5 = RKMethod(
    name="tsit5",
    c=(0.161, 0.327, 0.9, 0.9800255409045097, 1.0),
    a=((0.161,),
       (-0.008480655492356989, 0.335480655492357),
       (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
       (5.325864828439257, -11.748883564062828, 7.4955393428898365,
        -0.09249506636175525),
       (5.86145544294642, -12.92096931784711, 8.159367898576159,
        -0.071584973281401, -0.028269050394068383)),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774),
    # b - bhat: weights of the embedded 4th-order error estimate.
    bt=(-0.00178001105222577714, -0.0008164344596567469,
        0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
        -0.45808210592918697, 0.015151515151515152),
    order=5.0)

# Bogacki–Shampine 3(2) (BS3 of OrdinaryDiffEq.jl): 3 fresh RHS evals per
# substep vs Tsit5's 6 under FSAL.  Same PI controller and tolerances, so
# accuracy is governed by the same error target; the wave-relaxation ODE is
# smooth enough that the steady-state substep count matches Tsit5's,
# halving the advance cost (the #1 hot kernel).
BOSH3 = RKMethod(
    name="bosh3",
    c=(0.5, 0.75),
    a=((0.5,), (0.0, 0.75)),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0),
    bt=(2.0 / 9.0 - 7.0 / 24.0, 1.0 / 3.0 - 1.0 / 4.0,
        4.0 / 9.0 - 1.0 / 3.0, -1.0 / 8.0),
    order=3.0)

METHODS = {"tsit5": TSIT5, "bosh3": BOSH3}

_SAFETY = 0.9
_QMIN = 0.2
_QMAX = 10.0
_ORDER = 5.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs (subset of the reference ODESettings)."""

    abstol: float = 1e-4
    reltol: float = 1e-3
    dtmin: float = 1e-4
    force_dtmin: bool = True
    maxiters: int = 10_000
    method: str = "tsit5"   # "tsit5" | "bosh3"
    # adaptive=False: fixed sub-steps of the carried dt (clipped to land on
    # t_end), no error control — the reference's `adaptive` integrator knob
    # passed to every solver (core_2D.jl:185, particle_waves_v5.jl:55-58).
    # Deterministic substep sequences make it the tool for ulp-tight
    # cross-backend / sharded-vs-single comparisons.
    adaptive: bool = True


class SolveResult(NamedTuple):
    z: jnp.ndarray          # [..., D] final state
    t: jnp.ndarray          # [...] final time (== t_end where not failed)
    dt: jnp.ndarray         # [...] next-step size (persists across calls)
    failed: jnp.ndarray     # [...] bool, lane hit maxiters / dtmin failure
    naccept: jnp.ndarray    # [...] accepted substeps
    nreject: jnp.ndarray    # [...] rejected substeps


def _error_norm(err, z0, z1, abstol, reltol):
    sc = abstol + reltol * jnp.maximum(jnp.abs(z0), jnp.abs(z1))
    return jnp.sqrt(jnp.mean((err / sc) ** 2, axis=-1))


def rk_step(method: RKMethod, rhs: Callable, t, z, dt, aux,
            k1=None) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One embedded-RK step for all lanes: (z_new, error_estimate, k_fsal).

    FSAL: ``k_fsal = rhs(t+dt, z_new)`` doubles as the next step's ``k1``,
    so callers that carry it save one RHS eval per substep.
    """
    dt_ = dt[..., None]
    if k1 is None:
        k1 = rhs(t, z, aux)
    ks = [k1]
    for ci, row in zip(method.c, method.a):
        acc = z
        for aij, kj in zip(row, ks):
            if aij != 0.0:
                acc = acc + dt_ * aij * kj
        ks.append(rhs(t + ci * dt, acc, aux))
    z_new = z
    for bi, ki in zip(method.b, ks):
        if bi != 0.0:
            z_new = z_new + dt_ * bi * ki
    ks.append(rhs(t + dt, z_new, aux))  # FSAL
    err = jnp.zeros_like(z)
    for bti, ki in zip(method.bt, ks):
        if bti != 0.0:
            err = err + bti * ki
    return z_new, dt_ * err, ks[-1]


def tsit5_step(rhs: Callable, t, z, dt, aux, k1=None):
    """Back-compat wrapper: one Tsit5 step (see ``rk_step``)."""
    return rk_step(TSIT5, rhs, t, z, dt, aux, k1=k1)


def auto_dt(rhs: Callable, t, z, aux, *, abstol: float = 1e-4,
            reltol: float = 1e-3, order: float = _ORDER,
            max_dt: float = 3600.0) -> jnp.ndarray:
    """Hairer-style automatic initial step size, vectorized per lane.

    The batched analog of DifferentialEquations.jl's ``auto_dt_reset!`` used by
    the reference after every particle reset (mapping_2D.jl:91-111).
    """
    tiny = jnp.asarray(1e-10, z.dtype)
    sc = abstol + jnp.abs(z) * reltol
    f0 = rhs(t, z, aux)
    d0 = jnp.sqrt(jnp.mean((z / sc) ** 2, axis=-1))
    d1 = jnp.sqrt(jnp.mean((f0 / sc) ** 2, axis=-1))
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / jnp.maximum(d1, tiny))

    z1 = z + h0[..., None] * f0
    f1 = rhs(t + h0, z1, aux)
    d2 = jnp.sqrt(jnp.mean(((f1 - f0) / sc) ** 2, axis=-1)) / jnp.maximum(h0, tiny)

    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(dmax <= 1e-15,
                   jnp.maximum(1e-6, h0 * 1e-3),
                   (0.01 / jnp.maximum(dmax, tiny)) ** (1.0 / (order + 1.0)))
    return jnp.minimum(jnp.minimum(100.0 * h0, h1), max_dt)


def integrate_to(rhs: Callable, z0: jnp.ndarray, t0: jnp.ndarray,
                 t_end: jnp.ndarray, dt0: jnp.ndarray, aux,
                 active: jnp.ndarray, config: SolverConfig) -> SolveResult:
    """Advance every active lane from ``t0`` to ``t_end`` adaptively.

    Inactive lanes are untouched (their z/t/dt pass through).  This is the
    batched equivalent of the reference's advance loop
    ``step!(PI.ODEIntegrator, DT, true)`` (mapping_2D.jl:149-170).
    """
    dtype = z0.dtype
    method = METHODS[config.method]
    t0 = jnp.asarray(t0, dtype)
    t_end = jnp.asarray(t_end, dtype)
    dt0 = jnp.maximum(jnp.asarray(dt0, dtype), config.dtmin)
    zeros_i = jnp.zeros(t0.shape, jnp.int32)

    class Carry(NamedTuple):
        z: jnp.ndarray
        t: jnp.ndarray
        dt: jnp.ndarray
        k1: jnp.ndarray  # FSAL: rhs(t, z), valid for the current (t, z)
        done: jnp.ndarray
        failed: jnp.ndarray
        naccept: jnp.ndarray
        nreject: jnp.ndarray
        iters: jnp.ndarray  # scalar loop counter

    done0 = (~active) | (t0 >= t_end)
    carry0 = Carry(z=z0, t=t0, dt=dt0, k1=rhs(t0, z0, aux), done=done0,
                   failed=jnp.zeros_like(done0), naccept=zeros_i,
                   nreject=zeros_i, iters=jnp.zeros((), jnp.int32))

    def cond(c: Carry):
        return (~jnp.all(c.done)) & (c.iters < config.maxiters)

    # f32 clocks: a dt below ulp(t) cannot advance t (t + dt rounds back
    # to t), so a forced-dtmin step at large model time would mutate z at
    # a frozen clock and spin the loop to maxiters.  The effective floor
    # is spacing-aware: max(dtmin, 4 ulp(t)) guarantees every accepted
    # step makes progress.  Normal paths are unaffected (dt >> this floor
    # everywhere outside near-failure regimes).
    eps_t = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    def body(c: Carry):
        live = ~c.done
        remaining = t_end - c.t
        dtmin_eff = jnp.maximum(
            jnp.asarray(config.dtmin, dtype),
            4.0 * eps_t * jnp.maximum(jnp.abs(c.t), jnp.abs(t_end)))
        # clip to hit t_end exactly; keep a floor so masked-out lanes
        # don't divide by zero anywhere.
        dt_try = jnp.clip(c.dt, dtmin_eff, jnp.maximum(remaining, dtmin_eff))
        at_dtmin = dt_try <= dtmin_eff * (1.0 + 1e-8)

        z_new, err, k7 = rk_step(method, rhs, c.t, c.z, dt_try, aux, k1=c.k1)
        if config.adaptive:
            enorm = _error_norm(err, c.z, z_new, config.abstol, config.reltol)
            finite = (jnp.all(jnp.isfinite(z_new), axis=-1)
                      & jnp.isfinite(enorm))

            accept = (enorm <= 1.0) & finite
            if config.force_dtmin:
                accept = accept | at_dtmin
            newly_failed = live & at_dtmin & ~accept

            # step-size controller (I-controller with safety and limits)
            enorm_safe = jnp.maximum(enorm, 1e-10)
            q = _SAFETY * enorm_safe ** (-1.0 / method.order)
            q = jnp.where(finite, q, _QMIN)
            factor = jnp.clip(q, _QMIN, _QMAX)
            dt_next = jnp.where(accept, dt_try * factor,
                                jnp.maximum(dt_try * jnp.clip(q, _QMIN, 1.0),
                                            dtmin_eff))
        else:
            # fixed-substep: every step accepted, dt carried unchanged
            # (non-finite states fall through to the model's NaN guards,
            # as in a fixed-step reference integrator)
            accept = jnp.ones_like(c.done)
            newly_failed = jnp.zeros_like(c.done)
            dt_next = c.dt

        do_update = live & accept
        t_new = jnp.where(do_update, c.t + dt_try, c.t)
        z_out = jnp.where(do_update[..., None], z_new, c.z)
        dt_out = jnp.where(live, dt_next, c.dt)
        k1_out = jnp.where(do_update[..., None], k7, c.k1)
        done_new = c.done | (live & (t_new >= t_end - 1e-9)) | newly_failed

        return Carry(z=z_out, t=t_new, dt=dt_out, k1=k1_out, done=done_new,
                     failed=c.failed | newly_failed,
                     naccept=c.naccept + do_update.astype(jnp.int32),
                     nreject=c.nreject + (live & ~accept).astype(jnp.int32),
                     iters=c.iters + 1)

    final = jax.lax.while_loop(cond, body, carry0)
    # lanes still live after maxiters are failures
    failed = final.failed | (~final.done & active)
    # snap finished lanes exactly onto t_end (within one accepted step of it)
    t_final = jnp.where(active & ~failed, t_end, final.t)
    return SolveResult(z=final.z, t=t_final, dt=final.dt, failed=failed,
                       naccept=final.naccept, nreject=final.nreject)
