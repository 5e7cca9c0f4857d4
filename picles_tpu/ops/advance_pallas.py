"""Pallas fused advance kernel (Triton route) — the whole adaptive ODE
sub-step loop of a block of lanes in registers.

The XLA ``integrate_to`` while_loop is a whole-grid lockstep loop: every
iteration streams every state plane through device memory, and every lane
waits for the slowest lane of the grid.  This kernel flattens the particle
SoA to 1D, gives each Triton program a power-of-two block of ``B`` lanes,
and runs the *entire* adaptive RK loop (accept/reject, PI control,
dtmin/force_dtmin, per-lane t/dt) on that block: state is loaded once,
kept in registers through every sub-step, and stored once.  Each block
also converges independently: a quiet block exits its while_loop after its
own max sub-step count, not the grid's.

Constraints:
 - the wind sampler must be elementwise jnp ops over the node coordinates,
   the time, and optional per-node ``wind_fields`` arrays.  Analytic winds
   are closures; gridded winds pass their exact per-DT-window piecewise-
   linear decomposition ``u = a_u + t*s_u + sum_k ds_k*max(t - b_k, 0)``
   as field refs (winds are sampled at the fixed node position, mirroring
   the reference, so time is the only in-kernel variable — see
   GriddedWinds2D.pallas_pwl_fields),
 - semantics match `integrate_to` exactly (same controller constants), so
   the two paths are interchangeable and cross-checked in tests.
 - the kernel has no matrix products, so TF32 never applies; compiled
   transcendentals and FMA contraction differ from XLA's in the last
   bits, which can flip an accept/reject decision — the cross-checks are
   at solver tolerance, not bitwise.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .rhs import RHSConsts, TermFlags, rhs_core_2d
from .tsit5 import _QMAX, _QMIN, _SAFETY, METHODS, SolverConfig

# lanes per Triton program and warps per program (one lane per thread at
# 256/8); tuned on the 1536^2 box, see docs/PERF.md
BLOCK = 256
NUM_WARPS = 8


class PallasAdvanceResult(NamedTuple):
    lne: jnp.ndarray
    cgx: jnp.ndarray
    cgy: jnp.ndarray
    x: jnp.ndarray
    y: jnp.ndarray
    t: jnp.ndarray
    dt: jnp.ndarray
    failed: jnp.ndarray
    naccept: jnp.ndarray


def _advance_kernel(u_wind, v_wind, consts: RHSConsts, flags: TermFlags,
                    config: SolverConfig, DT: float, uniform, n_wf: int,
                    # refs:
                    *refs):
    (lne_ref, cgx_ref, cgy_ref, x_ref, y_ref, t_ref, dt_ref,
     act_ref, nx_ref, ny_ref) = refs[:10]
    # per-node wind-field refs (gridded winds linearized over the DT
    # window: the samplers read these instead of an analytic closure)
    wf = tuple(r[:] for r in refs[10:10 + n_wf])
    rest = refs[10 + n_wf:]
    if uniform is None:
        (m00_ref, m01_ref, m10_ref, m11_ref, pc_ref) = rest[:5]
        (lne_o, cgx_o, cgy_o, x_o, y_o, t_o, dt_o, fail_o, nacc_o) = rest[5:]
        m00, m01, m10, m11 = m00_ref[:], m01_ref[:], m10_ref[:], m11_ref[:]
        pc = pc_ref[:]
    else:
        # uniform grid: projection matrix + great-circle coefficient are
        # spatially constant — baked in as scalars, 5 fewer input streams
        (lne_o, cgx_o, cgy_o, x_o, y_o, t_o, dt_o, fail_o, nacc_o) = rest
        m00, m01, m10, m11, pc = uniform
    lne0, cgx0, cgy0 = lne_ref[:], cgx_ref[:], cgy_ref[:]
    px0, py0 = x_ref[:], y_ref[:]
    t0, dt0 = t_ref[:], dt_ref[:]
    active = act_ref[:] != 0
    xn, yn = nx_ref[:], ny_ref[:]

    t_end = t0 + DT

    def rhs(t, lne, cgx, cgy):
        u = u_wind(xn, yn, t, *wf)
        v = v_wind(xn, yn, t, *wf)
        u = jnp.broadcast_to(jnp.asarray(u, lne.dtype), lne.shape)
        v = jnp.broadcast_to(jnp.asarray(v, lne.dtype), lne.shape)
        return rhs_core_2d(lne, cgx, cgy, u, v, m00, m01, m10, m11, pc,
                           consts, flags)

    zeros_i = jnp.zeros_like(t0, dtype=jnp.int32)
    # done/failed ride the loop as int32 masks: the loop condition is a
    # block min (Triton lowers reduce_min, not a boolean all-reduce)
    done0 = ((~active) | (t0 >= t_end)).astype(jnp.int32)
    k1_0 = rhs(t0, lne0, cgx0, cgy0)

    def cond(c):
        (lne, cgx, cgy, px, py, t, dt, k1, done, failed, nacc, iters) = c
        return (jnp.min(done) == 0) & (iters < config.maxiters)

    def body(c):
        (lne, cgx, cgy, px, py, t, dt, k1, done_i, failed_i, nacc, iters) = c
        done = done_i != 0
        failed = failed_i != 0
        live = ~done
        remaining = t_end - t
        # spacing-aware floor: a dt below ulp(t) cannot advance the f32
        # clock (t + dt rounds to t), so forced-dtmin steps at large model
        # time would spin to maxiters — mirror of tsit5.integrate_to
        dtmin_eff = jnp.maximum(
            config.dtmin,
            4.0 * jnp.finfo(t.dtype).eps
            * jnp.maximum(jnp.abs(t), jnp.abs(t_end)))
        dt_try = jnp.clip(dt, dtmin_eff,
                          jnp.maximum(remaining, dtmin_eff))
        at_dtmin = dt_try <= dtmin_eff * (1.0 + 1e-8)

        z = (lne, cgx, cgy, px, py)
        method = METHODS[config.method]

        def fma(coeffs, ks):
            # z + dt * sum(a_i k_i), componentwise over the 5 state vars
            out = []
            for comp in range(5):
                acc = z[comp]
                for a, k in zip(coeffs, ks):
                    if a != 0.0:
                        acc = acc + dt_try * a * k[comp]
                out.append(acc)
            return tuple(out)

        # generic embedded-RK stage unroll (trace-time loop over the tableau)
        ks = [k1]
        for ci, row in zip(method.c, method.a):
            ks.append(rhs(t + ci * dt_try, *fma(row, ks)[:3]))
        z_new = fma(method.b, ks)
        ks.append(rhs(t + dt_try, *z_new[:3]))  # FSAL

        if config.adaptive:
            # scaled error norm over the 5 components
            err_sq = jnp.zeros_like(t)
            finite = jnp.ones_like(done)
            for comp in range(5):
                e = jnp.zeros_like(t)
                for bt, k in zip(method.bt, ks):
                    if bt != 0.0:
                        e = e + bt * k[comp]
                e = dt_try * e
                sc = (config.abstol + config.reltol
                      * jnp.maximum(jnp.abs(z[comp]), jnp.abs(z_new[comp])))
                err_sq = err_sq + (e / sc) ** 2
                finite = finite & jnp.isfinite(z_new[comp])
            enorm = jnp.sqrt(err_sq / 5.0)
            finite = finite & jnp.isfinite(enorm)

            accept = (enorm <= 1.0) & finite
            if config.force_dtmin:
                accept = accept | at_dtmin
            newly_failed = live & at_dtmin & ~accept

            enorm_safe = jnp.maximum(enorm, 1e-10)
            q = _SAFETY * enorm_safe ** (-1.0 / method.order)
            q = jnp.where(finite, q, _QMIN)
            factor = jnp.clip(q, _QMIN, _QMAX)
            dt_next = jnp.where(accept, dt_try * factor,
                                jnp.maximum(dt_try * jnp.clip(q, _QMIN, 1.0),
                                            dtmin_eff))
        else:
            # fixed-substep mode (ODESettings.adaptive=False): accept every
            # step, dt carried unchanged (see tsit5.integrate_to)
            accept = jnp.ones_like(done, dtype=bool)
            newly_failed = jnp.zeros_like(done, dtype=bool)
            dt_next = dt

        upd = live & accept
        t_new = jnp.where(upd, t + dt_try, t)
        out = tuple(jnp.where(upd, zn, zo) for zn, zo in zip(z_new, z))
        dt_out = jnp.where(live, dt_next, dt)
        k1_out = tuple(jnp.where(upd, kn, ko) for kn, ko in zip(ks[-1], k1))
        done_new = done | (live & (t_new >= t_end - 1e-9)) | newly_failed

        return (out[0], out[1], out[2], out[3], out[4], t_new, dt_out,
                k1_out, done_new.astype(jnp.int32),
                (failed | newly_failed).astype(jnp.int32),
                nacc + upd.astype(jnp.int32), iters + 1)

    init = (lne0, cgx0, cgy0, px0, py0, t0, dt0, k1_0, done0,
            jnp.zeros_like(done0), zeros_i, jnp.zeros((), jnp.int32))
    (lne, cgx, cgy, px, py, t, dt, _k1, done_i, failed_i, nacc,
     _it) = jax.lax.while_loop(cond, body, init)

    done = done_i != 0
    failed = (failed_i != 0) | (~done & active)
    lne_o[:] = lne
    cgx_o[:] = cgx
    cgy_o[:] = cgy
    x_o[:] = px
    y_o[:] = py
    t_o[:] = jnp.where(active & ~failed, t_end, t)
    dt_o[:] = dt
    fail_o[:] = failed.astype(jnp.int32)
    nacc_o[:] = nacc


def lane_block(n: int, block: int = BLOCK) -> Tuple[int, int]:
    """(lanes per program, padded lane count) for ``n`` lanes.

    Triton blocks are powers of two: ``block`` (rounded down to one) caps
    the block, a grid smaller than it gets the next power of two at or
    above ``n``, and the lane axis is padded up to a whole number of
    blocks — any ``n`` (primes included) tiles."""
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    cap = 1 << (int(block).bit_length() - 1)
    b = min(cap, 1 << max(int(n) - 1, 0).bit_length())
    return b, -(-int(n) // b) * b


def advance_pallas(u_wind: Callable, v_wind: Callable, consts: RHSConsts,
                   flags: TermFlags, config: SolverConfig, DT: float,
                   z, t: jnp.ndarray, dt: jnp.ndarray,
                   active: jnp.ndarray, xn, yn, proj, pc,
                   wind_fields: Tuple[jnp.ndarray, ...] = (),
                   block: int = BLOCK, num_warps: int = NUM_WARPS,
                   interpret: bool = False) -> PallasAdvanceResult:
    """Run the fused advance over ``[nx, ny]`` particle arrays.

    ``z``: a stacked ``[nx, ny, 5]`` array or a 5-tuple of ``[nx, ny]``
    component planes; returns component arrays (see PallasAdvanceResult).
    ``proj``: a 5-tuple of python floats ``(m00, m01, m10, m11, pc)`` for
    spatially uniform grids (baked into the kernel), else the per-node
    ``[nx, ny, 2, 2]`` projection with ``pc`` beside it.

    Wind sampler contract: ``u_wind(xn, yn, t, *wind_fields)`` where
    ``wind_fields`` are per-node ``[nx, ny]`` arrays streamed alongside
    the particle state.  Analytic winds ignore the fields (pass ``()``);
    gridded winds pass their exact piecewise-linear decomposition (see
    forcing.winds.GriddedWinds2D.pallas_pwl_fields).
    """
    shape = t.shape
    n = t.size
    b, n_pad = lane_block(n, block)

    def flat(a, fill=None):
        # row-major [nx, ny] -> [n] is a free reshape; padded tail lanes
        # are inactive (mask fill 0) and replicate the last lane's state
        # and coordinates so their RHS stays finite
        a = jnp.broadcast_to(jnp.asarray(a), shape).reshape(n)
        if n_pad == n:
            return a
        mode = dict(mode="edge") if fill is None else dict(
            mode="constant", constant_values=fill)
        return jnp.pad(a, (0, n_pad - n), **mode)

    uniform = proj if isinstance(proj, tuple) else None
    comps = z if isinstance(z, tuple) else tuple(z[..., i] for i in range(5))
    ins = [flat(a) for a in (*comps, t, dt)]
    ins += [flat(active.astype(jnp.int32), fill=0), flat(xn), flat(yn)]
    ins += [flat(jnp.asarray(f, t.dtype)) for f in wind_fields]
    if uniform is None:
        ins += [flat(a)
                for a in (proj[..., 0, 0], proj[..., 0, 1], proj[..., 1, 0],
                          proj[..., 1, 1], pc)]

    f32 = jax.ShapeDtypeStruct((n_pad,), t.dtype)
    i32 = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    out_shape = (f32, f32, f32, f32, f32, f32, f32, i32, i32)
    spec = pl.BlockSpec((b,), lambda i: (i,))

    kernel = functools.partial(_advance_kernel, u_wind, v_wind, consts,
                               flags, config, DT, uniform, len(wind_fields))
    outs = pl.pallas_call(
        kernel,
        grid=(n_pad // b,),
        in_specs=[spec] * len(ins),
        out_specs=(spec,) * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        # no more warps than the block has lanes to give one each
        compiler_params=plt.CompilerParams(
            num_warps=max(1, min(num_warps, b // 32)), num_stages=1),
        interpret=interpret,
        name="picles_advance",
    )(*ins)
    (lne, cgx, cgy, px, py, t_o, dt_o, fail, nacc) = (
        o[:n].reshape(shape) for o in outs)
    return PallasAdvanceResult(lne=lne, cgx=cgx, cgy=cgy, x=px, y=py, t=t_o,
                               dt=dt_o, failed=fail != 0, naccept=nacc)
