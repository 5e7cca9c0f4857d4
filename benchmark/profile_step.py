"""Phase breakdown of one model step on the GPU.

Times (by scan-length difference, like bench.py) jitted sub-pipelines:
  A. advance kernel only
  B. advance + scatter
  C. full step (advance + scatter + remesh)
  D. the reseed windsea computation alone (_reset_values over the grid)
so the cost of each phase is the difference of consecutive rows.
"""

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from bench import build  # noqa: E402


def timeit(fn, state, n_small, n_big, reps=3):
    run = jax.jit(lambda ms, n: jax.lax.scan(
        lambda c, _: (fn(c), None), ms, None, length=n)[0],
        static_argnums=1)
    out = run(state, 4)
    jax.block_until_ready(out)
    for n in (n_small, n_big):
        jax.block_until_ready(run(out, n))

    def t(n):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(out, n))
            best = min(best, time.perf_counter() - t0)
        return best

    return (t(n_big) - t(n_small)) / (n_big - n_small)


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit("profile_step.py times the GPU; no GPU found")
    nx = ny = int(sys.argv[1]) if len(sys.argv) > 1 else 768
    model = build(nx, ny)
    ms0 = model.init_state()

    from picles_tpu.models.state import Particles2D
    from picles_tpu.ops import pic
    from picles_tpu.ops import transforms as TR
    from picles_tpu.ops.advance_pallas import advance_pallas
    from picles_tpu.ops.rhs import make_rhs_consts

    consts = make_rhs_consts(gamma=model.constants.gamma,
                             constants=model.constants, params=model.params)
    g = model.grid
    sett = model.settings

    def advance_only(ms):
        P = ms.particles
        adv = P.on & model.active_mask
        pres = advance_pallas(model.winds.u, model.winds.v, consts,
                              model.flags, model.solver,
                              float(sett.timestep),
                              (P.lne, P.cgx, P.cgy, P.px, P.py),
                              P.t, P.dt, adv,
                              g.x, g.y, model.uniform_proj or g.proj, g.pc)
        return dataclasses.replace(ms, particles=Particles2D(
            lne=pres.lne, cgx=pres.cgx, cgy=pres.cgy, px=pres.x, py=pres.y,
            t=pres.t, dt=pres.dt, on=P.on),
            time=ms.time + sett.timestep)

    def advance_scatter(ms):
        ms2 = advance_only(ms)
        P = ms2.particles
        e, mx, my = TR.particle_to_node(P.lne, P.cgx, P.cgy)
        (e_n, mx_n, my_n), _ = pic.scatter_channels(
            P.px, P.py, (e, mx, my), P.on & model.active_mask,
            g.stats, model.config.halo, model.resolved_config().scatter_mode)
        return dataclasses.replace(
            ms2, state=jnp.stack([e_n, mx_n, my_n], axis=-1))

    def reseed_only(ms):
        u, v = model.winds(g.x, g.y, jnp.broadcast_to(ms.time, g.x.shape))
        u = jnp.broadcast_to(jnp.asarray(u, ms.particles.t.dtype), g.x.shape)
        v = jnp.broadcast_to(jnp.asarray(v, ms.particles.t.dtype), g.x.shape)
        lne, cgx, cgy = model._reset_values(u, v)
        return dataclasses.replace(ms, particles=dataclasses.replace(
            ms.particles, lne=lne, cgx=cgx, cgy=cgy),
            time=ms.time + sett.timestep)

    n_small, n_big = (50, 550) if nx * ny < 200_000 else (10, 40)
    rows = [("full step", model.step),
            ("advance+scatter", advance_scatter),
            ("advance only", advance_only),
            ("reseed windsea only", reseed_only)]
    for name, fn in rows:
        try:
            s = timeit(fn, ms0, n_small, n_big)
            print(f"{name:24s} {s*1e3:8.3f} ms/step")
        except Exception as e:  # keep profiling even if one pipeline breaks
            print(f"{name:24s} FAILED: {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
