"""Advance A/B on the GPU: the Triton advance against the XLA while_loop.

Times the whole jitted step (a ``fori_loop`` of n steps with a traced n,
so one executable serves every window length) with
``advance_mode="pallas"`` and ``advance_mode="xla"``, in turns, on

  * the 1536^2 bench box (2 km spacing, U=V=10, periodic,
    ``halo=((0, 3), (0, 3))``, carried dt), and
  * the 1 deg tripolar grid of ``tripolar_global_demo.py`` (per-node
    projection planes),

for both solvers.  Each window is calibrated to at least ``--window``
seconds and the per-step time is the median over ``--reps`` windows.  It
also times the CIC deposit alone (``dense`` against ``scatter_xla``) at
the box's steady state, and with ``--sweep`` the advance kernel alone
over lane blocks and warp counts.

Prints one JSON object per measurement and writes them all to
``chiprun_out/advance_ab.jsonl``.  Needs a GPU; refuses to run elsewhere.

Run:  python benchmark/advance_ab.py [--sweep] [--reps=5] [--window=0.5]
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from picles_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

RESULTS = []


def emit(**rec):
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def _arg(name, default):
    for a in sys.argv[1:]:
        if a.startswith(f"--{name}="):
            return type(default)(a.split("=", 1)[1])
    return default


def device_info():
    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()), smi=smi.strip().splitlines()[0])


def calibrate(fn, window):
    """Smallest power-of-two n whose call takes at least ``window`` s."""
    n = 1
    while True:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(n))
        if time.perf_counter() - t0 >= window or n >= 1 << 14:
            return n
        n *= 2


def timed(fn, n):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(n))
    return (time.perf_counter() - t0) / n


def ab_step(label, models, reps, window):
    """Per-step medians of several models' jitted steps, timed in turns."""
    runs, ns, outs = {}, {}, {}
    for mode, model in models.items():
        ms = model.init_state()
        run = jax.jit(lambda c, n, m=model: jax.lax.fori_loop(
            0, n, lambda _, s: m.step(s), c))
        t0 = time.perf_counter()
        ms = jax.block_until_ready(run(ms, 4))   # compile + spin-up
        compile_s = time.perf_counter() - t0
        outs[mode] = ms
        runs[mode] = (lambda n, r=run, s=ms: r(s, n))
        ns[mode] = calibrate(runs[mode], window)
        emit(phase="compile", case=label, mode=mode,
             compile_and_4_steps_s=compile_s, window_steps=ns[mode],
             substeps_max=int(ms.metrics.substeps_max),
             n_active=int(ms.metrics.n_active),
             n_failed=int(ms.metrics.n_failed),
             n_clamped=int(ms.metrics.n_clamped))
    order = list(models) + list(models)[::-1]
    per = {m: [] for m in models}
    for _ in range(reps):
        for mode in order:
            per[mode].append(timed(runs[mode], ns[mode]))
    res = {}
    for mode, ts in per.items():
        nxy = int(np.prod(outs[mode].particles.t.shape))
        med = statistics.median(ts)
        res[mode] = med
        emit(phase="step", case=label, mode=mode, s_per_step_median=med,
             s_per_step_min=min(ts), s_per_step_max=max(ts), n=len(ts),
             pushes_per_s=nxy / med)
    return outs, res


def deposit(label, model, ms, reps, window):
    """The CIC deposit alone at a steady state: dense vs scatter_xla."""
    from picles_tpu.ops import pic
    from picles_tpu.ops import transforms as TR

    P = ms.particles
    e, mx, my = TR.particle_to_node(P.lne, P.cgx, P.cgy)
    ch = jnp.stack([e, mx, my], axis=-1)
    act = P.on & model.active_mask
    stats, halo = model.grid.stats, model.config.halo
    out = {}
    for name, f in (("dense", pic.scatter_dense), ("xla", pic.scatter_xla)):
        one = jax.jit(lambda xr, yr, c, a, f=f: f(xr, yr, c, a, stats,
                                                  halo)[0])
        jax.block_until_ready(one(P.px, P.py, ch, act))

        def many(n, one=one):
            r = None
            for _ in range(n):
                r = one(P.px, P.py, ch, act)
            return r

        n = calibrate(many, window)
        ts = [timed(many, n) for _ in range(reps)]
        out[name] = np.asarray(one(P.px, P.py, ch, act))
        emit(phase="deposit", case=label, mode=name,
             s_per_call_median=statistics.median(ts),
             s_per_call_min=min(ts), s_per_call_max=max(ts))
    err = float(np.max(np.abs(out["dense"] - out["xla"])
                       / (np.abs(out["xla"]) + 1e-30)))
    emit(phase="deposit_check", case=label, max_rel_diff=err)


def sweep(model, ms, reps, window):
    """The advance kernel alone over (block, num_warps) at one state."""
    import picles_tpu.ops.advance_pallas as AP
    from picles_tpu.ops.rhs import make_rhs_consts

    P = ms.particles
    consts = make_rhs_consts(gamma=model.constants.gamma,
                             constants=model.constants, params=model.params)
    g = model.grid
    adv = P.on & model.active_mask
    proj = model.uniform_proj or g.proj
    rng = np.random.default_rng(0)
    # spread the sub-step counts: a random dt per lane over 5 decades
    dt = jnp.asarray(10.0 ** rng.uniform(-2, 3, P.t.shape), P.t.dtype)
    for block, warps in ((128, 4), (256, 4), (256, 8), (512, 8),
                         (512, 16), (1024, 16)):
        def one(block=block, warps=warps):
            r = AP.advance_pallas(
                model.winds.u, model.winds.v, consts, model.flags,
                model.solver, float(model.settings.timestep),
                (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, dt, adv,
                g.x, g.y, proj, g.pc, block=block, num_warps=warps)
            return r.lne
        f = jax.jit(one)
        try:
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            c = time.perf_counter() - t0

            def many(n):
                r = None
                for _ in range(n):
                    r = f()
                return r
            n = calibrate(many, window)
            ts = [timed(many, n) for _ in range(reps)]
            emit(phase="sweep", solver=model.settings.solver, block=block,
                 num_warps=warps, compile_s=c,
                 s_per_call_median=statistics.median(ts),
                 s_per_call_min=min(ts))
        except Exception as e:  # a refused configuration is a result too
            emit(phase="sweep", solver=model.settings.solver, block=block,
                 num_warps=warps, error=repr(e)[:300])


def main():
    if jax.default_backend() != "gpu":
        sys.exit("advance_ab.py measures the GPU; no GPU found")
    enable_compile_cache()
    reps, window = _arg("reps", 5), _arg("window", 0.5)
    emit(phase="device", **device_info())

    import bench
    import tripolar_global_demo as tg

    for solver in ("bosh3", "tsit5"):
        box = {m: bench.build(1536, 1536, advance_mode=m, solver=solver)
               for m in ("pallas", "xla")}
        outs, _ = ab_step(f"box1536_{solver}", box, reps, window)
        if "--sweep" in sys.argv:
            sweep(box["pallas"], outs["pallas"], reps, window)
        if solver == "bosh3":
            deposit("box1536", box["pallas"], outs["pallas"], reps, window)
        tri = {m: tg.build_model(advance_mode=m, solver=solver)
               for m in ("pallas", "xla")}
        outs, _ = ab_step(f"tripolar1deg_{solver}", tri, reps, window)
        if solver == "bosh3":
            deposit("tripolar1deg", tri["pallas"], outs["pallas"], reps,
                    window)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "advance_ab.jsonl"),
              "w") as fh:
        for r in RESULTS:
            fh.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
