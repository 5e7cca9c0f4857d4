"""Headline benchmark: full particle-push throughput on the GPU.

One particle-push = one full advance (adaptive ODE sub-stepping) + CIC
scatter + remesh cycle for one particle, the same unit as the reference
baseline (~5.0e4 pushes/s on a 4-thread laptop CPU for the 51x51 box,
BASELINE.md).  The benchmark runs the flagship WaveGrowth2D model on a
production-scale periodic box, steady state, scan-fused steps, with the
production config: the advance ``"auto"`` resolves to (the Triton kernel
on the GPU), the dense deposit, and the warm-restart dt policy (validated
against the reference-semantics auto_dt path to within solver tolerance,
tests/test_model_2d.py).

Timing: the per-step time is measured as a difference of two loop
lengths (the fixed dispatch and sync overhead cancels) with a value fetch
as the sync point.  Refuses to run without a GPU.

Prints exactly one JSON line:
  {"metric": "particle_pushes_per_s", "value": ..., "unit": "pushes/s",
   "vs_baseline": ...}
"""

import json
import sys
import time

BASELINE_PUSHES_PER_S = 5.0e4  # BASELINE.md derived reference throughput


def build(nx, ny, advance_mode="auto", dt_reset_mode="carry",
          solver="bosh3", scatter_mode="dense"):
    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.forcing.winds import constant_winds
    from picles_tpu.grids.cartesian import cartesian_box
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)

    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    # default solver="bosh3" is the FAST VARIANT: Bogacki-Shampine 3(2) at
    # the same error tolerances — 3 fresh RHS evals per substep vs Tsit5's
    # 6 (both FSAL), same substep count at steady state, fields agree to
    # ~1e-4 relative (test_bosh3_solver_matches_tsit5).  The reference runs
    # the AutoTsit5 family (particle_waves_v5.jl:47); pass --solver=tsit5
    # for the solver-identical parity configuration.
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True, solver=solver)
    # keep the reference's 2 km node spacing at every size so the CIC
    # displacement per DT stays within the halo (Courant ~2.4 < 3)
    grid = cartesian_box(2e3 * (nx - 1), nx, 2e3 * (ny - 1), ny,
                         periodic_boundary=(True, True))
    # the (+10, +10) wind drives strictly positive displacements, so the
    # CIC capacity bound is directional: ((0, 3), (0, 3)) pays 16 shifted
    # adds instead of the symmetric halo-3's 49.  Violations would show in
    # metrics.n_clamped, asserted zero after the spin-up below.
    return WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett,
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  advance_mode=advance_mode,
                                                  scatter_mode=scatter_mode,
                                                  dt_reset_mode=dt_reset_mode,
                                                  halo=((0, 3), (0, 3))))


def bench_config(nx, ny, n_small=None, n_big=None, reps=5, solver="bosh3"):
    """Returns a dict with the median-throughput headline plus the repeat
    band (min/max over ``reps`` paired measurements).  Each repeat times
    the (n_small, n_big) scan pair once and derives one per-step estimate,
    so the reported spread is the spread of the actual estimator (a
    regression is a drop beyond that band)."""
    import statistics

    import jax

    if n_small is None:
        # small grids step in ~0.1 ms; use enough steps that the scan-length
        # difference dominates the host<->device sync noise
        n_small, n_big = (50, 550) if nx * ny < 200_000 else (10, 40)

    model = build(nx, ny, solver=solver)
    ms = model.init_state()

    # dynamic trip count: ONE compiled executable serves every loop length
    # (a static-length scan would compile separately for n_small and n_big,
    # doubling cold-cache compile time — the dominant cost of this script)
    def run_n(ms, n):
        return jax.lax.fori_loop(0, n, lambda _, c: model.step(c), ms)

    run_jit = jax.jit(run_n)

    # spin-up to steady state + compile both scan lengths
    ms = run_jit(ms, 4)
    _ = float(ms.state[0, 0, 0])
    assert int(ms.metrics.n_clamped) == 0, "halo capacity bound violated"
    for n in (n_small, n_big):
        _ = float(run_jit(ms, n).state[0, 0, 0])

    def timed(n):
        t0 = time.perf_counter()
        out = run_jit(ms, n)
        _ = float(out.state[0, 0, 0])  # value fetch: a true sync
        return time.perf_counter() - t0

    estimates = []
    for _ in range(reps):
        t_small, t_big = timed(n_small), timed(n_big)
        estimates.append(
            max((t_big - t_small) / (n_big - n_small), 1e-9))
    pushes = nx * ny
    s_med = statistics.median(estimates)
    s_min, s_max = min(estimates), max(estimates)
    return {
        "pushes_per_s": pushes / s_med,          # headline: median
        "s_per_step": s_med,
        "pushes_per_s_max": pushes / s_min,      # fastest repeat
        "pushes_per_s_min": pushes / s_max,      # slowest repeat
        "spread_pct": 100.0 * (s_max - s_min) / s_med,
        "reps": reps,
    }


def main():
    import jax

    from picles_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py measures the GPU; no GPU found")
    # persist compiled executables across runs (compile dominates wall time)
    enable_compile_cache()

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    nx = ny = int(args[0]) if args else 1536
    solver = None
    for a in sys.argv[1:]:     # --solver=tsit5: reference-identical parity
        if a.startswith("--solver="):
            solver = a.split("=", 1)[1]
    explicit = solver is not None
    solver = solver or "bosh3"
    r = bench_config(nx, ny, solver=solver)
    pushes_per_s, s_per_step = r["pushes_per_s"], r["s_per_step"]
    msg = (f"[bench] {nx}x{ny} ({solver}): {pushes_per_s:.3e} pushes/s "
           f"median of {r['reps']} "
           f"[{r['pushes_per_s_min']:.3e}, {r['pushes_per_s_max']:.3e}] "
           f"spread {r['spread_pct']:.1f}% ({s_per_step*1e3:.2f} ms/step)")
    dev = jax.devices()[0]
    out = {
        "metric": "particle_pushes_per_s",
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "value": round(pushes_per_s, 1),
        "unit": "pushes/s",
        "vs_baseline": round(pushes_per_s / BASELINE_PUSHES_PER_S, 2),
        # repeat band (median-of-5 headline): quote regressions against
        # value_min, not the headline — see docs/PERF.md variance note
        "value_min": round(r["pushes_per_s_min"], 1),
        "value_max": round(r["pushes_per_s_max"], 1),
        "spread_pct": round(r["spread_pct"], 2),
        "reps": r["reps"],
    }
    if not explicit:
        # solver-identical parity number alongside the fast variant: the
        # reference integrates with the AutoTsit5 family
        # (particle_waves_v5.jl:47); bosh3 is this framework's fast twin
        # at the same tolerances.  Skipped when --solver pins one config.
        t = bench_config(nx, ny, solver="tsit5")
        msg += (f"; tsit5 parity: {t['pushes_per_s']:.3e} pushes/s "
                f"({t['s_per_step']*1e3:.2f} ms/step, "
                f"spread {t['spread_pct']:.1f}%)")
        out["parity_tsit5_pushes_per_s"] = round(t["pushes_per_s"], 1)
        out["parity_tsit5_vs_baseline"] = round(
            t["pushes_per_s"] / BASELINE_PUSHES_PER_S, 2)
        out["parity_tsit5_spread_pct"] = round(t["spread_pct"], 2)
    if "--small" in sys.argv:  # also time the reference's 51x51 config
        s = bench_config(51, 51, solver=solver)
        msg += (f"; 51x51: {s['pushes_per_s']:.3e} pushes/s "
                f"({s['s_per_step']*1e3:.2f} ms/step)")
    print(msg, file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
