"""Global-scale tripolar demo on the GPU (T03_PIC_tripolar analog,
reference tests/T03_PIC_tripolar_{aqua,land}.jl at production resolution).

Builds the synthetic tripolar supergrid at ~1 degree (720x360 supergrid,
k=2 -> 360x180 T-grid), adds a mid-latitude land blob on top of the default
pole masks, forces with a zonal jet, and

  1. times the full jitted step (scan-length difference, like bench.py),
  2. runs a 24 h simulation and reports the wave field + land-energy check,
  3. writes the double-globe Hs figure with the seam overlaid
     (docs/assets/tripolar_globes_1deg.png by default).

Run:  python benchmark/tripolar_global_demo.py [outdir] [--hours=24]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import picles_tpu as pt
from picles_tpu.grids.mask import make_boundaries
from picles_tpu.grids.base import Boundary
from picles_tpu.grids import tripolar as TG


def build_grid():
    """~1 deg global tripolar grid with pole masks + a synthetic continent."""
    X, Y, dx, dy, area, ang = TG.synthetic_tripolar_supergrid(
        nx_super=720, ny_super=360)
    grid = TG.mom6_grid_from_supergrid(X, Y, dx, dy, area, ang, k=2)
    # carve a continent (a lon/lat box with ragged edge) into the pole-masked
    # ocean so the land-absorption path runs at scale (T03 _land analog)
    lon = np.asarray(grid.x)
    lat = np.asarray(grid.y)
    m = np.asarray(grid.mask) != 0
    land = ((lon > 250.0) & (lon < 310.0) & (lat > -40.0) &
            (lat < 55.0 + 10.0 * np.sin(np.radians(3.0 * lon))))
    m &= ~land
    total = make_boundaries(m, Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
    import dataclasses
    return dataclasses.replace(grid, mask=jnp.asarray(np.asarray(total, np.int32)))


def build_model(DT=1200.0, hours=24.0, advance_mode="auto",
                solver="bosh3", scatter_mode="dense"):
    """The 1 deg tripolar model: zonal jets, carried dt, symmetric halo 3."""
    grid = build_grid()

    def u(x, y, t):
        y = jnp.asarray(y)
        return (12.0 * jnp.exp(-(((y - 40.0) / 18.0) ** 2))
                + 9.0 * jnp.exp(-(((y + 45.0) / 15.0) ** 2)))

    def v(x, y, t):
        return jnp.zeros_like(jnp.asarray(x))

    winds = pt.Winds2D(u=u, v=v)
    ws = pt.FetchRelations.MinimalWindsea(10.0, 10.0, DT)
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=hours * 3600.0, dt=1e-3,
                          dtmin=1e-4, force_dtmin=True, solver=solver)
    return pt.WaveGrowth2D(
        grid, winds, sett,
        config=pt.WaveGrowth2DConfig(periodic_boundary=True,
                                     advance_mode=advance_mode,
                                     scatter_mode=scatter_mode,
                                     dt_reset_mode="carry"))


def main():
    outdir = next((a for a in sys.argv[1:] if not a.startswith("--")), None)
    hours = 24.0
    for a in sys.argv[1:]:
        if a.startswith("--hours="):
            hours = float(a.split("=", 1)[1])

    DT = 1200.0
    model = build_model(DT, hours)
    grid = model.grid
    nx, ny = grid.stats.nx, grid.stats.ny
    print(f"grid: {nx}x{ny} tripolar, "
          f"{int(np.sum(np.asarray(grid.mask) == 1))} ocean nodes")

    # --- step timing (scan-length difference; fixed sync overhead cancels)
    ms = model.init_state()
    run = jax.jit(lambda c, n: jax.lax.fori_loop(
        0, n, lambda _, s: model.step(s), c))
    ms = run(ms, 4)
    _ = float(ms.state[0, 0, 0])
    for n in (10, 40):
        _ = float(run(ms, n).state[0, 0, 0])
    def timed(n, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _ = float(run(ms, n).state[0, 0, 0])
            best = min(best, time.perf_counter() - t0)
        return best
    s_step = (timed(40) - timed(10)) / 30
    print(f"step time: {s_step*1e3:.3f} ms/step "
          f"({nx*ny/s_step:.3e} pushes/s) at {nx}x{ny}")

    # --- 24 h simulation through the driver
    sim = pt.Simulation.create(model, stop_time=hours * 3600.0, verbose=False)
    t0 = time.perf_counter()
    sim.run()
    state = np.asarray(sim.state.state)
    wall = time.perf_counter() - t0
    nsteps = int(round(hours * 3600.0 / DT))
    print(f"{hours:.0f} h run ({nsteps} steps): {wall:.2f} s wall")

    e = state[..., 0]
    mask = np.asarray(grid.mask)
    hs_max = 4.0 * np.sqrt(max(e.max(), 0.0))
    land_e = float(np.abs(e[mask == 0]).sum())
    print(f"max Hs: {hs_max:.2f} m; land energy: {land_e:.2e}")
    assert np.isfinite(e).all(), "non-finite energy in final state"
    assert land_e == 0.0, "energy deposited on land"

    if outdir:
        from picles_tpu.viz import plotting as V
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, "tripolar_globes_1deg.png")
        hs_state = state.copy()
        hs_state[..., 0] = V.significant_wave_height(state[..., 0])
        V.plot_state_double_globe(grid, hs_state, show_seam=True, path=path,
                                  lat0=35.0, lons=(-60.0, 120.0))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
