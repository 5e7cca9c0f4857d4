"""Visualization smoke tests (Agg backend; files actually written)."""

import os

import numpy as np
import jax

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds, constant_winds_1d
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.grids.tripolar import synthetic_tripolar_grid
from picles_tpu.models.wave_growth_1d import WaveGrowth1D, WaveGrowth1DConfig, one_d_grid
from picles_tpu.models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig
from picles_tpu.viz import plotting as V


def _sett(DT=600.0):
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    return ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)


def test_plot_results_1d(tmp_path):
    grid = one_d_grid(0.0, 200e3, 21)
    model = WaveGrowth1D(grid, constant_winds_1d(10.0), _sett(),
                         config=WaveGrowth1DConfig(periodic_boundary=False))
    ms = model.init_state()
    ms, states = model.step_n(ms, 5)
    p = str(tmp_path / "oned.png")
    V.plot_results_1d(np.asarray(states), np.asarray(grid.x),
                      np.arange(1, 6) * 600.0,
                      u_func=lambda x, t: 10.0, path=p)
    assert os.path.getsize(p) > 1000


def test_plot_state_2d_and_movie(tmp_path):
    grid = cartesian_box(100e3, 15, 100e3, 15, periodic_boundary=(True, True))
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), _sett(),
                         config=WaveGrowth2DConfig(periodic_boundary=True))
    ms = model.init_state()
    ms, states = model.step_n(ms, 4)
    ax = V.plot_state_2d(grid, np.asarray(ms.state), title="E")
    assert ax is not None
    import matplotlib.pyplot as plt
    plt.close("all")
    p = str(tmp_path / "movie.gif")
    V.movie_2d(grid, np.asarray(states), p, times=np.arange(1, 5) * 600.0)
    assert os.path.getsize(p) > 1000


def test_double_globe_with_seam(tmp_path):
    grid = synthetic_tripolar_grid(k=2)
    import jax.numpy as jnp
    state = jnp.ones((grid.nx, grid.ny, 3)) * 0.01
    p = str(tmp_path / "globe.png")
    V.plot_state_double_globe(grid, np.asarray(state), path=p, show_seam=True)
    assert os.path.getsize(p) > 1000


def test_movie_dashboard_multi_panel(tmp_path):
    """movie_2d with winds renders the reference's multi-panel dashboard
    (movie_2D.jl:63-98): wind heatmap + quiver arrows, Hs, m_x/m_y and
    c_x/c_y panels with the DT/dx/CFL header — the winds argument is
    consumed, not ignored."""
    import matplotlib.pyplot as plt

    from picles_tpu.forcing.winds import half_domain_winds

    grid = cartesian_box(100e3, 15, 100e3, 15, periodic_boundary=(True, True))
    winds = half_domain_winds(10.0, 5.0, 60e3)
    model = WaveGrowth2D(grid, winds, _sett(),
                         config=WaveGrowth2DConfig(periodic_boundary=True))
    ms = model.init_state()
    ms, states = model.step_n(ms, 4)

    made = {"quiver": 0, "pcolormesh": 0}
    orig_quiver = plt.Axes.quiver
    orig_pcm = plt.Axes.pcolormesh

    def spy_quiver(self, *a, **k):
        made["quiver"] += 1
        return orig_quiver(self, *a, **k)

    def spy_pcm(self, *a, **k):
        made["pcolormesh"] += 1
        return orig_pcm(self, *a, **k)

    plt.Axes.quiver = spy_quiver
    plt.Axes.pcolormesh = spy_pcm
    try:
        p = str(tmp_path / "dashboard.gif")
        V.movie_2d(grid, np.asarray(states), p, winds=winds,
                   times=np.arange(1, 5) * 600.0, dt=600.0,
                   name_string="dashboard smoke")
    finally:
        plt.Axes.quiver = orig_quiver
        plt.Axes.pcolormesh = orig_pcm
    assert os.path.getsize(p) > 1000
    # 6 heatmap panels (winds, Hs, m_x, m_y, c_x, c_y) + 1 quiver overlay
    # (colorbars add internal pcolormesh calls, hence >=)
    assert made["pcolormesh"] >= 6
    assert made["quiver"] == 1
    # the dashboard must differ from the single-panel movie (wind panel
    # actually rendered): single-panel output is a different artifact
    p1 = str(tmp_path / "single.gif")
    V.movie_2d(grid, np.asarray(states), p1,
               times=np.arange(1, 5) * 600.0)
    assert os.path.getsize(p) > os.path.getsize(p1)


def test_movie_dashboard_dt_drives_wind_sample_times(tmp_path):
    """With ``dt`` given and no explicit ``times``, the dashboard samples
    winds at t = frame_index * dt (NOT t = frame index, which would
    freeze time-varying winds near t=0 for every frame)."""
    from picles_tpu.forcing.winds import Winds2D

    grid = cartesian_box(100e3, 9, 100e3, 9, periodic_boundary=(True, True))
    model = WaveGrowth2D(grid, constant_winds(10.0, 5.0), _sett(),
                         config=WaveGrowth2DConfig(periodic_boundary=True))
    ms = model.init_state()
    ms, states = model.step_n(ms, 3)

    seen = []

    def u(x, y, t):
        seen.append(float(np.max(np.asarray(t))))
        return np.full(np.shape(x), 10.0)

    def v(x, y, t):
        return np.zeros(np.shape(x))

    p = str(tmp_path / "dt_movie.gif")
    V.movie_2d(grid, np.asarray(states), p, winds=Winds2D(u=u, v=v),
               dt=600.0)
    assert os.path.getsize(p) > 1000
    # last frame samples winds at (nt-1) * dt seconds, never at t = index
    nt = np.asarray(states).shape[0]
    assert max(seen) == (nt - 1) * 600.0
    assert 1.0 not in seen and float(nt - 1) not in seen
