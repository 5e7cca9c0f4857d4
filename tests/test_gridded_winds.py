"""Gridded (stored) wind forcing — the netCDF-forced path (reference
T04_2D_reg_test_netCDF.jl / B02_2D_regtest_netCDF.jl analogs, with the wind
field supplied as arrays instead of a NetCDF file; the loader is the same
interpolation machinery)."""

import numpy as np
import jax
import jax.numpy as jnp

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import GriddedWinds2D, Winds2D
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig


def _gridded_blob_winds():
    """A moving wind blob stored on a coarse (t, x, y) grid."""
    nt, nx, ny = 8, 11, 11
    t = np.linspace(0, 4 * 3600.0, nt)
    x = np.linspace(0, 100e3, nx)
    y = np.linspace(0, 100e3, ny)
    T, X, Y = np.meshgrid(t, x, y, indexing="ij")
    x0 = 20e3 + 8.0 * T  # blob moving in +x
    u = 12.0 * np.exp(-(((X - x0) / 25e3) ** 2 + ((Y - 50e3) / 30e3) ** 2))
    v = np.zeros_like(u)
    return GriddedWinds2D(u_data=jnp.asarray(u, jnp.float32),
                          v_data=jnp.asarray(v, jnp.float32),
                          x0=0.0, dx=float(x[1] - x[0]),
                          y0=0.0, dy=float(y[1] - y[0]),
                          t0=0.0, dt=float(t[1] - t[0]))


def test_gridded_interpolation_values():
    gw = _gridded_blob_winds()
    # at a grid node the interpolant returns the stored value
    u = float(gw.u(20e3, 50e3, 0.0))
    assert np.isclose(u, 12.0, rtol=1e-5)
    # halfway between nodes: between neighbors
    u_mid = float(gw.u(24.5e3, 50e3, 0.0))
    assert 0 < u_mid < 12.0


def test_model_with_gridded_winds():
    gw = _gridded_blob_winds()
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, 21, 100e3, 21, periodic_boundary=(False, False))
    model = WaveGrowth2D(grid, gw.as_winds(), sett,
                         config=WaveGrowth2DConfig(periodic_boundary=False))
    ms = model.init_state()
    # seeded on only where the blob blows hard enough
    on0 = np.asarray(ms.particles.on)
    assert on0.sum() > 0
    assert not on0.all()
    step = jax.jit(model.step)
    for _ in range(8):
        ms = step(ms)
    e = np.asarray(ms.state[..., 0])
    assert np.all(np.isfinite(e))
    assert int(ms.metrics.n_failed) == 0
    # waves exist downwind of the blob track (center row)
    assert e[8:16, 8:13].max() > 0


def test_per_axis_edge_modes_short_wind_record():
    """A wind record SHORTER than the run: the time axis clamps (holds the
    last frame) independently of the spatial mode — previously choosing
    'wrap' for periodic space also wrapped time."""
    nt, nxw, nyw = 4, 6, 6
    rng = np.random.default_rng(7)
    u = rng.uniform(6.0, 12.0, (nt, nxw, nyw)).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, (nt, nxw, nyw)).astype(np.float32)
    kw = dict(x0=0.0, dx=20e3, y0=0.0, dy=20e3, t0=0.0, dt=600.0)

    gw = GriddedWinds2D(u_data=jnp.asarray(u), v_data=jnp.asarray(v),
                        mode="wrap", mode_t="clamp", **kw)
    # beyond the record end (t > 3*600) the last frame holds
    for t_late in (1800.0, 3600.0, 7200.0):
        np.testing.assert_allclose(
            np.asarray(gw.u(jnp.asarray([0.0, 40e3]), jnp.asarray([20e3] * 2),
                            jnp.full(2, t_late))),
            u[-1, [0, 2], 1], rtol=1e-6)
    # while space wraps periodically: x = nxw*dx == x = 0
    np.testing.assert_allclose(float(gw.u(nxw * 20e3, 0.0, 0.0)),
                               u[0, 0, 0], rtol=1e-6)
    # time wrap mode loops the record instead
    gw_wrap = GriddedWinds2D(u_data=jnp.asarray(u), v_data=jnp.asarray(v),
                             mode="wrap", mode_t="wrap", **kw)
    np.testing.assert_allclose(float(gw_wrap.u(0.0, 0.0, nt * 600.0)),
                               u[0, 0, 0], rtol=1e-6)


def test_model_run_past_wind_record_end():
    """Model integration continuing past the wind record: identical to a
    run on a record extended by repeating the final frame."""
    DT = 600.0
    nt, nxw, nyw = 3, 6, 6
    rng = np.random.default_rng(11)
    u = rng.uniform(8.0, 12.0, (nt, nxw, nyw)).astype(np.float32)
    v = rng.uniform(2.0, 4.0, (nt, nxw, nyw)).astype(np.float32)
    kw = dict(x0=0.0, dx=100e3 / (nxw - 1), y0=0.0, dy=100e3 / (nyw - 1),
              t0=0.0, dt=2 * DT)
    short = GriddedWinds2D(u_data=jnp.asarray(u), v_data=jnp.asarray(v),
                           **kw)
    u_ext = np.concatenate([u, np.repeat(u[-1:], 6, axis=0)])
    v_ext = np.concatenate([v, np.repeat(v[-1:], 6, axis=0)])
    extended = GriddedWinds2D(u_data=jnp.asarray(u_ext),
                              v_data=jnp.asarray(v_ext), **kw)

    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, 12, 100e3, 12,
                         periodic_boundary=(True, True))

    def run(gw):
        m = WaveGrowth2D(grid, gw, sett,
                         config=WaveGrowth2DConfig(periodic_boundary=True))
        ms = m.init_state()
        step = jax.jit(m.step)
        for _ in range(8):  # record covers 4 steps; 4 more past the end
            ms = step(ms)
        return np.asarray(ms.state)

    # f32 frac rounding at the clamp boundary (frac ~1e-7 against the
    # wrap neighbor) is amplified by the adaptive solver to ~1e-4; a
    # wrong-frame bug would be ~10%
    np.testing.assert_allclose(run(short), run(extended), rtol=1e-3)


def test_nonuniform_axes_match_scipy_oracle():
    """Non-uniform axis node tables (gaussian-spaced latitudes, irregular
    time cadence) against scipy RegularGridInterpolator — the reference's
    LinearInterpolation over arbitrary node vectors (WindEmulator.jl:26,
    B02_2D_regtest_netCDF.jl:73-75)."""
    from scipy.interpolate import RegularGridInterpolator

    rng = np.random.default_rng(3)
    # gaussian-grid-like latitude axis (uneven spacing), irregular time
    t_nodes = np.array([0.0, 500.0, 1700.0, 2400.0, 4400.0, 5000.0])
    x_nodes = np.linspace(0.0, 100e3, 7)            # uniform x
    y_nodes = 50e3 * (1 + np.sin(np.linspace(-np.pi / 2, np.pi / 2, 9)))
    y_nodes[0], y_nodes[-1] = 0.0, 100e3
    u = rng.uniform(4.0, 14.0, (len(t_nodes), len(x_nodes),
                                len(y_nodes))).astype(np.float32)
    v = rng.uniform(-5.0, 5.0, u.shape).astype(np.float32)

    gw = GriddedWinds2D(
        u_data=jnp.asarray(u), v_data=jnp.asarray(v),
        x0=0.0, dx=float(x_nodes[1] - x_nodes[0]),
        y0=0.0, dy=1.0, t0=0.0, dt=1.0,
        y_nodes=jnp.asarray(y_nodes), t_nodes=jnp.asarray(t_nodes))

    oracle_u = RegularGridInterpolator((t_nodes, x_nodes, y_nodes), u)
    oracle_v = RegularGridInterpolator((t_nodes, x_nodes, y_nodes), v)

    tq = rng.uniform(0.0, 5000.0, 64)
    xq = rng.uniform(0.0, 100e3, 64)
    yq = rng.uniform(0.0, 100e3, 64)
    np.testing.assert_allclose(
        np.asarray(gw.u(jnp.asarray(xq), jnp.asarray(yq), jnp.asarray(tq))),
        oracle_u(np.stack([tq, xq, yq], -1)), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(gw.v(jnp.asarray(xq), jnp.asarray(yq), jnp.asarray(tq))),
        oracle_v(np.stack([tq, xq, yq], -1)), rtol=2e-5, atol=1e-4)

    # clamp beyond the record in time (mode_t default), on a node row
    np.testing.assert_allclose(
        float(gw.u(x_nodes[2], y_nodes[3], 9000.0)), u[-1, 2, 3], rtol=1e-6)
    # node-exact on the non-uniform latitude axis
    np.testing.assert_allclose(
        float(gw.u(x_nodes[1], y_nodes[5], t_nodes[2])), u[2, 1, 5],
        rtol=1e-6)


def test_nonuniform_time_axis_pallas_pwl_exact():
    """pallas_pwl_fields on an IRREGULAR time axis: the reconstructed
    per-node u(t)/v(t) must equal the interpolant everywhere inside each
    DT window, including windows straddling the record start, interior
    breakpoints, and the clamped record end."""
    from picles_tpu.forcing.winds import gridded_pallas_samplers

    rng = np.random.default_rng(5)
    t_nodes = np.array([1000.0, 1400.0, 2600.0, 3000.0, 4200.0])
    nxw = nyw = 5
    u = rng.uniform(5.0, 12.0, (len(t_nodes), nxw, nyw)).astype(np.float32)
    v = rng.uniform(-4.0, 4.0, u.shape).astype(np.float32)
    gw = GriddedWinds2D(
        u_data=jnp.asarray(u), v_data=jnp.asarray(v),
        x0=0.0, dx=25e3, y0=0.0, dy=25e3, t0=0.0, dt=1.0,
        t_nodes=jnp.asarray(t_nodes))

    DT = 900.0
    B = gw.n_breakpoints(DT)
    assert B == int(900.0 / 400.0) + 1  # min spacing 400 s
    u_k, v_k = gridded_pallas_samplers(B)
    X, Y = np.meshgrid(np.arange(nxw) * 25e3, np.arange(nyw) * 25e3,
                       indexing="ij")
    X, Y = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)

    # windows: before the record, straddling its start, interior node,
    # the irregular long gap, the clamped end, fully past the end
    for t0 in (0.0, 400.0, 1200.0, 2400.0, 3900.0, 5000.0):
        fields = gw.pallas_pwl_fields(X, Y, t0, DT)
        for frac in (0.0, 0.21, 0.5, 0.77, 1.0):
            t = t0 + frac * DT
            tq = jnp.full(X.shape, t, jnp.float32)
            np.testing.assert_allclose(
                np.asarray(u_k(X, Y, tq, *fields)),
                np.asarray(gw.u(X, Y, tq)), rtol=2e-5, atol=2e-4,
                err_msg=f"u window t0={t0} frac={frac}")
            np.testing.assert_allclose(
                np.asarray(v_k(X, Y, tq, *fields)),
                np.asarray(gw.v(X, Y, tq)), rtol=2e-5, atol=2e-4,
                err_msg=f"v window t0={t0} frac={frac}")


def test_model_runs_with_nonuniform_wind_axes():
    """The full model steps with node-table wind axes (the XLA advance
    samples through the coordinate->index map)."""
    rng = np.random.default_rng(9)
    t_nodes = np.array([0.0, 900.0, 1500.0, 3600.0, 7200.0])
    y_nodes = np.array([0.0, 15e3, 45e3, 60e3, 80e3, 100e3])
    u = rng.uniform(8.0, 12.0, (len(t_nodes), 8, len(y_nodes))).astype(
        np.float32)
    v = rng.uniform(1.0, 3.0, u.shape).astype(np.float32)
    gw = GriddedWinds2D(
        u_data=jnp.asarray(u), v_data=jnp.asarray(v),
        x0=0.0, dx=100e3 / 7, y0=0.0, dy=1.0, t0=0.0, dt=1.0,
        y_nodes=jnp.asarray(y_nodes), t_nodes=jnp.asarray(t_nodes))
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, 12, 100e3, 12,
                         periodic_boundary=(True, True))
    m = WaveGrowth2D(grid, gw, sett,
                     config=WaveGrowth2DConfig(periodic_boundary=True))
    ms = m.init_state()
    step = jax.jit(m.step)
    for _ in range(6):
        ms = step(ms)
    e = np.asarray(ms.state[..., 0])
    assert np.all(np.isfinite(e)) and e.max() > 0
    assert int(ms.metrics.n_failed) == 0


def test_gridded_winds_1d_per_axis_edge_modes():
    """GriddedWinds1D: space wraps periodically (reference Periodic()
    parity) while time clamps at the record end by default — the 2D
    sampler's per-axis contract (one mode no longer covers both axes)."""
    from picles_tpu.forcing.winds import GriddedWinds1D

    rng = np.random.default_rng(13)
    nxw, ntw = 6, 4
    u = rng.uniform(5.0, 10.0, (nxw, ntw)).astype(np.float32)
    kw = dict(x0=0.0, dx=10e3, t0=0.0, dt=600.0)

    gw = GriddedWinds1D(u_data=jnp.asarray(u), **kw)   # wrap space, clamp t
    # x = nxw*dx wraps to x = 0
    np.testing.assert_allclose(float(gw.u(nxw * 10e3, 0.0)), u[0, 0],
                               rtol=1e-6)
    # beyond the record end the last frame holds (no silent looping)
    for t_late in (1800.0, 3600.0, 86400.0):
        np.testing.assert_allclose(float(gw.u(20e3, t_late)), u[2, -1],
                                   rtol=1e-6)
    # reference-exact both-axes-periodic behavior is one flag away
    gw_wrap = GriddedWinds1D(u_data=jnp.asarray(u), mode_t="wrap", **kw)
    np.testing.assert_allclose(float(gw_wrap.u(20e3, ntw * 600.0)), u[2, 0],
                               rtol=1e-6)
    # clamped space + wrapped time also composes
    gw_cl = GriddedWinds1D(u_data=jnp.asarray(u), mode="nearest",
                           mode_t="wrap", **kw)
    np.testing.assert_allclose(float(gw_cl.u(-5e3, 600.0)), u[0, 1],
                               rtol=1e-6)


def test_load_gridded_winds_nonuniform_netcdf(tmp_path):
    """A gaussian-spaced-latitude wind file loads into node-table axes and
    interpolates correctly."""
    import h5py

    from picles_tpu.forcing.winds import load_gridded_winds_2d

    nt, ny_, nx_ = 3, 7, 5
    ts = np.arange(nt) * 3600.0
    xs = np.linspace(0.0, 40e3, nx_)
    ys = 50e3 * (1 + np.sin(np.linspace(-np.pi / 2, np.pi / 2, ny_)))
    rng = np.random.default_rng(17)
    u = rng.uniform(5.0, 15.0, (nt, ny_, nx_)).astype(np.float32)
    path = str(tmp_path / "winds_gauss.nc")
    with h5py.File(path, "w") as f:
        f["u10"], f["v10"] = u, -u
        f["longitude"], f["latitude"], f["time"] = xs, ys, ts
    gw = load_gridded_winds_2d(path)
    assert gw.y_nodes is not None      # non-uniform axis kept as a table
    assert gw.t_nodes is None          # uniform axes stay index-mapped
    # node-exact on the gaussian axis
    np.testing.assert_allclose(float(gw.u(xs[2], ys[4], ts[1])), u[1, 4, 2],
                               rtol=1e-6)
    # midpoint between two unevenly spaced latitude nodes is linear
    ym = 0.5 * (ys[1] + ys[2])
    np.testing.assert_allclose(
        float(gw.u(xs[0], ym, ts[0])),
        u[0, 1, 0] + (u[0, 2, 0] - u[0, 1, 0])
        * (ym - ys[1]) / (ys[2] - ys[1]), rtol=1e-5)


def test_n_breakpoints_capped_by_record_length():
    """Near-duplicate timestamps in a node-table time axis must not blow
    up the Pallas field tuple: a window can straddle at most EVERY node,
    so the breakpoint count is bounded by the record length (not
    floor(DT / min_gap) + 1, which a 1 s gap would turn into ~DT terms),
    and the capped decomposition stays exact across the tiny gap."""
    from picles_tpu.forcing.winds import gridded_pallas_samplers

    rng = np.random.default_rng(11)
    t_nodes = np.array([0.0, 1.0, 3600.0, 7200.0])  # 1 s inter-node gap
    nxw = nyw = 4
    u = rng.uniform(5.0, 12.0, (len(t_nodes), nxw, nyw)).astype(np.float32)
    v = rng.uniform(-4.0, 4.0, u.shape).astype(np.float32)
    gw = GriddedWinds2D(
        u_data=jnp.asarray(u), v_data=jnp.asarray(v),
        x0=0.0, dx=25e3, y0=0.0, dy=25e3, t0=0.0, dt=1.0,
        t_nodes=jnp.asarray(t_nodes))

    DT = 900.0
    B = gw.n_breakpoints(DT)
    assert B == len(t_nodes)           # capped; uncapped would be 901

    u_k, v_k = gridded_pallas_samplers(B)
    X, Y = np.meshgrid(np.arange(nxw) * 25e3, np.arange(nyw) * 25e3,
                       indexing="ij")
    X, Y = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
    # windows: straddling the 1 s gap, interior, clamped end, past the end.
    # Tolerance is looser than the regular-gap test: the decomposition's
    # slope terms scale as du * t / gap, so a 1 s gap under f32 leaves
    # ~(DT/gap) * eps * |du| ~ 1e-3 of cancellation residue (exact in
    # exact arithmetic; see pallas_pwl_fields docstring).
    for t0 in (0.0, 0.5, 3000.0, 6800.0, 8000.0):
        fields = gw.pallas_pwl_fields(X, Y, t0, DT)
        assert len(fields) == 4 + 3 * B
        for frac in (0.0, 0.001, 0.3, 0.8, 1.0):
            tq = jnp.full(X.shape, t0 + frac * DT, jnp.float32)
            np.testing.assert_allclose(
                np.asarray(u_k(X, Y, tq, *fields)),
                np.asarray(gw.u(X, Y, tq)), rtol=1e-4, atol=2e-3,
                err_msg=f"u window t0={t0} frac={frac}")
            np.testing.assert_allclose(
                np.asarray(v_k(X, Y, tq, *fields)),
                np.asarray(gw.v(X, Y, tq)), rtol=1e-4, atol=2e-3,
                err_msg=f"v window t0={t0} frac={frac}")


def test_load_gridded_winds_north_to_south_latitude(tmp_path):
    """Real ERA5 files store latitude NORTH-TO-SOUTH (90..-90).  The
    loader flips a strictly decreasing spatial axis (and the data along
    it) so the file loads and interpolates exactly as its south-to-north
    mirror."""
    import h5py

    from picles_tpu.forcing.winds import load_gridded_winds_2d

    nt, ny_, nx_ = 4, 6, 5
    ts = np.arange(nt) * 3600.0
    xs = np.linspace(0.0, 40e3, nx_)
    ys_desc = np.linspace(50e3, 0.0, ny_)          # decreasing, ERA5-style
    rng = np.random.default_rng(23)
    u = rng.uniform(5.0, 15.0, (nt, ny_, nx_)).astype(np.float32)
    path = str(tmp_path / "winds_n2s.nc")
    with h5py.File(path, "w") as f:
        f["u10"], f["v10"] = u, -u
        f["longitude"], f["latitude"], f["time"] = xs, ys_desc, ts
    gw = load_gridded_winds_2d(path)
    assert gw.y_nodes is None and gw.dy > 0        # flipped to uniform asc.
    # every node sample maps back to the original [t, lat, lon] value
    for (k, j, i) in [(0, 0, 0), (1, 4, 2), (3, 5, 4), (2, 2, 1)]:
        np.testing.assert_allclose(
            float(gw.u(xs[i], ys_desc[j], ts[k])), u[k, j, i], rtol=1e-6)
    # midpoint between two latitude rows interpolates linearly
    ym = 0.5 * (ys_desc[1] + ys_desc[2])
    np.testing.assert_allclose(
        float(gw.u(xs[0], ym, ts[0])),
        0.5 * (u[0, 1, 0] + u[0, 2, 0]), rtol=1e-5)
