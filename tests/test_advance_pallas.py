"""Pallas fused-advance kernel (Triton route) vs the XLA while_loop path.

Interpret mode on the CPU; the same kernel compiles through Triton on the
GPU, where chip_smoke.py and the ``gpu``-marked tests cross-check it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds, time_cosine_winds
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig


def _models(winds, n=24):
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, n, 100e3, n, periodic_boundary=(True, True))
    mx = WaveGrowth2D(grid, winds, sett,
                      config=WaveGrowth2DConfig(periodic_boundary=True,
                                                advance_mode="xla"))
    mp = WaveGrowth2D(grid, winds, sett,
                      config=WaveGrowth2DConfig(periodic_boundary=True,
                                                advance_mode="pallas",
                                                pallas_interpret=True))
    return mx, mp


def test_pallas_advance_matches_xla_constant_winds():
    mx, mp = _models(constant_winds(10.0, 5.0))
    sx, sp = mx.init_state(), mp.init_state()
    for _ in range(3):
        sx = mx.step(sx)
        sp = mp.step(sp)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=5e-3, atol=1e-8)
    assert int(sp.metrics.n_failed) == 0
    # same branch counts: the state machine is identical
    assert int(sp.metrics.n_gather) == int(sx.metrics.n_gather)
    assert int(sp.metrics.n_active) == int(sx.metrics.n_active)


def test_pallas_advance_time_dependent_winds():
    """Per-lane time enters the wind closure inside the kernel."""
    winds = time_cosine_winds(10.0, 0.0, period=6 * 3600.0)
    mx, mp = _models(winds, n=12)
    sx, sp = mx.init_state(), mp.init_state()
    for _ in range(4):
        sx = mx.step(sx)
        sp = mp.step(sp)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=1e-2, atol=1e-7)


def test_pallas_block_divisor_handling():
    """Odd grid sizes still work (power-of-two lane blocks + tail
    padding)."""
    mx, mp = _models(constant_winds(10.0, 5.0), n=23)
    sp = mp.init_state()
    sp = mp.step(sp)
    assert np.all(np.isfinite(np.asarray(sp.state)))


@pytest.mark.parametrize("n", [
    61,
    # second prime size: exhaustive tier (same padding machinery)
    pytest.param(127, marks=pytest.mark.slow),
])
def test_pallas_prime_nx_all_kernels_match_xla(n):
    """Prime nx: the flattened lane axis (n * 13 lanes) is not a multiple
    of the block, so it runs as several programs plus a padded tail, and
    the carried-dt production step must match the XLA path."""
    from picles_tpu.ops.advance_pallas import BLOCK

    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, n, 50e3, 13, periodic_boundary=(True, True))
    assert n * 13 > BLOCK and (n * 13) % BLOCK != 0
    winds = constant_winds(10.0, 5.0)
    mx = WaveGrowth2D(grid, winds, sett,
                      config=WaveGrowth2DConfig(periodic_boundary=True,
                                                dt_reset_mode="carry"))
    mp = WaveGrowth2D(grid, winds, sett,
                      config=WaveGrowth2DConfig(
                          periodic_boundary=True, advance_mode="pallas",
                          dt_reset_mode="carry", pallas_interpret=True))
    sx, sp = mx.init_state(), mp.init_state()
    for _ in range(2):
        sx = mx.step(sx)
        sp = mp.step(sp)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=5e-3, atol=1e-8)
    assert int(sp.metrics.n_failed) == 0
    for k in ("n_gather", "n_reseed", "n_off", "n_active"):
        assert int(getattr(sp.metrics, k)) == int(getattr(sx.metrics, k)), k


@pytest.mark.slow
def test_pallas_advance_gridded_winds():
    """[exhaustive tier: the frame-straddle variant below is the
    stronger default-tier lock for the same path]

    Gridded (map_coordinates) winds run on the Pallas path via the
    per-step linearization fields.  Forcing cadence = 2 DT and aligned, so
    the linearization equals the tri-linear interpolant exactly and the two
    paths must agree to solver tolerance."""
    from picles_tpu.forcing.winds import GriddedWinds2D

    DT = 600.0
    nxw, nyw, ntw = 12, 12, 40
    rng = np.random.default_rng(0)
    u_data = 8.0 + 3.0 * rng.standard_normal((ntw, nxw, nyw)).astype(np.float32)
    v_data = 5.0 + 2.0 * rng.standard_normal((ntw, nxw, nyw)).astype(np.float32)
    gw = GriddedWinds2D(u_data=jnp.asarray(u_data), v_data=jnp.asarray(v_data),
                        x0=0.0, dx=100e3 / (nxw - 1), y0=0.0,
                        dy=100e3 / (nyw - 1), t0=0.0, dt=2 * DT)
    mx, mp = _models(gw.as_winds(), n=16)
    assert mp.gridded_winds is gw  # bound-method detection
    sx, sp = mx.init_state(), mp.init_state()
    for _ in range(4):
        sx = mx.step(sx)
        sp = mp.step(sp)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=1e-2, atol=1e-7)
    assert int(sp.metrics.n_failed) == 0
    assert int(sp.metrics.n_gather) == int(sx.metrics.n_gather)


@pytest.mark.parametrize("t0,dtw,DT", [
    (1200.0, 1200.0, 600.0),   # aligned: window inside one frame interval
    (900.0, 1200.0, 600.0),    # straddles one frame boundary (t=1200)
    (700.0, 1200.0, 600.0),    # straddle at an uneven offset
    (500.0, 400.0, 600.0),     # DT > frame cadence: B=2, two breakpoints
    (10300.0, 1200.0, 600.0),  # straddles the record end (time clamp)
])
def test_gridded_pwl_fields_match_interpolant_everywhere(t0, dtw, DT):
    """pallas_pwl_fields reproduces the tri-linear interpolant EXACTLY at
    dense query times through the window — including windows that straddle
    wind-data frame boundaries (the case the old secant linearization
    approximated) and the record-end time clamp."""
    from picles_tpu.forcing.winds import (GriddedWinds2D,
                                          gridded_pallas_samplers)

    rng = np.random.default_rng(1)
    gw = GriddedWinds2D(
        u_data=jnp.asarray(rng.standard_normal((10, 8, 8)).astype(np.float32)),
        v_data=jnp.asarray(rng.standard_normal((10, 8, 8)).astype(np.float32)),
        x0=0.0, dx=10e3, y0=0.0, dy=10e3, t0=0.0, dt=dtw)
    x = jnp.asarray(np.linspace(0, 70e3, 8, dtype=np.float32))
    xx, yy = jnp.meshgrid(x, x, indexing="ij")
    B = gw.n_breakpoints(DT)
    fields = gw.pallas_pwl_fields(xx, yy, t0, DT)
    assert len(fields) == 4 + 3 * B
    u_k, v_k = gridded_pallas_samplers(B)
    for frac in np.linspace(0.0, 1.0, 13):
        tq = t0 + frac * DT
        tqb = jnp.full_like(xx, tq)
        np.testing.assert_allclose(np.asarray(u_k(xx, yy, tqb, *fields)),
                                   np.asarray(gw.u(xx, yy, tqb)),
                                   rtol=1e-5, atol=1e-5, err_msg=f"u t={tq}")
        np.testing.assert_allclose(np.asarray(v_k(xx, yy, tqb, *fields)),
                                   np.asarray(gw.v(xx, yy, tqb)),
                                   rtol=1e-5, atol=1e-5, err_msg=f"v t={tq}")


def test_pallas_advance_gridded_winds_frame_straddle():
    """Model-level lock for the straddle case: wind frames at a cadence
    that is NOT a multiple of DT (900 s vs DT = 600 s), so every other DT
    window crosses a frame boundary mid-advance.  With the exact PWL
    fields the Pallas path must match the XLA path (which samples the
    interpolant directly at every RHS eval) at solver tolerance — there is
    no longer a silent secant approximation on the production path."""
    from picles_tpu.forcing.winds import GriddedWinds2D

    nxw = nyw = 10
    ntw = 30
    rng = np.random.default_rng(7)
    # smooth-ish in space, sharply varying between frames so a secant
    # across a frame boundary would be visibly wrong
    base = rng.uniform(6.0, 14.0, (ntw, 1, 1))
    u_data = (base + rng.standard_normal((ntw, nxw, nyw))).astype(np.float32)
    v_data = (0.5 * base
              + rng.standard_normal((ntw, nxw, nyw))).astype(np.float32)
    gw = GriddedWinds2D(u_data=jnp.asarray(u_data), v_data=jnp.asarray(v_data),
                        x0=0.0, dx=100e3 / (nxw - 1), y0=0.0,
                        dy=100e3 / (nyw - 1), t0=0.0, dt=900.0)
    mx, mp = _models(gw.as_winds(), n=12)
    assert mp._wind_B == 1
    sx, sp = mx.init_state(), mp.init_state()
    for _ in range(4):   # windows [0,600], [600,1200]*, [1200,1800]*, ...
        sx = mx.step(sx)
        sp = mp.step(sp)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=1e-2, atol=1e-7)
    assert int(sp.metrics.n_failed) == 0
    assert int(sp.metrics.n_gather) == int(sx.metrics.n_gather)


def test_pallas_advance_per_node_projection_spherical():
    """Spherical grids have per-node projection matrices and great-circle
    coefficients — the fused kernel's streamed (non-uniform) proj/pc branch.
    Propagation-only blob: pallas vs xla must agree on a sphere."""
    import dataclasses
    import math

    from picles_tpu.grids.spherical import spherical_grid_2d
    from picles_tpu.ops.rhs import TermFlags

    DT = 1800.0
    ws = FR.MinimalWindsea(1.0, 1.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=10 * 24 * 3600.0, dt=1.0,
                       dtmin=1e-2, force_dtmin=True)
    grid = spherical_grid_2d(0.0, 60.0, 16, 10.0, 50.0, 12,
                             periodic_boundary=(True, False))
    flags = TermFlags(input=False, dissipation=False, peak_shift=False,
                      direction=False)

    def mk(mode):
        return WaveGrowth2D(
            grid, constant_winds(0.0, 0.0), sett, flags=flags,
            config=WaveGrowth2DConfig(periodic_boundary=False, halo=4,
                                      advance_mode=mode,
                                      pallas_interpret=True))

    mx, mp = mk("xla"), mk("pallas")
    assert mp.uniform_proj is None  # must exercise the streamed-proj branch

    def plant(ms):
        nx, ny = grid.nx, grid.ny
        on = np.zeros((nx, ny), bool)
        on[5:9, 4:8] = True
        z = np.asarray(ms.particles.z).copy()
        z[..., 0] = math.log(0.1)
        z[..., 1] = 10.0
        z[..., 2] = 0.0
        z[..., 3:] = 0.0
        import jax.numpy as jnp
        from picles_tpu.models.state import Particles2D
        return dataclasses.replace(
            ms, particles=Particles2D.from_z(jnp.asarray(z, jnp.float32),
                                             ms.particles.t, ms.particles.dt,
                                             jnp.asarray(on)))

    sx, sp = plant(mx.init_state()), plant(mp.init_state())
    for _ in range(3):
        sx = mx.step(sx)
        sp = mp.step(sp)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=5e-3, atol=1e-8)
    assert int(sp.metrics.n_failed) == 0
    # the great-circle term must actually act (equatorward momentum appears)
    assert np.asarray(sp.state[..., 2]).min() < -1e-6


# ---------------------------------------------------------------------------
# Triton wrapper: 1D lane blocks, padding, direct kernel calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [
    (1, 256), (2, 256), (3, 256), (31, 256), (23 * 19, 256),
    (61 * 13, 64), (127, 100), (360 * 180, 256), (1536 * 1536, 256),
    (2 ** 20 + 1, 512),
])
def test_lane_block_power_of_two_and_padding(n, block):
    """Power-of-two lane blocks for any lane count (primes, odd products,
    the 1 deg tripolar and 1536^2 grids); padding is less than one block
    and vanishes when the block divides the lane count."""
    from picles_tpu.ops.advance_pallas import lane_block

    b, n_pad = lane_block(n, block)
    assert b & (b - 1) == 0 and 1 <= b <= block
    assert n_pad % b == 0 and n <= n_pad < n + b
    if n >= block:
        assert b == 1 << (block.bit_length() - 1)   # block rounded down
    else:
        assert b < 2 * n                            # small grids: one block
    if n % b == 0:
        assert n_pad == n


def test_lane_block_rejects_nonpositive_block():
    from picles_tpu.ops.advance_pallas import lane_block

    with pytest.raises(ValueError, match="block"):
        lane_block(100, 0)


def _direct_inputs(nx, ny, seed=0):
    """A perturbed mid-growth particle state on an odd grid: lane dts
    spread over five decades so the per-lane sub-step counts differ."""
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, nx, 100e3, ny, periodic_boundary=(True, True))
    m = WaveGrowth2D(grid, constant_winds(10.0, 5.0), sett,
                     config=WaveGrowth2DConfig(advance_mode="xla"))
    ms = m.step(m.init_state())
    rng = np.random.default_rng(seed)
    dt = jnp.asarray(10.0 ** rng.uniform(-2, 2.5, (nx, ny)), jnp.float32)
    act = jnp.asarray(rng.random((nx, ny)) > 0.2) & ms.particles.on
    return m, ms.particles, dt, act


def _run_direct(m, P, dt, act, **kw):
    from picles_tpu.ops.advance_pallas import advance_pallas
    from picles_tpu.ops.rhs import make_rhs_consts

    consts = make_rhs_consts(gamma=m.constants.gamma, constants=m.constants,
                             params=m.params)
    g = m.grid
    return advance_pallas(m.winds.u, m.winds.v, consts, m.flags, m.solver,
                          float(m.settings.timestep),
                          (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, dt, act,
                          g.x, g.y, m.uniform_proj, g.pc, interpret=True,
                          **kw)


@pytest.mark.parametrize("nx,ny,block", [(13, 7, 16), (11, 11, 32),
                                         (7, 5, 4)])
def test_advance_pallas_direct_matches_integrate_to(nx, ny, block):
    """The kernel alone against tsit5.integrate_to on odd and prime grids
    with several padded blocks: same state, clock and failures per lane.
    Accepted sub-step counts agree to one sub-step on a few lanes: the
    component-wise kernel and the stacked XLA loop round differently in
    the last bit, which can flip a borderline accept/reject decision."""
    from picles_tpu.ops.rhs import RHSParams
    from picles_tpu.ops.tsit5 import integrate_to

    m, P, dt, act = _direct_inputs(nx, ny)
    r = _run_direct(m, P, dt, act, block=block)
    g = m.grid
    ref = integrate_to(m.rhs, P.z, P.t, P.t + m.settings.timestep, dt,
                       RHSParams(x=g.x, y=g.y, M=g.proj, pc=g.pc), act,
                       m.solver)
    got = np.stack([np.asarray(c) for c in (r.lne, r.cgx, r.cgy, r.x, r.y)],
                   -1)
    np.testing.assert_allclose(got, np.asarray(ref.z), rtol=5e-3, atol=1e-8)
    np.testing.assert_allclose(np.asarray(r.t), np.asarray(ref.t), rtol=1e-6)
    assert np.array_equal(np.asarray(r.failed), np.asarray(ref.failed))
    dn = np.abs(np.asarray(r.naccept) - np.asarray(ref.naccept))
    assert dn.max() <= 1 and dn.mean() < 0.1
    assert int(np.asarray(ref.naccept).max()) > 1   # lanes really adapt


@pytest.mark.parametrize("block", [4, 16, 64])
def test_advance_pallas_block_size_invariant(block):
    """Lanes are independent: the block size (and with it which lanes share
    a program and how the tail is padded) changes the result only by the
    vector width's last-bit rounding, amplified at most by a flipped
    accept/reject decision — solver tolerance, same failures, and every
    lane's clock on t_end."""
    m, P, dt, act = _direct_inputs(9, 7, seed=1)
    a = _run_direct(m, P, dt, act, block=block)
    b = _run_direct(m, P, dt, act, block=256)
    for f in ("lne", "cgx", "cgy", "x", "y"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   np.asarray(getattr(b, f)), rtol=5e-3,
                                   atol=1e-8, err_msg=f)
    assert np.array_equal(np.asarray(a.failed), np.asarray(b.failed))
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    assert a.lne.shape == P.t.shape


# ---------------------------------------------------------------------------
# backend resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,mode,interpret,want", [
    ("cpu", "auto", False, "xla"),
    ("gpu", "auto", False, "pallas"),
    ("cpu", "xla", False, "xla"),
    ("gpu", "xla", False, "xla"),
    ("gpu", "pallas", False, "pallas"),
    ("cpu", "pallas", True, "pallas"),
    ("cpu", "pallas", False, ValueError),
    ("rocm", "pallas", False, ValueError),
])
def test_advance_mode_resolution(monkeypatch, backend, mode, interpret, want):
    """"auto" is the Triton advance on the GPU and the XLA loop elsewhere;
    an explicit "pallas" that cannot compile raises instead of silently
    interpreting or falling back."""
    from picles_tpu.models import wave_growth_2d as W

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = WaveGrowth2DConfig(advance_mode=mode, pallas_interpret=interpret)
    if want is ValueError:
        with pytest.raises(ValueError, match="GPU"):
            W._resolve_auto_modes(cfg)
    else:
        assert W._resolve_auto_modes(cfg).advance_mode == want


@pytest.mark.parametrize("kw", [dict(advance_mode="bogus"),
                                dict(scatter_mode="pallas"),
                                dict(scatter_mode="auto")])
def test_unknown_kernel_modes_raise(kw):
    from picles_tpu.models.wave_growth_2d import _resolve_auto_modes

    with pytest.raises(ValueError, match="unknown"):
        _resolve_auto_modes(WaveGrowth2DConfig(**kw))


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_fixed_substep_carries_dt_unclipped(mode):
    """ODESettings.adaptive=False: both advances carry the configured fixed
    sub-step verbatim through the remesh, even outside [dtmin, DT]."""
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0,
                       dt=2 * DT,              # deliberate: outside [dtmin, DT]
                       dtmin=1e-4, force_dtmin=True, adaptive=False)
    grid = cartesian_box(100e3, 8, 100e3, 8, periodic_boundary=(True, True))
    mk = lambda am: WaveGrowth2D(  # noqa: E731
        grid, constant_winds(10.0, 5.0), sett,
        config=WaveGrowth2DConfig(periodic_boundary=True, advance_mode=am,
                                  dt_reset_mode="carry",
                                  pallas_interpret=True))
    mx, mp = mk("xla"), mk(mode)
    sx, sp = mx.init_state(), mp.init_state()
    for _ in range(2):
        sx, sp = mx.step(sx), mp.step(sp)
    np.testing.assert_array_equal(np.asarray(sp.particles.dt),
                                  np.full((8, 8), 2 * DT, np.float32))
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=2e-6, atol=1e-9)
