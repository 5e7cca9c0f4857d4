"""WaveGrowth2D integration tests (reference T04 2D box regression analogs,
asserting instead of plotting)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds, half_domain_winds
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import (ParticleDefaults2D, WaveGrowth2D,
                                              WaveGrowth2DConfig)
from picles_tpu.ops.rhs import RHSParams
from picles_tpu.ops.tsit5 import SolverConfig, integrate_to


def _settings(DT=600.0, U=10.0, V=10.0):
    ws_min = FR.MinimalWindsea(U, V, DT)
    return ODESettings(log_energy_minimum=float(ws_min.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)


def _box_model(U=10.0, V=10.0, n=21, periodic=True, **cfg_kw):
    grid = cartesian_box(100e3, n, 100e3, n,
                         periodic_boundary=(periodic, periodic))
    cfg = WaveGrowth2DConfig(periodic_boundary=periodic, **cfg_kw)
    return WaveGrowth2D(grid, constant_winds(U, V), _settings(U=U, V=V),
                        config=cfg)


def test_seeding_windsea_matches_fetch_law():
    model = _box_model()
    ms = model.init_state()
    ws = FR.get_initial_windsea(10.0, 10.0, 600.0)
    # every ocean node seeded on with the windsea energy
    assert bool(jnp.all(ms.particles.on))
    np.testing.assert_allclose(float(ms.state[5, 5, 0]), float(ws.E), rtol=1e-5)
    np.testing.assert_allclose(float(ms.state[5, 5, 1]), float(ws.m_x), rtol=1e-5)


def test_seeding_weak_wind_minimal_off():
    model = _box_model(U=0.5, V=0.5)
    ms = model.init_state()
    assert not bool(jnp.any(ms.particles.on))
    np.testing.assert_allclose(np.asarray(ms.state), 0.0, atol=1e-12)
    # particle z carries the minimal particle
    mp = FR.MinimalParticle(0.5, 0.5, 600.0)
    np.testing.assert_allclose(np.asarray(ms.particles.z[3, 3]),
                               np.asarray(mp), rtol=1e-5)


def test_homogeneous_growth_matches_single_particle_ode():
    """Uniform wind + periodic box: the PIC cycle is an exact identity, so
    the field energy must track the single-particle ODE (B01/T04 analog)."""
    model = _box_model(periodic=True)
    ms = model.init_state()
    step = jax.jit(model.step)
    n_steps = 12  # 2 hours
    for _ in range(n_steps):
        ms = step(ms)

    # single-particle chain: integrate the same RHS straight through
    z0 = FR.get_initial_windsea_particle_state(10.0, 10.0, 600.0)[None, :]
    aux = RHSParams(x=jnp.zeros(1), y=jnp.zeros(1),
                    M=model.grid.proj[0, 0][None], pc=jnp.zeros(1))
    res = integrate_to(model.rhs, z0.astype(jnp.float32), jnp.zeros(1),
                       jnp.full((1,), n_steps * 600.0), jnp.full((1,), 1e-3),
                       aux, jnp.array([True]),
                       SolverConfig(abstol=1e-6, reltol=1e-7))
    e_particle = float(jnp.exp(res.z[0, 0]))
    e_field = np.asarray(ms.state[..., 0])
    # uniform field
    assert e_field.std() / e_field.mean() < 1e-3
    np.testing.assert_allclose(e_field.mean(), e_particle, rtol=2e-2)
    assert int(ms.metrics.n_failed) == 0


def test_energy_growth_monotone_early():
    model = _box_model()
    ms = model.init_state()
    step = jax.jit(model.step)
    means = [float(ms.state[..., 0].mean())]
    for _ in range(6):
        ms = step(ms)
        means.append(float(ms.state[..., 0].mean()))
    assert all(b > a for a, b in zip(means, means[1:]))


def test_determinism_bitwise():
    """Same input -> bitwise same state (the reference's threaded scatter
    races; XLA is deterministic — SURVEY §5 race-detection note)."""
    model = _box_model()
    ms = model.init_state()
    step = jax.jit(model.step)
    a = step(ms)
    b = step(ms)
    assert np.array_equal(np.asarray(a.state), np.asarray(b.state))
    assert np.array_equal(np.asarray(a.particles.z), np.asarray(b.particles.z))


def test_scatter_modes_agree_in_model():
    m1 = _box_model(scatter_mode="dense")
    m2 = _box_model(scatter_mode="xla")
    ms1, ms2 = m1.init_state(), m2.init_state()
    for _ in range(3):
        ms1 = m1.step(ms1)
        ms2 = m2.step(ms2)
    # f32 summation-order differences compound through exp/log round-trips
    np.testing.assert_allclose(np.asarray(ms1.state), np.asarray(ms2.state),
                               rtol=2e-3, atol=1e-9)


def test_nonperiodic_fetch_gradient():
    """Non-periodic box, wind along +x: energy should grow with fetch
    (downwind nodes carry more energy than upwind ones) — T04 physics."""
    model = _box_model(U=10.0, V=0.0, n=31, periodic=False)
    ms = model.init_state()
    step = jax.jit(model.step)
    for _ in range(18):  # 3 hours
        ms = step(ms)
    e = np.asarray(ms.state[..., 0])
    interior = e[1:-1, 1:-1]
    mid = interior.shape[1] // 2
    upwind = interior[1, mid]
    downwind = interior[-2, mid]
    assert downwind > upwind * 1.01
    assert int(ms.metrics.n_failed) == 0


def test_half_domain_wind_relight_and_off():
    """Wind only in half the domain: calm-side particles sit off; the wavy
    side stays on (T04_2D_on_off analog)."""
    grid = cartesian_box(100e3, 21, 100e3, 21, periodic_boundary=(False, False))
    winds = half_domain_winds(10.0, 0.0, x_split=50e3, background=0.0)
    model = WaveGrowth2D(grid, winds, _settings(U=10.0, V=0.0),
                         config=WaveGrowth2DConfig(periodic_boundary=False))
    ms = model.init_state()
    on0 = np.asarray(ms.particles.on)
    assert on0[2, 10] and not on0[18, 10]
    step = jax.jit(model.step)
    for _ in range(6):
        ms = step(ms)
    e = np.asarray(ms.state[..., 0])
    assert e[3, 10] > 0
    assert int(ms.metrics.n_failed) == 0
    assert np.all(np.isfinite(e))


def test_emax_clamp_engages():
    """Force an absurdly low energy ceiling and check the clamp fires."""
    ws_min = FR.MinimalWindsea(10.0, 10.0, 600.0)
    sett = ODESettings(log_energy_minimum=float(ws_min.lne),
                       log_energy_maximum=math.log(1e-3),
                       saving_step=600.0, timestep=600.0,
                       total_time=6 * 24 * 3600.0, dt=1e-3, dtmin=1e-4,
                       force_dtmin=True)
    grid = cartesian_box(50e3, 11, 50e3, 11, periodic_boundary=(True, True))
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett)
    ms = model.init_state()
    step = jax.jit(model.step)
    clamped = 0
    for _ in range(8):
        ms = step(ms)
        clamped += int(ms.metrics.n_emax_clamp)
    assert clamped > 0
    assert float(ms.state[..., 0].max()) <= 1e-3 * 1.05


def test_fixed_defaults_seeding():
    d = ParticleDefaults2D(lne=math.log(1e-4), cg_x=2.0, cg_y=0.0)
    model = _box_model(ode_init_type=d)
    ms = model.init_state()
    np.testing.assert_allclose(float(ms.particles.z[4, 4, 0]), d.lne, rtol=1e-6)
    assert bool(jnp.all(ms.particles.on))


def test_step_n_scan_matches_loop():
    model = _box_model()
    ms = model.init_state()
    ms_scan, states = model.step_n(ms, 4)
    ms_loop = ms
    step = jax.jit(model.step)
    for _ in range(4):
        ms_loop = step(ms_loop)
    np.testing.assert_allclose(np.asarray(ms_scan.state),
                               np.asarray(ms_loop.state), rtol=1e-6)
    assert states.shape[0] == 4


def test_dt_carry_mode_matches_auto():
    """Warm-restart dt policy stays within solver tolerance of the
    reference-semantics auto_dt path (and uses fewer substeps)."""
    import jax

    from picles_tpu.forcing.winds import time_cosine_winds

    def build(mode, winds):
        DT = 600.0
        ws = FR.MinimalWindsea(10.0, 10.0, DT)
        sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                           timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                           dtmin=1e-4, force_dtmin=True)
        grid = cartesian_box(100e3, 21, 100e3, 21,
                             periodic_boundary=(True, True))
        return WaveGrowth2D(grid, winds, sett,
                            config=WaveGrowth2DConfig(periodic_boundary=True,
                                                      dt_reset_mode=mode))

    winds = time_cosine_winds(10.0, 0.0, period=6 * 3600.0)
    ma, mc = build("auto", winds), build("carry", winds)
    sa, sc = ma.init_state(), mc.init_state()
    fa, fc = jax.jit(ma.step), jax.jit(mc.step)
    for _ in range(10):
        sa, sc = fa(sa), fc(sc)
    a, c = np.asarray(sa.state), np.asarray(sc.state)
    denom = np.abs(a).max(axis=(0, 1), keepdims=True) + 1e-12
    assert np.max(np.abs(a - c) / denom) < 5e-3
    assert int(sc.metrics.substeps_max) <= int(sa.metrics.substeps_max)
    assert int(sc.metrics.n_failed) == 0


def test_bosh3_solver_matches_tsit5():
    """The production bench config runs solver="bosh3" (half the RHS evals
    per substep); same error tolerances => same physics within solver
    tolerance, and the steady-state substep count must not regress."""
    import dataclasses

    def run(solver):
        grid = cartesian_box(100e3, 21, 100e3, 21,
                             periodic_boundary=(True, True))
        sett = dataclasses.replace(_settings(), solver=solver)
        model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett,
                             config=WaveGrowth2DConfig(periodic_boundary=True,
                                                       dt_reset_mode="carry"))
        ms = model.init_state()
        step = jax.jit(model.step)
        for _ in range(12):
            ms = step(ms)
        return ms

    a = run("tsit5")
    b = run("bosh3")
    assert int(b.metrics.n_failed) == 0
    # steady state: both settle to 1 substep per DT
    assert int(b.metrics.substeps_max) <= int(a.metrics.substeps_max)
    np.testing.assert_allclose(np.asarray(b.state), np.asarray(a.state),
                               rtol=2e-3, atol=1e-6)


def test_boundary_type_mininmal_boundary_stays_dark():
    """boundary_type selects the open-boundary inflow condition (reference
    WaveGrowthModels2D.jl:273-292 + the intended mapping_2D.jl:338-345
    branch): boundary particles never integrate; each remesh they reseed
    from boundary_defaults and scatter that state as-is.

    "mininmal" -> boundary holds the fixed 5-min/1.41 m/s minimal windsea
    (stays dark); "wind_sea" -> boundary holds the full local windsea
    (bright inflow); "same" -> reference-actual behavior (inert boundary).
    """
    models = {bt: _box_model(periodic=False, boundary_type=bt)
              for bt in ("mininmal", "wind_sea", "same")}
    states = {bt: m.init_state() for bt, m in models.items()}
    steps = {bt: jax.jit(m.step) for bt, m in models.items()}
    for _ in range(6):
        for bt in models:
            states[bt] = steps[bt](states[bt])

    bnd = np.asarray(models["mininmal"].boundary_mask)
    E = {bt: np.asarray(s.state[..., 0]) for bt, s in states.items()}

    # deep interior is unaffected by the boundary condition choice
    for bt in ("mininmal", "wind_sea"):
        np.testing.assert_allclose(E[bt][8:-8, 8:-8], E["same"][8:-8, 8:-8],
                                   rtol=1e-5)

    # mechanism: after the remesh, "mininmal" boundary particles carry
    # exactly the fixed minimal defaults (wind is strong -> reseed branch)
    bd = models["mininmal"].boundary_defaults
    lne_b = np.asarray(states["mininmal"].particles.lne)[bnd]
    np.testing.assert_allclose(lne_b, bd.lne, rtol=1e-6)
    assert bool(np.all(np.asarray(states["mininmal"].particles.on)[bnd]))

    # "mininmal" boundary stays dark while the interior grows: its own
    # scattered energy is the (tiny) minimal windsea, so the boundary row
    # carries only neighbor inflow — far below the grown interior
    assert E["mininmal"][bnd].max() < 0.5 * E["mininmal"][~bnd].mean()
    # "wind_sea" boundary shines with the local windsea inflow; compare
    # minima (maxima are dominated by interior inflow in both modes)
    ws = FR.get_initial_windsea(10.0, 10.0, 600.0)
    assert E["wind_sea"][bnd].min() > 0.8 * float(ws.E)
    assert E["wind_sea"][bnd].min() > 100 * E["mininmal"][bnd].min()


def test_boundary_type_pallas_advance_matches_xla():
    """The open-boundary inflow condition (boundary nodes never integrate,
    reseed from boundary_defaults) is the same with the Triton advance."""
    kw = dict(periodic=False, boundary_type="mininmal",
              dt_reset_mode="carry")
    m_x = _box_model(**kw)
    m_p = _box_model(advance_mode="pallas", pallas_interpret=True, **kw)
    s_x, s_p = m_x.init_state(), m_p.init_state()
    step_x, step_p = jax.jit(m_x.step), jax.jit(m_p.step)
    for _ in range(4):
        s_x = step_x(s_x)
        s_p = step_p(s_p)
    np.testing.assert_allclose(np.asarray(s_p.state), np.asarray(s_x.state),
                               rtol=2e-3, atol=1e-8)
    for k in ("n_gather", "n_reseed", "n_off"):
        assert int(getattr(s_p.metrics, k)) == int(getattr(s_x.metrics, k)), k


def test_boundary_type_validation():
    with pytest.raises(ValueError, match="boundary_type"):
        _box_model(boundary_type="bogus")
    from picles_tpu.models.wave_growth_1d import (WaveGrowth1D,
                                                  WaveGrowth1DConfig,
                                                  one_d_grid)
    from picles_tpu.forcing.winds import constant_winds_1d
    with pytest.raises(ValueError, match="boundary_type"):
        WaveGrowth1D(one_d_grid(0.0, 100e3, 11), constant_winds_1d(10.0),
                     _settings(),
                     config=WaveGrowth1DConfig(boundary_type="bogus"))


def test_auto_kernel_modes_resolve_per_backend(monkeypatch):
    """"auto" resolves LAZILY at step-build time against the then-current
    backend (not snapshotted at construction): a model built before device
    selection compiles the right advance, and ``model.config`` round-trips
    the user's "auto"."""
    import jax

    from picles_tpu.models.wave_growth_2d import _resolve_auto_modes

    m = _box_model()  # default config -> auto advance, dense deposit
    # config round-trips the user's choice verbatim
    assert m.config.advance_mode == "auto"
    assert m.config.scatter_mode == "dense"
    # resolution against the current (CPU) backend picks the XLA loop
    r = m.resolved_config()
    assert r.advance_mode == "xla" and r.scatter_mode == "dense"
    # ...and the resolved config actually steps (never sees "auto")
    ms = m.step(m.init_state())
    assert float(ms.time) > 0.0

    # construct-on-cpu / step-on-gpu: the SAME model re-resolves when the
    # default backend changes after construction
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    r_gpu = m.resolved_config()
    assert r_gpu.advance_mode == "pallas"
    assert r_gpu.scatter_mode == "dense"
    assert m.config.advance_mode == "auto"  # still round-trips

    # explicit choices always win, on any backend
    cfg = WaveGrowth2DConfig(advance_mode="xla", scatter_mode="dense")
    r = _resolve_auto_modes(cfg)
    assert r.advance_mode == "xla" and r.scatter_mode == "dense"


def test_rotated_cartesian_grid_diagonal_propagation():
    """Rotated box (reference T04 rotation/diagonal b.c. variants,
    CartesianGrid.jl:115-131): with grid rotation angle a, physically
    x-directed swell advances +i (with the grid) and -j (against the
    rotated j-axis) in the ratio -tan(a)*dx/dy — the TRUE rotation
    projection M = [[c/dx, s/dx], [-s/dy, c/dy]] applied inside the RHS
    (the reference's symmetric-sin matrix is a documented bug fix, see
    projection_kernel_cartesian)."""
    import dataclasses
    import math

    from picles_tpu.grids.cartesian import (cartesian_box,
                                            projection_kernel_cartesian)
    from picles_tpu.models.state import Particles2D
    from picles_tpu.ops.rhs import TermFlags

    # kernel-level: rows are grid axes dotted with physical velocity
    M = projection_kernel_cartesian(2000.0, 1000.0, 30.0)
    c, s = math.cos(math.radians(30.0)), math.sin(math.radians(30.0))
    np.testing.assert_allclose(M, [[c / 2000.0, s / 2000.0],
                                   [-s / 1000.0, c / 1000.0]])
    # a proper rotation/scaling: invertible at every angle (the reference
    # matrix is singular at 45 deg)
    M45 = projection_kernel_cartesian(1000.0, 1000.0, 45.0)
    assert abs(np.linalg.det(M45)) > 1e-10

    # model-level: propagation-only blob on a 45-deg grid
    DT = 600.0
    ws = FR.MinimalWindsea(1.0, 1.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 3600.0, dt=1.0,
                       dtmin=1e-2, force_dtmin=True)
    grid = cartesian_box(100e3, 32, 100e3, 32, angle=45.0,
                         periodic_boundary=(True, True))
    flags = TermFlags(input=False, dissipation=False, peak_shift=False,
                      direction=False)
    model = WaveGrowth2D(grid, constant_winds(0.0, 0.0), sett, flags=flags,
                         minimal_state=np.array([1e-12, 1e-20]),
                         config=WaveGrowth2DConfig(periodic_boundary=True,
                                                   halo=3))
    ms = model.init_state()
    on = np.zeros((32, 32), bool)
    on[8:12, 8:12] = True
    z = np.zeros((32, 32, 5), np.float32)
    z[..., 0] = math.log(0.1)
    z[..., 1] = 8.0          # physically x-directed swell
    ms = dataclasses.replace(ms, particles=Particles2D.from_z(
        jnp.asarray(z), ms.particles.t, ms.particles.dt, jnp.asarray(on)))
    step = jax.jit(model.step)
    com = []
    for _ in range(6):
        ms = step(ms)
        e = np.asarray(ms.state[..., 0])
        ii, jj = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
        com.append((float((ii * e).sum() / e.sum()),
                    float((jj * e).sum() / e.sum())))
    di = com[-1][0] - com[0][0]
    dj = com[-1][1] - com[0][1]
    # x-swell on a +45 deg grid: +i (toward the rotated i-axis) and -j
    assert di > 0.3 and dj < -0.3
    np.testing.assert_allclose(dj / di, -math.tan(math.radians(45.0)),
                               rtol=0.05)  # -tan(angle) * dx/dy = -1
    assert int(ms.metrics.n_failed) == 0


@pytest.mark.parametrize("dt_reset_mode", ["carry", "auto"])
def test_xla_remesh_reseed_and_off_branches(dt_reset_mode):
    """The XLA remesh's reseed and off branches, forced: with a node
    energy floor above any deposit no node can gather, so every node with
    usable wind reseeds to the local windsea and every node whose wind
    died switches off.  Winds blow everywhere for the first two remeshes,
    then only on the x < 50 km half."""
    from picles_tpu.forcing.winds import Winds2D

    DT = 600.0
    grid = cartesian_box(100e3, 21, 100e3, 11, periodic_boundary=(True, True))
    windy = np.asarray(grid.x) < 50e3

    def u(x, y, t):
        return jnp.where((jnp.asarray(x) < 50e3) | (jnp.asarray(t) < 2 * DT),
                         10.0, 0.0)

    def v(x, y, t):
        return jnp.zeros_like(jnp.asarray(x) * jnp.asarray(t))

    ws = FR.get_initial_windsea(10.0, 0.0, DT)
    model = WaveGrowth2D(grid, Winds2D(u=u, v=v), _settings(U=10.0, V=0.0),
                         minimal_state=(1e3 * float(ws.E), 0.0),
                         config=WaveGrowth2DConfig(
                             periodic_boundary=True,
                             dt_reset_mode=dt_reset_mode))
    ms = model.init_state()
    assert bool(np.all(np.asarray(ms.particles.on)))
    step = jax.jit(model.step)
    n = windy.size
    for k in range(4):
        ms = step(ms)
        M, P = ms.metrics, ms.particles
        assert int(M.n_gather) == 0
        on = np.asarray(P.on)
        if k < 2:          # remesh winds sampled at t = k DT < 2 DT
            assert int(M.n_reseed) == n and int(M.n_off) == 0
            assert on.all()
        else:
            assert int(M.n_reseed) == int(windy.sum())
            # off counts on -> off transitions: once, at the wind's death
            assert int(M.n_off) == (n - int(windy.sum()) if k == 2 else 0)
            assert np.array_equal(on, windy)
        # reseeded lanes hold the fresh windsea at their home node
        np.testing.assert_allclose(np.asarray(P.lne)[on], float(ws.lne),
                                   rtol=1e-6)
        assert not np.any(np.asarray(P.px)[on])
        assert not np.any(np.asarray(P.py)[on])
        dt = np.asarray(P.dt)[on]
        assert np.all((dt >= model.settings.dtmin) & (dt <= DT))
        assert np.all(np.isfinite(np.asarray(ms.state)))
