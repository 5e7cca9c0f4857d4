"""Layers: the reference's 4th State dimension (multiple wave partitions,
WaveGrowthModels2D.jl:112-119; tests/T06_layers.jl runs layers=10).  Each
layer is a full particle system vmapped over a leading axis; a layered run
stores [time, layer, x, y, state]."""

import os

import h5py
import numpy as np
import jax

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import (ParticleDefaults2D,
                                              WaveGrowth2D,
                                              WaveGrowth2DConfig)
from picles_tpu.simulation.simulation import Simulation


def _model(layers, n=12):
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, n, 100e3, n, periodic_boundary=(True, True))
    return WaveGrowth2D(grid, constant_winds(10.0, 5.0), sett,
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  layers=layers))


def _swell_defaults(L):
    """L distinct swell systems: energies and directions spread out."""
    out = []
    for k in range(L):
        ang = 2 * np.pi * k / L
        cg = 4.0 + 0.5 * k
        out.append(ParticleDefaults2D(lne=float(np.log(0.002 * (k + 1))),
                                      cg_x=float(cg * np.cos(ang)),
                                      cg_y=float(cg * np.sin(ang))))
    return out


def test_layers_differ_and_evolve_independently():
    """T06 analog: layers=10 with distinct per-layer seeding; every layer
    carries its own field and matches the equivalent single-layer run."""
    L = 10
    m = _model(L)
    defaults = _swell_defaults(L)
    lay = m.as_layered(defaults)
    ms = lay.init_state()
    assert ms.state.shape == (L, 12, 12, 3)

    step = jax.jit(lay.step)
    for _ in range(3):
        ms = step(ms)
    S = np.asarray(ms.state)
    assert np.all(np.isfinite(S))
    # layers actually differ (distinct seeds -> distinct evolution)
    for k in range(1, L):
        assert not np.allclose(S[0], S[k], rtol=1e-3)

    # layer k of the vmapped run == an unlayered model seeded the same way
    m1 = _model(1)
    ref = m1.init_state(defaults=defaults[3])
    step1 = jax.jit(m1.step)
    for _ in range(3):
        ref = step1(ref)
    np.testing.assert_allclose(S[3], np.asarray(ref.state), rtol=1e-5,
                               atol=1e-8)


def test_layered_simulation_stores_time_layer_x_y_state(tmp_path):
    """A layered run through the driver stores [time, layer, x, y, state]."""
    L = 4
    lay = _model(L).as_layered(_swell_defaults(L))
    sim = Simulation.create(lay, stop_time=1800.0)
    sim.initialize()
    sim.init_state_store(str(tmp_path))
    sim.run(store=True)
    sim.store.close()

    with h5py.File(os.path.join(str(tmp_path), "state.h5")) as f:
        d = f["waves/data"]
        assert d.shape == (5, L, 12, 12, 3)  # initial + 4 steps
        assert list(f["waves"].attrs["dims"]) == ["time", "layer", "x", "y",
                                                  "state"]
        data = d[:]
        assert np.all(np.isfinite(data))
        # stored layers differ too
        assert not np.allclose(data[-1, 0], data[-1, 1], rtol=1e-3)


def test_layered_storeless_run_o_state():
    """The storeless driver path works for layered models as well."""
    L = 3
    lay = _model(L).as_layered(_swell_defaults(L))
    sim = Simulation.create(lay, stop_time=1800.0)
    sim.run()
    assert sim.state.state.shape == (L, 12, 12, 3)
    assert float(sim.state.time) == 4 * 600.0


def test_layers_per_layer_winds():
    """Per-layer wind forcing (as_layered(per_layer_winds=...)): each swell
    system evolves under its own sampler; a layer forced like a plain model
    must reproduce that model exactly."""
    L = 3
    m = _model(L)
    winds = [constant_winds(10.0, 5.0), constant_winds(6.0, 0.0),
             constant_winds(0.0, 12.0)]
    lm = m.as_layered(per_layer_winds=winds)
    ms = lm.init_state()
    assert ms.state.shape == (L, 12, 12, 3)
    step = jax.jit(lm.step)
    for _ in range(3):
        ms = step(ms)
    # layers see different winds -> different fields
    e = np.asarray(ms.state[..., 0])
    assert not np.allclose(e[0], e[1])
    assert not np.allclose(e[1], e[2])
    # layer 0's forcing equals the base model's: exact same trajectory
    single = _model(1)
    ss = single.init_state()
    sstep = jax.jit(single.step)
    for _ in range(3):
        ss = sstep(ss)
    np.testing.assert_allclose(e[0], np.asarray(ss.state[..., 0]),
                               rtol=1e-6, atol=1e-9)


def test_layers_sharded_matches_single_device():
    """Layered x sharded composition: config.layers > 1 states shard over
    the mesh with the layer axis replicated (vmap inside the shard_map
    body); must reproduce the single-device step_layers run."""
    from picles_tpu.parallel.sharded import ShardedWaveGrowth2D, make_mesh

    L = 3
    m = _model(L, n=16)
    mesh = make_mesh(shape=(4, 2))
    sharded = ShardedWaveGrowth2D(m, mesh)
    assert sharded.layers == L

    ms0 = m.init_state_layers(_swell_defaults(L))
    ref = ms0
    step_ref = jax.jit(m.step_layers)
    msh = sharded.shard_state(ms0)
    for _ in range(2):
        ref = step_ref(ref)
        msh = sharded.step(msh)
    np.testing.assert_allclose(np.asarray(msh.state), np.asarray(ref.state),
                               rtol=2e-3, atol=1e-9)
    for k in ("n_active", "n_gather", "n_failed"):
        np.testing.assert_array_equal(np.asarray(getattr(msh.metrics, k)),
                                      np.asarray(getattr(ref.metrics, k)), k)


def test_layered_adapter_rejected_by_sharded_with_clear_error():
    """Passing the LayeredWaveGrowth2D adapter itself (per-layer winds are
    single-device closures) fails loudly, pointing at `.model`."""
    import pytest

    from picles_tpu.parallel.sharded import ShardedWaveGrowth2D, make_mesh

    lm = _model(2, n=16).as_layered()
    with pytest.raises(TypeError, match="pass its `.model`"):
        ShardedWaveGrowth2D(lm, make_mesh(shape=(4, 2)))


def test_with_winds_rejects_custom_rhs():
    """with_winds (per-layer winds) cannot rebuild a model whose RHS was
    overridden — the override closes over its own winds; fails loudly."""
    import pytest

    from picles_tpu.ops.rhs import particle_equations

    m0 = _model(2)
    custom = particle_equations(lambda x, y, t: 7.0, lambda x, y, t: 0.0)
    m = WaveGrowth2D(m0.grid, constant_winds(10.0, 5.0), m0.settings,
                     rhs=custom, config=m0.config)
    with pytest.raises(ValueError, match="custom `rhs`"):
        m.as_layered(per_layer_winds=[constant_winds(1.0, 0.0)] * 2)


def test_layers_pallas_kernels_vmap():
    """The layered step vmaps the advance's pallas_call: vmap lowers it
    with a prepended grid dimension — locked against the XLA layered step
    (interpret mode here; chip_smoke.py compiles the kernel on the GPU)."""
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, 16, 100e3, 16, periodic_boundary=(True, True))
    mk = lambda **c: WaveGrowth2D(  # noqa: E731
        grid, constant_winds(10.0, 5.0), sett,
        config=WaveGrowth2DConfig(periodic_boundary=True, layers=2,
                                  dt_reset_mode="carry", **c))
    mx = mk(advance_mode="xla")
    mp = mk(advance_mode="pallas", pallas_interpret=True)
    ms = mx.init_state_layers(_swell_defaults(2))
    sx = jax.jit(mx.step_layers)(ms)
    sp = jax.jit(mp.step_layers)(ms)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=5e-3, atol=1e-8)
    np.testing.assert_array_equal(np.asarray(sp.metrics.n_gather),
                                  np.asarray(sx.metrics.n_gather))
