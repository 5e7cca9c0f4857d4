"""Simulation driver + store tests (reference run!/storing semantics)."""

import os

import h5py
import numpy as np
import jax.numpy as jnp

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig
from picles_tpu.simulation.simulation import Simulation
from picles_tpu.simulation.store import CashStore, convert_store_to_tuple


def _sim(stop_time=3600.0, n=15):
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, n, 100e3, n, periodic_boundary=(True, True))
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett)
    return Simulation.create(model, stop_time=stop_time)


def test_run_step_count_matches_reference_loop():
    sim = _sim(stop_time=3600.0)  # 6 DTs -> reference runs 7 steps
    assert sim.n_steps() == 7
    sim.run(cash_store=True)
    # initial write + one per step
    assert len(sim.store.store) == 8
    assert float(sim.state.time) == 7 * 600.0


def test_cash_store_contents_grow():
    sim = _sim(stop_time=1800.0)
    sim.run(cash_store=True)
    arr = sim.store.as_array()
    e0, e_last = arr[0, ..., 0].mean(), arr[-1, ..., 0].mean()
    assert e_last > e0
    assert arr.shape[1:] == (15, 15, 3)


def test_hdf5_state_store_layout(tmp_path):
    """Store layout parity with the reference (storing.jl:36-62):
    waves/data[time, x, y, state], dims attr, var_names."""
    sim = _sim(stop_time=1800.0)
    sim.initialize()
    sim.init_state_store(str(tmp_path))
    sim.run(store=True)
    sim.store.close()

    with h5py.File(os.path.join(str(tmp_path), "state.h5")) as f:
        assert "waves" in f
        d = f["waves/data"]
        assert d.shape == (5, 15, 15, 3)  # initial + 4 steps
        assert list(f["waves"].attrs["dims"]) == ["time", "x", "y", "state"]
        assert [v.decode() for v in f["waves/var_names"][:]] == ["e", "m_x", "m_y"]
        assert f["waves/time"].shape == (5,)
        data = d[:]
        assert np.all(np.isfinite(data))
        assert data[1:, ..., 0].min() > 0  # post-step energies positive


def test_chunked_run_equals_unchunked(tmp_path):
    s1 = _sim(stop_time=2400.0)
    s1.run(cash_store=True)
    s2 = _sim(stop_time=2400.0)
    s2.initialize()
    s2.store = CashStore()
    s2.store.push(s2.state.state)
    remaining = s2.n_steps()
    done = 0
    while done < remaining:
        n = min(2, remaining - done)
        s2.state, states = s2.model.step_n(s2.state, n)
        s2.store.push_block = None  # force per-state path not needed; push each
        for i in range(n):
            s2.store.push(states[i])
        done += n
    a1, a2 = s1.store.as_array(), s2.store.as_array()
    np.testing.assert_allclose(a1, a2, rtol=1e-6)


def test_reset_simulation():
    sim = _sim(stop_time=1200.0)
    sim.run(cash_store=True)
    t_after = float(sim.state.time)
    sim.reset()
    assert float(sim.state.time) == 0.0
    assert t_after > 0.0


def test_convert_store_to_tuple():
    sim = _sim(stop_time=1200.0)
    sim.run(cash_store=True)
    out = convert_store_to_tuple(sim.store)
    assert out["data"].shape[0] == len(sim.store.store)


def test_storeless_run_matches_stored_and_stays_o_state():
    """The storeless path (step_n_quiet fori_loop) must reach the same final
    state as the scan-with-outputs path while never materializing the
    [n, nx, ny, 3] history (a 6-day 1536^2 run through step_n
    would stack ~24 GB of unread states)."""
    import jax

    s1 = _sim(stop_time=2400.0)
    s1.run()  # storeless
    s2 = _sim(stop_time=2400.0)
    s2.run(cash_store=True)
    np.testing.assert_allclose(np.asarray(s1.state.state),
                               np.asarray(s2.state.state), rtol=1e-6)
    assert float(s1.state.time) == float(s2.state.time)

    # memory claim: the jaxpr of step_n_quiet has no stacked [n, ...] output
    m = s1.model
    ms = m.init_state()
    jaxpr = jax.make_jaxpr(lambda s, n: m.step_n_quiet(s, n))(ms, 5)
    nx = ms.state.shape[0]
    for v in jaxpr.jaxpr.outvars:
        shape = getattr(v.aval, "shape", ())
        assert len(shape) < 4 or shape[0] == nx, shape


def test_storeless_wall_time_limit_enforced():
    """wall_time_limit must stop the storeless path too (it was
    only checked on the store loop)."""
    sim = _sim(stop_time=600.0 * 400)  # 401 steps — plenty to outlast 0 s
    sim.wall_time_limit = 0.0          # first chunk exceeds immediately
    sim.run(chunk_size=2)
    assert int(sim.state.iteration) == 2  # stopped after one chunk
    assert float(sim.state.time) == 2 * 600.0


def test_storeless_run_dynamic_chunks_single_compile():
    """step_n_quiet takes the trip count as a traced scalar: chunks of any
    length reuse one executable."""
    sim = _sim(stop_time=3000.0)
    m = sim.model
    ms = m.init_state()
    size0 = m.step_n_quiet._cache_size()  # self is static: cache is shared
    a = m.step_n_quiet(ms, 2)
    b = m.step_n_quiet(a, 3)
    full = m.step_n_quiet(m.init_state(), 5)
    np.testing.assert_allclose(np.asarray(b.state), np.asarray(full.state),
                               rtol=1e-6)
    assert m.step_n_quiet._cache_size() == size0 + 1


def test_wall_time_limit_halts_stored_run_early():
    """A finite wall_time_limit must be enforced on the STORE path too: the
    default chunking may not be one all-remaining dispatch (reference checks
    wall time every step, run.jl:117-121).  With an already-expired limit,
    only the first chunk runs and the store holds partial output."""
    sim = _sim(stop_time=24 * 3600.0)       # 145 steps if run to completion
    sim.wall_time_limit = 1e-9              # expires during the first chunk
    sim.run(cash_store=True)
    n_stored = len(sim.store.store)
    assert sim.n_steps() == 145
    # initial write + one default chunk (64) at most — NOT the full 146
    assert 2 <= n_stored <= 65
    # the partial output is real state
    arr = sim.store.as_array()
    assert np.all(np.isfinite(arr))
    assert int(sim.state.iteration) == n_stored - 1


def test_stored_run_default_is_bounded_chunks():
    """store=True must NEVER dispatch one all-remaining step_n scan: the
    stacked scan output lives on device as [n, nx, ny, 3], so an unbounded
    n is O(n_steps * state) of device memory (a 865-step 1536^2 endurance
    run would stack ~24 GB of history).  Default chunking bounds every
    dispatch at 64 steps (reference stores once per step and never stacks,
    run.jl:94-112)."""
    sim = _sim(stop_time=24 * 3600.0)   # 145 steps — production-shaped horizon
    dispatched, capacities = [], []
    inner = sim.model.step_n_buffered

    def spy(state, n, capacity):
        dispatched.append(n)
        capacities.append(capacity)
        return inner(state, n, capacity)

    sim.model.step_n_buffered = spy
    sim.run(cash_store=True)
    assert dispatched, "store path did not go through step_n_buffered"
    assert max(dispatched) <= 64, dispatched
    assert sum(dispatched) == 145
    # one static buffer capacity across full AND ragged chunks -> the
    # ragged tail reuses the same compiled executable
    assert set(capacities) == {64}, capacities
    # store holds initial write + every step, same as per-step storing
    assert len(sim.store.store) == 146
    assert int(sim.state.iteration) == 145


def test_callbacks_run_per_chunk_and_nan_checker_halts():
    """Simulation.callbacks are LIVE (the reference declares diagnostics/
    callbacks OrderedDicts but never invokes them, simulation.jl:63-75):
    called after every chunk, and a raising callback (the NaNChecker the
    reference left commented out) stops the run."""
    import jax.numpy as jnp
    import pytest

    from picles_tpu.utils.diagnostics import check_nans

    sim = _sim(stop_time=3600.0)   # 7 steps
    calls = []
    sim.callbacks["count"] = lambda s: calls.append(float(s.state.time))
    sim.run(chunk_size=2)
    assert len(calls) == 4         # ceil(7 / 2) chunks
    assert calls == sorted(calls)  # monotone clock at each invocation

    # storeless default chunking must still fire callbacks (no infinite
    # single dispatch when callbacks are attached)
    sim2 = _sim(stop_time=3600.0)
    n2 = []
    sim2.callbacks["count"] = lambda s: n2.append(1)
    sim2.run()
    assert len(n2) >= 1

    # NaNChecker: poison the state mid-run via a callback that injects a
    # NaN, then assert the checker raises on the next chunk
    import dataclasses as dc

    sim3 = _sim(stop_time=3600.0)

    def poison_then_check(s):
        s.state = dc.replace(s.state,
                             state=s.state.state.at[0, 0, 0].set(jnp.nan))
        check_nans(s.state)

    sim3.callbacks["nan_check"] = poison_then_check
    with pytest.raises(FloatingPointError):
        sim3.run(chunk_size=2)


def test_store_rows_time_aligned_after_pickup(tmp_path):
    """A resumed run writes its history at the time-correct store rows:
    the resumed state (iteration k) lands at row k, not at row 0 with
    every later row shifted by k*dt (code-review r5 finding)."""
    # uninterrupted reference history: 6 DTs -> 7 steps + initial = 8 rows
    ref = _sim(stop_time=3600.0)
    ref.initialize()
    ref.init_state_store(str(tmp_path / "ref"))
    ref.run(store=True)
    ref.store.close()
    with h5py.File(os.path.join(str(tmp_path), "ref", "state.h5")) as f:
        full = f["waves/data"][:]

    # leg 1: store sized for the FULL horizon, stop after 2 DTs, checkpoint
    leg1 = _sim(stop_time=3600.0)
    leg1.initialize()
    leg1.init_state_store(str(tmp_path / "resumed"))
    leg1.stop_time = 1200.0
    leg1.run(store=True)
    k = int(leg1.state.iteration)
    ckpt = leg1.checkpoint(str(tmp_path / "ck.npz"))
    leg1.store.close()

    # leg 2: pickup, re-attach the SAME file append-mode, finish horizon
    leg2 = _sim(stop_time=3600.0)
    leg2.pickup(ckpt)
    leg2.init_state_store(str(tmp_path / "resumed"), replace=False)
    leg2.run(store=True)
    leg2.store.close()

    with h5py.File(os.path.join(str(tmp_path), "resumed", "state.h5")) as f:
        resumed = f["waves/data"][:]
    # bit-exact checkpoint + deterministic steps -> identical history,
    # row-for-row (leg 2 rewrote row k with the identical boundary state)
    assert resumed.shape == full.shape
    np.testing.assert_array_equal(resumed, full)
    assert k < full.shape[0] - 1        # the resume really was mid-horizon


def test_run_twice_continuation_overwrites_boundary_row(tmp_path):
    """run() -> raise stop_time -> run() again continues the SAME store
    without duplicating the boundary frame one row later."""
    ref = _sim(stop_time=3000.0)
    ref.run(cash_store=True)
    full = ref.store.as_array()

    sim = _sim(stop_time=3000.0)
    sim.initialize()
    # store sized for the final horizon; first leg stops early
    sim.init_state_store(str(tmp_path))
    sim.stop_time = 1200.0
    sim.run(store=True)
    sim.stop_time = 3000.0
    sim.run(store=True)
    sim.store.close()
    with h5py.File(os.path.join(str(tmp_path), "state.h5")) as f:
        got = f["waves/data"][:]
    assert got.shape == full.shape
    np.testing.assert_allclose(got, full, rtol=0, atol=0)


def test_reset_clears_cash_store():
    """reset() must clear a CashStore too, or the next run's history is
    appended after the previous one's snapshots."""
    sim = _sim(stop_time=1200.0)
    sim.run(cash_store=True)
    n_rows = len(sim.store.store)
    sim.reset()
    sim.run(store=False, cash_store=False)
    # the old cash store must not have grown during the second run
    assert isinstance(sim.store, CashStore)
    assert len(sim.store.store) == 0 or len(sim.store.store) == n_rows
    sim2 = _sim(stop_time=1200.0)
    sim2.run(cash_store=True)
    sim2.reset()
    sim2.run(cash_store=True)
    assert len(sim2.store.store) == n_rows  # fresh history, not appended


def test_step_n_buffered_single_compile_across_ragged_lengths():
    """The buffered dispatcher compiles ONCE per (capacity, shapes): a
    ragged final chunk (n < capacity) must not trigger a second full-scan
    XLA compile (code-review r5 efficiency finding)."""
    import jax

    sim = _sim(stop_time=1800.0, n=8)
    sim.initialize()
    m = sim.model
    f = type(m).step_n_buffered
    before = f._cache_size()
    s1, b1 = m.step_n_buffered(sim.state, 4, 4)
    s2, b2 = m.step_n_buffered(s1, 2, 4)          # ragged: same executable
    assert f._cache_size() == before + 1
    # ragged call fills exactly n rows; the rest stay zero
    assert np.all(np.asarray(b2[:2, ..., 0]) > 0)
    assert np.all(np.asarray(b2[2:]) == 0.0)
    # and matches the scan-based step_n history
    sim2 = _sim(stop_time=1800.0, n=8)
    sim2.initialize()
    _, ref = sim2.model.step_n(sim2.state, 6)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(b1), np.asarray(b2[:2])]),
        np.asarray(ref))
