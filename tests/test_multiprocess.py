"""TRUE multi-process execution of the sharded model.

Spawns 2 real OS processes (tests/_multiproc_worker.py), each owning 4
CPU devices, joined by ``jax.distributed.initialize`` into one 8-device
global mesh.  The workers build the 4x2 mesh from global ``jax.devices()``,
place state through the ``make_array_from_callback`` branch of
``ShardedWaveGrowth2D.shard_state`` (the ``jax.process_count() > 1`` path,
parallel/sharded.py), and step 3 times with cross-process ppermute/psum
collectives (gloo).  The parent reassembles the workers' addressable
shards into the global field and compares against the SAME model stepped
single-process — both the in-process 8-device sharded twin and the dense
unsharded step.

This is the multi-process analog of the reference's experimental
Distributed/DArray block partition (TimeSteppers.jl:144-180,
tests/T05_2D_distributed_particles.jl) actually executing as separate
processes, not emulated in-process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_multiproc_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reassemble(paths, nx, ny):
    """Rebuild the global [nx, ny, 3] field from both workers' shard dumps."""
    out = np.full((nx, ny, 3), np.nan, np.float32)
    meta = {}
    for p in paths:
        z = np.load(p)
        for i in range(int(z["n_shards"])):
            d = z[f"data_{i}"]
            x0, y0 = z[f"x0_{i}"]
            out[x0:x0 + d.shape[0], y0:y0 + d.shape[1]] = d
        meta["n_active"] = int(z["n_active"])
        meta["time"] = float(z["time"])
    assert np.isfinite(out).all(), "shard dumps did not tile the global grid"
    return out, meta


def test_two_process_sharded_step_matches_single_process(tmp_path):
    # (worker hangs are bounded by the communicate(timeout=420) below)
    port = _free_port()
    outs = [str(tmp_path / f"w{i}.npz") for i in range(2)]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # workers set their own device count
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), str(port), outs[i]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    results = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, results):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se[-4000:]}"
    got, meta = _reassemble(outs, 32, 32)

    # single-process twin on this process's 8 virtual devices (conftest)
    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.forcing.winds import constant_winds
    from picles_tpu.grids.cartesian import cartesian_box
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)
    from picles_tpu.parallel.sharded import ShardedWaveGrowth2D, make_mesh

    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, 32, 100e3, 32, periodic_boundary=(True, True))
    model = WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett,
                         config=WaveGrowth2DConfig(periodic_boundary=True))

    sharded = ShardedWaveGrowth2D(model, make_mesh(shape=(4, 2)))
    ms = sharded.init_state()
    for _ in range(3):
        ms = sharded.step(ms)
    want = np.asarray(ms.state)

    # identical computation graph, identical shardings: bit-level agreement
    # is expected; allow f32-ulp slack for gloo reduction ordering
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    assert meta["n_active"] == int(ms.metrics.n_active)
    assert meta["time"] == float(ms.time)

    # and the dense unsharded step agrees at solver level (sharded-vs-
    # dense differs through adaptive-dt accumulation order; the TIGHT
    # locks live in test_sharded.py: ulp-exact collective isolation
    # :172-219 and f64 fixed-substep twins :332-383)
    dense = model.init_state()
    import jax

    step = jax.jit(model.step)
    for _ in range(3):
        dense = step(dense)
    np.testing.assert_allclose(got, np.asarray(dense.state), rtol=1e-3)
