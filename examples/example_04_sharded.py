"""Multi-device (sharded) run — this build's answer to the reference's
`Distributed.pmap` experiment (exmpl_homogenous_box_mprocess.jl,
tests/T05_2D_distributed_particles.jl): the grid block-shards over a 2D
device mesh, the CIC deposit's halo slabs ride `ppermute` rings between
neighbor shards, and the whole thing drives through the same `Simulation`
as a single-chip run.

Runs on whatever devices JAX exposes (the GPUs of a host in
production).  Set
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
for a virtual 8-device CPU mesh on any machine.

Run:  python examples/example_04_sharded.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

SMOKE = _os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_examples.py
if SMOKE and "JAX_PLATFORMS" not in _os.environ:
    _os.environ["JAX_PLATFORMS"] = "cpu"
    _os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "")
                                + " --xla_force_host_platform_device_count=8")

import jax
import numpy as np

import picles_tpu as pt
from picles_tpu.parallel.sharded import ShardedWaveGrowth2D, make_mesh

if SMOKE:
    jax.config.update("jax_platforms", "cpu")

devices = jax.devices()
n_dev = len(devices)
# 2D mesh factorization so both axes carry collectives when possible
px = int(n_dev ** 0.5)
while n_dev % px:
    px -= 1
mesh = make_mesh(shape=(n_dev // px, px))
print(f"mesh: {dict(mesh.shape)} over {n_dev} {devices[0].platform} device(s)")

U10, V10, DT = 10.0, 5.0, 600.0
sx, sy = mesh.shape["x"], mesh.shape["y"]
nx, ny = 16 * sx, 16 * sy          # 16x16 tile per device
grid = pt.cartesian_box(2e3 * (nx - 1), nx, 2e3 * (ny - 1), ny,
                        periodic_boundary=(True, True))
ws = pt.FetchRelations.MinimalWindsea(U10, V10, DT)
sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                      timestep=DT, total_time=6 * 3600.0, dt=1e-3,
                      dtmin=1e-4, force_dtmin=True)
model = pt.WaveGrowth2D(grid, pt.constant_winds(U10, V10), sett,
                        config=pt.WaveGrowth2DConfig(periodic_boundary=True))
sharded = ShardedWaveGrowth2D(model, mesh)

# the regular driver runs the sharded model unchanged
sim = pt.Simulation.create(sharded, stop_time=(3 if SMOKE else 6) * DT)
sim.run(cash_store=True)
states = sim.store.as_array()

sharding = sim.state.state.sharding
print(f"state {states.shape[1:]} sharded as {sharding.spec}; "
      f"{len(sharding.device_set)} devices")
print(f"ran {len(states) - 1} steps; final mean E = "
      f"{states[-1, ..., 0].mean():.4e}; "
      f"failures: {int(sim.state.metrics.n_failed)}")
assert np.all(np.isfinite(states))
