"""Multi-PROCESS run: 2 real OS processes, one global device mesh.

The reference ships an experimental multi-process driver
(`examples/exmpl_homogenous_box_mprocess.jl`: `Distributed.addprocs` +
`pmap(advance_wrap, workers, ParticleCollection)` with a SharedArray
State).  This build's equivalent is multi-process JAX: every process
owns a slice of the devices, `jax.distributed.initialize` joins them into
one runtime, the grid block-shards over the GLOBAL mesh, and the step's
halo exchange rides cross-process collectives (gloo here, NCCL between
GPU hosts).  The workers and the cross-check stay pinned to the CPU, so
no process of this example opens a GPU.  No SharedArray: each process
only ever touches its addressable shards.

This script is self-launching: run it with no arguments and it spawns
2 worker copies of itself (4 virtual CPU devices each -> a global
4x2 mesh), waits for both, then reassembles the workers' shard dumps
into the global field and compares it against a single-process run of
the identical model — the same cross-check as the reference's
mprocess example printing `mean energy after advance` per phase.

Run:  python examples/example_05_multiprocess.py
"""

import os as _os
import subprocess as _sp
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

SMOKE = _os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_examples.py
N_STEPS = 3 if SMOKE else 12
NX = NY = 32
DT, U10, V10 = 600.0, 10.0, 5.0


def _build_model():
    import picles_tpu as pt

    ws = pt.FetchRelations.MinimalWindsea(U10, V10, DT)
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=6 * 3600.0, dt=1e-3,
                          dtmin=1e-4, force_dtmin=True)
    grid = pt.cartesian_box(2e3 * (NX - 1), NX, 2e3 * (NY - 1), NY,
                            periodic_boundary=(True, True))
    return pt.WaveGrowth2D(grid, pt.constant_winds(U10, V10), sett,
                           config=pt.WaveGrowth2DConfig(
                               periodic_boundary=True))


def _worker(role: int, port: str, out_path: str) -> None:
    """One of 2 processes: 4 local devices, global 8-device 4x2 mesh."""
    # platform + device count must land before the first jax import
    _os.environ["JAX_PLATFORMS"] = "cpu"
    _os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=role)
    assert jax.process_count() == 2 and len(jax.devices()) == 8

    import numpy as np

    from picles_tpu.parallel.sharded import ShardedWaveGrowth2D, make_mesh

    model = _build_model()
    sharded = ShardedWaveGrowth2D(model, make_mesh(shape=(4, 2)))
    ms = sharded.init_state()      # multi-process make_array_from_callback
    for _ in range(N_STEPS):
        ms = sharded.step(ms)      # ppermute halo rings cross processes
    jax.block_until_ready(ms.state)

    # dump this process's ADDRESSABLE shards with their global offsets
    dump = {"n_shards": np.array(len(ms.state.addressable_shards)),
            "n_active": np.array(int(ms.metrics.n_active)),   # psum'd
            "mean_e_local": np.array(np.mean([
                np.asarray(s.data)[..., 0].mean()
                for s in ms.state.addressable_shards]))}
    for i, s in enumerate(ms.state.addressable_shards):
        dump[f"data_{i}"] = np.asarray(s.data)
        dump[f"x0_{i}"] = np.array([s.index[0].start or 0,
                                    s.index[1].start or 0])
    np.savez(out_path, **dump)
    print(f"[worker {role}] {len(ms.state.addressable_shards)} local shards, "
          f"global n_active={dump['n_active']}", flush=True)


def _launch():
    """Parent: spawn 2 workers, reassemble the global field, cross-check."""
    import socket
    import tempfile

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    tmp = tempfile.mkdtemp(prefix="picles_mp_")
    outs = [_os.path.join(tmp, f"w{i}.npz") for i in range(2)]

    env = dict(_os.environ)
    env.pop("XLA_FLAGS", None)     # workers pin their own device count
    env["PICLES_MP_PORT"] = port
    procs = []
    for role in (0, 1):
        e = dict(env, PICLES_MP_ROLE=str(role), PICLES_MP_OUT=outs[role])
        procs.append(_sp.Popen([_sys.executable, _os.path.abspath(__file__)],
                               env=e, stdout=_sp.PIPE, stderr=_sp.PIPE,
                               text=True))
    for role, p in enumerate(procs):
        so, se = p.communicate(timeout=600)
        print(so, end="")
        if p.returncode != 0:
            raise RuntimeError(f"worker {role} failed:\n{se[-4000:]}")

    # reassemble the global [NX, NY, 3] field from both processes' shards
    field = np.full((NX, NY, 3), np.nan, np.float32)
    n_active = None
    for path in outs:
        z = np.load(path)
        for i in range(int(z["n_shards"])):
            d, (x0, y0) = z[f"data_{i}"], z[f"x0_{i}"]
            field[x0:x0 + d.shape[0], y0:y0 + d.shape[1]] = d
        n_active = int(z["n_active"])
    assert np.isfinite(field).all(), "shards did not tile the global grid"

    # single-process cross-check (dense step, same model, same horizon)
    _os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    model = _build_model()
    dense = model.init_state()
    step = jax.jit(model.step)
    for _ in range(N_STEPS):
        dense = step(dense)
    ref = np.asarray(dense.state)
    # sharded-vs-dense agrees at solver level (adaptive-dt accumulation
    # order differs across blockings; the ulp-level locks live in
    # tests/test_sharded.py and tests/test_multiprocess.py)
    rel = np.abs(field - ref).max() / max(np.abs(ref).max(), 1e-30)
    print(f"2 processes x 4 devices, {N_STEPS} steps on {NX}x{NY}: "
          f"mean E = {field[..., 0].mean():.4e}, n_active = {n_active}, "
          f"max rel diff vs single-process = {rel:.2e}")
    assert rel < 5e-3, rel
    return field, ref, n_active


if _os.environ.get("PICLES_MP_ROLE") is not None:
    _worker(int(_os.environ["PICLES_MP_ROLE"]),
            _os.environ["PICLES_MP_PORT"], _os.environ["PICLES_MP_OUT"])
else:
    field, ref, n_active = _launch()
