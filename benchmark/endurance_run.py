"""Production-horizon endurance run on the GPU.

Drives the flagship 1536^2 configuration through the REAL driver
(``Simulation.run``, storeless O(state) fori_loop path with wall-time
chunking) for a 6-day horizon (864 DT steps), with a mid-run checkpoint,
then restarts a fresh Simulation from the checkpoint and verifies the
resumed trajectory reaches the same end state bit-for-bit.  Records wall
time, steps/s, device memory stats, the StepMetrics counters, and the
resume check into one JSON blob (``out.json`` — the evidence that the
flagship config completes a production horizon under the production
driver, not just a bench loop).

``--store`` additionally re-runs the same horizon with a full HDF5
StateStore attached (``run(store=True)``, default 64-step chunking):
every step's field is written to disk exactly like
the reference's per-step store (run.jl:94-112) while peak device memory
stays O(chunk * state); the record gains the stored-run wall time, the
on-disk size, and a bitwise check of the final stored frame against the
storeless trajectory.

Run:  python benchmark/endurance_run.py [N] [--days=D] [--store] [--global]
      [--cpu] [out.json]   (--cpu: a functional run on the CPU, whose
      times are not device numbers)
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

from bench import build


def device_memory_stats():
    try:
        st = jax.local_devices()[0].memory_stats() or {}
        return {k: int(v) for k, v in st.items()
                if "bytes" in k and isinstance(v, (int, float))}
    except Exception:
        return {}


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    nx, out_path = 1536, None
    for a in args:
        if a.isdigit():
            nx = int(a)
        else:
            out_path = a
    days = 6.0
    for a in sys.argv[1:]:
        if a.startswith("--days="):
            days = float(a.split("=", 1)[1])

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        raise SystemExit("no GPU found; pass --cpu for a functional run")

    from picles_tpu.simulation.simulation import Simulation
    from picles_tpu.utils.compile_cache import enable_compile_cache
    from picles_tpu.utils.diagnostics import step_summary

    enable_compile_cache()

    if "--global" in sys.argv:
        # ~1 deg global tripolar config (land + pole masks + seam + zonal
        # jet — the reference's actual production use case, T03 analog)
        from tripolar_global_demo import build_model as build_global

        def build_model():
            return build_global(hours=days * 24.0)
    else:
        def build_model():
            return build(nx, nx)

    model = build_model()
    horizon = days * 24 * 3600.0
    half = horizon / 2.0
    ckdir = tempfile.mkdtemp(prefix="picles_endurance_")

    # ---- leg 1: 0 -> T/2, checkpoint ------------------------------------
    sim = Simulation.create(model, stop_time=half,
                            wall_time_limit=20 * 60.0)
    t0 = time.perf_counter()
    sim.run()
    jax.block_until_ready(sim.state.state)
    t_leg1 = time.perf_counter() - t0
    steps_leg1 = int(sim.state.iteration)
    ck = sim.checkpoint(os.path.join(ckdir, "half"))

    # ---- continue uninterrupted to T ------------------------------------
    sim.stop_time = horizon
    t0 = time.perf_counter()
    sim.run()
    jax.block_until_ready(sim.state.state)
    t_leg2 = time.perf_counter() - t0
    final_a = np.asarray(sim.state.state)
    summary = step_summary(sim.state)
    mem = device_memory_stats()

    # ---- resume leg: fresh Simulation from the checkpoint ---------------
    model2 = build_model()
    sim2 = Simulation.create(model2, stop_time=horizon,
                             wall_time_limit=20 * 60.0)
    sim2.pickup(ck)
    assert int(sim2.state.iteration) == steps_leg1
    t0 = time.perf_counter()
    sim2.run()
    jax.block_until_ready(sim2.state.state)
    t_resume = time.perf_counter() - t0
    final_b = np.asarray(sim2.state.state)
    bit_exact = bool(np.array_equal(final_a, final_b))

    n_steps = int(sim.state.iteration)
    wall = t_leg1 + t_leg2
    g = model.grid
    n_nodes = g.stats.nx * g.stats.ny
    DT_used = float(model.settings.timestep)
    rec = dict(
        grid=f"{g.stats.nx}x{g.stats.ny}-{g.stats.kind}",
        days=days, n_steps=n_steps,
        wall_s_total=round(wall, 3),
        wall_s_leg1=round(t_leg1, 3),
        wall_s_leg2=round(t_leg2, 3),
        wall_s_resume_leg=round(t_resume, 3),
        steps_per_s=round(n_steps / wall, 2),
        pushes_per_s=round(n_steps * n_nodes / wall, 1),
        sim_seconds_per_wall_second=round(n_steps * DT_used / wall, 1),
        checkpoint_at_step=steps_leg1,
        resume_bit_exact=bit_exact,
        final_counters={k: (float(v) if isinstance(v, float) else int(v))
                        for k, v in summary.items()},
        device_memory=mem,
        finite=bool(np.all(np.isfinite(final_a))),
    )
    if "--global" in sys.argv:
        mask = np.asarray(g.mask)
        rec["land_energy"] = float(np.abs(final_a[mask == 0, 0]).sum())
        assert rec["land_energy"] == 0.0, "energy deposited on land"
    assert bit_exact, "checkpoint resume is not bit-exact!"
    assert rec["finite"]

    if "--store" in sys.argv:
        # ---- stored-run leg: same horizon with a FULL HDF5 StateStore --
        # (default 64-step chunking bounds device memory at O(64 * state);
        # an unchunked dispatch would stack the whole [n_steps, nx, ny, 3]
        # history on device — the r4 hazard this leg proves fixed)
        store_dir = tempfile.mkdtemp(prefix="picles_endurance_store_")
        model3 = build_model()
        sim3 = Simulation.create(model3, stop_time=horizon)
        sim3.initialize()
        sim3.init_state_store(store_dir)
        t0 = time.perf_counter()
        sim3.run(store=True)
        jax.block_until_ready(sim3.state.state)
        t_store = time.perf_counter() - t0
        last_idx = int(sim3.state.iteration)   # frame 0 is the seed state
        sim3.store.close()
        import h5py
        with h5py.File(os.path.join(store_dir, "state.h5")) as f:
            d = f["waves/data"]
            n_frames = d.shape[0]
            last_frame = d[last_idx]
            disk_bytes = os.path.getsize(os.path.join(store_dir, "state.h5"))
        # deterministic twin: the stored trajectory's final frame must be
        # bitwise the storeless run's end state (modulo the store's f8 cast)
        stored_matches = bool(
            np.array_equal(last_frame.astype(np.float32), final_a))
        rec.update(
            store_wall_s=round(t_store, 3),
            store_n_frames=n_frames,
            store_frames_written=last_idx + 1,
            store_disk_gb=round(disk_bytes / 1e9, 2),
            store_steps_per_s=round(int(sim3.state.iteration) / t_store, 2),
            store_final_frame_bitwise=stored_matches,
            store_device_memory=device_memory_stats(),
        )
        assert stored_matches, "stored final frame != storeless end state"
        import shutil
        shutil.rmtree(store_dir, ignore_errors=True)
    line = json.dumps(rec)
    print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
