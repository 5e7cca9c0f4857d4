"""Multi-GPU weak-scaling benchmark of the sharded step.

Measures the sharded step's throughput (particle-pushes/s and
grid-points*steps/s) at increasing device counts with a FIXED per-device
tile, reporting scaling efficiency vs the single-device rate — the
BASELINE.md north-star metric (>=80% 1 -> 2 hosts).  By default it uses
every GPU of the host; ``--cpu=N`` runs it on an N-device virtual CPU mesh
(correctness and wiring only: those times are not device numbers).

Run:  python benchmark/bench_sharded.py [--tile=768] [--cpu=8]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    tile = 768
    cpu = 0
    for a in sys.argv[1:]:
        if a.startswith("--tile="):
            tile = int(a.split("=", 1)[1])
        if a.startswith("--cpu="):
            cpu = int(a.split("=", 1)[1])
    if cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={cpu}").strip()

    import jax

    from bench import build
    from picles_tpu.utils.compile_cache import enable_compile_cache

    if not cpu and jax.default_backend() != "gpu":
        raise SystemExit("no GPU found; pass --cpu=N for a virtual mesh")
    enable_compile_cache()
    from picles_tpu.parallel.sharded import ShardedWaveGrowth2D, make_mesh

    devices = jax.devices()
    n_dev = len(devices)
    # device-count ladder: 1, 2, 4, ... n (powers of two that divide n)
    ladder = [d for d in (1, 2, 4, 8, 16, 32, 64, 128, 256)
              if d <= n_dev and n_dev % d == 0]

    def mesh_shape(d):
        px = int(d ** 0.5)
        while d % px:
            px -= 1
        return (d // px, px)

    rows = []
    base_rate = None
    for d in ladder:
        sx, sy = mesh_shape(d)
        nx, ny = tile * sx, tile * sy
        model = build(nx, ny)
        mesh = make_mesh(devices=devices[:d], shape=(sx, sy))
        sharded = ShardedWaveGrowth2D(model, mesh)
        ms = sharded.init_state()

        run = jax.jit(lambda c, n: jax.lax.fori_loop(
            0, n, lambda _, s: sharded._step(s), c))
        ms = run(ms, 2)
        jax.block_until_ready(ms.state)
        n_small, n_big = (2, 8) if cpu else (10, 50)
        for n in (n_small, n_big):
            jax.block_until_ready(run(ms, n).state)

        def timed(n):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(run(ms, n).state)
                best = min(best, time.perf_counter() - t0)
            return best

        s_step = (timed(n_big) - timed(n_small)) / (n_big - n_small)
        rate = nx * ny / s_step
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d)
        rows.append(dict(devices=d, mesh=[sx, sy], nx=nx, ny=ny,
                         ms_per_step=s_step * 1e3,
                         pushes_per_s=rate,
                         scaling_efficiency=eff))
        print(json.dumps(rows[-1]))
        print(f"  {d} dev ({sx}x{sy}): {s_step*1e3:.3f} ms/step, "
              f"{rate:.3e} pushes/s, eff {eff*100:.0f}%", file=sys.stderr)


if __name__ == "__main__":
    main()
