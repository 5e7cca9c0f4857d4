"""Perf dossier: size sweep x solver x backend with roofline accounting.

For each config this measures the per-step wall time (scan-length
difference, fixed sync overhead cancels) and pulls XLA's compile-time cost
analysis of the single-step executable (bytes accessed, flops) to place the
step on the device-memory roofline of the card.  Emits one JSON line per
config plus a human table on stderr.  Needs a GPU whose ``device_kind`` is
in ``PEAK_HBM_GBPS``; anything else is an error, not a default.

Run:  python benchmark/perf_dossier.py [--fast]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from bench import build
from picles_tpu.utils.compile_cache import enable_compile_cache

# Published device-memory bandwidth by jax ``device_kind`` (NVIDIA H100
# data sheet, SXM part: 80 GB HBM3 at 3.35 TB/s).  The step is all
# elementwise f32 work with no matrix products, so utilization is reported
# against memory bandwidth, the binding resource.
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_hbm_gbps() -> float:
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_HBM_GBPS:
        raise SystemExit(f"no peak bandwidth known for device {kind!r}; "
                         "add it to PEAK_HBM_GBPS with its source")
    return PEAK_HBM_GBPS[kind]


def measure(nx, ny, *, solver="bosh3", advance_mode="auto",
            dt_reset_mode="carry", scatter_mode="dense", reps=3):
    model = build(nx, ny, advance_mode=advance_mode,
                  dt_reset_mode=dt_reset_mode, solver=solver,
                  scatter_mode=scatter_mode)
    ms = model.init_state()

    def run_n(c, n):
        return jax.lax.fori_loop(0, n, lambda _, s: model.step(s), c)

    run_jit = jax.jit(run_n)
    ms = run_jit(ms, 4)
    _ = float(ms.state[0, 0, 0])

    def timed(n):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _ = float(run_jit(ms, n).state[0, 0, 0])
            best = min(best, time.perf_counter() - t0)
        return best

    # Calibrated timing window: the scan-length DIFFERENCE must dominate
    # host<->device sync jitter at every size — a fixed 30-step window
    # leaves small differences inside the noise.  Rough-calibrate
    # the per-step time from two cheap runs, then size the big window so
    # t_big - t_small >= ~150 ms.  The trip count is a traced scalar: one
    # executable serves every length.
    n_small = 10
    for n in (n_small, 4 * n_small):
        _ = float(run_jit(ms, n).state[0, 0, 0])
    s_rough = max((timed(4 * n_small) - timed(n_small)) / (3 * n_small), 1e-7)
    # 0.25/s_rough: the rough estimate overshoots ~2x at launch-bound tiny
    # sizes (sync noise in a 30-step window), so aim past the 150 ms target
    n_big = n_small + max(40, int(0.25 / s_rough) + 1)
    _ = float(run_jit(ms, n_big).state[0, 0, 0])

    s_step = (timed(n_big) - timed(n_small)) / (n_big - n_small)

    # XLA cost analysis of ONE step (bytes accessed ~= device-memory
    # traffic after fusion; excludes what runs inside the Pallas kernel)
    try:
        ca = jax.jit(model.step).lower(ms).compile().cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        gbytes = float(ca.get("bytes accessed", 0.0)) / 1e9
        gflops = float(ca.get("flops", 0.0)) / 1e9
    except Exception:
        gbytes = gflops = float("nan")

    dev = jax.devices()[0]
    out = dict(platform=dev.platform, device_kind=dev.device_kind,
               nx=nx, ny=ny, solver=solver,
               advance=model.resolved_config().advance_mode,
               dt_reset=dt_reset_mode, scatter=scatter_mode,
               ms_per_step=s_step * 1e3,
               window_ms=(n_big - n_small) * s_step * 1e3,
               pushes_per_s=nx * ny / s_step,
               hbm_gb_per_step=gbytes,
               achieved_hbm_gbps=gbytes / s_step,
               hbm_util_pct=100.0 * gbytes / s_step / peak_hbm_gbps(),
               xla_gflops_per_step=gflops)
    if out["hbm_util_pct"] > 100.0:
        # physically impossible as stated: flag it as a cost-model
        # overcount ("bytes accessed" is XLA's pre-fusion estimate for
        # some ops) rather than publishing silent >100% utilization
        out["hbm_util_note"] = "cost-model overcount (bytes accessed > true HBM traffic)"
    return out


def main():
    fast = "--fast" in sys.argv
    if jax.default_backend() != "gpu":
        raise SystemExit("perf_dossier.py measures the GPU; no GPU found")
    peak_hbm_gbps()   # fail before measuring on an unknown card
    enable_compile_cache()

    configs = [
        # size sweep, production config (auto advance + carry + bosh3)
        dict(nx=256, ny=256),
        dict(nx=768, ny=768),
        dict(nx=1536, ny=1536),
        dict(nx=3072, ny=3072),
        # solver comparison at the flagship size
        dict(nx=1536, ny=1536, solver="tsit5"),
        # backend ablations at the flagship size
        dict(nx=1536, ny=1536, advance_mode="xla"),
        dict(nx=1536, ny=1536, dt_reset_mode="auto"),
        dict(nx=1536, ny=1536, scatter_mode="xla"),
        # the reference's own 51x51 config (BASELINE: 0.105 s / 2 steps)
        dict(nx=51, ny=51),
    ]
    if fast:
        configs = [c for c in configs if c["nx"] <= 768]

    rows = []
    for c in configs:
        try:
            r = measure(**c)
        except Exception as e:
            print(f"FAILED {c}: {type(e).__name__}: {e}", file=sys.stderr)
            continue
        rows.append(r)
        print(json.dumps(r))
        print(f"{r['nx']:>5}x{r['ny']:<5} {r['solver']:<6} "
              f"adv={r['advance']:<6} dt={r['dt_reset']:<5} "
              f"{r['ms_per_step']:8.3f} ms/step  "
              f"{r['pushes_per_s']:.3e} pushes/s  "
              f"HBM {r['achieved_hbm_gbps']:6.1f} GB/s "
              f"({r['hbm_util_pct']:.0f}%)", file=sys.stderr)


if __name__ == "__main__":
    main()
