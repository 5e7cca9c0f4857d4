"""Smoke test of the main path on the GPU, at production size.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py            # one GPU: phases a-d
    python chip_smoke.py --four     # four GPUs: the sharded step only

Phases (each prints its wall time and result; any failure exits non-zero):

  a. main path: the 1536^2 box (2 km spacing, U = V = 10 m/s, periodic)
     with the user-default ``WaveGrowth2DConfig()`` (advance "auto", which
     is the Triton kernel on the GPU; Hairer dt reset; halo 3) through
     ``Simulation.create(...).run(cash_store=True)`` for 12 steps of
     DT = 600 s: finite fields, no failed lanes, no halo clamps, energy
     rising step over step under the constant wind;
  b. bench config: the same box as ``bench.build`` (carried dt,
     directional halo) for a few jitted ``step_n`` steps;
  c. kernel against reference: the Triton advance against the XLA
     ``integrate_to`` on the 1536^2 box and the 1 deg tripolar grid, both
     solvers.  The kernel alone runs on a state one step in (on the box
     with lane dts scattered over a decade and jittered energy): lanes
     within rtol 5e-3 / atol 1e-8, except at most one in 10^4 whose
     accept/reject path diverged, and those within ten times that, with
     equal failure counts.  The model runs three steps from its seed:
     equal n_active / n_gather / n_failed and the node state within the
     controller's envelope, rtol 2e-2 (atol: a thousandth of the energy's
     and the momentum's peak).  Compiled
     transcendentals and FMA contraction differ from XLA's in the last
     bits, which can flip an accept/reject decision.  The program has no
     matrix products, so TF32 does not apply;
  d. deposit against oracle: ``scatter_mode="dense"`` against
     ``scatter_xla`` at 1536^2 (rtol 1e-5: the oracle's scatter-add uses
     atomics on the GPU, so its summation order varies run to run);
  e. ``--four`` (and nothing else): ``ShardedWaveGrowth2D`` on a 2x2 mesh
     of four GPUs against the single-GPU step, on the box and on the
     tripolar seam, plus the exact collective-isolation check of the
     sharded deposit, and each GPU holding its own shard.

The last line of standard output is one JSON object naming the device.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 600.0
N = 1536


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def assert_close(got, want, rtol, atol, what):
    """``assert_allclose`` with a per-channel ``atol`` (last axis)."""
    import numpy as np

    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        i = np.unravel_index(np.argmax(err / (atol + rtol * np.abs(want))),
                             err.shape)
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.size} outside rtol={rtol} "
            f"atol={atol}; worst at {tuple(int(k) for k in i)}: "
            f"{got[i]!r} vs {want[i]!r}")


def box_settings(solver="bosh3"):
    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings

    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    return ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True, solver=solver)


def box_grid():
    from picles_tpu.grids.cartesian import cartesian_box

    return cartesian_box(2e3 * (N - 1), N, 2e3 * (N - 1), N,
                         periodic_boundary=(True, True))


def phase_a():
    import numpy as np

    import picles_tpu as pt

    model = pt.WaveGrowth2D(box_grid(), pt.constant_winds(10.0, 10.0),
                            box_settings(), config=pt.WaveGrowth2DConfig())
    assert model.resolved_config().advance_mode == "pallas"
    sim = pt.Simulation.create(model, stop_time=11 * DT)
    metrics = []
    sim.callbacks["metrics"] = lambda s: metrics.append(s.state.metrics)
    sim.run(cash_store=True, chunk_size=1)
    frames = sim.store.as_array()
    assert frames.shape == (13, N, N, 3), frames.shape
    assert np.all(np.isfinite(frames)), "non-finite fields"
    assert len(metrics) == 12, len(metrics)
    for k, m in enumerate(metrics):
        assert int(m.n_failed) == 0, (k, int(m.n_failed))
        assert int(m.n_clamped) == 0, (k, int(m.n_clamped))
    energy = frames[..., 0].sum(axis=(1, 2), dtype=np.float64)
    assert np.all(np.diff(energy) > 0), energy
    print(f"[a] 12 steps, total energy {energy[1]:.4e} -> {energy[-1]:.4e}, "
          f"substeps_max {int(metrics[-1].substeps_max)}, "
          f"run wall {sim.run_wall_time:.2f} s")


def phase_b():
    import jax
    import numpy as np

    sys.path.insert(0, ROOT)
    import bench

    model = bench.build(N, N)
    assert model.resolved_config().advance_mode == "pallas"
    ms, states = model.step_n(model.init_state(), 4)
    jax.block_until_ready(states)
    assert np.all(np.isfinite(np.asarray(states)))
    assert int(ms.metrics.n_failed) == 0 and int(ms.metrics.n_clamped) == 0
    e = np.asarray(states[..., 0]).sum(axis=(1, 2), dtype=np.float64)
    assert np.all(np.diff(e) > 0), e
    print(f"[b] 4 steps, energy {e[0]:.4e} -> {e[-1]:.4e}")


def _spun_up(model, perturb):
    """A state one step in.  ``perturb`` scatters the per-lane dts over a
    decade below the carried one and jitters the wave energy, so that the
    lanes of a homogeneous box take different sub-step counts (the
    tripolar grid's winds and land already make them differ)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    ms = jax.jit(model.step)(model.init_state())
    if not perturb:
        return ms
    P = ms.particles
    rng = np.random.default_rng(7)
    shape = P.t.shape
    dt = P.dt * jnp.asarray(10.0 ** rng.uniform(-1, 0.3, shape), P.t.dtype)
    lne = P.lne + jnp.asarray(rng.normal(0.0, 0.05, shape), P.t.dtype)
    return dataclasses.replace(
        ms, particles=dataclasses.replace(P, dt=dt, lne=lne))


def _check_kernel(label, make_model, solver, perturb):
    """Triton advance vs integrate_to, directly and through the model."""
    import jax
    import numpy as np

    from picles_tpu.ops.advance_pallas import advance_pallas
    from picles_tpu.ops.rhs import RHSParams, make_rhs_consts
    from picles_tpu.ops.tsit5 import integrate_to

    mp, mx = make_model("pallas", solver), make_model("xla", solver)
    ms = _spun_up(mx, perturb)
    P, g = ms.particles, mx.grid
    adv = P.on & mx.active_mask
    consts = make_rhs_consts(gamma=mp.constants.gamma,
                             constants=mp.constants, params=mp.params)

    @jax.jit
    def kernel(P):
        return advance_pallas(mp.winds.u, mp.winds.v, consts, mp.flags,
                              mp.solver, float(mp.settings.timestep),
                              (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, P.dt,
                              adv, g.x, g.y, mp.uniform_proj or g.proj, g.pc)

    @jax.jit
    def reference(P):
        return integrate_to(mx.rhs, P.z, P.t, P.t + mx.settings.timestep,
                            P.dt, RHSParams(x=g.x, y=g.y, M=g.proj, pc=g.pc),
                            adv, mx.solver)

    r, ref = kernel(P), reference(P)
    got = np.stack([np.asarray(c) for c in (r.lne, r.cgx, r.cgy, r.x, r.y)],
                   -1)
    want = np.asarray(ref.z)
    # per lane: the worst of its five components, in units of the state
    # tolerance (rtol 5e-3, atol 1e-8).  A lane whose accept/reject path
    # diverged (last-bit differences of compiled transcendentals and FMA
    # contraction) lands on another valid solution: those lanes must be
    # rare, and still within ten times the tolerance.  A wrong kernel
    # (indexing, padding, masking) moves whole blocks of lanes.
    ratio = (np.abs(got - want) / (1e-8 + 5e-3 * np.abs(want))).max(-1)
    n_out = int((ratio > 1.0).sum())
    n_act = int(np.asarray(adv).sum())
    assert n_out <= 1e-4 * n_act, (label, solver, n_out, n_act)
    assert float(ratio.max()) <= 10.0, (label, solver, float(ratio.max()))
    n_fail = (int(np.asarray(r.failed).sum()),
              int(np.asarray(ref.failed).sum()))
    assert n_fail[0] == n_fail[1], (label, solver, n_fail)
    dn = np.abs(np.asarray(r.naccept) - np.asarray(ref.naccept))

    # through the model: three steps from the seeded state, with equal
    # branch counts.  The node state is held to the controller's envelope,
    # rtol 2e-2: three remesh cycles compound the diverged lanes above,
    # and exp() turns a log-energy difference into ~|lne| times that in
    # energy.  Nodes below a thousandth of the field's peak (young seas
    # in calm air, cancelling momentum) get that peak-scaled floor —
    # energy's own peak, and the momentum vector's for both components
    sp, sx = mp.init_state(), mx.init_state()
    step_p, step_x = jax.jit(mp.step), jax.jit(mx.step)
    for _ in range(3):
        sp, sx = step_p(sp), step_x(sx)
    want = np.asarray(sx.state)
    peak = np.abs(want).max(axis=(0, 1))
    floor = 1e-3 * np.array([peak[0], peak[1:].max(), peak[1:].max()])
    assert_close(np.asarray(sp.state), want, 2e-2, floor,
                 f"{label} {solver} step")
    node_ratio = float((np.abs(np.asarray(sp.state) - want)
                        / (floor + 2e-2 * np.abs(want))).max())
    for k in ("n_active", "n_gather", "n_failed"):
        a, b = int(getattr(sp.metrics, k)), int(getattr(sx.metrics, k))
        assert a == b, (label, solver, k, a, b)
    print(f"[c] {label} {solver}: lanes {adv.size}, active {n_act}, "
          f"substeps max {int(np.asarray(ref.naccept).max())}, "
          f"accepted-count diffs {int((dn > 0).sum())} lanes "
          f"(max {int(dn.max())}), failed {n_fail[0]}; kernel: "
          f"{n_out} lanes beyond tolerance, worst {float(ratio.max()):.3g}x "
          f"tolerance; 3 steps: worst node {node_ratio:.3g}x tolerance")


def phase_c():
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import bench
    import tripolar_global_demo as tg

    for solver in ("bosh3", "tsit5"):
        _check_kernel("box1536", lambda m, s: bench.build(
            N, N, advance_mode=m, solver=s), solver, perturb=True)
        _check_kernel("tripolar1deg", lambda m, s: tg.build_model(
            advance_mode=m, solver=s), solver, perturb=False)


def phase_d():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from picles_tpu.ops import pic
    from picles_tpu.ops import transforms as TR

    model = bench.build(N, N)
    ms = model.step_n_quiet(model.init_state(), 3)
    P = ms.particles
    ch = jnp.stack(TR.particle_to_node(P.lne, P.cgx, P.cgy), axis=-1)
    act = P.on & model.active_mask
    st, halo = model.grid.stats, model.config.halo
    dense = jax.jit(lambda *a: pic.scatter_dense(*a, st, halo))(
        P.px, P.py, ch, act)
    oracle = jax.jit(lambda *a: pic.scatter_xla(*a, st, halo))(
        P.px, P.py, ch, act)
    got, want = np.asarray(dense[0]), np.asarray(oracle[0])
    assert int(dense[1].clamped) == 0
    # rtol is summation order; atol (a millionth of each channel's peak)
    # covers momentum components that cancel towards zero at some nodes
    atol = 1e-6 * np.abs(want).max(axis=(0, 1))
    assert_close(got, want, 1e-5, atol, "dense vs scatter_xla")
    print(f"[d] dense vs scatter_xla at {N}^2: max rel diff "
          f"{float(np.max(np.abs(got - want) / (np.abs(want) + atol))):.2e}")


def phase_four():
    import jax

    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import bench
    import tripolar_global_demo as tg
    from __graft_entry__ import check_scatter_isolation, check_sharded_step
    from picles_tpu.parallel.sharded import make_mesh

    devices = jax.devices()
    assert len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}"
    mesh = make_mesh(devices=devices, shape=(2, 2))
    sharded = check_sharded_step(bench.build(N, N), mesh, steps=3,
                                 label="box1536")
    check_scatter_isolation(sharded, label="box1536")
    print(f"[e] box {N}^2 on 2x2: step and deposit isolation ok")
    tri = tg.build_model()
    sharded = check_sharded_step(tri, mesh, steps=3, label="tripolar1deg")
    check_scatter_isolation(sharded, label="tripolar1deg")
    print("[e] tripolar 1 deg (seam fold) on 2x2: step and deposit "
          "isolation ok")


def main():
    if not os.path.isdir(os.path.join(ROOT, "picles_tpu")):
        _fail("run from a checkout of the repository (package not found)")
    sys.path.insert(0, ROOT)
    try:
        import jax

        backend = jax.default_backend()
    except Exception as e:  # no usable backend at all
        _fail(f"JAX found no device: {e!r}")
    if backend != "gpu":
        _fail(f"needs a GPU; JAX's default backend is {backend!r}")

    from picles_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)

    four = "--four" in sys.argv[1:]
    phases = ([("e", phase_four)] if four else
              [("a", phase_a), ("b", phase_b), ("c", phase_c),
               ("d", phase_d)])
    for name, fn in phases:
        print(f"[{name}] start", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            sys.exit(1)
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main()
