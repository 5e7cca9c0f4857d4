"""Particle diagnostics (reference src/Utils/ParticleTools.jl).

The reference inspects per-particle ODE solution objects; this build's
equivalent history is the stacked per-step particle SoA produced by a
``lax.scan`` (see ``record_trajectories``).  Converters produce pandas
DataFrames with the same column sets (time, x, y, cg, lne, E, m)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..ops import transforms as TR


def create_iteration_mask(time: np.ndarray) -> np.ndarray:
    """Segment counter that increments wherever time jumps backward
    (reference CreateIterationMask, ParticleTools.jl:12-25)."""
    time = np.asarray(time)
    mask = np.zeros(len(time), dtype=int)
    seg = 1
    for i in range(len(time)):
        if i > 0 and time[i] < time[i - 1]:
            seg += 1
        mask[i] = seg
    return mask


def record_trajectories(model, ms, n_steps: int, saving_step=None):
    """Run n steps collecting per-step particle SoA snapshots.

    Returns (final_state, dict with stacked arrays z[n, ...], t[n, ...],
    on[n, ...], state[n, ...]) — the batched analog of the reference's
    per-particle ``sol`` histories.

    ``saving_step`` (default ``model.settings.saving_step``) enables
    SUB-DT trajectory sampling, the analog of the reference integrators'
    retained ``saveat=saving_step`` solution histories
    (particle_waves_v5.jl:60, core_2D.jl:177-194): when it is smaller
    than DT, every model step additionally records the raw ODE solution
    at each save point by advancing a shadow copy of the particle state
    in save-aligned sub-windows (guards/remesh are per-DT events and do
    not appear inside a window, exactly like the reference's in-window
    histories).  The result dict then also carries ``z_fine`` shaped
    ``[n * K, ...]`` and ``t_fine`` with ``K = round(DT / saving_step)``
    samples per step (the last one landing on the step end).
    """
    from ..ops.tsit5 import integrate_to

    DT = float(model.settings.timestep)
    if saving_step is None:
        saving_step = float(getattr(model.settings, "saving_step", DT))
    K = max(1, int(round(DT / float(saving_step))))

    def body(carry, _):
        if K > 1:
            # shadow sub-window advance of the CURRENT particles: the raw
            # in-window ODE history at the save cadence
            P = carry.particles
            # match the real step's advance mask: 2D models expose
            # active_mask; the 1D step advances on & ~boundary_mask
            # (boundary particles never integrate, wave_growth_1d.py)
            aux = getattr(model, "aux", model.grid)
            if hasattr(model, "active_mask"):
                active = P.on & model.active_mask
            elif hasattr(model, "boundary_mask"):
                active = P.on & ~model.boundary_mask
            else:
                active = P.on
            h = jnp.asarray(DT / K, P.t.dtype)

            def sub(sc, _):
                z, t, dtc = sc
                res = integrate_to(model.rhs, z, t, t + h, dtc, aux,
                                   active, model.solver)
                return (res.z, res.t, res.dt), (res.z, res.t)

            _, (z_fine, t_fine) = jax.lax.scan(
                sub, (P.z, P.t, P.dt), None, length=K)
        else:
            z_fine = t_fine = None
        nxt = model.step(carry)
        out = (nxt.particles.z, nxt.particles.t, nxt.particles.on, nxt.state)
        if K > 1:
            out = out + (z_fine, t_fine)
        return nxt, out

    final, outs = jax.lax.scan(body, ms, None, length=n_steps)
    z, t, on, state = outs[:4]
    rec = dict(z=z, t=t, on=on, state=state)
    if K > 1:
        zf, tf = outs[4], outs[5]   # [n, K, ...] -> [n*K, ...]
        rec["z_fine"] = zf.reshape((n_steps * K,) + zf.shape[2:])
        rec["t_fine"] = tf.reshape((n_steps * K,) + tf.shape[2:])
    return final, rec


def particle_to_dataframe(z_hist: np.ndarray, t_hist: np.ndarray,
                          ij: Tuple[int, ...]) -> pd.DataFrame:
    """One particle's trajectory as a DataFrame (reference
    ParticleToDataframe / FormatParticleData, ParticleTools.jl:27-81)."""
    z = np.asarray(z_hist)[(slice(None),) + tuple(ij)]
    t = np.asarray(t_hist)[(slice(None),) + tuple(ij)]
    if z.shape[-1] == 5:
        e, mx, my = TR.particle_to_node(jnp.asarray(z[:, 0]),
                                        jnp.asarray(z[:, 1]),
                                        jnp.asarray(z[:, 2]))
        df = pd.DataFrame(dict(time=t, lne=z[:, 0], cgx=z[:, 1], cgy=z[:, 2],
                               x=z[:, 3], y=z[:, 4], E=np.asarray(e),
                               mx=np.asarray(mx), my=np.asarray(my)))
    else:
        e, mx = TR.particle_to_node_1d(jnp.asarray(z[:, 0]),
                                       jnp.asarray(z[:, 1]))
        df = pd.DataFrame(dict(time=t, lne=z[:, 0], cgx=z[:, 1], x=z[:, 2],
                               E=np.asarray(e), mx=np.asarray(mx)))
    df["mask"] = create_iteration_mask(df["time"].to_numpy())
    return df


def particles_to_dataframes(z_hist, t_hist,
                            ij_list: Sequence[Tuple[int, ...]]) -> List[pd.DataFrame]:
    return [particle_to_dataframe(z_hist, t_hist, ij) for ij in ij_list]


def metrics_to_dict(ms) -> dict:
    """Per-step counters as plain ints (the FailedCollection stats analog)."""
    return {k: int(np.asarray(v).sum()) for k, v in ms.metrics._asdict().items()}


def state_to_dataframe(state: np.ndarray, grid) -> pd.DataFrame:
    """Flatten an Eulerian state snapshot into a tidy DataFrame."""
    s = np.asarray(state)
    x = np.asarray(jax.device_get(grid.x)).ravel()
    y = np.asarray(jax.device_get(grid.y)).ravel()
    return pd.DataFrame(dict(x=x, y=y, e=s[..., 0].ravel(),
                             m_x=s[..., 1].ravel(), m_y=s[..., 2].ravel()))
