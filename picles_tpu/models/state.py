"""Model state pytrees.

The reference model god-object (WaveGrowth2D, src/Models/WaveGrowthModels2D.jl)
splits here into (a) a static model description (grid + winds + config,
closed over by the jitted step) and (b) this dynamic ``ModelState`` pytree
that flows through ``step``: the Eulerian state array, the particle SoA, and
the clock.  Per-particle ODEIntegrator objects become three extra arrays:
``t`` (per-particle clock — off particles lag, reference mapping_2D.jl:172-185),
``dt`` (adapted sub-step, persists across steps) and ``on``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


class StepMetrics(NamedTuple):
    """Per-step observability counters (the analog of the reference's
    FailedCollection bookkeeping and @info debugging)."""

    n_active: jnp.ndarray        # particles advanced this step
    n_failed: jnp.ndarray        # ODE failures (MarkedParticleInstance analog)
    n_nan_reset: jnp.ndarray     # NaN guards tripped (mapping_2D.jl:196-220)
    n_inf_reset: jnp.ndarray
    n_emax_clamp: jnp.ndarray    # log_energy_maximum clamps (:222-235)
    n_relight: jnp.ndarray       # off->on wind re-lights in advance (:172-185)
    n_gather: jnp.ndarray        # remesh branch (a): node state adopted
    n_reseed: jnp.ndarray        # remesh branch (b/c): windsea reseeds
    n_off: jnp.ndarray           # on->off TRANSITIONS in remesh (not the
                                 # standing off population)
    n_clamped: jnp.ndarray       # scatter displacements clamped to the halo
    substeps_max: jnp.ndarray    # max accepted ODE substeps over the batch

    @classmethod
    def zeros(cls) -> "StepMetrics":
        z = jnp.zeros((), jnp.int32)
        return cls(*([z] * 11))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Particles2D:
    """SoA particle collection, one particle per grid node.

    True structure-of-arrays: the 5 ODE variables are separate [nx, ny]
    planes, NOT a stacked [nx, ny, 5] array — a 5-wide minor dimension
    forces strided access and layout copies between the fusions of the
    hot loop, and the Pallas advance streams each plane as its own
    contiguous lane array.  Use the ``z`` property / ``from_z`` only at
    API boundaries.

    lne, cgx, cgy: [nx, ny] log-energy and mean group velocity
    px, py:        [nx, ny] positions relative to the home node in
                   grid-index units (mesh-grid convention, reference
                   mapping_2D.jl:59-73)
    t:  [nx, ny] per-particle integrator time
    dt: [nx, ny] per-particle next sub-step
    on: [nx, ny] bool
    """

    lne: jnp.ndarray
    cgx: jnp.ndarray
    cgy: jnp.ndarray
    px: jnp.ndarray
    py: jnp.ndarray
    t: jnp.ndarray
    dt: jnp.ndarray
    on: jnp.ndarray

    @property
    def z(self) -> jnp.ndarray:
        """Stacked [nx, ny, 5] view (diagnostics / API compatibility)."""
        return jnp.stack([self.lne, self.cgx, self.cgy, self.px, self.py],
                         axis=-1)

    @classmethod
    def from_z(cls, z: jnp.ndarray, t: jnp.ndarray, dt: jnp.ndarray,
               on: jnp.ndarray) -> "Particles2D":
        return cls(lne=z[..., 0], cgx=z[..., 1], cgy=z[..., 2],
                   px=z[..., 3], py=z[..., 4], t=t, dt=dt, on=on)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ModelState2D:
    """state: [nx, ny, 3] Eulerian (e, m_x, m_y) — the reference's
    SharedArray State."""

    state: jnp.ndarray
    particles: Particles2D
    time: jnp.ndarray
    iteration: jnp.ndarray
    metrics: StepMetrics


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Particles1D:
    """z: [nx, 3] = (lne, cg_x, x) with absolute x in meters."""

    z: jnp.ndarray
    t: jnp.ndarray
    dt: jnp.ndarray
    on: jnp.ndarray


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ModelState1D:
    state: jnp.ndarray  # [nx, 3]
    particles: Particles1D
    time: jnp.ndarray
    iteration: jnp.ndarray
    metrics: StepMetrics
