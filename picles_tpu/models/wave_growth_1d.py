"""WaveGrowth1D — the 1D growth-curve model (B01 regression path).

JAX re-implementation of the reference 1D stack
(src/Models/WaveGrowthModels1D.jl, src/Operators/core_1D.jl,
src/Operators/mapping_1D.jl, TimeSteppers.jl:51-92).  Differences from 2D:
particle state is ``[lne, cg_x, x]`` with *absolute* x in meters on a legacy
regular grid (ParticleMesh.jl:20-60), the scatter applies the sign-merge
rule (ParticleInCell.jl:545-613), boundary particles ([0, nx-1] when
non-periodic) never advance (mapping_1D.jl:100), and the node state is
``(e, m_x, 0)`` with ``m_x = E / (2 cg_x)`` (core_1D.jl:103-112).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core import fetch_relations as FR
from ..core.constants import IDConstants, ODEParameters, ODESettings
from ..forcing.winds import Winds1D
from ..grids.base import Grid1D, GridStats, Boundary
from ..ops import pic
from ..ops import transforms as TR
from ..ops.rhs import TermFlags, particle_equations_1d
from .drivers import StepDrivers
from ..ops.tsit5 import SolverConfig, auto_dt, integrate_to
from .state import ModelState1D, Particles1D, StepMetrics

SQRT2 = math.sqrt(2.0)


def one_d_grid(xmin: float, xmax: float, nx: int,
               periodic: bool = False, dtype=jnp.float32) -> Grid1D:
    """Regular absolute-coordinate 1D grid (reference OneDGrid,
    ParticleMesh.jl:20-60)."""
    dx = (xmax - xmin) / (nx - 1)
    stats = GridStats(nx=nx, ny=1,
                      bx=Boundary.PERIODIC if periodic else Boundary.NONPERIODIC,
                      by=Boundary.NONPERIODIC, xmin=xmin, xmax=xmax, dx=dx,
                      kind="regular1d")
    return Grid1D(x=jnp.asarray(np.linspace(xmin, xmax, nx), dtype),
                  stats=stats)


@dataclasses.dataclass(frozen=True)
class ParticleDefaults1D:
    """Reference core_1D.jl:36-47."""

    lne: float
    cg_x: float
    x: float = 0.0


@dataclasses.dataclass(frozen=True)
class WaveGrowth1DConfig:
    periodic_boundary: bool = True
    ode_init_type: Union[str, ParticleDefaults1D] = "wind_sea"
    boundary_type: str = "same"
    merge_rule: bool = True   # sign-merge scatter (reference 1D path)
    dtype: type = jnp.float32


class WaveGrowth1D(StepDrivers):
    """1D model: build RHS from winds ``u(x, t)``; expose ``step``."""

    def __init__(self, grid: Grid1D, winds: Winds1D,
                 ode_settings: ODESettings,
                 ode_params: Optional[ODEParameters] = None,
                 constants: Optional[IDConstants] = None,
                 flags: TermFlags = TermFlags(),
                 minimal_particle=None, minimal_state=None,
                 config: WaveGrowth1DConfig = WaveGrowth1DConfig()):
        self.grid = grid
        self.winds = winds
        self.settings = ode_settings
        self.config = config
        if ode_params is None:
            ode_params, constants, _ = ODEParameters.create()
        self.params = ode_params
        self.constants = constants or IDConstants.create(r_g=ode_params.r_g)
        self.rhs = particle_equations_1d(winds.u, gamma=self.constants.gamma,
                                         params=self.params,
                                         constants=self.constants, flags=flags)

        DT = ode_settings.timestep
        # reference defaults: MinimalParticle(2, 0, DT) / MinimalState(2, 0, DT)
        self.minimal_particle = (jnp.asarray(minimal_particle, config.dtype)
                                 if minimal_particle is not None
                                 else jnp.asarray(FR.MinimalParticle(2.0, 0.0, DT),
                                                  config.dtype))
        self.minimal_state = (jnp.asarray(minimal_state, config.dtype)
                              if minimal_state is not None
                              else jnp.asarray(FR.MinimalState(2.0, 0.0, DT),
                                               config.dtype))
        self.solver = SolverConfig(abstol=ode_settings.abstol,
                                   reltol=ode_settings.reltol,
                                   dtmin=ode_settings.dtmin,
                                   force_dtmin=ode_settings.force_dtmin,
                                   maxiters=ode_settings.maxiters,
                                   method=ode_settings.solver,
                                   adaptive=ode_settings.adaptive)
        from ..ops.tsit5 import METHODS
        self._rk_order = METHODS[ode_settings.solver].order

        nx = grid.nx
        bnd = np.zeros(nx, dtype=bool)
        if not config.periodic_boundary:
            bnd[0] = bnd[-1] = True  # reference WaveGrowthModels1D.jl:142-146
        self.boundary_mask = jnp.asarray(bnd)

        if config.ode_init_type == "mininmal":
            self.defaults: Optional[ParticleDefaults1D] = \
                ParticleDefaults1D(-11.0, 1e-3)
        elif isinstance(config.ode_init_type, ParticleDefaults1D):
            self.defaults = config.ode_init_type
        elif config.ode_init_type == "wind_sea":
            self.defaults = None
        else:
            # same validation as the 2D model: an unrecognized string
            # (e.g. the correctly-spelled "minimal") must not silently
            # fall through to windsea seeding
            raise ValueError(
                f"ode_init_type {config.ode_init_type!r}: expected "
                f"'wind_sea', 'mininmal' (sic, the reference spelling, "
                f"WaveGrowthModels2D.jl:223-231) or ParticleDefaults1D")

        # boundary_type parity (reference WaveGrowthModels1D.jl:146-158):
        # the knob is validated and its defaults constructed, but the 1D
        # branch table has no boundary reseed — boundary particles always
        # switch off (mapping_1D.jl:244-278) — so the defaults are inert,
        # exactly as in the reference.
        if config.boundary_type == "mininmal":
            self.boundary_defaults: Optional[ParticleDefaults1D] = \
                ParticleDefaults1D(-11.0, 1e-3)
        elif config.boundary_type == "wind_sea":
            self.boundary_defaults = None
        elif config.boundary_type == "same":
            self.boundary_defaults = self.defaults
        else:
            raise ValueError("boundary_type must be 'wind_sea', 'mininmal' "
                             "or 'same'")

    # ------------------------------------------------------------------

    def _reset_values(self, u, x_node):
        """1D ResetParticleValues (core_1D.jl:247-270): signed windsea from
        the 1D fetch law; position = node position."""
        if self.defaults is None:
            ws = FR.get_initial_windsea_1d(u, self.settings.timestep)
            z = jnp.stack([ws.lne, ws.cg_bar_x, x_node], axis=-1)
        else:
            d = self.defaults
            z = jnp.stack([jnp.full_like(x_node, d.lne),
                           jnp.full_like(x_node, d.cg_x), x_node], axis=-1)
        return z.astype(self.config.dtype)

    def init_state(self) -> ModelState1D:
        """Vectorized SeedParticle! (core_1D.jl:292-341)."""
        cfg = self.config
        x = self.grid.x
        u0 = jnp.broadcast_to(
            jnp.asarray(self.winds.u(x, jnp.zeros_like(x)), cfg.dtype), x.shape)

        if self.defaults is None:
            strong = jnp.abs(u0) > SQRT2
            ws = FR.get_initial_windsea_1d(u0, self.settings.timestep)
            z_sea = jnp.stack([ws.lne, ws.cg_bar_x, x], axis=-1)
            # deliberately the 2-ARG MinimalParticle(u, 0, DT): the
            # reference's 1D seed calls exactly this (core_1D.jl:217),
            # whose V10=0 is rewritten to a unit sign inside
            # MinimalWindsea (FetchRelations.jl:378-382) — NOT the 1-arg
            # MinimalWindsea_1d variant.  Parity over plausibility.
            mp = FR.MinimalParticle(u0, jnp.zeros_like(u0),
                                    self.settings.timestep)
            z_min = jnp.stack([mp[..., 0], mp[..., 1], x], axis=-1)
            z = jnp.where(strong[..., None], z_sea, z_min).astype(cfg.dtype)
            on = strong
        else:
            z = self._reset_values(u0, x)
            on = jnp.ones(x.shape, bool)

        e, m_x = TR.particle_to_node_1d(z[..., 0], z[..., 1])
        zeros = jnp.zeros_like(e)
        state = jnp.stack([e, m_x, zeros], axis=-1) * on[..., None]

        particles = Particles1D(z=z, t=jnp.zeros(x.shape, cfg.dtype),
                                dt=jnp.full(x.shape, self.settings.dt,
                                            cfg.dtype), on=on)
        return ModelState1D(state=state.astype(cfg.dtype), particles=particles,
                            time=jnp.zeros((), cfg.dtype),
                            iteration=jnp.zeros((), jnp.int32),
                            metrics=StepMetrics.zeros())

    # ------------------------------------------------------------------

    def step(self, ms: ModelState1D) -> ModelState1D:
        """One DT (mapping_1D.advance!/remesh!, TimeSteppers.jl:51-92)."""
        cfg = self.config
        sett = self.settings
        DT = jnp.asarray(sett.timestep, cfg.dtype)
        P = ms.particles
        x_node = self.grid.x
        boundary = self.boundary_mask
        aux = self.grid  # rhs aux only needs .x

        # ADVANCE: on & ~boundary (mapping_1D.jl:100)
        adv = P.on & ~boundary
        res = integrate_to(self.rhs, P.z, P.t, P.t + DT, P.dt, aux, adv,
                           self.solver)
        failed = res.failed & adv
        z = jnp.where(adv[..., None], res.z, P.z)
        t = jnp.where(adv, res.t, P.t)
        dt = jnp.where(adv, res.dt, P.dt)
        # on & boundary -> switched off (mapping_1D.jl:139-144)
        on = P.on & ~(P.on & boundary)

        # off re-light (mapping_1D.jl:122-135)
        off = ~P.on & ~boundary
        u_end = jnp.broadcast_to(
            jnp.asarray(self.winds.u(x_node, P.t + DT), cfg.dtype), t.shape)
        relight = off & (u_end ** 2 >= sett.wind_min_squared)
        z = jnp.where(relight[..., None], self._reset_values(u_end, x_node), z)
        on = on | relight

        # guards (mapping_1D.jl:147-177); note: in 1D the e-max clamp resets
        # the full state to the windsea (unlike 2D which clamps lne only)
        guardable = ~failed & ~boundary
        nan_mask = guardable & jnp.any(jnp.isnan(z), axis=-1)
        inf_mask = guardable & ~nan_mask & jnp.any(jnp.isinf(z), axis=-1)
        emax_mask = guardable & (z[..., 0] > sett.log_energy_maximum)
        bad = nan_mask | inf_mask | emax_mask
        z = jnp.where(bad[..., None], self._reset_values(u_end, x_node), z)

        # SCATTER with merge rule, absolute positions (mapping_1D.jl:40-50)
        scatter_on = on & ~failed & ~boundary
        e, m_x = TR.particle_to_node_1d(z[..., 0], z[..., 1])
        charge = jnp.stack([e, m_x, jnp.zeros_like(e)], axis=-1)
        st = self.grid.stats
        scatter = (pic.scatter_1d_merge if cfg.merge_rule
                   else pic.scatter_1d_add)
        S = scatter(z[..., 2], charge, scatter_on, st.xmin, st.dx, st.nx,
                    cfg.periodic_boundary)

        # REMESH (mapping_1D.jl:221-278)
        u_i = jnp.broadcast_to(
            jnp.asarray(self.winds.u(x_node,
                                     jnp.broadcast_to(ms.time, t.shape)),
                        cfg.dtype), t.shape)
        e_n, m_n = S[..., 0], S[..., 1]
        gather = (~boundary & (e_n >= self.minimal_state[0])
                  & (m_n ** 2 >= self.minimal_state[1]))
        reseed = ~boundary & ~gather & (u_i ** 2 >= sett.wind_min_squared)
        go_off = ~boundary & ~gather & ~reseed

        lne_g, cgx_g = TR.node_to_particle_1d(e_n, m_n)
        z_gather = jnp.stack([lne_g, cgx_g, x_node], axis=-1)
        z = jnp.where(gather[..., None], z_gather, z)
        z = jnp.where(reseed[..., None], self._reset_values(u_i, x_node), z)
        on_before_remesh = on
        on = jnp.where(~boundary, gather | reseed, on)

        was_reset = relight | bad | gather | reseed
        if sett.adaptive:
            dt_auto = auto_dt(self.rhs, t, z, aux, order=self._rk_order,
                              abstol=sett.abstol,
                              reltol=sett.reltol)
            dt = jnp.where(was_reset, jnp.clip(dt_auto, sett.dtmin, DT), dt)
        # fixed-substep mode: dt stays the configured constant sub-step

        def _c(x):
            return jnp.sum(x).astype(jnp.int32)

        metrics = StepMetrics(
            n_active=_c(adv), n_failed=_c(failed), n_nan_reset=_c(nan_mask),
            n_inf_reset=_c(inf_mask), n_emax_clamp=_c(emax_mask),
            n_relight=_c(relight), n_gather=_c(gather), n_reseed=_c(reseed),
            # transitions only (was on, switched off), mirroring the 2D model
            n_off=_c(go_off & on_before_remesh),
            n_clamped=jnp.zeros((), jnp.int32),
            substeps_max=jnp.max(res.naccept).astype(jnp.int32))

        return ModelState1D(state=S, particles=Particles1D(z=z, t=t, dt=dt,
                                                           on=on),
                            time=ms.time + DT, iteration=ms.iteration + 1,
                            metrics=metrics)

    # step_n / step_n_buffered / step_n_quiet / step_jit: StepDrivers
