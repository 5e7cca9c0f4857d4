"""WaveGrowth2D — the flagship model, as one pure jitted step function.

JAX re-design of the reference model + stepping stack
(src/Models/WaveGrowthModels2D.jl, src/Operators/mapping_2D.jl,
src/Operators/TimeSteppers.jl, src/Simulations/run.jl:72-115).  One model
time step ``DT`` is:

  1. zero the Eulerian state            (run.jl:74-79)
  2. ADVANCE: batched adaptive Tsit5 over every active particle, with the
     full reference state machine as masks — off-particle wind re-light,
     NaN/Inf windsea resets, log-energy clamp  (mapping_2D.jl:118-243)
  3. SCATTER: CIC deposit of (E, m_x, m_y) to the 4 surrounding nodes with
     periodic / non-periodic / tripolar-seam boundaries (ParticleInCell.jl)
  4. REMESH: per-node gather + reseed state machine (mapping_2D.jl:279-356)
  5. tick the clock                     (TimeSteppers.jl:163)

Everything is a masked dense operation over ``[nx, ny]`` arrays: no Python
control flow, no scatter in the hot loop beyond the pad-and-fold deposit,
fully shardable over a device mesh (see picles_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core import fetch_relations as FR
from ..core.constants import IDConstants, ODEParameters, ODESettings
from ..forcing.winds import (GriddedWinds2D, Winds2D,
                             gridded_pallas_samplers)
from ..grids.base import Grid2D
from ..ops import pic
from ..ops import transforms as TR
from ..ops.rhs import RHSParams, TermFlags, particle_equations
from ..ops.tsit5 import SolverConfig, auto_dt, integrate_to
from .drivers import StepDrivers
from .state import ModelState2D, Particles2D, StepMetrics

SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class ParticleDefaults2D:
    """Fixed particle initial state (reference core_2D.jl:40-58)."""

    lne: float
    cg_x: float
    cg_y: float
    x: float = 0.0
    y: float = 0.0


@dataclasses.dataclass(frozen=True)
class WaveGrowth2DConfig:
    """Static model configuration (the kwargs of the reference constructor,
    WaveGrowthModels2D.jl:194-208)."""

    periodic_boundary: bool = True
    # "wind_sea" -> seed/reset from local winds; or a ParticleDefaults2D
    ode_init_type: Union[str, ParticleDefaults2D] = "wind_sea"
    boundary_type: str = "same"   # "wind_sea" | "mininmal" | "same"
    # CIC deposit: "dense" (pad-and-fold shifted adds, deterministic) or
    # "xla" (index scatter-add; the oracle, no halo bound)
    scatter_mode: str = "dense"   # "dense" | "xla"
    # "auto" resolves LAZILY, at trace time (each step_core call asks
    # jax.default_backend()): the fused Pallas advance (Triton route) on
    # the GPU, the XLA while_loop elsewhere (numerics agree to solver
    # tolerance — cross-checked in tests and chip_smoke.py).  A model
    # constructed before device selection therefore compiles the right
    # advance when first stepped, and ``model.config`` round-trips the
    # user's "auto" (``model.resolved_config()`` shows what it resolves
    # to right now).  An explicit "pallas" off the GPU needs
    # ``pallas_interpret=True``.
    advance_mode: str = "auto"    # "auto" | "xla" | "pallas"
    # "auto": Hairer auto_dt on every reseed/gather (reference
    # auto_dt_reset! semantics, mapping_2D.jl:91-111).  "carry": warm
    # restart — keep the particle's adapted dt across the remesh; accuracy
    # is still governed by the embedded error controller (a too-large dt is
    # rejected and shrunk), but the steady-state substep count drops ~3-5x.
    dt_reset_mode: str = "auto"   # "auto" | "carry"
    # CIC displacement capacity in cells (dense scatter modes): an int H
    # (symmetric) or ((x_lo, x_hi), (y_lo, y_hi)) bounds.  Directional
    # regimes (e.g. constant trade winds) only displace one way, so
    # asymmetric bounds cut the deposit's (x_lo+x_hi+1)(y_lo+y_hi+1)
    # shifted adds vs (2H+1)^2; violations are clamped and counted in
    # metrics.n_clamped (a CFL-style capacity statement).
    halo: Union[int, Tuple[Tuple[int, int], Tuple[int, int]]] = 3
    layers: int = 1
    dtype: type = jnp.float32
    pallas_interpret: bool = False  # interpreter mode (CPU testing)


def _resolve_auto_modes(cfg: "WaveGrowth2DConfig") -> "WaveGrowth2DConfig":
    """Resolve ``advance_mode="auto"`` against the current default backend
    (called lazily from ``step_core``, NOT at model construction — see
    ``WaveGrowth2D.resolved_config``).

    The Triton advance compiles only for the GPU, where it beats the XLA
    while_loop end to end (docs/PERF.md); everywhere else ``"auto"`` is
    the XLA loop.  An explicit ``"pallas"`` that cannot compile here
    raises instead of silently interpreting or falling back.
    """
    backend = jax.default_backend()
    if cfg.advance_mode not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown advance_mode {cfg.advance_mode!r}")
    if cfg.scatter_mode not in ("dense", "xla"):
        raise ValueError(f"unknown scatter_mode {cfg.scatter_mode!r}")
    if cfg.advance_mode == "auto":
        return dataclasses.replace(
            cfg, advance_mode="pallas" if backend == "gpu" else "xla")
    if (cfg.advance_mode == "pallas" and backend != "gpu"
            and not cfg.pallas_interpret):
        raise ValueError(
            'advance_mode="pallas" is a Triton kernel and compiles only for '
            f"the GPU (default backend here: {backend!r}); pass "
            'pallas_interpret=True to run it in the interpreter, or use '
            'advance_mode="auto" / "xla"')
    return cfg


class WaveGrowth2D(StepDrivers):
    """Model factory: builds the RHS, seeds, and exposes ``step``.

    Parameters mirror the reference constructor: ``grid``, ``winds``
    (callable pair), ``ode_settings``, optional ``ode_params`` /
    ``constants`` / term flags, ``minimal_particle`` / ``minimal_state``
    overrides, and config switches.
    """

    def __init__(self, grid: Grid2D, winds: Winds2D,
                 ode_settings: ODESettings,
                 ode_params: Optional[ODEParameters] = None,
                 constants: Optional[IDConstants] = None,
                 flags: TermFlags = TermFlags(),
                 minimal_particle=None, minimal_state=None,
                 config: WaveGrowth2DConfig = WaveGrowth2DConfig(),
                 rhs: Optional[Callable] = None):
        self.grid = grid
        # gridded winds run on the Pallas path via their per-step
        # linearization (winds are node-sampled, so in-kernel time is the
        # only variable); detect both a GriddedWinds2D passed directly and
        # a Winds2D of its bound methods
        if isinstance(winds, GriddedWinds2D):
            self.gridded_winds: Optional[GriddedWinds2D] = winds
            winds = winds.as_winds()
        else:
            gw = getattr(getattr(winds, "u", None), "__self__", None)
            self.gridded_winds = gw if isinstance(gw, GriddedWinds2D) else None
        self.winds = winds
        self.settings = ode_settings
        # kept verbatim ("auto" intact) — kernel modes resolve lazily per
        # backend in resolved_config(), so a model built before device
        # selection still compiles the right kernel family at first step
        self.config = config
        if ode_params is None:
            ode_params, constants, _ = ODEParameters.create()
        self.params = ode_params
        self.constants = constants or IDConstants.create(r_g=ode_params.r_g)
        self.flags = flags
        self._rhs_override = rhs is not None
        self.rhs = rhs if rhs is not None else particle_equations(
            winds.u, winds.v, gamma=self.constants.gamma, params=self.params,
            constants=self.constants, flags=flags)

        DT = ode_settings.timestep
        # static breakpoint count of the exact piecewise-linear wind fields
        # on the Pallas path (see GriddedWinds2D.pallas_pwl_fields)
        self._wind_B = (self.gridded_winds.n_breakpoints(DT)
                        if self.gridded_winds is not None else 0)
        # reference defaults: MinimalParticle(2, 2, DT) / MinimalState(2, 2, DT)
        # (WaveGrowthModels2D.jl:234-246)
        self.minimal_particle = (jnp.asarray(minimal_particle, config.dtype)
                                 if minimal_particle is not None
                                 else jnp.asarray(FR.MinimalParticle(2.0, 2.0, DT),
                                                  config.dtype))
        self.minimal_state = (jnp.asarray(minimal_state, config.dtype)
                              if minimal_state is not None
                              else jnp.asarray(FR.MinimalState(2.0, 2.0, DT),
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

        # static node masks.  config.periodic_boundary=True means "treat
        # grid-edge (mask==3) nodes as wrapped interior" — only coherent
        # when BOTH grid axes are periodic (the deposit wraps per
        # grid.stats regardless); warn on the mismatch the reference's own
        # usage avoids (T03_PIC_sphere_aqua.jl: mixed grid -> model false)
        from ..grids.base import Boundary as _Bd

        if config.periodic_boundary and (grid.stats.bx == _Bd.NONPERIODIC
                                         or grid.stats.by == _Bd.NONPERIODIC):
            import warnings

            warnings.warn(
                "config.periodic_boundary=True on a grid with a "
                "non-periodic axis: the open-edge ring (mask==3) will be "
                "treated as active interior instead of boundary nodes; "
                "pass periodic_boundary=False for mixed-periodicity "
                "domains (reference T03_PIC_sphere_aqua.jl usage)",
                stacklevel=2)
        self.active_mask = grid.ocean_point_mask(config.periodic_boundary)
        self.boundary_mask = grid.boundary_point_mask(config.periodic_boundary)
        self.aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)

        # spatially uniform projection/great-circle coefficient (regular
        # Cartesian boxes): bake as scalars into the Pallas advance
        pj = np.asarray(grid.proj).reshape(-1, 4)
        pcn = np.asarray(grid.pc).reshape(-1)
        if (np.all(pj == pj[0]) and np.all(pcn == pcn[0])):
            self.uniform_proj: Optional[Tuple[float, ...]] = (
                float(pj[0, 0]), float(pj[0, 1]), float(pj[0, 2]),
                float(pj[0, 3]), float(pcn[0]))
        else:
            self.uniform_proj = None

        if config.ode_init_type == "mininmal":
            # reference WaveGrowthModels2D.jl:228
            self.defaults: Optional[ParticleDefaults2D] = \
                ParticleDefaults2D(-11.0, 1e-3, 0.0)
        elif isinstance(config.ode_init_type, ParticleDefaults2D):
            self.defaults = config.ode_init_type
        elif config.ode_init_type == "wind_sea":
            self.defaults = None
        else:
            raise ValueError("ode_init_type must be 'wind_sea', 'mininmal' "
                             "or a ParticleDefaults2D")

        # boundary_type -> what boundary nodes are reseeded to (reference
        # WaveGrowthModels2D.jl:273-292 builds `boundary_defaults` and
        # NodeToParticle! has a `PI.boundary & wind strong -> reseed`
        # branch, mapping_2D.jl:338-345 — but the reference wiring leaves
        # both dead: time_step! iterates ocean_points only, which never
        # intersects the boundary-flagged nodes, and passes ODEdefaults.
        # The intent (advance!'s commented-out `& ~PI.boundary` guards,
        # mapping_2D.jl:131/149/191) is an open-boundary inflow condition:
        # boundary particles do NOT integrate their ODE; each remesh they
        # are reseeded from boundary_defaults and scatter that state as-is.
        # Here that intended semantics is real for "wind_sea"/"mininmal";
        # "same" keeps the reference's actual behavior (inert boundary).
        if config.boundary_type == "wind_sea":
            # boundary reseeds from the local windsea (defaults = nothing)
            self.boundary_defaults: Optional[ParticleDefaults2D] = None
            self._boundary_source = True
        elif config.boundary_type == "mininmal":
            # fixed 5-minute 1.41 m/s minimal windsea
            # (WaveGrowthModels2D.jl:279-285)
            bws = FR.MinimalWindsea(1.0, 1.0, 5 * 60.0)
            self.boundary_defaults = ParticleDefaults2D(
                float(bws.lne), float(bws.cg_bar_x), float(bws.cg_bar_y))
            self._boundary_source = True
        elif config.boundary_type == "same":
            self.boundary_defaults = self.defaults
            self._boundary_source = False
        else:
            raise ValueError("boundary_type must be 'wind_sea', 'mininmal' "
                             "or 'same'")
        # "same" (and "wind_sea" when the model defaults are already
        # windsea) needs no separate boundary select in the remesh
        self._boundary_differs = (self.boundary_defaults is not self.defaults
                                  and not (self.boundary_defaults is None
                                           and self.defaults is None))

    def resolved_config(self) -> WaveGrowth2DConfig:
        """``self.config`` with "auto" kernel modes resolved against the
        CURRENT default backend.  Called from ``step_core`` at trace time,
        so resolution tracks device selection, not construction order;
        ``self.config`` itself round-trips the user's "auto"."""
        return _resolve_auto_modes(self.config)

    def _pallas_wind(self, grid, t0):
        """Kernel-side wind samplers + per-window field planes.

        Gridded winds ride the Pallas kernels as their exact piecewise-
        linear-in-t decomposition over the DT window (winds are node-
        sampled, so time is the only in-kernel variable); analytic winds
        pass straight through with no fields."""
        if self.gridded_winds is not None:
            u_k, v_k = gridded_pallas_samplers(self._wind_B)
            fields = self.gridded_winds.pallas_pwl_fields(
                grid.x, grid.y, t0, float(self.settings.timestep))
            return u_k, v_k, fields
        return self.winds.u, self.winds.v, ()

    # ------------------------------------------------------------------
    # seeding
    # ------------------------------------------------------------------

    def _reset_values(self, u, v, defaults="model"):
        """Vectorized ResetParticleValues (reference core_2D.jl:307-343):
        windsea from local winds when no defaults are set, otherwise the
        fixed defaults.  Returns (lne, cgx, cgy) component planes;
        positions reset to (0, 0) at the call sites.  ``defaults`` selects
        the ParticleDefaults2D source ("model" = self.defaults; the remesh
        boundary branch passes self.boundary_defaults)."""
        dtype = self.config.dtype
        d = self.defaults if defaults == "model" else defaults
        if d is None:
            ws = FR.get_initial_windsea(u, v, self.settings.timestep)
            return (ws.lne.astype(dtype), ws.cg_bar_x.astype(dtype),
                    ws.cg_bar_y.astype(dtype))
        shp = jnp.shape(u)
        return tuple(jnp.broadcast_to(jnp.asarray(val, dtype), shp)
                     for val in (d.lne, d.cg_x, d.cg_y))

    def init_state(self, defaults="model") -> ModelState2D:
        """Vectorized particle seeding (reference SeedParticle,
        core_2D.jl:434-488 + init_particles!, run.jl:199-247).

        ``defaults``: "model" uses the configured ode_init_type; a
        ParticleDefaults2D or None overrides it (the per-layer seeding
        path, reference T06_layers.jl)."""
        cfg = self.config
        g = self.grid
        d = self.defaults if defaults == "model" else defaults
        u0, v0 = self.winds(g.x, g.y, jnp.zeros_like(g.x))
        u0 = jnp.broadcast_to(jnp.asarray(u0, cfg.dtype), g.x.shape)
        v0 = jnp.broadcast_to(jnp.asarray(v0, cfg.dtype), g.x.shape)
        wind_speed = jnp.sqrt(u0 ** 2 + v0 ** 2)

        land = g.mask == 0
        if d is None:
            strong = wind_speed > SQRT2  # reference core_2D.jl:258
            sea = FR.get_initial_windsea(u0, v0, self.settings.timestep)
            wmin = FR.MinimalWindsea(u0, v0, self.settings.timestep)
            lne = jnp.where(strong, sea.lne, wmin.lne).astype(cfg.dtype)
            cgx = jnp.where(strong, sea.cg_bar_x,
                            wmin.cg_bar_x).astype(cfg.dtype)
            cgy = jnp.where(strong, sea.cg_bar_y,
                            wmin.cg_bar_y).astype(cfg.dtype)
            on = strong & ~land
        else:
            lne, cgx, cgy = self._reset_values(u0, v0, defaults=d)
            on = ~land

        e, mx, my = TR.particle_to_node(lne, cgx, cgy)
        state = jnp.stack([e, mx, my], axis=-1) * on[..., None].astype(cfg.dtype)

        zero = jnp.zeros(g.x.shape, cfg.dtype)
        particles = Particles2D(
            lne=lne, cgx=cgx, cgy=cgy, px=zero, py=zero,
            t=jnp.zeros(g.x.shape, cfg.dtype),
            dt=jnp.full(g.x.shape, self.settings.dt, cfg.dtype),
            on=on)
        return ModelState2D(state=state.astype(cfg.dtype), particles=particles,
                            time=jnp.zeros((), cfg.dtype),
                            iteration=jnp.zeros((), jnp.int32),
                            metrics=StepMetrics.zeros())

    # ------------------------------------------------------------------
    # one model step
    # ------------------------------------------------------------------

    def step(self, ms: ModelState2D) -> ModelState2D:
        """One DT: advance -> scatter -> remesh -> tick (pure; jit me)."""
        return self.step_core(ms, self.grid, self.active_mask,
                              self.boundary_mask, None)

    def step_core(self, ms: ModelState2D, grid: Grid2D,
                  active: jnp.ndarray, boundary: jnp.ndarray,
                  scatter_fn: Optional[Callable],
                  psum_axes: Optional[Tuple[str, ...]] = None) -> ModelState2D:
        """Step body over explicit (possibly shard-local) grid arrays.

        ``scatter_fn(xrel, yrel, charge, act) -> (S, stats)`` overrides the
        deposit (the sharded path injects a halo-exchange version); None
        selects the local config scatter.  Everything else is elementwise
        and runs unchanged under ``shard_map``.
        """
        cfg = self.resolved_config()
        sett = self.settings
        DT = jnp.asarray(sett.timestep, cfg.dtype)
        P = ms.particles
        aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)

        # ---------------- ADVANCE ----------------
        adv = P.on & active
        comps0 = (P.lne, P.cgx, P.cgy, P.px, P.py)
        if cfg.advance_mode == "pallas":
            from ..ops.advance_pallas import advance_pallas
            from ..ops.rhs import make_rhs_consts

            consts = make_rhs_consts(gamma=self.constants.gamma,
                                     constants=self.constants,
                                     params=self.params)
            u_k, v_k, wind_fields = self._pallas_wind(grid, ms.time)
            pres = advance_pallas(u_k, v_k, consts,
                                  self.flags, self.solver,
                                  float(sett.timestep), comps0,
                                  P.t, P.dt, adv,
                                  grid.x, grid.y,
                                  self.uniform_proj or grid.proj, grid.pc,
                                  wind_fields=wind_fields,
                                  interpret=cfg.pallas_interpret)
            res_c = (pres.lne, pres.cgx, pres.cgy, pres.x, pres.y)
            res_t, res_dt = pres.t, pres.dt
            res_failed, res_naccept = pres.failed, pres.naccept
        else:
            res = integrate_to(self.rhs, jnp.stack(comps0, axis=-1), P.t,
                               P.t + DT, P.dt, aux, adv, self.solver)
            res_c = tuple(res.z[..., i] for i in range(5))
            res_t, res_dt = res.t, res.dt
            res_failed, res_naccept = res.failed, res.naccept
        failed = res_failed & adv
        lne, cgx, cgy, px, py = (jnp.where(adv, rc, c0)
                                 for rc, c0 in zip(res_c, comps0))
        t = jnp.where(adv, res_t, P.t)
        dt = jnp.where(adv, res_dt, P.dt)
        on = P.on

        # off-particle re-light at (lagged) t_end (mapping_2D.jl:172-185)
        off = ~P.on & active
        t_end_off = P.t + DT
        u_end, v_end = self.winds(grid.x, grid.y, t_end_off)
        u_end = jnp.broadcast_to(jnp.asarray(u_end, cfg.dtype), t.shape)
        v_end = jnp.broadcast_to(jnp.asarray(v_end, cfg.dtype), t.shape)
        wind2_end = u_end ** 2 + v_end ** 2
        relight = off & (wind2_end >= sett.wind_min_squared)

        # guards (mapping_2D.jl:196-235); not applied to failed lanes
        guardable = active & ~failed
        isbad = lambda f: f(lne) | f(cgx) | f(cgy)  # noqa: E731
        nan_mask = guardable & isbad(jnp.isnan)
        inf_mask = guardable & ~nan_mask & isbad(jnp.isinf)
        bad = nan_mask | inf_mask

        # re-light and NaN/Inf guard both reset to the local windsea at
        # t_start + DT with positions (0, 0)
        reset_adv = relight | bad
        lne_r, cgx_r, cgy_r = self._reset_values(u_end, v_end)
        lne = jnp.where(reset_adv, lne_r, lne)
        cgx = jnp.where(reset_adv, cgx_r, cgx)
        cgy = jnp.where(reset_adv, cgy_r, cgy)
        px = jnp.where(reset_adv, 0.0, px)
        py = jnp.where(reset_adv, 0.0, py)
        on = on | relight

        emax_mask = guardable & ~bad & (lne > sett.log_energy_maximum)
        lne = jnp.where(emax_mask,
                        jnp.asarray(sett.log_energy_maximum, cfg.dtype), lne)
        was_reset_adv = relight | bad | emax_mask

        # boundary-source nodes: hold their reseeded boundary_defaults
        # (never integrated) and scatter them as-is — the open-boundary
        # inflow condition (see __init__ boundary_type notes)
        bsrc = boundary if self._boundary_source else jnp.zeros_like(boundary)

        # ---------------- SCATTER ----------------
        scatter_on = (on & active & ~failed) | (on & bsrc)
        e, mx, my = TR.particle_to_node(lne, cgx, cgy)
        if scatter_fn is None:
            (e_n, mx_n, my_n), sc_stats = pic.scatter_channels(
                px, py, (e, mx, my), scatter_on, grid.stats, cfg.halo,
                cfg.scatter_mode)
        else:
            S_sh, sc_stats = scatter_fn(px, py,
                                        jnp.stack([e, mx, my], axis=-1),
                                        scatter_on)
            e_n, mx_n, my_n = S_sh[..., 0], S_sh[..., 1], S_sh[..., 2]

        # ---------------- REMESH ----------------
        # winds at the pre-tick clock time (TimeSteppers.jl:144-151)
        u_i, v_i = self.winds(grid.x, grid.y,
                              jnp.broadcast_to(ms.time, t.shape))
        u_i = jnp.broadcast_to(jnp.asarray(u_i, cfg.dtype), t.shape)
        v_i = jnp.broadcast_to(jnp.asarray(v_i, cfg.dtype), t.shape)
        wind2_i = u_i ** 2 + v_i ** 2

        m2_n = mx_n ** 2 + my_n ** 2
        part = active | bsrc   # nodes the remesh state machine touches
        gather = (part & ~boundary
                  & (e_n >= self.minimal_state[0])
                  & (m2_n >= self.minimal_state[1]))
        wind_ok = wind2_i >= sett.wind_min_squared
        reseed = part & ~gather & wind_ok
        go_off = part & ~gather & ~reseed

        lne_g, cgx_g, cgy_g = TR.node_to_particle(e_n, mx_n, my_n)
        lne_s, cgx_s, cgy_s = self._reset_values(u_i, v_i)
        if self._boundary_differs:
            # boundary reseed branch uses boundary_defaults
            # (mapping_2D.jl:338-345 + WaveGrowthModels2D.jl:273-292)
            lne_b, cgx_b, cgy_b = self._reset_values(
                u_i, v_i, defaults=self.boundary_defaults)
            lne_s = jnp.where(boundary, lne_b, lne_s)
            cgx_s = jnp.where(boundary, cgx_b, cgx_s)
            cgy_s = jnp.where(boundary, cgy_b, cgy_s)

        lne = jnp.where(gather, lne_g, jnp.where(reseed, lne_s, lne))
        cgx = jnp.where(gather, cgx_g, jnp.where(reseed, cgx_s, cgx))
        cgy = jnp.where(gather, cgy_g, jnp.where(reseed, cgy_s, cgy))
        px = jnp.where(gather | reseed, 0.0, px)
        py = jnp.where(gather | reseed, 0.0, py)
        on_before_remesh = on
        on = jnp.where(part, (gather | reseed), on)

        # dt reset (auto_dt_reset!) for every lane whose u was replaced
        was_reset = was_reset_adv | gather | reseed
        if not sett.adaptive:
            # fixed-substep mode: dt is the configured constant sub-step —
            # no controller, no Hairer estimate (reference adaptive=false,
            # core_2D.jl:185)
            pass
        elif cfg.dt_reset_mode == "carry":
            # warm restart: keep each lane's adapted dt (clipped into range);
            # the error controller re-shrinks it if the reseeded state needs
            # smaller steps.  Skips the auto_dt RHS evaluations entirely.
            dt = jnp.clip(dt, sett.dtmin, DT)
        else:
            dt_auto = auto_dt(self.rhs,
                              t, jnp.stack([lne, cgx, cgy, px, py], axis=-1),
                              aux, abstol=sett.abstol, reltol=sett.reltol,
                              order=self._rk_order)
            dt = jnp.where(was_reset, jnp.clip(dt_auto, sett.dtmin, DT), dt)

        metrics = self._build_metrics(
            psum_axes, adv=adv, failed=failed, nan_mask=nan_mask,
            inf_mask=inf_mask, emax_mask=emax_mask, relight=relight,
            # n_off counts TRANSITIONS (was on, switched off this remesh),
            # not the standing population of off nodes — a calm half-domain
            # would otherwise report ~nx*ny/2 "switched off" every step
            gather=gather, reseed=reseed, off=go_off & on_before_remesh,
            clamped=sc_stats.clamped, naccept=res_naccept)

        particles = Particles2D(lne=lne, cgx=cgx, cgy=cgy, px=px, py=py,
                                t=t, dt=dt, on=on)
        S = jnp.stack([e_n, mx_n, my_n], axis=-1)
        return ModelState2D(state=S, particles=particles,
                            time=ms.time + DT,
                            iteration=ms.iteration + 1,
                            metrics=metrics)

    # ------------------------------------------------------------------

    @staticmethod
    def _build_metrics(psum_axes, *, adv, failed, nan_mask, inf_mask,
                       emax_mask, relight, gather, reseed, off, clamped,
                       naccept) -> StepMetrics:
        """Per-step counters, psum/pmax-reduced across the mesh when the
        step runs inside shard_map)."""
        if psum_axes:
            def _count(x):
                return jax.lax.psum(jnp.sum(x).astype(jnp.int32), psum_axes)

            def _maxred(x):
                return jax.lax.pmax(jnp.max(x).astype(jnp.int32), psum_axes)

            n_cl = jax.lax.psum(jnp.asarray(clamped, jnp.int32), psum_axes)
        else:
            def _count(x):
                return jnp.sum(x).astype(jnp.int32)

            def _maxred(x):
                return jnp.max(x).astype(jnp.int32)

            n_cl = jnp.asarray(clamped, jnp.int32)
        return StepMetrics(
            n_active=_count(adv), n_failed=_count(failed),
            n_nan_reset=_count(nan_mask), n_inf_reset=_count(inf_mask),
            n_emax_clamp=_count(emax_mask), n_relight=_count(relight),
            n_gather=_count(gather), n_reseed=_count(reseed),
            n_off=_count(off), n_clamped=n_cl,
            substeps_max=_maxred(naccept))

    # ------------------------------------------------------------------
    # layers (reference `layers` State dimension, WaveGrowthModels2D.jl:112-119;
    # the per-layer particle types of T06 don't exist in the reference src —
    # here every layer is a full particle system, vmapped)
    # ------------------------------------------------------------------

    def init_state_layers(self, per_layer_defaults=None) -> ModelState2D:
        """Seed ``config.layers`` wave systems along a leading axis.

        ``per_layer_defaults``: optional length-L sequence of
        ParticleDefaults2D / None (windsea) — each layer seeds its own
        system (multiple swell partitions, reference T06_layers.jl).
        Without it every layer starts as an identical copy."""
        L = self.config.layers
        if per_layer_defaults is None:
            base = self.init_state()

            def bc(x):
                return jnp.broadcast_to(x, (L,) + x.shape)

            # metrics are per-layer [L] after step_layers: stack at init
            # too so scan/fori_loop carries are type-stable
            return ModelState2D(
                state=bc(base.state),
                particles=jax.tree.map(bc, base.particles),
                time=base.time, iteration=base.iteration,
                metrics=jax.tree.map(bc, base.metrics))
        if len(per_layer_defaults) != L:
            raise ValueError(f"need {L} per-layer defaults, "
                             f"got {len(per_layer_defaults)}")
        states = [self.init_state(defaults=d) for d in per_layer_defaults]
        stack = lambda *xs: jnp.stack(xs)  # noqa: E731
        return ModelState2D(
            state=jnp.stack([s.state for s in states]),
            particles=jax.tree.map(stack, *[s.particles for s in states]),
            time=states[0].time, iteration=states[0].iteration,
            metrics=jax.tree.map(stack, *[s.metrics for s in states]))

    def step_layers(self, ms: ModelState2D) -> ModelState2D:
        """vmap the step over the leading layer axis (shared clock;
        metrics are per-layer [L] arrays in and out)."""
        per_layer = StepMetrics(*([0] * len(StepMetrics._fields)))
        p_axes0 = Particles2D(lne=0, cgx=0, cgy=0, px=0, py=0,
                              t=0, dt=0, on=0)
        in_axes = ModelState2D(state=0, particles=p_axes0, time=None,
                               iteration=None, metrics=per_layer)
        out_axes = ModelState2D(state=0, particles=p_axes0, time=None,
                                iteration=None, metrics=per_layer)
        return jax.vmap(self.step, in_axes=(in_axes,),
                        out_axes=out_axes)(ms)

    def with_winds(self, winds) -> "WaveGrowth2D":
        """A model sharing this one's grid/settings/constants but forced by
        different winds (used by per-layer wind forcing)."""
        if self._rhs_override:
            raise ValueError(
                "with_winds cannot rebuild a model constructed with a "
                "custom `rhs` (the override closes over its own winds); "
                "build the per-layer models explicitly instead.")
        return WaveGrowth2D(self.grid, winds, self.settings,
                            ode_params=self.params, constants=self.constants,
                            flags=self.flags,
                            minimal_particle=self.minimal_particle,
                            minimal_state=self.minimal_state,
                            config=self.config)

    def as_layered(self, per_layer_defaults=None,
                   per_layer_winds=None) -> "LayeredWaveGrowth2D":
        """Driver-compatible layered view (reference `layers` kwarg,
        WaveGrowthModels2D.jl:112-119): Simulation/StateStore work
        unchanged and store ``[time, layer, x, y, state]``."""
        return LayeredWaveGrowth2D(self, per_layer_defaults, per_layer_winds)

    # step_n / step_n_buffered / step_n_quiet / step_jit: StepDrivers

    def fields(self, ms: ModelState2D):
        """Reference ``fields(model)`` (WaveGrowthModels2D.jl:355)."""
        return dict(State=ms.state)


class LayeredWaveGrowth2D(StepDrivers):
    """Layered driver adapter: the Simulation/StateStore-facing surface of
    a WaveGrowth2D with ``config.layers > 1`` (reference 4D State,
    WaveGrowthModels2D.jl:112-119; exercised by tests/T06_layers.jl).

    Each layer is a full particle system vmapped over a leading axis with
    a shared clock; states are ``[L, nx, ny, 3]`` and a StateStore-backed
    run stores ``[time, layer, x, y, state]``.
    """

    def __init__(self, model: WaveGrowth2D, per_layer_defaults=None,
                 per_layer_winds=None):
        self.model = model
        self.per_layer_defaults = per_layer_defaults
        self.settings = model.settings
        self.grid = model.grid
        self.layers = model.config.layers
        # per-layer wind forcing (each swell system driven by its own
        # sampler): one model variant per layer sharing grid/settings,
        # stepped unrolled at trace time (L is small) — arbitrary wind
        # closures cannot ride a single vmap
        if per_layer_winds is not None:
            if len(per_layer_winds) != self.layers:
                raise ValueError(f"need {self.layers} per-layer winds, "
                                 f"got {len(per_layer_winds)}")
            self.layer_models = [model.with_winds(w) for w in per_layer_winds]
        else:
            self.layer_models = None

    @staticmethod
    def _layer_slice(ms: ModelState2D, i: int) -> ModelState2D:
        take = lambda x: x[i]  # noqa: E731
        return ModelState2D(state=ms.state[i],
                            particles=jax.tree.map(take, ms.particles),
                            time=ms.time, iteration=ms.iteration,
                            metrics=jax.tree.map(take, ms.metrics))

    @staticmethod
    def _layer_stack(parts) -> ModelState2D:
        stack = lambda *xs: jnp.stack(xs)  # noqa: E731
        return ModelState2D(
            state=jnp.stack([p.state for p in parts]),
            particles=jax.tree.map(stack, *[p.particles for p in parts]),
            time=parts[0].time, iteration=parts[0].iteration,
            metrics=jax.tree.map(stack, *[p.metrics for p in parts]))

    def init_state(self) -> ModelState2D:
        if self.layer_models is not None:
            defaults = (self.per_layer_defaults
                        or ["model"] * self.layers)
            return self._layer_stack(
                [m.init_state(defaults=d)
                 for m, d in zip(self.layer_models, defaults)])
        return self.model.init_state_layers(self.per_layer_defaults)

    def step(self, ms: ModelState2D) -> ModelState2D:
        if self.layer_models is not None:
            return self._layer_stack(
                [m.step(self._layer_slice(ms, i))
                 for i, m in enumerate(self.layer_models)])
        return self.model.step_layers(ms)

    # step_n / step_n_buffered / step_n_quiet / step_jit: StepDrivers

    def fields(self, ms: ModelState2D):
        return dict(State=ms.state)
