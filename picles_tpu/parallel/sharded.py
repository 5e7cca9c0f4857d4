"""Multi-chip execution: shard_map'd model step with halo exchange.

The reference parallelizes with `@threads` over a SharedArray on one host
plus an experimental Distributed/DArray block partition
(TimeSteppers.jl:144-180, tests/T05_2D_distributed_particles.jl).  This
design block-shards the ``[nx, ny]`` particle/grid arrays over a
2D device mesh; the model step is embarrassingly parallel except the CIC
deposit, whose inter-shard traffic is exactly the halo slabs of the padded
accumulator (picles_tpu.ops.pic.scatter_accumulate_padded):

 - interior edges: the H-wide x/y halo slabs ride ``ppermute`` rings to the
   neighboring shard and are added to its core — one bidirectional exchange
   per axis per step over the device interconnect,
 - domain edges fall out of the ``ppermute`` permutation: a periodic domain
   closes the ring (wrap == neighbor-add), a non-periodic one omits the wrap
   link so edge shards receive zeros (== the reference's silent drop,
   ParticleInCell.jl:318-338),
 - the tripolar north seam all-gathers the top halo slab along x (H rows of
   the global grid), applies the global x-flip fold, and each top-row shard
   adds back its slice (TripolarNorthBoundary, ParticleInCell.jl:409-428).

Everything else in the step (ODE advance, guards, remesh) needs no
communication; metrics are ``psum``-reduced.

Multi-host runs: call ``jax.distributed.initialize()`` before building the
mesh (``make_mesh`` defaults to ``jax.devices()``, which is GLOBAL across
processes); ``shard_state`` detects ``jax.process_count() > 1`` and
contributes per-host shards via ``make_array_from_callback``.  The step
itself is a ``shard_map`` over named mesh axes and is process-agnostic —
its ppermute/all_gather collectives run over the device interconnect
(NVLink within a host), as laid out by the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..grids.base import Boundary, Grid2D
from ..models.state import ModelState2D, Particles2D, StepMetrics
from ..ops import pic


def make_mesh(devices=None, shape: Optional[Tuple[int, int]] = None,
              axis_names=("x", "y")) -> Mesh:
    """Build a 2D device mesh; defaults to all devices in a (n, 1) layout."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (devices.size, 1)
    return Mesh(devices.reshape(shape), axis_names)


def _ring_perm(n: int, wrap: bool, reverse: bool = False):
    """Permutation for sending slabs one step along a mesh axis."""
    if reverse:  # send to the left neighbor (i -> i-1)
        perm = [(i, i - 1) for i in range(1, n)]
        if wrap and n > 0:
            perm.append((0, n - 1))
    else:        # send to the right neighbor (i -> i+1)
        perm = [(i, i + 1) for i in range(n - 1)]
        if wrap and n > 0:
            perm.append((n - 1, 0))
    return perm


def grid_specs(grid: Grid2D) -> Grid2D:
    """PartitionSpec pytree matching Grid2D leaves."""
    return Grid2D(x=P("x", "y"), y=P("x", "y"), dx_m=P("x", "y"),
                  dy_m=P("x", "y"), area=P("x", "y"), angle=P("x", "y"),
                  mask=P("x", "y"), proj=P("x", "y", None, None),
                  pc=P("x", "y"), stats=grid.stats)


def state_specs(layered: bool = False) -> ModelState2D:
    """PartitionSpecs for a ModelState2D; ``layered=True`` for states with
    a leading (replicated) layer axis ``[L, nx, ny, ...]`` whose metrics
    are per-layer ``[L]`` arrays."""
    lead = (None,) if layered else ()
    pxy = P(*lead, "x", "y")
    pmet = P(None) if layered else P()
    return ModelState2D(
        state=P(*lead, "x", "y", None),
        particles=Particles2D(lne=pxy, cgx=pxy, cgy=pxy, px=pxy, py=pxy,
                              t=pxy, dt=pxy, on=pxy),
        time=P(), iteration=P(),
        metrics=StepMetrics(*([pmet] * len(StepMetrics._fields))))


class ShardedWaveGrowth2D:
    """Wraps a WaveGrowth2D model with a shard_map'd step over ``mesh``.

    Usage:
        sharded = ShardedWaveGrowth2D(model, mesh)
        ms = sharded.shard_state(model.init_state())
        ms = sharded.step(ms)        # jitted, collective halo exchange
    """

    def __init__(self, model, mesh: Mesh):
        self.model = model
        self.mesh = mesh
        self.nx_dev = mesh.shape["x"]
        self.ny_dev = mesh.shape["y"]
        # layered models (config.layers > 1): the step vmaps over the
        # leading layer axis INSIDE the shard_map body — every layer
        # shares the mesh, layer planes are [L, nx/px, ny/py] per shard
        # (reference `layers` State dimension, WaveGrowthModels2D.jl:112-119)
        self.layers = int(getattr(getattr(model, "config", None),
                                  "layers", 1) or 1)
        if not hasattr(model, "step_core"):
            raise TypeError(
                "ShardedWaveGrowth2D wraps a WaveGrowth2D model; for a "
                "LayeredWaveGrowth2D adapter pass its `.model` (layers "
                "shard automatically when config.layers > 1). Per-layer "
                "winds are a single-device feature (each layer closes "
                "over its own wind sampler).")
        g = model.grid
        if g.nx % self.nx_dev or g.ny % self.ny_dev:
            raise ValueError(
                f"grid {g.nx}x{g.ny} not divisible by mesh "
                f"{self.nx_dev}x{self.ny_dev}")
        self._step = self._build_step()

    # ------------------------------------------------------------------

    def _scatter_sharded(self, xrel, yrel, charge, act):
        """Local accumulate + ppermute halo exchange + boundary folds.

        Halo slab widths follow the (possibly asymmetric) halo bounds: the
        low-side slab (width x_lo) belongs to the left neighbor's tail, the
        high-side slab (width x_hi) to the right neighbor's head.
        """
        model = self.model
        (xl, xh), (yl, yh) = pic.normalize_halo(model.config.halo)
        st = model.grid.stats
        nxd, nyd = self.nx_dev, self.ny_dev

        Pacc, stats = pic.scatter_accumulate_padded(
            xrel, yrel, charge, act, model.config.halo)
        nxl = Pacc.shape[0] - xl - xh
        nyl = Pacc.shape[1] - yl - yh

        # ---- x axis ----
        wrap_x = st.bx == Boundary.PERIODIC or st.bx == Boundary.TRIPOLAR_NORTH
        Q = Pacc[xl:xl + nxl]
        if xl:
            left_halo = Pacc[:xl]         # belongs to left neighbor's tail
            from_right = jax.lax.ppermute(left_halo, "x",
                                          _ring_perm(nxd, wrap_x, reverse=True))
            Q = Q.at[nxl - xl:].add(from_right)
        if xh:
            right_halo = Pacc[xl + nxl:]  # belongs to right neighbor's head
            from_left = jax.lax.ppermute(right_halo, "x",
                                         _ring_perm(nxd, wrap_x, reverse=False))
            Q = Q.at[:xh].add(from_left)

        # ---- y axis ----
        wrap_y = st.by == Boundary.PERIODIC
        top_halo = Q[:, yl + nyl:]
        S = Q[:, yl:yl + nyl]
        if yl:
            bot_halo = Q[:, :yl]
            from_top = jax.lax.ppermute(bot_halo, "y",
                                        _ring_perm(nyd, wrap_y, reverse=True))
            S = S.at[:, nyl - yl:].add(from_top)
        if yh:
            from_bot = jax.lax.ppermute(top_halo, "y",
                                        _ring_perm(nyd, wrap_y, reverse=False))
            S = S.at[:, :yh].add(from_bot)

        if st.by == Boundary.TRIPOLAR_NORTH:
            # global x-flip fold of the top halo; only the top y-row of
            # shards receives it (mirrors pic.fold_padded_y tripolar branch).
            full_top = jax.lax.all_gather(top_halo, "x", axis=0, tiled=True)
            nx_glob = full_top.shape[0]
            ix = jax.lax.axis_index("x")
            iy = jax.lax.axis_index("y")
            is_top = (iy == nyd - 1).astype(S.dtype)
            my_x0 = ix * nxl
            for k in range(yh):
                row = full_top[:, k]                       # [nx_glob, C]
                folded = jnp.roll(row[::-1], -1, axis=0)    # x' = nx-2-x mod nx
                my_slice = jax.lax.dynamic_slice_in_dim(folded, my_x0, nxl, 0)
                S = S.at[:, nyl - 1 - k].add(is_top * my_slice)
        return S, stats

    # ------------------------------------------------------------------

    def _build_step(self):
        model = self.model
        gspec = grid_specs(model.grid)
        layered = self.layers > 1
        msspec = state_specs(layered)

        def local_step(ms, grid, active, boundary):
            return model.step_core(ms, grid, active, boundary,
                                   self._scatter_sharded,
                                   psum_axes=("x", "y"))

        if layered:
            met0 = StepMetrics(*([0] * len(StepMetrics._fields)))
            p0 = Particles2D(lne=0, cgx=0, cgy=0, px=0, py=0, t=0, dt=0, on=0)
            ms_ax = ModelState2D(state=0, particles=p0, time=None,
                                 iteration=None, metrics=met0)

            def body(ms, grid, active, boundary):
                # vmap over layers inside the shard: collectives keep
                # acting on the named mesh axes, batched over L
                return jax.vmap(local_step, in_axes=(ms_ax, None, None, None),
                                out_axes=ms_ax)(ms, grid, active, boundary)
        else:
            body = local_step

        sharded = shard_map(
            body, mesh=self.mesh,
            in_specs=(msspec, gspec, P("x", "y"), P("x", "y")),
            out_specs=msspec,
            check_vma=False)

        def step(ms):
            return sharded(ms, model.grid, model.active_mask,
                           model.boundary_mask)

        return jax.jit(step)

    def step(self, ms: ModelState2D) -> ModelState2D:
        return self._step(ms)

    def step_n(self, ms: ModelState2D, n: int):
        def body(carry, _):
            nxt = self._step(carry)
            return nxt, nxt.state

        return jax.lax.scan(body, ms, None, length=n)

    # -- Simulation-driver surface (Simulation.run works sharded) -------

    @property
    def settings(self):
        return self.model.settings

    @property
    def grid(self):
        return self.model.grid

    def init_state(self) -> ModelState2D:
        """Seed on host semantics, then place with the step's shardings."""
        ms = (self.model.init_state_layers() if self.layers > 1
              else self.model.init_state())
        return self.shard_state(ms)

    def step_n_quiet(self, ms: ModelState2D, n) -> ModelState2D:
        """n sharded steps with no per-step output (the storeless
        Simulation.run path); ``n`` is a traced scalar."""
        return jax.lax.fori_loop(0, n, lambda _, s: self._step(s), ms)

    # ------------------------------------------------------------------

    def shard_state(self, ms: ModelState2D) -> ModelState2D:
        """Place a (host/global) ModelState onto the mesh with the step's
        shardings so no resharding happens inside the loop.

        Multi-host runs (jax.process_count() > 1 after
        ``jax.distributed.initialize``): ``device_put`` cannot target
        non-addressable devices, so each process contributes its
        addressable shards via ``make_array_from_callback`` — every host
        computes the same deterministic global seed state and slices its
        own blocks out of it.
        """
        specs = state_specs(self.layers > 1)
        if jax.process_count() > 1:
            def put(x, s):
                sharding = NamedSharding(self.mesh, s)
                host = np.asarray(jax.device_get(x))
                return jax.make_array_from_callback(
                    host.shape, sharding, lambda idx: host[idx])
        else:
            def put(x, s):
                return jax.device_put(x, NamedSharding(self.mesh, s))
        return jax.tree.map(put, ms, specs)

    def shard_grid_and_masks(self):
        """Optionally pre-place grid arrays (XLA would otherwise reshard on
        first use)."""
        m = self.model
        gspec = grid_specs(m.grid)
        m.grid = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s))
            if isinstance(s, P) else x, m.grid, gspec)
        m.active_mask = jax.device_put(
            m.active_mask, NamedSharding(self.mesh, P("x", "y")))
        m.boundary_mask = jax.device_put(
            m.boundary_mask, NamedSharding(self.mesh, P("x", "y")))
