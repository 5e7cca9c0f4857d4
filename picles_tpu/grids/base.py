"""Grid data model: one pytree dataclass for all grid families.

The reference's grid type zoo (TwoDCartesianGridMesh / TwoDSphericalGridMesh /
MOM6GridMesh, each a StructArray + stats + projection/correction closures;
src/Grids/*.jl) collapses here into a single ``Grid2D`` pytree: dense per-node
arrays (coordinates, metric spacings, mask, projection matrices, great-circle
coefficients) plus a hashable static ``GridStats``.  Per-node *closures*
become per-node *arrays* — the idiomatic JAX representation, directly
shardable along (x, y).

Mask convention (reference src/Grids/mask_utils.jl:25-55):
  0 = land, 1 = ocean, 2 = land boundary, 3 = grid boundary.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class Boundary(enum.IntEnum):
    """Axis boundary types (reference custom_structures.jl:51-61)."""

    PERIODIC = 0        # N_Periodic
    NONPERIODIC = 1     # N_NonPeriodic
    TRIPOLAR_NORTH = 2  # N_TripolarNorth


@dataclasses.dataclass(frozen=True)
class GridStats:
    """Static (hashable) grid metadata — the analog of the reference's
    TwoDCartesianGridStatistics etc. (CartesianGrid.jl:26-64)."""

    nx: int
    ny: int
    bx: Boundary
    by: Boundary
    xmin: float = 0.0
    xmax: float = 0.0
    ymin: float = 0.0
    ymax: float = 0.0
    dx: float = 1.0        # nominal spacing (meters or degrees)
    dy: float = 1.0
    angle: float = 0.0
    kind: str = "cartesian"  # cartesian | spherical | tripolar | regular1d

    @property
    def periodic(self) -> Tuple[bool, bool]:
        return (self.bx == Boundary.PERIODIC,
                self.by in (Boundary.PERIODIC,))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Dense grid pytree.

    data fields (all ``[nx, ny]`` unless noted):
      x, y      : node coordinates (meters for cartesian, degrees for
                  spherical/tripolar)
      dx_m, dy_m: metric spacing in meters per grid step
      area      : cell area in m^2
      angle     : local rotation of the grid x-axis (radians; tripolar)
      mask      : int32 {0 land, 1 ocean, 2 land-bnd, 3 grid-bnd}
      proj      : [nx, ny, 2, 2] projection matrices, m/s -> grid-index/s
                  (the reference's per-node ProjetionKernel closures)
      pc        : great-circle propagation-correction coefficient
                  (tan(lat)/R clamped; 0 for cartesian)
    """

    x: jnp.ndarray
    y: jnp.ndarray
    dx_m: jnp.ndarray
    dy_m: jnp.ndarray
    area: jnp.ndarray
    angle: jnp.ndarray
    mask: jnp.ndarray
    proj: jnp.ndarray
    pc: jnp.ndarray
    stats: GridStats = dataclasses.field(metadata=dict(static=True),
                                         default=None)

    @property
    def nx(self) -> int:
        return self.stats.nx

    @property
    def ny(self) -> int:
        return self.stats.ny

    def ocean_point_mask(self, periodic_boundary: bool) -> jnp.ndarray:
        """Nodes that carry active particles (reference
        WaveGrowthModels2D.jl:255-270): ocean plus — when the domain is
        periodic — the grid-boundary ring."""
        if periodic_boundary:
            return (self.mask == 1) | (self.mask == 3)
        return self.mask == 1

    def boundary_point_mask(self, periodic_boundary: bool) -> jnp.ndarray:
        """Per-particle ``boundary`` flag (reference core_2D.jl:360-366):
        land-boundary nodes always; grid-boundary nodes only when the domain
        is non-periodic."""
        if periodic_boundary:
            return self.mask == 2
        return self.mask >= 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid1D:
    """Legacy absolute-coordinate 1D grid (reference ParticleMesh.jl:20-60).

    x is ``[nx]`` node positions in meters; particle positions are absolute.
    """

    x: jnp.ndarray
    stats: GridStats = dataclasses.field(metadata=dict(static=True),
                                         default=None)

    @property
    def nx(self) -> int:
        return self.stats.nx
