"""PiCLES in JAX: a Lagrangian ocean surface-wave model for accelerators.

A from-scratch JAX/XLA re-design of the PiCLES particle-in-cell wave model
(Kudryavtsev et al. 2021 physics; one parametric particle per grid node;
advance -> CIC scatter -> semi-Lagrangian remesh per model step), built for
an accelerator: SoA particle state, one pure jitted step, batched adaptive ODE
integration, dense pad-and-fold scatter, and shard_map domain decomposition
with ppermute halo exchange.

Quick start (the README example_00 analog)::

    import picles_tpu as pt

    grid = pt.cartesian_box(100e3, 51, 100e3, 51)
    winds = pt.constant_winds(10.0, 10.0)
    ws_min = pt.FetchRelations.MinimalWindsea(10.0, 10.0, 600.0)
    settings = pt.ODESettings(log_energy_minimum=float(ws_min.lne),
                              saving_step=600.0, timestep=600.0,
                              total_time=6 * 24 * 3600.0,
                              dt=1e-3, dtmin=1e-4, force_dtmin=True)
    model = pt.WaveGrowth2D(grid, winds, settings)
    sim = pt.Simulation.create(model, stop_time=2 * 3600.0)
    sim.run(cash_store=True)
"""

from .core import fetch_relations as FetchRelations
from .core.constants import (IDConstants, ODEParameters, ODESettings,
                             ScgConstants)
from .forcing.winds import (GriddedWinds1D, GriddedWinds2D, Winds1D, Winds2D,
                            constant_winds, constant_winds_1d,
                            half_domain_winds, load_gridded_winds_2d,
                            time_cosine_winds)
from .grids.base import Boundary, Grid1D, Grid2D, GridStats
from .grids.cartesian import cartesian_box, cartesian_grid_2d
from .grids.legacy import (OneDGrid, OneDGridNotes, TwoDGrid, TwoDGridMesh,
                           TwoDGridNotes)
from .grids.spherical import spherical_grid_2d
from .grids.tripolar import (load_mom6_grid, mom6_grid_from_supergrid,
                             synthetic_tripolar_grid)
from .models.state import (ModelState1D, ModelState2D, Particles1D,
                           Particles2D, StepMetrics)
from .models.wave_growth_1d import (ParticleDefaults1D, WaveGrowth1D,
                                    WaveGrowth1DConfig, one_d_grid)
from .models.wave_growth_2d import (LayeredWaveGrowth2D, ParticleDefaults2D,
                                    WaveGrowth2D, WaveGrowth2DConfig)
from .ops.rhs import TermFlags, particle_equations, particle_equations_1d
from .parallel.sharded import ShardedWaveGrowth2D, make_mesh
from .simulation.checkpoint import load_checkpoint, save_checkpoint
from .simulation.simulation import Simulation
from .simulation.store import CashStore, EmptyStore, StateStore

__version__ = "0.1.0"
