"""Card-only checks: the Triton advance compiled for the GPU (no
interpreter).  They skip on the CPU; chip_smoke.py runs the same
comparisons at production size."""

import numpy as np
import pytest

import jax

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig

pytestmark = pytest.mark.gpu


def _model(mode, solver, n=61):
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True, solver=solver)
    grid = cartesian_box(100e3, n, 100e3, 47, periodic_boundary=(True, True))
    return WaveGrowth2D(grid, constant_winds(10.0, 5.0), sett,
                        config=WaveGrowth2DConfig(advance_mode=mode))


@pytest.mark.parametrize("solver", ["bosh3", "tsit5"])
def test_compiled_advance_matches_xla(gpu, solver):
    """The compiled kernel (a padded tail block: 61 * 47 lanes) against
    the XLA loop through three steps, with equal branch counts."""
    mp, mx = _model("auto", solver), _model("xla", solver)
    assert mp.resolved_config().advance_mode == "pallas"
    sp, sx = mp.init_state(), mx.init_state()
    fp, fx = jax.jit(mp.step), jax.jit(mx.step)
    for _ in range(3):
        sp, sx = fp(sp), fx(sx)
    np.testing.assert_allclose(np.asarray(sp.state), np.asarray(sx.state),
                               rtol=5e-3, atol=1e-8)
    for k in ("n_active", "n_gather", "n_failed"):
        assert int(getattr(sp.metrics, k)) == int(getattr(sx.metrics, k)), k
