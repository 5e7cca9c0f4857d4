"""Golden numerical regression lock.

Pins the Eulerian state of the canonical forced-box configuration
(16x16 periodic, U10 = V10 = 10 m/s, DT = 10 min — the T04/example_00
regime, reference tests/T04_2D_reg_test.jl) at several steps, so physics
or kernel refactors that silently change the model's numbers fail loudly.
Values generated from the XLA reference-semantics path (commit-pinned);
tolerances allow float32 reassociation across backends/fusion changes but
not physics drift.
"""

import numpy as np
import pytest

from picles_tpu.core import fetch_relations as FR
from picles_tpu.core.constants import ODESettings
from picles_tpu.forcing.winds import constant_winds
from picles_tpu.grids.cartesian import cartesian_box
from picles_tpu.models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig

# step -> (e, m_x, m_y at node [8, 8]; total energy)
# Generated on the CPU (XLA host) backend — the backend the suite pins in
# conftest.py.  Cross-backend (GPU) runs agree only to ~1e-3: the adaptive
# error controller amplifies last-ulp transcendental differences into
# different (all valid) accept/reject paths — see _rtols().
GOLDEN = {
    1: (2.6601212099e-02, 5.8118416928e-03, 5.8118421584e-03, 6.8099231720e+00),
    3: (6.8184584379e-02, 1.0807109997e-02, 1.0807107203e-02, 1.7456180573e+01),
    6: (1.2437149137e-01, 1.5976341441e-02, 1.5976335853e-02, 3.1839084625e+01),
    12: (2.2151729465e-01, 2.3117741570e-02, 2.3117739707e-02, 5.6708507538e+01),
}
GOLDEN_BACKEND = "cpu"


def _model(**cfg_kw):
    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True)
    grid = cartesian_box(100e3, 16, 100e3, 16, periodic_boundary=(True, True))
    return WaveGrowth2D(grid, constant_winds(10.0, 10.0), sett,
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  **cfg_kw))


def _rtols(cfg):
    """Tolerance policy: tight same-backend lock, looser cross-backend.

    carry-mode dt policy changes substep placement within tolerance of the
    error controller; the pallas kernels reassociate float32 FMAs (~1e-4
    relative after a few growth steps); the XLA path must match tightly on
    the golden-generating backend.  On any other backend the adaptive
    controller turns last-ulp vectorization differences into different
    (all valid) substep paths, so every config gets the loose bound there.
    """
    import jax

    if jax.default_backend() != GOLDEN_BACKEND:
        return 5e-3
    if cfg.get("dt_reset_mode") == "carry":
        return 2e-3
    if cfg.get("advance_mode") == "pallas":
        return 1e-3
    return 1e-4


# Interpret-mode Pallas goldens are the suite's slowest tests.  The default
# tier keeps one golden per family: the XLA reference, the production
# stack (Triton advance + carried dt), and the asymmetric halo.  The
# advance alone under the reference dt policy is the exhaustive `slow`
# tier (its kernel stays locked by pallas-full here plus the dedicated
# kernel-vs-XLA tests in test_advance_pallas); run it with --runslow /
# PICLES_SLOW=1.
_slow = pytest.mark.slow
@pytest.mark.parametrize("cfg", [
    dict(),                                                    # XLA reference
    pytest.param(dict(advance_mode="pallas", pallas_interpret=True),
                 marks=_slow),                                 # fused advance
    dict(advance_mode="pallas", pallas_interpret=True,
         dt_reset_mode="carry"),                               # production stack
    dict(halo=((1, 3), (1, 3))),                               # asym capacity
], ids=["xla", "pallas-adv", "pallas-full", "asym-halo"])
def test_forced_box_golden(cfg):
    m = _model(**cfg)
    ms = m.init_state()
    rtol_pt = rtol_sum = _rtols(cfg)
    # interpret-mode Pallas configs lock steps 1/3/6 (the kernels' numerics
    # are step-local; the 12-step accumulated-physics tail stays locked by
    # the cheap XLA + asym-halo configs, which run all four checkpoints)
    steps = [k for k in sorted(GOLDEN)
             if not (cfg.get("pallas_interpret") and k > 6)]
    for k in steps:
        while int(ms.iteration) < k:
            ms = m.step(ms)
        e, mx, my, sumE = GOLDEN[k]
        S = np.asarray(ms.state)
        np.testing.assert_allclose(S[8, 8, 0], e, rtol=rtol_pt,
                                   err_msg=f"e at step {k}")
        np.testing.assert_allclose(S[8, 8, 1], mx, rtol=rtol_pt,
                                   err_msg=f"m_x at step {k}")
        np.testing.assert_allclose(S[8, 8, 2], my, rtol=rtol_pt,
                                   err_msg=f"m_y at step {k}")
        np.testing.assert_allclose(S[..., 0].sum(), sumE, rtol=rtol_sum,
                                   err_msg=f"sum E at step {k}")
    assert int(ms.metrics.n_failed) == 0
    assert int(ms.metrics.n_clamped) == 0


def test_determinism_bitwise():
    """Same input -> bitwise same state (the reference's threaded scatter
    races, SURVEY §5; this build is deterministic by construction)."""
    m = _model()
    a, b = m.init_state(), m.init_state()
    for _ in range(3):
        a = m.step(a)
        b = m.step(b)
    assert np.array_equal(np.asarray(a.state), np.asarray(b.state))
    assert np.array_equal(np.asarray(a.particles.lne),
                          np.asarray(b.particles.lne))
