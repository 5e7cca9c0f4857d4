"""PIC scatter unit tests (reference T01 analogs, asserting):
mass conservation, dense-vs-XLA cross-checks, boundary and seam properties."""

import numpy as np
import jax.numpy as jnp
import pytest

from picles_tpu.grids.base import Boundary, GridStats
from picles_tpu.ops import pic


def _stats(nx, ny, bx, by):
    return GridStats(nx=nx, ny=ny, bx=bx, by=by)


def _rand_inputs(rng, nx, ny, spread=1.5):
    xr = jnp.asarray(rng.uniform(-spread, spread, (nx, ny)), jnp.float32)
    yr = jnp.asarray(rng.uniform(-spread, spread, (nx, ny)), jnp.float32)
    ch = jnp.asarray(rng.uniform(0, 1, (nx, ny, 3)), jnp.float32)
    act = jnp.asarray(rng.uniform(0, 1, (nx, ny)) > 0.3)
    return xr, yr, ch, act


@pytest.mark.parametrize("mode", ["dense", "xla"])
def test_mass_conservation_periodic(mode):
    """Periodic box: total charge is exactly conserved (T01 analog,
    reference tests/T01_test_PIC_1D.jl:20-56)."""
    rng = np.random.default_rng(0)
    nx, ny = 16, 12
    xr, yr, ch, act = _rand_inputs(rng, nx, ny)
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.PERIODIC)
    S, _ = pic.scatter(xr, yr, ch, act, st, halo=3, mode=mode)
    total_in = np.sum(np.asarray(ch) * np.asarray(act)[..., None], axis=(0, 1))
    np.testing.assert_allclose(np.sum(np.asarray(S), axis=(0, 1)), total_in,
                               rtol=1e-5)


def test_dense_equals_xla_all_boundaries():
    rng = np.random.default_rng(1)
    nx, ny = 10, 14
    xr, yr, ch, act = _rand_inputs(rng, nx, ny)
    for bx in (Boundary.PERIODIC, Boundary.NONPERIODIC):
        for by in (Boundary.PERIODIC, Boundary.NONPERIODIC):
            st = _stats(nx, ny, bx, by)
            S1, _ = pic.scatter(xr, yr, ch, act, st, halo=3, mode="dense")
            S2, _ = pic.scatter(xr, yr, ch, act, st, halo=3, mode="xla")
            np.testing.assert_allclose(np.asarray(S1), np.asarray(S2),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"bx={bx} by={by}")


def test_dense_equals_xla_tripolar():
    rng = np.random.default_rng(2)
    nx, ny = 12, 8
    xr, yr, ch, act = _rand_inputs(rng, nx, ny, spread=2.5)
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
    S1, _ = pic.scatter(xr, yr, ch, act, st, halo=4, mode="dense")
    S2, _ = pic.scatter(xr, yr, ch, act, st, halo=4, mode="xla")
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S2), rtol=2e-5,
                               atol=1e-6)


def test_zero_displacement_identity():
    """Particles exactly at their nodes deposit everything there."""
    nx, ny = 6, 6
    ch = jnp.ones((nx, ny, 3))
    z = jnp.zeros((nx, ny))
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.PERIODIC)
    S, _ = pic.scatter(z, z, ch, jnp.ones((nx, ny), bool), st, halo=2)
    np.testing.assert_allclose(np.asarray(S), np.asarray(ch), atol=1e-7)


def test_half_cell_shift_splits_weight():
    nx, ny = 6, 6
    ch = jnp.zeros((nx, ny, 1)).at[2, 3, 0].set(1.0)
    act = jnp.zeros((nx, ny), bool).at[2, 3].set(True)
    xr = jnp.full((nx, ny), 0.5)
    yr = jnp.zeros((nx, ny))
    st = _stats(nx, ny, Boundary.NONPERIODIC, Boundary.NONPERIODIC)
    S, _ = pic.scatter(xr, yr, ch, act, st, halo=2)
    S = np.asarray(S)[..., 0]
    assert np.isclose(S[2, 3], 0.5) and np.isclose(S[3, 3], 0.5)
    assert np.isclose(S.sum(), 1.0)


def test_nonperiodic_drops_outflow():
    """Charge leaving a non-periodic edge is silently dropped
    (reference ParticleInCell.jl:318-338)."""
    nx, ny = 5, 5
    ch = jnp.zeros((nx, ny, 1)).at[4, 2, 0].set(1.0)
    act = jnp.zeros((nx, ny), bool).at[4, 2].set(True)
    xr = jnp.full((nx, ny), 1.2)   # floor +1 -> nodes 5,6: both out of domain
    yr = jnp.zeros((nx, ny))
    st = _stats(nx, ny, Boundary.NONPERIODIC, Boundary.NONPERIODIC)
    S, _ = pic.scatter(xr, yr, ch, act, st, halo=3)
    assert np.asarray(S).sum() == pytest.approx(0.0, abs=1e-7)
    # periodic keeps it
    stp = _stats(nx, ny, Boundary.PERIODIC, Boundary.NONPERIODIC)
    Sp, _ = pic.scatter(xr, yr, ch, act, stp, halo=3)
    assert np.asarray(Sp).sum() == pytest.approx(1.0, rel=1e-6)


def test_tripolar_seam_fold_positions():
    """A particle pushed across the north seam lands at the flipped-x
    column of the top row (0-based form of ParticleInCell.jl:409-428)."""
    nx, ny = 8, 6
    i, j = 3, 5  # top row
    ch = jnp.zeros((nx, ny, 1)).at[i, j, 0].set(1.0)
    act = jnp.zeros((nx, ny), bool).at[i, j].set(True)
    xr = jnp.zeros((nx, ny))
    yr = jnp.full((nx, ny), 1.0)  # exactly one row above the top: gy = 6
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
    S, _ = pic.scatter(xr, yr, ch, act, st, halo=3)
    S = np.asarray(S)[..., 0]
    # gy=6 folds to 2*6-1-6 = 5 (top row), gx=3 folds to (8-2-3)%8 = 3
    assert np.isclose(S[3, 5], 1.0)
    assert np.isclose(S.sum(), 1.0)


def test_tripolar_seam_mass_conserved():
    rng = np.random.default_rng(3)
    nx, ny = 16, 10
    xr = jnp.asarray(rng.uniform(-1.5, 1.5, (nx, ny)), jnp.float32)
    # strong northward push so plenty of seam crossings
    yr = jnp.asarray(rng.uniform(0.0, 2.5, (nx, ny)), jnp.float32)
    ch = jnp.asarray(rng.uniform(0, 1, (nx, ny, 3)), jnp.float32)
    act = jnp.ones((nx, ny), bool)
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
    S, _ = pic.scatter(xr, yr, ch, act, st, halo=4)
    np.testing.assert_allclose(np.sum(np.asarray(S), axis=(0, 1)),
                               np.sum(np.asarray(ch), axis=(0, 1)), rtol=1e-5)


def test_halo_clamp_counted():
    nx, ny = 6, 6
    ch = jnp.ones((nx, ny, 1))
    act = jnp.ones((nx, ny), bool)
    xr = jnp.full((nx, ny), 10.0)  # way beyond halo 2
    yr = jnp.zeros((nx, ny))
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.PERIODIC)
    _, stats = pic.scatter(xr, yr, ch, act, st, halo=2, mode="dense")
    assert int(stats.clamped) == nx * ny


def test_scatter_1d_add_mass_conservation():
    rng = np.random.default_rng(4)
    nx = 21
    x = jnp.asarray(np.linspace(0, 20, nx) + rng.uniform(-0.4, 0.4, nx))
    ch = jnp.asarray(rng.uniform(0, 1, (nx, 3)))
    act = jnp.ones((nx,), bool)
    S = pic.scatter_1d_add(x, ch, act, 0.0, 1.0, nx, periodic=True)
    np.testing.assert_allclose(np.sum(np.asarray(S), axis=0),
                               np.sum(np.asarray(ch), axis=0), rtol=1e-6)


def test_scatter_1d_merge_same_sign_is_additive():
    """Single-signed momentum: merge scatter == additive scatter
    (the B01 growth regime)."""
    rng = np.random.default_rng(5)
    nx = 15
    x = jnp.asarray(np.linspace(0, 14, nx) + rng.uniform(-0.3, 0.3, nx))
    ch = jnp.asarray(np.stack([rng.uniform(0.1, 1, nx),
                               rng.uniform(0.01, 0.1, nx),
                               np.zeros(nx)], axis=-1))
    act = jnp.ones((nx,), bool)
    S1 = pic.scatter_1d_merge(x, ch, act, 0.0, 1.0, nx, periodic=False)
    S2 = pic.scatter_1d_add(x, ch, act, 0.0, 1.0, nx, periodic=False)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S2), rtol=1e-6)


def test_scatter_1d_merge_opposing_keeps_larger():
    nx = 5
    x = jnp.asarray([2.2, 2.6])  # both scatter into nodes 2/3
    ch = jnp.asarray([[1.0, 0.5, 0.0], [0.2, -0.05, 0.0]])
    act = jnp.ones((2,), bool)
    S = pic.scatter_1d_merge(x, ch, act, 0.0, 1.0, nx, periodic=False)
    S = np.asarray(S)
    # positive-momentum group dominates everywhere it deposits
    assert S[2, 1] > 0 and S[3, 1] > 0


# ---------------------------------------------------------------------------
# 2D angle merge rule (reference merge! V1 / ⊓, ParticleInCell.jl:228-299)
# ---------------------------------------------------------------------------

def test_merge_2d_angle_aligned_adds():
    g = jnp.asarray([1.0, 0.5, 0.0])
    c = jnp.asarray([2.0, 0.4, 0.1])  # well within 60 degrees
    out = np.asarray(pic.merge_2d_angle(g, c))
    np.testing.assert_allclose(out, np.asarray(g) + np.asarray(c), rtol=1e-6)


def test_merge_2d_angle_empty_node_adds():
    g = jnp.asarray([0.0, 0.0, 0.0])
    c = jnp.asarray([2.0, -0.4, 0.1])
    out = np.asarray(pic.merge_2d_angle(g, c))
    np.testing.assert_allclose(out, np.asarray(c), rtol=1e-6)


def test_merge_2d_angle_opposed_higher_energy_wins():
    g = jnp.asarray([3.0, 0.5, 0.0])
    c = jnp.asarray([1.0, -0.5, 0.0])  # 180 degrees apart
    out = np.asarray(pic.merge_2d_angle(g, c))
    np.testing.assert_allclose(out, np.asarray(g))  # grid has more energy
    out2 = np.asarray(pic.merge_2d_angle(c, g))
    np.testing.assert_allclose(out2, np.asarray(g))  # charge replaces


def test_merge_2d_angle_elementwise_batch():
    g = jnp.stack([jnp.asarray([1.0, 0.5, 0.0]),
                   jnp.asarray([3.0, 0.5, 0.0])])
    c = jnp.stack([jnp.asarray([2.0, 0.4, 0.1]),
                   jnp.asarray([1.0, -0.5, 0.0])])
    out = np.asarray(pic.merge_2d_angle(g, c))
    np.testing.assert_allclose(out[0], np.asarray(g[0] + c[0]), rtol=1e-6)
    np.testing.assert_allclose(out[1], np.asarray(g[1]))


# ---------------------------------------------------------------------------
# asymmetric halo bounds
# ---------------------------------------------------------------------------

def _directional_inputs(rng, nx, ny, lo=-0.8, hi=2.7):
    xr = jnp.asarray(rng.uniform(lo, hi, (nx, ny)), jnp.float32)
    yr = jnp.asarray(rng.uniform(lo, hi, (nx, ny)), jnp.float32)
    ch = jnp.asarray(rng.uniform(0, 1, (nx, ny, 3)), jnp.float32)
    act = jnp.asarray(rng.uniform(0, 1, (nx, ny)) > 0.3)
    return xr, yr, ch, act


def test_normalize_halo_forms():
    assert pic.normalize_halo(3) == ((3, 3), (3, 3))
    assert pic.normalize_halo((1, 2)) == ((1, 1), (2, 2))
    assert pic.normalize_halo(((0, 3), (1, 2))) == ((0, 3), (1, 2))
    assert pic.halo_max(((0, 3), (1, 2))) == 3


@pytest.mark.parametrize("mode", ["dense"])
def test_asymmetric_halo_matches_xla_oracle(mode):
    """Displacements within ((1,3),(1,3)) deposit identically to the
    unbounded XLA oracle, for every boundary combination."""
    rng = np.random.default_rng(7)
    nx, ny = 12, 10
    xr, yr, ch, act = _directional_inputs(rng, nx, ny)
    bounds = ((1, 3), (1, 3))
    for bx in (Boundary.PERIODIC, Boundary.NONPERIODIC):
        for by in (Boundary.PERIODIC, Boundary.NONPERIODIC):
            st = _stats(nx, ny, bx, by)
            S1, st1 = pic.scatter(xr, yr, ch, act, st, bounds, mode=mode)
            S2, _ = pic.scatter(xr, yr, ch, act, st, 0, mode="xla")
            np.testing.assert_allclose(np.asarray(S1), np.asarray(S2),
                                       rtol=2e-5, atol=1e-6,
                                       err_msg=f"bx={bx} by={by}")
            assert int(st1.clamped) == 0


def test_asymmetric_halo_tripolar_matches_xla():
    rng = np.random.default_rng(8)
    nx, ny = 12, 8
    xr, yr, ch, act = _directional_inputs(rng, nx, ny, lo=-0.5, hi=2.5)
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
    S1, _ = pic.scatter(xr, yr, ch, act, st, ((1, 3), (1, 3)), mode="dense")
    S2, _ = pic.scatter(xr, yr, ch, act, st, 0, mode="xla")
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S2), rtol=2e-5,
                               atol=1e-6)


def test_asymmetric_halo_clamps_and_counts():
    """Out-of-bounds displacement is clamped into [-lo, hi) and counted;
    mass is still conserved on a periodic box."""
    nx, ny = 8, 8
    xr = jnp.zeros((nx, ny), jnp.float32).at[2, 2].set(2.9)  # > hi of 2
    yr = jnp.zeros((nx, ny), jnp.float32)
    ch = jnp.ones((nx, ny, 3), jnp.float32)
    act = jnp.ones((nx, ny), bool)
    st = _stats(nx, ny, Boundary.PERIODIC, Boundary.PERIODIC)
    S, stats = pic.scatter(xr, yr, ch, act, st, ((0, 2), (0, 2)), mode="dense")
    assert int(stats.clamped) == 1
    np.testing.assert_allclose(np.sum(np.asarray(S), axis=(0, 1)),
                               np.full(3, nx * ny), rtol=1e-5)


_FAMILIES = {
    "periodic": (Boundary.PERIODIC, Boundary.PERIODIC),
    "periodic-x": (Boundary.PERIODIC, Boundary.NONPERIODIC),
    "nonperiodic": (Boundary.NONPERIODIC, Boundary.NONPERIODIC),
    "tripolar": (Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH),
}


@pytest.mark.parametrize("halo", [3, ((0, 3), (0, 3)), ((1, 2), (0, 3)),
                                  ((2, 0), (3, 1))])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_dense_matches_xla_oracle_families_and_halos(family, halo):
    """The production deposit (pad-and-fold, scatter_mode="dense") equals
    the unbounded index scatter-add oracle for every boundary family and
    halo shape the configurations use: symmetric, zero-lo directional,
    and asymmetric either way, including the tripolar seam's x-flip fold.
    Tolerance is summation order: the two add the same terms in another
    order (on the GPU the oracle's atomics change it run to run)."""
    rng = np.random.default_rng(3)
    nx, ny = 22, 18
    (xlo, xhi), (ylo, yhi) = pic.normalize_halo(halo)
    xr = jnp.asarray(rng.uniform(-xlo, xhi - 1e-3, (nx, ny)), jnp.float32)
    yr = jnp.asarray(rng.uniform(-ylo, yhi - 1e-3, (nx, ny)), jnp.float32)
    ch = jnp.asarray(rng.uniform(0, 1, (nx, ny, 3)), jnp.float32)
    act = jnp.asarray(rng.uniform(0, 1, (nx, ny)) > 0.25)
    st = _stats(nx, ny, *_FAMILIES[family])
    S1, s1 = pic.scatter(xr, yr, ch, act, st, halo, mode="dense")
    S2, _ = pic.scatter(xr, yr, ch, act, st, 0, mode="xla")
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S2), rtol=1e-5,
                               atol=1e-6)
    assert int(s1.clamped) == 0
    # the channel-plane entry point the model calls is the same deposit
    planes, _ = pic.scatter_channels(xr, yr, tuple(ch[..., i]
                                                   for i in range(3)),
                                     act, st, halo)
    np.testing.assert_array_equal(np.stack(planes, -1), np.asarray(S1))
