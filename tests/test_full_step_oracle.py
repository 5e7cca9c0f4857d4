"""Independent float64 full-step oracle.

A plain numpy/scipy implementation of the full model cycle — windsea seed ->
adaptive ODE advance -> CIC scatter -> gather/reseed/off remesh — transcribed
directly from the reference formulas (citations inline), sharing NO code with
picles_tpu's compute path (the RHS transcription `_np_rhs_2d` lives in
test_rhs.py and is itself locked against scipy there).  The framework's
jitted step is then run on the same tiny configurations and must match the
oracle to solver tolerance.  This anchors the golden regression locks
OUTSIDE the code under test.

Oracle per-step semantics (reference run.jl:72-115 + mapping_2D.jl:118-356):
  1. advance every on particle by DT with an independent adaptive RK
     (scipy RK45 at tight tolerance on the float64 RHS transcription),
  2. re-light off particles when wind(t+DT)^2 >= wind_min^2 -> windsea,
  3. e-max clamp (lne capped at log_energy_maximum),
  4. CIC scatter of (E, m_x, m_y) = (e^lne, cg E/2|cg|^2) to the 4
     surrounding nodes; periodic wrap or non-periodic drop,
  5. remesh with winds at the pre-tick clock: gather when the node state
     exceeds MinimalState(2, 2, DT), else reseed when winds are strong,
     else off (NodeToParticle! branch table, mapping_2D.jl:306-353).
"""

import math

import numpy as np
import pytest
from scipy.integrate import solve_ivp

from test_rhs import _np_rhs_2d

from picles_tpu.core.constants import ODEParameters

G = 9.81
WIND_MIN_SQ = 4.0
LOG_E_MAX = math.log(17.0)


# ---------------------------------------------------------------------------
# float64 fetch relations (reference FetchRelations.jl:107-139, 165-203,
# 314-359, 381-415)
# ---------------------------------------------------------------------------

def np_windsea(u, v, dt):
    """get_initial_windsea (FetchRelations.jl:316-359), JONSWAP branch."""
    q_x, A, xi_0x = 0.2748, 22.8013, 2.4097   # Dulov et al. 2020
    U = math.hypot(u, v)
    U = max(U, 0.1)
    tau = G * abs(dt) / U
    X_t = (tau / (A * xi_0x)) ** (1.0 / (1.0 - q_x))
    f_m = 3.5 * (G / U) * X_t ** (-0.33)
    a_j = 0.033 * (f_m * U / G) ** 0.67
    E = 0.31 * G ** 2 * a_j * (f_m * 2 * math.pi) ** (-4)
    f_peak = f_m * G / U
    T_bar = 0.9 / f_peak
    cg_amp = G * T_bar / (4 * math.pi)
    cg_x, cg_y = cg_amp * u / U, cg_amp * v / U
    m_x = (u / U) * E / (2 * cg_amp)
    m_y = (v / U) * E / (2 * cg_amp)
    return dict(E=E, lne=math.log(E), cg_x=cg_x, cg_y=cg_y, m_x=m_x, m_y=m_y)


def np_minimal_windsea(u, v, dt):
    """MinimalWindsea (FetchRelations.jl:381-386): unit wind, same sign."""
    U = math.hypot(u, v) or 1.0
    return np_windsea(u / U, v / U, dt)


def np_minimal_state(dt):
    """MinimalState(2, 2, DT) (FetchRelations.jl:412-415)."""
    ws = np_minimal_windsea(2.0, 2.0, dt)
    return ws["E"], ws["m_x"] ** 2 + ws["m_y"] ** 2


# ---------------------------------------------------------------------------
# float64 mask construction (reference mask_utils.jl:38-55)
# ---------------------------------------------------------------------------

def np_make_mask(ocean, bx, by):
    """{0 land, 1 ocean, 2 land-boundary, 3 grid-boundary}.

    Note the reference's "land boundary" is the LAND cells adjacent to
    ocean (interior_boundary marks ``circshift(mask) && !mask``), and
    non-periodic edges are forced to 3 unconditionally.  ``bx``/``by`` in
    {"periodic", "nonperiodic", "tripolar"}; a tripolar y axis forces no
    edges (x-periodic, north seam folds onto the domain itself)."""
    bmask = np.zeros_like(ocean)
    for d in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        bmask |= np.roll(ocean, d, axis=(0, 1)) & ~ocean
    mask = ocean.astype(int) + 2 * bmask.astype(int)
    if bx == "nonperiodic":
        mask[0, :] = mask[-1, :] = 3
    if by == "nonperiodic":
        mask[:, 0] = mask[:, -1] = 3
    return mask


# ---------------------------------------------------------------------------
# float64 per-node geometry: spherical metric / projection / great-circle
# (independent transcriptions of the reference formulas; NOT imported from
# picles_tpu.grids)
# ---------------------------------------------------------------------------

def np_spherical_metric(X, Y):
    """Metric spacings in meters from lon/lat degree coordinates
    (reference SphericalGrid.jl:25-75, R = 6371 km): centered differences
    of the degree coordinates scaled by pi/180 * R [* cos(lat) for lon]."""
    R = 6371.0e3
    dxd = np.zeros_like(X)
    dxd[1:-1, :] = (X[2:, :] - X[:-2, :]) / 2
    dxd[0, :] = X[1, :] - X[0, :]
    dxd[-1, :] = X[-1, :] - X[-2, :]
    dyd = np.zeros_like(Y)
    dyd[:, 1:-1] = (Y[:, 2:] - Y[:, :-2]) / 2
    dyd[:, 0] = Y[:, 1] - Y[:, 0]
    dyd[:, -1] = Y[:, -1] - Y[:, -2]
    dxm = dxd * math.pi / 180.0 * R * np.cos(np.radians(Y))
    dym = dyd * math.pi / 180.0 * R
    return dxm, dym


def np_great_circle_coef(lat_deg):
    """sign(phi) * min(sign(phi) * tand(phi), 60) / R with R = 6.3710e6
    (reference spherical_grid_corrections.jl:3-21).  Applied in the RHS as
    S_sphere = pc * cg_x rotating (cg_x, cg_y)."""
    R = 6.3710e6
    s = np.sign(lat_deg)
    return s * np.minimum(s * np.tan(np.radians(lat_deg)), 60.0) / R


def np_rotation_projection(angle_deg, dxm, dym):
    """Per-node rotation projection of the tripolar grid
    (reference TripolarGridMOM6.jl:436-462):
    M = [[cos a / dx, sin a / dy], [-sin a / dx, cos a / dy]]."""
    ca, sa = np.cos(np.radians(angle_deg)), np.sin(np.radians(angle_deg))
    M = np.zeros(angle_deg.shape + (2, 2))
    M[..., 0, 0] = ca / dxm
    M[..., 0, 1] = sa / dym
    M[..., 1, 0] = -sa / dxm
    M[..., 1, 1] = ca / dym
    return M


# ---------------------------------------------------------------------------
# the oracle step
# ---------------------------------------------------------------------------

class Oracle:
    """Float64 full-step oracle over arbitrary grid geometry.

    The Cartesian constructor (positional args) reproduces the original
    box configuration; ``X/Y/M/pc/bx/by`` kwargs generalize to spherical
    (per-node diag projection + great-circle coefficient) and tripolar
    (per-node rotation projection + north-seam scatter fold) geometry.
    ``M`` may be a global 2x2 or a per-node [nx, ny, 2, 2]; ``pc`` a
    scalar or per-node [nx, ny].
    """

    def __init__(self, nx, ny, Lx, Ly, periodic, u_func, v_func, DT, *,
                 X=None, Y=None, M=None, pc=0.0, bx=None, by=None,
                 boundary_source=False):
        # boundary_source: the open-boundary inflow condition
        # (boundary_type="wind_sea"): boundary-flagged nodes never advance,
        # scatter their held state, and reseed from the local windsea every
        # remesh (the reference's intended-but-dead wiring,
        # WaveGrowthModels2D.jl:273-292 + mapping_2D.jl:338-345)
        self.boundary_source = boundary_source
        self.nx, self.ny = nx, ny
        if bx is None:
            bx = "periodic" if periodic else "nonperiodic"
        if by is None:
            by = "periodic" if periodic else "nonperiodic"
        self.bx, self.by = bx, by
        # reference core_2D.jl:360-366 / WaveGrowthModels2D.jl:255-270:
        # "periodic" for the active/boundary classification means the
        # domain has no forced grid-boundary ring (tripolar counts)
        self.periodic = (bx != "nonperiodic") and (by != "nonperiodic")
        self.u_func, self.v_func = u_func, v_func
        self.DT = DT
        self.pars, self.cid, _ = ODEParameters.create()
        if X is None:
            xs = np.linspace(0.0, Lx, nx)
            ys = np.linspace(0.0, Ly, ny)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
        self.X, self.Y = X, Y
        if M is None:
            # projection: m/s -> cell/s (CartesianGrid.jl:115-136, angle 0)
            M = np.array([[1.0 / (Lx / (nx - 1)), 0.0],
                          [0.0, 1.0 / (Ly / (ny - 1))]])
        self.Mf = (np.broadcast_to(M, (nx, ny, 2, 2)) if M.ndim == 2 else M)
        self.pcf = np.broadcast_to(np.asarray(pc, float), (nx, ny))
        self.min_e, self.min_m2 = np_minimal_state(DT)
        self.n_folds = 0   # north-seam fold events (tripolar observability)

    def masks(self, ocean):
        mask = np_make_mask(ocean, self.bx, self.by)
        if self.periodic:
            active = (mask == 1) | (mask == 3)
        else:
            active = mask == 1
        return mask, active

    def seed(self, ocean):
        """SeedParticle (core_2D.jl:434-488): windsea when wind > sqrt(2)."""
        mask, active = self.masks(ocean)
        nx, ny = self.nx, self.ny
        z = np.zeros((nx, ny, 5))
        on = np.zeros((nx, ny), bool)
        S = np.zeros((nx, ny, 3))
        for i in range(nx):
            for j in range(ny):
                u = self.u_func(self.X[i, j], self.Y[i, j], 0.0)
                v = self.v_func(self.X[i, j], self.Y[i, j], 0.0)
                strong = math.hypot(u, v) > math.sqrt(2.0)
                ws = (np_windsea(u, v, self.DT) if strong
                      else np_minimal_windsea(u, v, self.DT))
                z[i, j] = [ws["lne"], ws["cg_x"], ws["cg_y"], 0.0, 0.0]
                on[i, j] = strong and mask[i, j] != 0
                if on[i, j]:
                    E = math.exp(z[i, j, 0])
                    c2 = z[i, j, 1] ** 2 + z[i, j, 2] ** 2
                    S[i, j] = [E, z[i, j, 1] * E / (2 * c2),
                               z[i, j, 2] * E / (2 * c2)]
        return z, on, S, mask, active

    def step(self, z, on, t0, mask, active):
        nx, ny = self.nx, self.ny
        DT = self.DT
        z, on = z.copy(), on.copy()

        # --- advance (mapping_2D.jl:149-243) ---
        for i in range(nx):
            for j in range(ny):
                if not active[i, j]:
                    continue
                xg, yg = self.X[i, j], self.Y[i, j]
                if on[i, j]:
                    Mij, pcij = self.Mf[i, j], self.pcf[i, j]
                    # winds sampled at the fixed node position but at the
                    # SOLVER's time — time-dependent forcing varies within
                    # the window, exactly like the framework RHS
                    sol = solve_ivp(
                        lambda t, zz: _np_rhs_2d(
                            t, zz, self.u_func(xg, yg, t),
                            self.v_func(xg, yg, t), Mij, pcij,
                            self.pars, gamma=self.cid.gamma),
                        (t0, t0 + DT), z[i, j], rtol=1e-8, atol=1e-11,
                        method="RK45")
                    z[i, j] = sol.y[:, -1]
                else:
                    ue = self.u_func(xg, yg, t0 + DT)
                    ve = self.v_func(xg, yg, t0 + DT)
                    if ue * ue + ve * ve >= WIND_MIN_SQ:  # re-light
                        ws = np_windsea(ue, ve, DT)
                        z[i, j] = [ws["lne"], ws["cg_x"], ws["cg_y"], 0, 0]
                        on[i, j] = True
                if z[i, j, 0] > LOG_E_MAX:                # e-max clamp
                    z[i, j, 0] = LOG_E_MAX

        # --- scatter (ParticleInCell.jl:341-376) ---
        if self.periodic:
            bnd = mask == 2
        else:
            bnd = mask >= 2
        S = np.zeros((nx, ny, 3))
        for i in range(nx):
            for j in range(ny):
                part = active[i, j] or (self.boundary_source and bnd[i, j])
                if not (on[i, j] and part):
                    continue
                lne, cx, cy, px, py = z[i, j]
                E = math.exp(lne)
                c2 = cx * cx + cy * cy
                charge = np.array([E, cx * E / (2 * c2), cy * E / (2 * c2)])
                fx, fy = math.floor(px), math.floor(py)
                wx, wy = px - fx, py - fy
                for cxo, wxo in ((0, 1 - wx), (1, wx)):
                    for cyo, wyo in ((0, 1 - wy), (1, wy)):
                        gi, gj = i + int(fx) + cxo, j + int(fy) + cyo
                        if self.by == "tripolar":
                            # north-seam fold (TripolarNorthBoundary,
                            # ParticleInCell.jl:409-428, 0-based form):
                            # gy > ny-1 -> gy' = 2 ny - 1 - gy with
                            # gx' = (nx - 2 - gx) mod nx, charge unchanged;
                            # south exceed dropped (:353); x periodic.
                            if gj < 0:
                                continue
                            if gj > ny - 1:
                                gi = nx - 2 - gi
                                gj = 2 * ny - 1 - gj
                                self.n_folds += 1
                            gi %= nx
                        else:
                            if self.bx == "periodic":
                                gi %= nx
                            elif not (0 <= gi < nx):
                                continue
                            if self.by == "periodic":
                                gj %= ny
                            elif not (0 <= gj < ny):
                                continue
                        S[gi, gj] += wxo * wyo * charge

        # --- remesh (mapping_2D.jl:306-353), winds at pre-tick clock ---
        for i in range(nx):
            for j in range(ny):
                boundary = bnd[i, j]
                if not (active[i, j]
                        or (self.boundary_source and boundary)):
                    continue
                E, mx, my = S[i, j]
                u = self.u_func(self.X[i, j], self.Y[i, j], t0)
                v = self.v_func(self.X[i, j], self.Y[i, j], t0)
                if (not boundary and E >= self.min_e
                        and mx * mx + my * my >= self.min_m2):
                    m2 = mx * mx + my * my
                    z[i, j] = [math.log(E), mx * E / (2 * m2),
                               my * E / (2 * m2), 0.0, 0.0]
                    on[i, j] = True
                elif u * u + v * v >= WIND_MIN_SQ:
                    ws = np_windsea(u, v, DT)
                    z[i, j] = [ws["lne"], ws["cg_x"], ws["cg_y"], 0.0, 0.0]
                    on[i, j] = True
                else:
                    on[i, j] = False
        return z, on, S


# ---------------------------------------------------------------------------
# framework-vs-oracle comparisons
# ---------------------------------------------------------------------------

def _framework(nx, ny, Lx, Ly, periodic, winds, ocean=None,
               abstol=1e-7, reltol=1e-6):
    import jax
    import jax.numpy as jnp

    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.grids.cartesian import cartesian_box
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)

    DT = 600.0
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    # tight solver tolerances: the comparison then isolates the STRUCTURE
    # of the step (seeding, branch table, transforms, scatter indexing) —
    # measured agreement is ~3e-6 relative (f32 floor); the production
    # tolerances (1e-4/1e-3) add only solver error on top
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True,
                       abstol=abstol, reltol=reltol)
    from picles_tpu.grids.cartesian import cartesian_grid_2d

    if ocean is None:
        grid = cartesian_box(Lx, nx, Ly, ny,
                             periodic_boundary=(periodic, periodic))
    else:
        grid = cartesian_grid_2d(0.0, Lx, nx, 0.0, Ly, ny,
                                 mask=np.asarray(ocean),
                                 periodic_boundary=(periodic, periodic))
    model = WaveGrowth2D(grid, winds, sett,
                         config=WaveGrowth2DConfig(
                             periodic_boundary=periodic))
    return model, jax.jit(model.step)


CASES = {
    "periodic-const": dict(periodic=True, U=10.0, V=5.0, land=False),
    "nonperiodic-const": dict(periodic=False, U=10.0, V=5.0, land=False),
    "periodic-halfdomain": dict(periodic=True, U=10.0, V=0.0, land=False,
                                half=True),
    "periodic-landmask": dict(periodic=True, U=10.0, V=5.0, land=True),
    # growing/decaying winds (T04_2D_growing_decaying analog): forcing
    # varies WITHIN each advance window (the oracle RHS samples winds at
    # the solver's time) and collapses toward 0 at step 3, driving the
    # re-light / reseed / off branches under time dependence
    "periodic-timecosine": dict(periodic=True, U=10.0, V=0.0, land=False,
                                timecos=7200.0),
}


@pytest.mark.parametrize("case", sorted(CASES), ids=sorted(CASES))
def test_full_step_matches_f64_oracle(case):
    from picles_tpu.forcing.winds import Winds2D
    import jax.numpy as jnp

    cfg = CASES[case]
    nx = ny = 6
    Lx = Ly = 100e3
    DT = 600.0
    U, V = cfg["U"], cfg["V"]

    if cfg.get("half"):
        xsplit = 50e3

        # oracle winds (python scalars)
        def u_o(x, y, t):
            return U if x < xsplit else 0.0

        def v_o(x, y, t):
            return 0.0

        winds = Winds2D(
            u=lambda x, y, t: jnp.where(jnp.asarray(x) < xsplit, U, 0.0),
            v=lambda x, y, t: jnp.zeros_like(jnp.asarray(x, jnp.float32)))
    elif cfg.get("timecos"):
        from picles_tpu.forcing.winds import time_cosine_winds

        period = cfg["timecos"]

        def u_o(x, y, t):
            return U * math.cos(2.0 * math.pi * t / period)

        def v_o(x, y, t):
            return 0.0

        winds = time_cosine_winds(U, 0.0, period=period)
    else:
        def u_o(x, y, t):
            return U

        def v_o(x, y, t):
            return V

        winds = Winds2D(
            u=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), U),
            v=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), V))

    ocean = np.ones((nx, ny), bool)
    if cfg["land"]:
        ocean[2, 2] = False

    # ---- oracle ----
    orc = Oracle(nx, ny, Lx, Ly, cfg["periodic"], u_o, v_o, DT)
    z, on, S0, mask, active = orc.seed(ocean)
    t = 0.0
    states = []
    for _ in range(3):
        z, on, S = orc.step(z, on, t, mask, active)
        t += DT
        states.append(S.copy())

    # ---- framework ----
    model, step = _framework(nx, ny, Lx, Ly, cfg["periodic"], winds,
                             ocean=ocean if cfg["land"] else None)
    # oracle and framework must agree on the mask layout
    np.testing.assert_array_equal(np.asarray(model.grid.mask), mask)
    ms = model.init_state()
    for k in range(3):
        ms = step(ms)
        got = np.asarray(ms.state)
        # f32 framework at tight solver tolerance vs f64 oracle: ~3e-6
        # measured; 1e-4 leaves 30x headroom while still catching any
        # structural error (wrong index, branch, transform) instantly
        np.testing.assert_allclose(got, states[k], rtol=1e-4, atol=1e-9,
                                   err_msg=f"{case} step {k + 1}")
    # on/off pattern must match exactly
    np.testing.assert_array_equal(np.asarray(ms.particles.on), on)


# ---------------------------------------------------------------------------
# spherical + tripolar full-step oracle locks: the
# per-node rotation projection, the great-circle steering term, and the
# north-seam scatter fold — the subtlest math in the repo — anchored against
# the independent float64 transcriptions above.
# ---------------------------------------------------------------------------

def test_full_step_matches_f64_oracle_spherical():
    """Spherical aqua blob (T03_PIC_sphere_aqua analog, shrunk): lon/lat
    grid at high latitude so the great-circle coefficient tan(lat)/R is
    O(3e-7) and rotates cg measurably within 3 steps.  The oracle builds
    its metric (SphericalGrid.jl:25-75), diag projection, and pc
    (spherical_grid_corrections.jl:3-21) from scratch in float64."""
    import jax
    import jax.numpy as jnp

    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.forcing.winds import Winds2D
    from picles_tpu.grids.spherical import spherical_grid_2d
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)

    nx = ny = 6
    lon0, lon1, lat0, lat1 = 0.0, 10.0, 55.0, 75.0
    DT = 600.0
    U, V = 10.0, 5.0

    def u_o(x, y, t):
        return U

    def v_o(x, y, t):
        return V

    winds = Winds2D(
        u=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), U),
        v=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), V))

    # ---- oracle geometry (independent f64 transcription) ----
    X, Y = np.meshgrid(np.linspace(lon0, lon1, nx),
                       np.linspace(lat0, lat1, ny), indexing="ij")
    dxm, dym = np_spherical_metric(X, Y)
    M = np.zeros((nx, ny, 2, 2))
    M[..., 0, 0] = 1.0 / dxm
    M[..., 1, 1] = 1.0 / dym
    pc = np_great_circle_coef(Y)

    orc = Oracle(nx, ny, 0.0, 0.0, False, u_o, v_o, DT,
                 X=X, Y=Y, M=M, pc=pc, bx="nonperiodic", by="nonperiodic")
    ocean = np.ones((nx, ny), bool)
    z, on, S0, mask, active = orc.seed(ocean)
    t = 0.0
    states = []
    for _ in range(3):
        z, on, S = orc.step(z, on, t, mask, active)
        t += DT
        states.append(S.copy())

    # ---- framework ----
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True,
                       abstol=1e-7, reltol=1e-6)
    grid = spherical_grid_2d(lon0, lon1, nx, lat0, lat1, ny,
                             periodic_boundary=(False, False))
    model = WaveGrowth2D(grid, winds, sett,
                         config=WaveGrowth2DConfig(periodic_boundary=False))
    np.testing.assert_array_equal(np.asarray(model.grid.mask), mask)
    # the framework's grid geometry must match the oracle's transcription
    np.testing.assert_allclose(np.asarray(model.grid.pc), pc, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(model.grid.proj), M, rtol=1e-5)
    ms = model.init_state()
    step = jax.jit(model.step)
    for k in range(3):
        ms = step(ms)
        np.testing.assert_allclose(np.asarray(ms.state), states[k],
                                   rtol=1e-4, atol=1e-9,
                                   err_msg=f"spherical step {k + 1}")
    np.testing.assert_array_equal(np.asarray(ms.particles.on), on)


def test_full_step_matches_f64_oracle_tripolar_seam():
    """Synthetic tripolar grid, metrics scaled down (1/400 planet) so a
    northward windsea crosses the seam within one DT: top-row deposits fold
    to gy' = 2 ny - 1 - gy with gx' = (nx - 2 - gx) mod nx.  The oracle
    transcribes the rotation projection (TripolarGridMOM6.jl:436-462), the
    great-circle coefficient, and the seam fold (ParticleInCell.jl:409-428)
    independently; the framework runs its real construction + dense-fold
    scatter.  (The C-grid stride extraction/aggregation pipeline is shared
    input geometry — it is locked separately in test_tripolar.py.)"""
    import jax
    import jax.numpy as jnp

    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.forcing.winds import Winds2D
    from picles_tpu.grids.tripolar import (calculate_distances,
                                           extract_grid_points,
                                           mom6_grid_from_supergrid,
                                           synthetic_tripolar_supergrid)
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)

    DT = 600.0
    U, V = 2.0, 10.0   # northward-dominated: pushes particles over the seam
    Xs, Ys, dxs, dys, areas, angs = synthetic_tripolar_supergrid(
        nx_super=24, ny_super=16)
    scale = 1.0 / 400.0
    dxs, dys, areas = dxs * scale, dys * scale, areas * scale ** 2
    nx, ny = 12, 8
    tmask = np.ones((nx, ny), bool)

    def u_o(x, y, t):
        return U

    def v_o(x, y, t):
        return V

    winds = Winds2D(
        u=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), U),
        v=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), V))

    # ---- oracle geometry: shared C-grid aggregation, independent M/pc ----
    G = extract_grid_points(Xs, Ys, angs, 2, mask=tmask)
    GA = calculate_distances(areas, dxs, dys, 2, 1)
    t_lat, angd = np.asarray(G["t_lat"]), np.asarray(G["angle"])
    dxm, dym = GA["dxCu"], GA["dyCv"]
    M = np_rotation_projection(angd, dxm, dym)
    pc = np_great_circle_coef(t_lat)

    orc = Oracle(nx, ny, 0.0, 0.0, True, u_o, v_o, DT,
                 X=np.asarray(G["t_lon"]), Y=t_lat, M=M, pc=pc,
                 bx="periodic", by="tripolar")
    z, on, S0, mask, active = orc.seed(tmask)
    t = 0.0
    states = []
    for _ in range(3):
        z, on, S = orc.step(z, on, t, mask, active)
        t += DT
        states.append(S.copy())

    # ---- framework ----
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True,
                       abstol=1e-7, reltol=1e-6)
    grid = mom6_grid_from_supergrid(Xs, Ys, dxs, dys, areas, angs, 2,
                                    mask=tmask)
    model = WaveGrowth2D(grid, winds, sett,
                         config=WaveGrowth2DConfig(periodic_boundary=True))
    np.testing.assert_array_equal(np.asarray(model.grid.mask), mask)
    np.testing.assert_allclose(np.asarray(model.grid.pc), pc, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(model.grid.proj), M, rtol=1e-5,
                               atol=1e-12)
    ms = model.init_state()
    step = jax.jit(model.step)
    crossed = False
    for k in range(3):
        ms = step(ms)
        np.testing.assert_allclose(np.asarray(ms.state), states[k],
                                   rtol=1e-4, atol=1e-9,
                                   err_msg=f"tripolar step {k + 1}")
    np.testing.assert_array_equal(np.asarray(ms.particles.on), on)
    # the fold must actually have been exercised: every top-row particle
    # with northward cg deposits (weight py) across the seam each step
    assert orc.n_folds > 0, \
        "no seam-crossing deposits — test configuration regressed"


def test_full_step_matches_f64_oracle_open_boundary_inflow():
    """boundary_type="wind_sea" (open-boundary inflow): boundary nodes
    never integrate, reseed from the local windsea every remesh, and
    scatter that state inward.  The reference intended this but left the
    wiring dead (WaveGrowthModels2D.jl:273-292, mapping_2D.jl:338-345);
    here it is live — so anchor it against the independent oracle too."""
    import jax
    import jax.numpy as jnp

    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.forcing.winds import Winds2D
    from picles_tpu.grids.cartesian import cartesian_box
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)

    nx = ny = 6
    Lx = Ly = 100e3
    DT = 600.0
    U, V = 10.0, 5.0

    def u_o(x, y, t):
        return U

    def v_o(x, y, t):
        return V

    winds = Winds2D(
        u=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), U),
        v=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), V))

    orc = Oracle(nx, ny, Lx, Ly, False, u_o, v_o, DT, boundary_source=True)
    ocean = np.ones((nx, ny), bool)
    z, on, S0, mask, active = orc.seed(ocean)
    t = 0.0
    states = []
    for _ in range(3):
        z, on, S = orc.step(z, on, t, mask, active)
        t += DT
        states.append(S.copy())
    # the inflow must actually act: boundary-adjacent interior nodes
    # receive deposits from the ring (the ring itself is never gathered)
    assert states[-1][1, 1, 0] > 0

    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True,
                       abstol=1e-7, reltol=1e-6)
    grid = cartesian_box(Lx, nx, Ly, ny, periodic_boundary=(False, False))
    model = WaveGrowth2D(grid, winds, sett,
                         config=WaveGrowth2DConfig(
                             periodic_boundary=False,
                             boundary_type="wind_sea"))
    assert model._boundary_source
    np.testing.assert_array_equal(np.asarray(model.grid.mask), mask)
    ms = model.init_state()
    step = jax.jit(model.step)
    for k in range(3):
        ms = step(ms)
        np.testing.assert_allclose(np.asarray(ms.state), states[k],
                                   rtol=1e-4, atol=1e-9,
                                   err_msg=f"inflow step {k + 1}")
    np.testing.assert_array_equal(np.asarray(ms.particles.on), on)


def test_full_step_matches_f64_oracle_gridded_winds():
    """Gridded (t, x, y) wind forcing through the full step: the oracle
    samples its OWN float64 trilinear interpolant (independent of
    jax.scipy.ndimage.map_coordinates — index convention, spatial clamp,
    time clamp all re-derived), at a 900 s cadence vs DT = 600 s so
    advance windows straddle wind frames.  Locks the loader/sampler
    conventions (reference WindEmulator.jl:18-43) from outside."""
    import jax

    from picles_tpu.core import fetch_relations as FR
    from picles_tpu.core.constants import ODESettings
    from picles_tpu.forcing.winds import GriddedWinds2D
    from picles_tpu.grids.cartesian import cartesian_box
    from picles_tpu.models.wave_growth_2d import (WaveGrowth2D,
                                                  WaveGrowth2DConfig)
    import jax.numpy as jnp

    nx = ny = 6
    Lx = Ly = 100e3
    DT = 600.0
    nxw = nyw = 5
    ntw = 8
    dtw = 900.0
    dxw, dyw = Lx / (nxw - 1), Ly / (nyw - 1)
    rng = np.random.default_rng(23)
    # smooth mean + mild noise, f32 data (what the loader produces)
    u_rec = (9.0 + 1.5 * rng.standard_normal((ntw, nxw, nyw))).astype(
        np.float32)
    v_rec = (4.0 + rng.standard_normal((ntw, nxw, nyw))).astype(np.float32)

    def tri(data, x, y, t):
        """Independent f64 trilinear sample: clamp on every axis (the
        default mode='nearest' spatial clamp + mode_t='clamp')."""
        d = np.asarray(data, np.float64)
        xi = min(max(x / dxw, 0.0), nxw - 1.0)
        yi = min(max(y / dyw, 0.0), nyw - 1.0)
        ti = min(max(t / dtw, 0.0), ntw - 1.0)

        def lerp1(arr, f):
            i0 = int(math.floor(f))
            i1 = min(i0 + 1, arr.shape[0] - 1)
            w = f - i0
            return arr[i0] * (1 - w) + arr[i1] * w

        return lerp1(lerp1(lerp1(d, ti), xi), yi)

    def u_o(x, y, t):
        return tri(u_rec, x, y, t)

    def v_o(x, y, t):
        return tri(v_rec, x, y, t)

    gw = GriddedWinds2D(u_data=jnp.asarray(u_rec), v_data=jnp.asarray(v_rec),
                        x0=0.0, dx=dxw, y0=0.0, dy=dyw, t0=0.0, dt=dtw)

    orc = Oracle(nx, ny, Lx, Ly, True, u_o, v_o, DT)
    ocean = np.ones((nx, ny), bool)
    z, on, S0, mask, active = orc.seed(ocean)
    t = 0.0
    states = []
    for _ in range(3):
        z, on, S = orc.step(z, on, t, mask, active)
        t += DT
        states.append(S.copy())

    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    sett = ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True,
                       abstol=1e-7, reltol=1e-6)
    grid = cartesian_box(Lx, nx, Ly, ny, periodic_boundary=(True, True))
    model = WaveGrowth2D(grid, gw.as_winds(), sett,
                         config=WaveGrowth2DConfig(periodic_boundary=True))
    assert model.gridded_winds is gw
    ms = model.init_state()
    step = jax.jit(model.step)
    for k in range(3):
        ms = step(ms)
        np.testing.assert_allclose(np.asarray(ms.state), states[k],
                                   rtol=2e-4, atol=1e-9,
                                   err_msg=f"gridded step {k + 1}")
    np.testing.assert_array_equal(np.asarray(ms.particles.on), on)
