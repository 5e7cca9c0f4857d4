"""Wind forcing: jit-able samplers u(x, y, t), v(x, y, t).

The reference passes arbitrary Julia closures / Interpolations.jl objects as
winds (NamedTuple (u, v); e.g. src/Utils/WindEmulator.jl).  Here a wind is any
Python callable operating on jnp arrays; the helpers below cover the cases
the reference tests exercise: constants, analytic closures, half-domain
switches, time-modulated fields, and gridded data with multilinear
interpolation (the WindEmulator analog, built on map_coordinates).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates


class Winds2D(NamedTuple):
    """(u, v) sampler pair, mirroring the reference ``winds = (u=..., v=...)``."""

    u: Callable
    v: Callable

    def __call__(self, x, y, t):
        return self.u(x, y, t), self.v(x, y, t)


class Winds1D(NamedTuple):
    u: Callable

    def __call__(self, x, t):
        return self.u(x, t)


def constant_winds(U10: float, V10: float) -> Winds2D:
    """Uniform steady winds (the README example_00 forcing)."""
    return Winds2D(u=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), U10),
                   v=lambda x, y, t: jnp.full_like(jnp.asarray(x, jnp.float32), V10))


def constant_winds_1d(U10: float) -> Winds1D:
    return Winds1D(u=lambda x, t: jnp.full_like(jnp.asarray(x, jnp.float32), U10))


def half_domain_winds(U10: float, V10: float, x_split: float,
                      background: float = 0.0) -> Winds2D:
    """IfElse half-domain winds used in T04 variants
    (x < x_split -> (U10, V10), else background)."""
    def u(x, y, t):
        return jnp.where(jnp.asarray(x) < x_split, U10, background)

    def v(x, y, t):
        return jnp.where(jnp.asarray(x) < x_split, V10, background)

    return Winds2D(u=u, v=v)


def time_cosine_winds(U10: float, V10: float, period: float,
                      t_off: Optional[float] = None) -> Winds2D:
    """Growing/decaying winds (T04_2D_growing_decaying_winds analog):
    amplitude modulated by cos(2 pi t / period), optionally zeroed after
    ``t_off``."""
    def amp(t):
        a = jnp.cos(2.0 * jnp.pi * jnp.asarray(t, jnp.float32) / period)
        if t_off is not None:
            a = jnp.where(jnp.asarray(t) > t_off, 0.0, a)
        return a

    return Winds2D(u=lambda x, y, t: U10 * amp(t) + 0.0 * jnp.asarray(x),
                   v=lambda x, y, t: V10 * amp(t) + 0.0 * jnp.asarray(x))


# ---------------------------------------------------------------------------
# gridded winds (WindEmulator analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GriddedWinds2D:
    """Tri-linear interpolation of gridded (t, x, y) wind data.

    The JAX replacement for Interpolations.jl linear_interpolation
    with periodic extrapolation (reference WindEmulator.jl:18-43): index
    coordinates are computed from the axis metadata and fed to
    ``jax.scipy.ndimage.map_coordinates`` (order=1).

    Axes may be UNIFORM (give ``x0/dx`` etc.; index = (c - c0)/dc) or
    NON-UNIFORM (give ``x_nodes``/``y_nodes``/``t_nodes``, strictly
    increasing; index = piecewise-linear coordinate->index map evaluated
    with ``jnp.interp`` over the node table — linear interpolation in
    fractional-index space between nodes k and k+1 is then exactly linear
    interpolation in coordinate space, matching the reference's
    ``LinearInterpolation(nodes, ...)`` over arbitrary node vectors,
    WindEmulator.jl:26 / B02_2D_regtest_netCDF.jl:73-75 — e.g. a
    gaussian-spaced latitude axis).  Per-axis: any mix of uniform and
    node-table axes works.

    u_data, v_data: [nt, nx, ny]
    """

    u_data: jnp.ndarray
    v_data: jnp.ndarray
    x0: float
    dx: float
    y0: float
    dy: float
    t0: float
    dt: float
    # Edge handling is PER-AXIS: ``mode`` applies to the two spatial axes
    # ('nearest' = clamp, 'wrap' = periodic — the reference WindEmulator's
    # periodic spatial extrapolation, WindEmulator.jl:18-43); ``mode_t``
    # to the time axis ('clamp' holds the first/last frame beyond the
    # record — a wind record shorter than the run keeps its final state —
    # or 'wrap' to loop the record).  Previously one mode covered all
    # three axes, so periodic space silently wrapped time too.
    mode: str = "nearest"
    mode_t: str = "clamp"
    # optional non-uniform node tables (override c0/dc for that axis);
    # 'wrap' on a node-table axis uses period nodes[-1] - nodes[0]
    # (nodes[-1] identified with nodes[0] — the Interpolations.jl
    # Periodic() convention for irregular knot vectors), vs the uniform
    # axis's n*dc period with a residual [n-1, n) interval against
    # sample 0.
    x_nodes: Optional[jnp.ndarray] = None
    y_nodes: Optional[jnp.ndarray] = None
    t_nodes: Optional[jnp.ndarray] = None

    def _axis_index(self, c, nodes, c0, dc, n, wrap):
        """Coordinate -> fractional index for one axis (uniform metadata
        or non-uniform node table)."""
        c = jnp.asarray(c)
        if nodes is None:
            ci = (c - c0) / dc
            # pre-fold into range; the residual [n-1, n) interval of a
            # wrapped axis interpolates against sample 0 via mode='wrap'
            return jnp.mod(ci, n) if wrap else jnp.clip(ci, 0.0, n - 1.0)
        nd = jnp.asarray(nodes, c.dtype if jnp.issubdtype(c.dtype, jnp.floating)
                         else jnp.float32)
        if wrap:
            c = nd[0] + jnp.mod(c - nd[0], nd[-1] - nd[0])
        # jnp.interp clamps outside [nodes[0], nodes[-1]] — the 'nearest'
        # edge behavior; inside, exact piecewise-linear index map
        return jnp.interp(c, nd, jnp.arange(nd.shape[0], dtype=nd.dtype))

    def _coords(self, x, y, t):
        nt, nxw, nyw = self.u_data.shape
        wrap_s = self.mode == "wrap"
        ti = self._axis_index(t, self.t_nodes, self.t0, self.dt, nt,
                              self.mode_t == "wrap")
        xi = self._axis_index(x, self.x_nodes, self.x0, self.dx, nxw, wrap_s)
        yi = self._axis_index(y, self.y_nodes, self.y0, self.dy, nyw, wrap_s)
        ti, xi, yi = jnp.broadcast_arrays(ti, xi, yi)
        return [ti, xi, yi]

    def u(self, x, y, t):
        return map_coordinates(self.u_data, self._coords(x, y, t), order=1,
                               mode="wrap")

    def v(self, x, y, t):
        return map_coordinates(self.v_data, self._coords(x, y, t), order=1,
                               mode="wrap")

    def as_winds(self) -> Winds2D:
        return Winds2D(u=self.u, v=self.v)

    def n_breakpoints(self, DT: float) -> int:
        """Max wind-data frame boundaries a ``[t0, t0 + DT]`` window can
        straddle: ``ceil(DT / dt)`` for a uniform time axis;
        ``floor(DT / min_spacing) + 1`` for a node table (a safe bound —
        surplus breakpoints carry zero slope jumps and stay exact).
        Static (python ints/floats only, computed from concrete node
        data) — it sizes the piecewise-linear field tuple at trace time."""
        import math

        if self.t_nodes is not None:
            import numpy as _np

            tn = _np.asarray(self.t_nodes, _np.float64)
            d = _np.diff(tn)
            if d.size == 0:
                return 1
            # capped at the record length: a window can straddle at most
            # ALL node times, so one tiny inter-node gap (near-duplicate
            # timestamps) must not blow the field tuple up to DT/gap terms
            return max(1, min(int(math.floor(float(DT) / float(d.min()))) + 1,
                              int(tn.size)))
        return max(1, int(math.ceil(float(DT) / float(self.dt) - 1e-9)))

    def pallas_pwl_fields(self, x, y, t0, DT):
        """EXACT per-node time dependence of the winds over one step window
        ``[t0, t0 + DT]`` for the fused Pallas kernels.

        Winds are sampled at the fixed node position (reference
        particle_waves_v5.jl:488-495 — params.x/y override the advected
        coordinates), so within a step only time varies, and the tri-linear
        interpolant (reference WindEmulator.jl:18-43) is PIECEWISE-linear in
        t with breakpoints at the wind-data frame times.  The window
        straddles at most ``B = n_breakpoints(DT)`` of them, so per node

            u(t) = a_u + s_u * t + sum_k ds_k * max(t - b_k, 0)

        with slope jumps ``ds_k = s_k - s_{k-1}`` at the frame boundaries
        ``b_k`` inside the window — equal to the interpolant everywhere in
        the window (breakpoints at/after ``t0 + DT`` contribute 0; a window
        inside one frame interval has all ``ds_k = 0`` and reduces to the
        aligned-cadence linearization).  Frame values are sampled through
        ``self.u/v`` at the frame times, so the per-axis edge modes
        (space wrap/clamp, time clamp/wrap) transfer exactly.

        Returns ``(a_u, s_u, a_v, s_v, [ds_u_k, ds_v_k, b_k] * B)`` arrays
        shaped like ``x`` — the ``wind_fields`` contract of
        ``gridded_pallas_samplers(B)``.

        A NON-UNIFORM time axis (``t_nodes``) works too: frame times come
        from the node table (gathered around ``searchsorted(t_nodes, t0)``)
        and slopes divide by the actual per-segment gaps.  Repeated clamped
        node times (windows straddling the record's ends) get zero slope
        via a safe divide — exactly the clamp-mode interpolant, which is
        flat there.  Precision note: the slope terms scale as
        ``du * t / gap``, so NEAR-DUPLICATE node times (gap << DT) leave
        ~``(DT/gap) * eps_f32 * |du|`` of cancellation residue in f32 —
        exact in exact arithmetic, and bounded in term count because
        ``n_breakpoints`` caps at the record length.
        ``mode_t='wrap'`` with a node table is not supported
        on this path (wrap boundaries of an irregular record are not
        frame times of the window enumeration): use the XLA advance path.
        """
        B = self.n_breakpoints(DT)
        shp = jnp.shape(x)
        t0b = jnp.broadcast_to(jnp.asarray(t0, jnp.float32), shp)
        if self.t_nodes is None:
            # frame index at/below t0; frame time t_f[j] = t0w + (k0+j) dtw
            k0 = jnp.floor((t0b - self.t0) / self.dt)
            tf = [self.t0 + (k0 + j) * self.dt for j in range(B + 2)]
            gaps = [self.dt] * (B + 1)
        else:
            if self.mode_t == "wrap":
                raise ValueError(
                    "pallas_pwl_fields: mode_t='wrap' is not supported "
                    "with a non-uniform t_nodes table; use advance_mode="
                    "'xla' or a clamped time axis")
            tn = jnp.asarray(self.t_nodes, jnp.float32)
            ntf = tn.shape[0]
            # segment index at/below t0 (may be -1: t0 before the record)
            k0 = jnp.searchsorted(tn, t0b, side="right").astype(jnp.int32) - 1
            tf = []
            for j in range(B + 2):
                t_j = jnp.take(tn, jnp.clip(k0 + j, 0, ntf - 1))
                if j == 0:
                    # before the record the clamp-mode field is flat:
                    # anchor the first sample at t0 itself so the first
                    # segment's slope is exactly 0
                    t_j = jnp.where(k0 < 0, t0b, t_j)
                tf.append(t_j)
            gaps = [tf[j + 1] - tf[j] for j in range(B + 1)]
        us = [self.u(x, y, t) for t in tf]
        vs = [self.v(x, y, t) for t in tf]

        def slope(hi, lo, gap):
            if isinstance(gap, float):
                return (hi - lo) / gap
            safe = jnp.where(gap > 0, gap, 1.0)
            return jnp.where(gap > 0, (hi - lo) / safe, 0.0)

        s_u = [slope(us[j + 1], us[j], gaps[j]) for j in range(B + 1)]
        s_v = [slope(vs[j + 1], vs[j], gaps[j]) for j in range(B + 1)]
        fields = [us[0] - tf[0] * s_u[0], s_u[0],
                  vs[0] - tf[0] * s_v[0], s_v[0]]
        for k in range(1, B + 1):
            fields += [s_u[k] - s_u[k - 1], s_v[k] - s_v[k - 1], tf[k]]
        return tuple(fields)


def gridded_pallas_samplers(n_break: int = 0):
    """Kernel-side wind samplers matching ``pallas_pwl_fields``:
    ``u_wind(xn, yn, t, a_u, s_u, a_v, s_v, [ds_u_k, ds_v_k, b_k]*B)`` —
    pure elementwise ops (the breakpoint terms unroll at trace time)."""
    def u(xn, yn, t, *f):
        val = f[0] + t * f[1]
        for k in range(n_break):
            val = val + f[4 + 3 * k] * jnp.maximum(t - f[6 + 3 * k], 0.0)
        return val

    def v(xn, yn, t, *f):
        val = f[2] + t * f[3]
        for k in range(n_break):
            val = val + f[5 + 3 * k] * jnp.maximum(t - f[6 + 3 * k], 0.0)
        return val

    return u, v


@dataclasses.dataclass(frozen=True)
class GriddedWinds1D:
    """Bi-linear interpolation of gridded (x, t) wind data — the direct
    WindEmulator.IdealizedWindGrid + wind_interpolator analog.

    Edge handling is PER-AXIS, same contract as ``GriddedWinds2D``:
    ``mode`` covers space ('wrap' = periodic, the reference
    wind_interpolator's ``Periodic()`` extrapolation, WindEmulator.jl:26;
    'nearest' = clamp) and ``mode_t`` covers time.  ``mode_t`` defaults
    to 'clamp' (hold the last frame past the record's end) — the
    reference wraps BOTH axes, which silently loops a wind record shorter
    than the run; pass ``mode_t='wrap'`` for that exact behavior.
    """

    u_data: jnp.ndarray  # [nx, nt]
    x0: float
    dx: float
    t0: float
    dt: float
    mode: str = "wrap"      # spatial axis; reference-parity periodic
    mode_t: str = "clamp"   # time axis

    def u(self, x, t):
        nxw, ntw = self.u_data.shape
        xi = (jnp.asarray(x) - self.x0) / self.dx
        ti = (jnp.asarray(t) - self.t0) / self.dt
        # pre-fold each axis by its own mode (the residual [n-1, n)
        # interval of a wrapped axis interpolates against sample 0 via
        # map_coordinates mode='wrap')
        xi = jnp.mod(xi, nxw) if self.mode == "wrap" \
            else jnp.clip(xi, 0.0, nxw - 1.0)
        ti = jnp.mod(ti, ntw) if self.mode_t == "wrap" \
            else jnp.clip(ti, 0.0, ntw - 1.0)
        xi, ti = jnp.broadcast_arrays(xi, ti)
        return map_coordinates(self.u_data, [xi, ti], order=1, mode="wrap")

    def as_winds(self) -> Winds1D:
        return Winds1D(u=self.u)


def idealized_wind_grid_1d(u_func, Lx: float, T: float, dx: float,
                           dt: float) -> GriddedWinds1D:
    """Grid an analytic wind (reference WindEmulator.IdealizedWindGrid)."""
    import numpy as np

    xi = np.arange(0, Lx + dx / 2, dx)
    ti = np.arange(0, T + dt / 2, dt)
    data = np.asarray([[float(u_func(x, t)) for t in ti] for x in xi],
                      dtype=np.float32)
    return GriddedWinds1D(u_data=jnp.asarray(data), x0=0.0, dx=dx, t0=0.0,
                          dt=dt)


def load_gridded_winds_2d(path: str, *, u_name: str = "u10",
                          v_name: str = "v10", x_name: str = "longitude",
                          y_name: str = "latitude", t_name: str = "time",
                          mode: str = "nearest",
                          mode_t: str = "clamp",
                          time_scale: float = 1.0,
                          relative_time: bool = False) -> GriddedWinds2D:
    """Load (t, x, y) wind fields from a NetCDF file into GriddedWinds2D.

    The analog of the reference's NCDatasets-based wind forcing
    (tests/T03_PIC_tripolar_realistic.jl:54, T04_2D_reg_test_netCDF.jl,
    B02_2D_regtest_netCDF.jl).  Reads NetCDF-4 via h5py with a scipy
    NetCDF-3 fallback (utils.io.read_netcdf_vars, shared with
    grids.tripolar.load_mom6_grid).
    Uniform axes use linear-index interpolation; a non-uniform axis
    (e.g. gaussian-grid latitudes, or MOM6-native forcing) is kept as a
    node table and interpolated through the coordinate->index map (see
    GriddedWinds2D).  Data stored [t, y, x] (CF convention) is transposed
    to [t, x, y].

    ERA5-style files (the reference's
    era5_surfacewinds_202301_10days_6hourly_1deg.nc) name the variables
    ``lon/lat/time/U10N/V10N`` and carry the time axis in hours; pass
    ``u_name="U10N", v_name="V10N", x_name="lon", y_name="lat",
    time_scale=3600.0, relative_time=True`` to convert to
    seconds-since-first-frame (the reference's Dates.Millisecond
    conversion, T03_PIC_tripolar_realistic.jl:61-65).
    """
    import numpy as np

    from ..utils.io import read_netcdf_vars

    v = read_netcdf_vars(path, [u_name, v_name, x_name, y_name, t_name])
    xs, ys, ts = (np.asarray(v[x_name], np.float64),
                  np.asarray(v[y_name], np.float64),
                  np.asarray(v[t_name], np.float64))

    def _txy(a):
        a = np.asarray(a, np.float32)
        if a.shape == (ts.size, ys.size, xs.size):   # CF [t, y, x]
            return np.transpose(a, (0, 2, 1))
        if a.shape == (ts.size, xs.size, ys.size):
            return a
        raise ValueError(f"wind variable shape {a.shape} does not match axes")

    u_txy, v_txy = _txy(v[u_name]), _txy(v[v_name])

    # ERA5 stores latitude north-to-south (90..-90); normalize any
    # strictly DECREASING spatial axis by flipping it and the data along
    # that axis, so every mode (incl. 'wrap') sees a standard increasing
    # axis.  A decreasing time axis stays an error.
    if xs.size > 1 and np.all(np.diff(xs) < 0):
        xs, u_txy, v_txy = xs[::-1], u_txy[:, ::-1, :], v_txy[:, ::-1, :]
    if ys.size > 1 and np.all(np.diff(ys) < 0):
        ys, u_txy, v_txy = ys[::-1], u_txy[:, :, ::-1], v_txy[:, :, ::-1]

    def _axis(a, name):
        """(c0, dc, nodes) — nodes is None for a uniform axis."""
        if a.size > 1:
            d = np.diff(a)
            if np.any(d <= 0):
                raise ValueError(f"{name} axis is not strictly increasing")
            if np.allclose(d, d[0], rtol=1e-4):
                return float(a[0]), float(d[0]), None
            return float(a[0]), float(d.mean()), jnp.asarray(a, jnp.float32)
        return float(a[0]), 1.0, None

    x0, dx, x_nodes = _axis(xs, x_name)
    y0, dy, y_nodes = _axis(ys, y_name)
    if relative_time:
        ts = ts - ts[0]
    t0, dt, t_nodes = _axis(ts * time_scale, t_name)
    if abs(t0) > 1e7:
        # the sampling path (and any non-uniform node table) is float32:
        # epoch-scale axes quantize to ~|t0| * 1.2e-7 s ulps (minutes at
        # seconds-since-1970), and the model clock starts at 0 anyway
        import warnings

        warnings.warn(
            f"wind time axis starts at {t0:.3g} s; float32 sampling "
            f"quantizes epoch-scale times to ~{abs(t0) * 1.2e-7:.0f} s — "
            f"pass relative_time=True (seconds since the first frame)",
            stacklevel=2)

    return GriddedWinds2D(u_data=jnp.asarray(u_txy),
                          v_data=jnp.asarray(v_txy),
                          x0=x0, dx=dx, y0=y0, dy=dy, t0=t0, dt=dt,
                          mode=mode, mode_t=mode_t,
                          x_nodes=x_nodes, y_nodes=y_nodes, t_nodes=t_nodes)


def slopped_blob(x, t, U10, V, T, x_scale, t_scale, x0=300e3):
    """Moving Gaussian wind blob (reference WindEmulator.jl:50-52)."""
    x = jnp.asarray(x)
    return 0.5 + U10 * (jnp.exp(-(((x - (x0 + t * V)) / x_scale) ** 2))
                        * jnp.exp(-(((t - T / 2) / t_scale) ** 2)))
