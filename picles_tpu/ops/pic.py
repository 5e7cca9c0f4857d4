"""Particle-in-Cell scatter/gather kernels — the second hot kernel family.

JAX re-implementation of the reference PIC engine
(src/ParticleInCell.jl).  Two interchangeable implementations:

``scatter_dense`` (default): every particle lives at its home node ``(i, j)``
of the ``[nx, ny]`` SoA and scatters bilinear (CIC) weights to the 4 corners
around its *relative* position (reference compute_weights_and_index_mininal,
ParticleInCell.jl:149-157).  Because relative displacements are bounded by a
static halo ``H``, the scatter becomes a sum of (2H+1)^2 statically-shifted
dense adds into a padded ``[nx+2H, ny+2H]`` accumulator, followed by a
boundary *fold* of the halo slabs (periodic wrap / non-periodic drop /
tripolar north-seam flip).  Everything is static-shape elementwise work — no XLA
scatter, deterministic, and the halo slabs are exactly the payloads the
sharded version exchanges with ``ppermute``.

``scatter_xla``: direct translation using global index arithmetic and
``.at[].add`` — the cross-checking oracle (and the path with no halo bound).

Boundary semantics (reference push_to_grid!, ParticleInCell.jl:341-428):
 - periodic axis: 1-based ``wrap_index!`` == 0-based mod N,
 - non-periodic axis: out-of-domain contributions silently dropped,
 - tripolar north: gy > ny-1 folds to gy' = 2 ny - 1 - gy with
   gx' = (nx - 2 - gx) mod nx and unchanged charge
   (TripolarNorthBoundary, ParticleInCell.jl:409-428); gy < 0 dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..grids.base import Boundary, GridStats


class ScatterStats(NamedTuple):
    clamped: jnp.ndarray  # number of particles whose displacement hit the halo


def normalize_halo(halo) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Normalize a halo spec to ``((x_lo, x_hi), (y_lo, y_hi))``.

    An int ``H`` means the symmetric ``((H, H), (H, H))``.  Asymmetric
    bounds are a capacity statement like a CFL condition: displacements are
    clamped into ``[-lo, hi)`` per axis (violations counted in
    ``ScatterStats.clamped``), and the deposit pays ``(x_lo + x_hi + 1) *
    (y_lo + y_hi + 1)`` shifted adds instead of ``(2H+1)^2`` — directional
    flows (trade winds, channel flows) only displace one way, so e.g.
    ``((1, 3), (1, 3))`` halves the scatter cost vs symmetric 3.
    """
    if isinstance(halo, int):
        return ((halo, halo), (halo, halo))
    hx, hy = halo
    if isinstance(hx, int):
        return ((hx, hx), (hy, hy))
    return ((int(hx[0]), int(hx[1])), (int(hy[0]), int(hy[1])))


def halo_max(halo) -> int:
    (xl, xh), (yl, yh) = normalize_halo(halo)
    return max(xl, xh, yl, yh)


# ---------------------------------------------------------------------------
# CIC weights
# ---------------------------------------------------------------------------

def cic_weights(pos: jnp.ndarray, halo) -> Tuple[jnp.ndarray, jnp.ndarray,
                                                 jnp.ndarray, jnp.ndarray]:
    """Floor offset and (floor, ceil) weights of a relative position.

    Reference get_absolute_i_and_w (ParticleInCell.jl:58-71) without the
    round-to-6-digits weight snapping (float32 path).  Positions are clamped
    into the halo range [-lo, hi) so the dense scatter stays static-shape;
    the clamp count is returned for observability.
    """
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    lim_lo = -float(lo)
    lim_hi = float(hi) - 1e-5
    clamped = (pos < lim_lo) | (pos > lim_hi)
    p = jnp.clip(pos, lim_lo, lim_hi)
    f = jnp.floor(p)
    frac = p - f
    return f.astype(jnp.int32), 1.0 - frac, frac, clamped


# ---------------------------------------------------------------------------
# dense shift-accumulate scatter
# ---------------------------------------------------------------------------

def _weight_planes(fi: jnp.ndarray, w_floor: jnp.ndarray, w_ceil: jnp.ndarray,
                   lo: int, hi: int):
    """Per-offset weight planes: W[o] = w_floor*[fi==o] + w_ceil*[fi==o-1]."""
    planes = []
    for o in range(-lo, hi + 1):
        w = jnp.where(fi == o, w_floor, 0.0) + jnp.where(fi == o - 1, w_ceil, 0.0)
        planes.append(w)
    return planes


def scatter_accumulate_padded(xrel: jnp.ndarray, yrel: jnp.ndarray,
                              charge: jnp.ndarray, active: jnp.ndarray,
                              halo) -> Tuple[jnp.ndarray, ScatterStats]:
    """Accumulate CIC contributions into a [nx+xl+xh, ny+yl+yh, C] array.

    ``charge[nx, ny, C]``; ``active`` zeroes non-scattering particles
    (off / land, reference mapping_2D.jl:238-240 scatters only when on).
    """
    nx, ny, C = charge.shape
    (xl, xh), (yl, yh) = normalize_halo(halo)
    fx, wxf, wxc, cx_cl = cic_weights(xrel, (xl, xh))
    fy, wyf, wyc, cy_cl = cic_weights(yrel, (yl, yh))
    act = active.astype(charge.dtype)
    ch = charge * act[..., None]

    Wx = _weight_planes(fx, wxf, wxc, xl, xh)
    Wy = _weight_planes(fy, wyf, wyc, yl, yh)

    P = jnp.zeros((nx + xl + xh, ny + yl + yh, C), charge.dtype)
    for ix, ox in enumerate(range(-xl, xh + 1)):
        for iy, oy in enumerate(range(-yl, yh + 1)):
            w = Wx[ix] * Wy[iy]
            P = P.at[xl + ox:xl + ox + nx, yl + oy:yl + oy + ny, :].add(
                w[..., None] * ch)
    clamped = jnp.sum((cx_cl | cy_cl) & active)
    return P, ScatterStats(clamped=clamped)


def fold_padded_x(P: jnp.ndarray, bx: Boundary, halo) -> jnp.ndarray:
    """Fold the x halo slabs of a padded array: periodic wrap or drop."""
    (xl, xh), _ = normalize_halo(halo)
    nx = P.shape[0] - xl - xh
    core = P[xl:xl + nx]
    if xl == 0 and xh == 0:
        return core
    if bx == Boundary.PERIODIC:
        if xl:
            core = core.at[nx - xl:].add(P[:xl])
        if xh:
            core = core.at[:xh].add(P[xl + nx:])
    elif bx == Boundary.NONPERIODIC:
        pass  # drop (reference ParticleInCell.jl:351-355)
    else:
        raise ValueError("tripolar fold applies to the y axis only")
    return core


def _tripolar_flip_x(row: jnp.ndarray) -> jnp.ndarray:
    """x' = (nx - 2 - x) mod nx: reverse then roll by -1 (0-based form of
    TripolarNorthBoundary's x flip, ParticleInCell.jl:409-418)."""
    return jnp.roll(row[::-1], -1, axis=0)


def fold_padded_y(Q: jnp.ndarray, by: Boundary, halo) -> jnp.ndarray:
    """Fold the y halo slabs: periodic wrap, drop, or tripolar north fold."""
    _, (yl, yh) = normalize_halo(halo)
    ny = Q.shape[1] - yl - yh
    core = Q[:, yl:yl + ny]
    if yl == 0 and yh == 0:
        return core
    if by == Boundary.PERIODIC:
        if yl:
            core = core.at[:, ny - yl:].add(Q[:, :yl])
        if yh:
            core = core.at[:, :yh].add(Q[:, yl + ny:])
    elif by == Boundary.NONPERIODIC:
        pass
    elif by == Boundary.TRIPOLAR_NORTH:
        # south halo dropped (ParticleInCell.jl:353); north halo row
        # gy = ny + k folds onto gy' = ny - 1 - k with x flipped.
        for k in range(yh):
            core = core.at[:, ny - 1 - k].add(_tripolar_flip_x(Q[:, yl + ny + k]))
    return core


def scatter_dense(xrel: jnp.ndarray, yrel: jnp.ndarray, charge: jnp.ndarray,
                  active: jnp.ndarray, stats: GridStats,
                  halo) -> Tuple[jnp.ndarray, ScatterStats]:
    """Full dense scatter: accumulate padded, fold x then y."""
    P, st = scatter_accumulate_padded(xrel, yrel, charge, active, halo)
    Q = fold_padded_x(P, stats.bx, halo)
    S = fold_padded_y(Q, stats.by, halo)
    return S, st


# ---------------------------------------------------------------------------
# XLA scatter-add oracle
# ---------------------------------------------------------------------------

def scatter_xla(xrel: jnp.ndarray, yrel: jnp.ndarray, charge: jnp.ndarray,
                active: jnp.ndarray, stats: GridStats,
                halo: int = 0) -> Tuple[jnp.ndarray, ScatterStats]:
    """Index-arithmetic scatter used as a cross-check oracle.

    No halo bound: arbitrary displacements.  ``halo`` accepted for signature
    parity (ignored).
    """
    nx, ny, C = charge.shape
    ii = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 1)

    fx = jnp.floor(xrel).astype(jnp.int32)
    fy = jnp.floor(yrel).astype(jnp.int32)
    wxc = xrel - jnp.floor(xrel)
    wyc = yrel - jnp.floor(yrel)

    S = jnp.zeros((nx, ny, C), charge.dtype)
    act = active.astype(charge.dtype)

    for cx in (0, 1):
        for cy in (0, 1):
            gx = ii + fx + cx
            gy = jj + fy + cy
            w = (jnp.where(cx == 0, 1.0 - wxc, wxc)
                 * jnp.where(cy == 0, 1.0 - wyc, wyc)) * act

            keep = jnp.ones_like(w, dtype=bool)
            if stats.bx == Boundary.PERIODIC:
                gx = jnp.mod(gx, nx)
            else:
                keep &= (gx >= 0) & (gx < nx)
            if stats.by == Boundary.PERIODIC:
                gy = jnp.mod(gy, ny)
            elif stats.by == Boundary.NONPERIODIC:
                keep &= (gy >= 0) & (gy < ny)
            else:  # TRIPOLAR_NORTH: x must be periodic (already wrapped)
                keep &= gy >= 0
                over = gy > ny - 1
                gx = jnp.where(over, jnp.mod(nx - 2 - gx, nx), gx)
                gy = jnp.where(over, 2 * ny - 1 - gy, gy)

            w = jnp.where(keep, w, 0.0)
            gx = jnp.clip(gx, 0, nx - 1)
            gy = jnp.clip(gy, 0, ny - 1)
            flat = gx * ny + gy
            S = S.reshape(nx * ny, C).at[flat.reshape(-1)].add(
                (w[..., None] * charge).reshape(-1, C)).reshape(nx, ny, C)
    return S, ScatterStats(clamped=jnp.zeros((), jnp.int32))


def scatter(xrel, yrel, charge, active, stats: GridStats, halo,
            mode: str = "dense"):
    if mode == "dense":
        return scatter_dense(xrel, yrel, charge, active, stats, halo)
    if mode == "xla":
        return scatter_xla(xrel, yrel, charge, active, stats, halo)
    raise ValueError(f"unknown scatter mode {mode!r}")


def scatter_channels(xrel, yrel, chans: Tuple[jnp.ndarray, ...], active,
                     stats: GridStats, halo, mode: str = "dense"):
    """Channel-plane variant of ``scatter``: takes and returns per-channel
    [nx, ny] arrays instead of a stacked [nx, ny, C] (the models' hot
    path keeps per-channel planes)."""
    S, st = scatter(xrel, yrel, jnp.stack(chans, axis=-1), active, stats,
                    halo, mode)
    return tuple(S[..., i] for i in range(len(chans))), st


# ---------------------------------------------------------------------------
# 1D scatter with merge rules
# ---------------------------------------------------------------------------

def scatter_1d_add(xabs: jnp.ndarray, charge: jnp.ndarray,
                   active: jnp.ndarray, xmin: float, dx: float, nx: int,
                   periodic: bool) -> jnp.ndarray:
    """Plain additive 1D CIC scatter from absolute positions (reference
    compute_weights_and_index for OneDGrid, ParticleInCell.jl:163-172)."""
    xn = (xabs - xmin) / dx
    f = jnp.floor(xn).astype(jnp.int32)
    wc = xn - jnp.floor(xn)
    act = active.astype(charge.dtype)
    C = charge.shape[-1]
    S = jnp.zeros((nx, C), charge.dtype)
    for c in (0, 1):
        g = f + c
        w = jnp.where(c == 0, 1.0 - wc, wc) * act
        if periodic:
            g = jnp.mod(g, nx)
        else:
            w = jnp.where((g >= 0) & (g < nx), w, 0.0)
            g = jnp.clip(g, 0, nx - 1)
        S = S.at[g].add(w[..., None] * charge)
    return S


def merge_2d_angle(grid_point: jnp.ndarray, charge: jnp.ndarray) -> jnp.ndarray:
    """Angle-based 2D merge rule, elementwise over [..., 3] (e, m_x, m_y).

    Reference ``merge!`` V1 / the ``⊓`` operator (ParticleInCell.jl:228-253,
    298-299): add when the momentum vectors are within 60 degrees (or the
    node is empty); otherwise the higher-energy side wins the node.  Defined
    in the reference but only wired into the 1D path — the 2D deposit uses
    plain ``+=`` — kept here for API parity.  Two latent reference bugs are
    corrected: the cos-angle numerator's ``grid_point[3] * grid_point[3]``
    typo (intended ``grid_point[3] * charge[3]``, with Julia precedence
    applying the norm division to one term only), and the dead
    ``(cosθ > 0.5) & (ΔE <= 0)`` replace branch (intended ``cosθ < 0.5``).
    """
    gE, gx, gy = grid_point[..., 0], grid_point[..., 1], grid_point[..., 2]
    cE, cx, cy = charge[..., 0], charge[..., 1], charge[..., 2]
    gn = jnp.sqrt(gx ** 2 + gy ** 2)
    cn = jnp.sqrt(cx ** 2 + cy ** 2)
    denom = gn * cn
    cos_t = jnp.where(denom == 0, 1.0,
                      (gx * cx + gy * cy) / jnp.where(denom == 0, 1.0, denom))
    add = cos_t >= 0.5
    keep_grid = ~add & (gE - cE > 0)
    merged = jnp.where(add[..., None], grid_point + charge,
                       jnp.where(keep_grid[..., None], grid_point, charge))
    return merged


def scatter_1d_merge(xabs: jnp.ndarray, charge: jnp.ndarray,
                     active: jnp.ndarray, xmin: float, dx: float, nx: int,
                     periodic: bool) -> jnp.ndarray:
    """1D CIC scatter with the sign-merge rule.

    The reference merges sequentially per contribution (merge!,
    ParticleInCell.jl:276-293): add when momentum signs agree (or the node is
    empty), otherwise keep whichever carries the larger |momentum|.  A
    sequential fold is order-dependent and unparallelizable; here the same
    intent is applied deterministically: contributions are partitioned by
    momentum sign, each sign group is summed, and the group with the larger
    |momentum| wins the node.  For single-signed wave fields (the B01
    regression regime) this is exactly additive like the reference.
    """
    pos_mask = charge[..., 1] >= 0
    S_pos = scatter_1d_add(xabs, charge, active & pos_mask, xmin, dx, nx,
                           periodic)
    S_neg = scatter_1d_add(xabs, charge, active & ~pos_mask, xmin, dx, nx,
                           periodic)
    take_pos = jnp.abs(S_pos[..., 1]) >= jnp.abs(S_neg[..., 1])
    return jnp.where(take_pos[..., None], S_pos, S_neg)
