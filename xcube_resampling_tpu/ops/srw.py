"""Separable-residual warp (SRW): gather-free reprojection at HBM speed.

A general 2D gather reads scattered addresses, while contiguous
row-takes, column-takes shared by all rows, rolls, selects and FMAs all
stream through memory in order.  SRW reformulates smooth-warp resampling
(reprojection, affine) to use only those primitives.

**Two-pass decomposition** (Catmull & Smith 1980 style): vertical pass
``v[j, c] = src(iy*(j, c), c)`` onto the (output-row, source-column) grid,
then horizontal pass ``out[j, i] = v(j, ix(j, i))``.  The reparametrized
row field ``iy*(j, c) = iy(j, ix^{-1}(j, .)(c))`` is computed on the host
from the float64 coarse coordinate field (the inverse exists wherever
``ix`` is monotone along rows — true for regular CRS pairs away from
projection folds; the planner verifies this, callers fall back to the
XLA-gather kernel otherwise).

Two execution strategies, chosen by the planner from the measured field:

* **Tiled** (mild warp): within a column tile, ``iy*`` varies by only a
  few pixels around a per-output-row integer base, so each pass is a short
  sum of hat-weighted whole-row (resp. row-shared column) takes.
* **Aligned** (severe warp/rotation): a smooth per-column integer shift
  vector is applied first via log2(range) roll+select passes, which
  collapses the residual variation to ~1 pixel regardless of rotation;
  the taps then use a per-row base with ~4 taps and no tiles.  This keeps
  the global 4326 -> 3035 configuration on the fast path.

Supports "bilinear" and "nearest" ("triangular" is inherently
non-separable; callers fall back to the gather kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..crs import Transformer
from ..gridmapping import GridMapping


# ---------------------------------------------------------------------------
# shared host-side geometry
# ---------------------------------------------------------------------------


@dataclass
class _Fields:
    """Float64 coarse coordinate fields shared by both planners."""

    ix64: np.ndarray  # (ncj, nci): source col per (out row, out col)
    iy64: np.ndarray  # (ncj, nci): source row per (out row, out col)
    iystar64: np.ndarray  # (ncj, ncc): source row per (out row, src col)
    step: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def _raw_coarse_fields(
    source_gm: GridMapping, target_gm: GridMapping, step: int
) -> tuple[np.ndarray, np.ndarray]:
    """Float64 coarse ix/iy fields of the inverse transform, unvalidated
    (may contain non-finite values near projection singularities).  Bit-for-
    bit the same evaluation as reproject_ops.coarse_coord_field — float32
    casts of these ARE the gather kernel's coordinate fields, which is what
    makes the exact-warp kernels (ops/esw.py) reproduce it exactly."""
    transformer = Transformer.from_crs(target_gm.crs, source_gm.crs)

    out_h, out_w = target_gm.height, target_gm.width

    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2

    tgt_x = np.asarray(target_gm.x_coords.data, dtype=np.float64)
    tgt_y = np.asarray(target_gm.y_coords.data, dtype=np.float64)
    tgt_x0, tgt_dx = float(tgt_x[0]), float(tgt_x[1] - tgt_x[0])
    tgt_y0, tgt_dy = float(tgt_y[0]), float(tgt_y[1] - tgt_y[0])
    xs = tgt_x0 + tgt_dx * (np.arange(nci, dtype=np.float64) * step)
    ys = tgt_y0 + tgt_dy * (np.arange(ncj, dtype=np.float64) * step)
    xx, yy = np.meshgrid(xs, ys)
    sx, sy = transformer.transform(xx, yy)

    src_x0 = float(np.asarray(source_gm.x_coords.data)[0])
    y_vals = np.asarray(source_gm.y_coords.data)
    src_y0 = float(y_vals[0])
    src_yres_signed = float(y_vals[1] - y_vals[0])
    ix64 = (np.asarray(sx) - src_x0) / float(source_gm.x_res)
    iy64 = (np.asarray(sy) - src_y0) / src_yres_signed
    return ix64, iy64


def _coarse_geometry(
    source_gm: GridMapping, target_gm: GridMapping, step: int
) -> _Fields | None:
    out_h, out_w = target_gm.height, target_gm.width
    src_h, src_w = source_gm.height, source_gm.width

    ix64, iy64 = _raw_coarse_fields(source_gm, target_gm, step)

    if not np.isfinite(ix64).all() or not np.isfinite(iy64).all():
        return None

    iystar = _iystar_from_fields(ix64, iy64, src_w, step)
    if iystar is None:
        return None

    return _Fields(ix64, iy64, iystar, step, src_h, src_w, out_h, out_w)


def _iystar_from_fields(
    ix64: np.ndarray, iy64: np.ndarray, src_w: int, step: int
) -> np.ndarray | None:
    """Reparametrized row field iy*(out row, source col) from the coarse
    coordinate fields, or None when rows are not monotone in ix (no valid
    reparametrization exists there)."""
    # monotone ix along output rows is required for the reparametrization
    dx_row = np.diff(ix64, axis=1)
    if np.all(dx_row > 0):
        ascending = True
    elif np.all(dx_row < 0):
        ascending = False
    else:
        return None

    ncj = ix64.shape[0]
    ncc = (src_w - 1) // step + 2
    cs = np.arange(ncc, dtype=np.float64) * step
    iystar = np.empty((ncj, ncc), dtype=np.float64)
    for r in range(ncj):
        xp_row = ix64[r] if ascending else ix64[r, ::-1]
        fp_row = iy64[r] if ascending else iy64[r, ::-1]
        vals = np.interp(cs, xp_row, fp_row)
        # np.interp clamps flat outside the row's ix range; extrapolate
        # linearly so edge taps see consistent positions
        left = cs < xp_row[0]
        if left.any():
            slope = (fp_row[1] - fp_row[0]) / (xp_row[1] - xp_row[0])
            vals[left] = fp_row[0] + (cs[left] - xp_row[0]) * slope
        right = cs > xp_row[-1]
        if right.any():
            slope = (fp_row[-1] - fp_row[-2]) / (xp_row[-1] - xp_row[-2])
            vals[right] = fp_row[-1] + (cs[right] - xp_row[-1]) * slope
        iystar[r] = vals

    return iystar


def _interp_rows(field: np.ndarray, n_rows: int, step: int) -> np.ndarray:
    """Linearly interpolate a coarse field to every output row (matching
    the device's row interpolation)."""
    rows_full = np.arange(n_rows, dtype=np.float64) / step
    jr0 = np.clip(rows_full.astype(np.int64), 0, field.shape[0] - 2)
    frr = rows_full - jr0
    return field[jr0, :] * (1 - frr[:, None]) + field[jr0 + 1, :] * frr[:, None]


def _interp_cols(field: np.ndarray, n_cols: int, step: int) -> np.ndarray:
    cols_full = np.arange(n_cols, dtype=np.float64) / step
    ic0 = np.clip(cols_full.astype(np.int64), 0, field.shape[1] - 2)
    fcc = cols_full - ic0
    return field[:, ic0] * (1 - fcc[None, :]) + field[:, ic0 + 1] * fcc[None, :]


def _twopass_slope(fields: _Fields) -> float:
    """Worst per-pixel variation of the separable warp's fields: the
    two-pass filter deviates from direct bilinear by about a quarter of
    this value on worst-case data.  iy* is measured only on the columns
    the horizontal taps can reach."""
    ix64, iystar, step = fields.ix64, fields.iystar64, fields.step
    k0 = max(0, int(np.floor(np.nanmin(ix64) / step)) - 1)
    k1 = min(iystar.shape[1], int(np.ceil(np.nanmax(ix64) / step)) + 2)
    used = iystar[:, k0:k1] if k1 - k0 >= 2 else iystar
    s_v = float(np.nanmax(np.abs(np.diff(used, axis=1)))) / step
    s_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0)))) / step
    return max(s_v, s_h)


def _fields_interp_err(fields: _Fields) -> float:
    """Estimated worst-case position error (pixels) of linearly
    interpolating the coarse fields: |second difference| / 8.  iy* is
    evaluated only on the columns reachable by the horizontal taps; its
    extrapolated tail (outside every row's ix range) never reaches an
    output pixel."""

    def second_diff_err(f):
        e = 0.0
        if f.shape[1] >= 3:
            e = max(e, float(np.nanmax(np.abs(np.diff(f, 2, axis=1)))) / 8)
        if f.shape[0] >= 3:
            e = max(e, float(np.nanmax(np.abs(np.diff(f, 2, axis=0)))) / 8)
        return e

    ix64, iystar, step = fields.ix64, fields.iystar64, fields.step
    k0 = max(0, int(np.floor(np.nanmin(ix64) / step)) - 1)
    k1 = min(iystar.shape[1], int(np.ceil(np.nanmax(ix64) / step)) + 2)
    used = iystar[:, k0:k1] if k1 - k0 >= 3 else iystar
    return max(
        second_diff_err(used),
        second_diff_err(ix64),
        second_diff_err(fields.iy64),
    )


def fields_from_ij_map(
    ij_map: np.ndarray,
    src_h: int,
    src_w: int,
    step: int = 16,
    pos_tol: float = 0.05,
    gate_mask: np.ndarray | None = None,
) -> _Fields | None:
    """Build SRW coarse fields from a full-resolution fractional (i, j)
    map (e.g. rectify Phase A's output, reference rectify.py:312-371) —
    SRW then accelerates any smooth precomputed warp, not only CRS pairs.

    NaN entries (outside swath coverage) are filled per row by linear
    interpolation/extrapolation from the valid samples; those positions
    are masked downstream by the caller's validity mask, they only have
    to be finite and smooth here.  Because the true per-pixel field is
    available, the coarse approximation is gated on its *measured* error
    (max |coarse-interped - true| over valid pixels <= pos_tol)."""
    ix_full = np.asarray(ij_map[0], dtype=np.float64)
    iy_full = np.asarray(ij_map[1], dtype=np.float64)
    out_h, out_w = ix_full.shape
    if out_h < 2 * step or out_w < 2 * step:
        return None

    def _fill_rows(f):
        filled = f.copy()
        cols = np.arange(out_w, dtype=np.float64)
        last_good = None
        for r in range(out_h):
            row = filled[r]
            good = np.isfinite(row)
            n_good = int(good.sum())
            if n_good == out_w:
                last_good = filled[r]
                continue
            if n_good >= 2:
                xg = cols[good]
                yg = row[good]
                vals = np.interp(cols, xg, yg)
                lo = cols < xg[0]
                if lo.any():
                    s = (yg[1] - yg[0]) / (xg[1] - xg[0])
                    vals[lo] = yg[0] + (cols[lo] - xg[0]) * s
                hi = cols > xg[-1]
                if hi.any():
                    s = (yg[-1] - yg[-2]) / (xg[-1] - xg[-2])
                    vals[hi] = yg[-1] + (cols[hi] - xg[-1]) * s
                filled[r] = vals
                last_good = vals
            elif last_good is not None:
                filled[r] = last_good
            # else: leading sparse/all-NaN rows — back-filled below
        if not np.isfinite(filled).all():
            # leading rows had no valid data: back-fill from the first
            # fully-finite row
            finite_rows = np.where(np.isfinite(filled).all(axis=1))[0]
            if finite_rows.size == 0:
                return None
            filled[: finite_rows[0]] = filled[finite_rows[0]]
        return filled

    ix_f = _fill_rows(ix_full)
    iy_f = _fill_rows(iy_full)
    if ix_f is None or iy_f is None:
        return None

    # coarse subsample (with the last sample clamped to the final pixel,
    # mirroring _coarse_geometry's +2 sampling)
    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2
    rsel = np.minimum(np.arange(ncj) * step, out_h - 1)
    csel = np.minimum(np.arange(nci) * step, out_w - 1)
    ix64 = ix_f[np.ix_(rsel, csel)]
    iy64 = iy_f[np.ix_(rsel, csel)]

    # measured accuracy gate against the true per-pixel field (callers
    # may pass a narrower gate_mask, e.g. the eroded interior when they
    # resolve the coverage-edge band another way)
    valid = gate_mask if gate_mask is not None else np.isfinite(ix_full)
    if valid.any():
        ix_approx = _interp_rows(_interp_cols(ix64, out_w, step), out_h, step)
        iy_approx = _interp_rows(_interp_cols(iy64, out_w, step), out_h, step)
        err = max(
            float(np.max(np.abs(ix_approx[valid] - ix_full[valid]))),
            float(np.max(np.abs(iy_approx[valid] - iy_full[valid]))),
        )
        if err > pos_tol:
            return None

    return _finish_fields(ix64, iy64, step, src_h, src_w, out_h, out_w)


def _finish_fields(
    ix64: np.ndarray,
    iy64: np.ndarray,
    step: int,
    src_h: int,
    src_w: int,
    out_h: int,
    out_w: int,
) -> _Fields | None:
    """Shared tail of the field builders: require monotone columns and
    resample iy onto the source-column lattice (iy*)."""
    ncj = ix64.shape[0]
    dx_row = np.diff(ix64, axis=1)
    if np.all(dx_row > 0):
        ascending = True
    elif np.all(dx_row < 0):
        ascending = False
    else:
        return None

    ncc = (src_w - 1) // step + 2
    cs = np.arange(ncc, dtype=np.float64) * step
    iystar = np.empty((ncj, ncc), dtype=np.float64)
    for r in range(ncj):
        xp_row = ix64[r] if ascending else ix64[r, ::-1]
        fp_row = iy64[r] if ascending else iy64[r, ::-1]
        vals = np.interp(cs, xp_row, fp_row)
        left = cs < xp_row[0]
        if left.any():
            slope = (fp_row[1] - fp_row[0]) / (xp_row[1] - xp_row[0])
            vals[left] = fp_row[0] + (cs[left] - xp_row[0]) * slope
        right = cs > xp_row[-1]
        if right.any():
            slope = (fp_row[-1] - fp_row[-2]) / (xp_row[-1] - xp_row[-2])
            vals[right] = fp_row[-1] + (cs[right] - xp_row[-1]) * slope
        iystar[r] = vals

    return _Fields(ix64, iy64, iystar, step, src_h, src_w, out_h, out_w)


def _fill_lattice_rows(f: np.ndarray) -> np.ndarray | None:
    """Row-wise linear fill/extrapolation of NaN lattice entries (the
    lattice-resolution analogue of the full-map fill above)."""
    filled = f.copy()
    n_rows, n_cols = filled.shape
    cols = np.arange(n_cols, dtype=np.float64)
    last_good = None
    for r in range(n_rows):
        row = filled[r]
        good = np.isfinite(row)
        n_good = int(good.sum())
        if n_good == n_cols:
            last_good = row
            continue
        if n_good >= 2:
            xg, yg = cols[good], row[good]
            vals = np.interp(cols, xg, yg)
            lo = cols < xg[0]
            if lo.any():
                s = (yg[1] - yg[0]) / (xg[1] - xg[0])
                vals[lo] = yg[0] + (cols[lo] - xg[0]) * s
            hi = cols > xg[-1]
            if hi.any():
                s = (yg[-1] - yg[-2]) / (xg[-1] - xg[-2])
                vals[hi] = yg[-1] + (cols[hi] - xg[-1]) * s
            filled[r] = vals
            last_good = vals
        elif last_good is not None:
            filled[r] = last_good
    if not np.isfinite(filled).all():
        finite_rows = np.where(np.isfinite(filled).all(axis=1))[0]
        if finite_rows.size == 0:
            return None
        filled[: finite_rows[0]] = filled[finite_rows[0]]
    return filled


def fields_from_lattice(
    ix_lat: np.ndarray,
    iy_lat: np.ndarray,
    probe_ix: np.ndarray,
    probe_iy: np.ndarray,
    probe_valid: np.ndarray,
    probe_rc: tuple[np.ndarray, np.ndarray],
    step: int,
    src_h: int,
    src_w: int,
    out_h: int,
    out_w: int,
    pos_tol: float = 0.05,
) -> _Fields | None:
    """SRW coarse fields from step-lattice samples of a fractional (i, j)
    map — the device-resident analogue of :func:`fields_from_ij_map` for
    callers that cannot afford fetching the full map to the host (rectify
    Phase B over a :class:`~.rectify_ops.DeviceIJMap`).

    The accuracy gate cannot measure against every pixel; instead it
    checks the half-offset probe lattice (*probe_rc* positions, true map
    values in *probe_ix*/*probe_iy*), where the piecewise-linear
    reconstruction error of a smooth field peaks.  Probes outside the
    coverage (*probe_valid* False) are ignored, like NaN pixels in the
    full-map gate."""
    ix_lat = np.asarray(ix_lat, dtype=np.float64)
    iy_lat = np.asarray(iy_lat, dtype=np.float64)
    lat_valid = np.isfinite(ix_lat) & np.isfinite(iy_lat)
    ix64 = _fill_lattice_rows(ix_lat.copy())
    iy64 = _fill_lattice_rows(iy_lat.copy())
    if ix64 is None or iy64 is None:
        return None

    prow, pcol = probe_rc
    ncj, nci = ix64.shape
    rf = np.asarray(prow, dtype=np.float64) / step
    cf = np.asarray(pcol, dtype=np.float64) / step
    r0 = np.clip(rf.astype(np.int64), 0, ncj - 2)
    c0 = np.clip(cf.astype(np.int64), 0, nci - 2)
    fr = (rf - r0)[:, None]
    fc = (cf - c0)[None, :]
    # gate only where the reconstruction rests on measured (not filled)
    # lattice samples: SRW output is consumed on the interior eroded by
    # step+2 pixels, whose entire lattice support is valid by
    # construction — boundary probes reconstruct from extrapolated
    # samples and are resolved by the caller's exact edge gather instead
    supported = (
        lat_valid[r0[:, None], c0[None, :]]
        & lat_valid[r0[:, None], c0[None, :] + 1]
        & lat_valid[r0[:, None] + 1, c0[None, :]]
        & lat_valid[r0[:, None] + 1, c0[None, :] + 1]
    )
    gate = np.asarray(probe_valid, dtype=bool) & supported
    if gate.any():
        err = 0.0
        for field, true_vals in ((ix64, probe_ix), (iy64, probe_iy)):
            approx = (
                field[r0[:, None], c0[None, :]] * (1 - fr) * (1 - fc)
                + field[r0[:, None], c0[None, :] + 1] * (1 - fr) * fc
                + field[r0[:, None] + 1, c0[None, :]] * fr * (1 - fc)
                + field[r0[:, None] + 1, c0[None, :] + 1] * fr * fc
            )
            diff = np.abs(approx - np.asarray(true_vals, dtype=np.float64))
            err = max(err, float(np.max(diff[gate])))
        if err > pos_tol:
            return None

    return _finish_fields(ix64, iy64, step, src_h, src_w, out_h, out_w)


# ---------------------------------------------------------------------------
# tiled plan (mild warp)
# ---------------------------------------------------------------------------


@dataclass
class SRWPlan:
    """Tiled-strategy plan: coarse fields, per-tile bases, tap counts."""

    iystar_c: np.ndarray
    step_vr: int
    step_vc: int
    base_v: np.ndarray  # (out_h, n_col_tiles) int32
    d_v: int
    col_tile: int
    ix_c: np.ndarray
    iy_c: np.ndarray
    step: int
    base_h: np.ndarray  # (n_row_tiles, out_w) int32
    d_h: int
    row_tile: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def _pick_tile(slope: float, tap_budget: int) -> int:
    """Largest power-of-two tile in [64, 1024] whose in-tile span stays
    around *tap_budget* positions."""
    if not np.isfinite(slope) or slope <= 0:
        return 1024
    tile = tap_budget / slope
    for cand in (1024, 512, 256, 128, 64):
        if tile >= cand:
            return cand
    return 64


def plan_srw(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    col_tile: int | None = None,
    row_tile: int | None = None,
    max_taps: int = 48,
    tap_budget: int = 12,
    fields: _Fields | None = None,
) -> SRWPlan | None:
    """Build the tiled plan, or None when the mapping is unsuitable."""
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step
    ncj = ix64.shape[0]

    if col_tile is None:
        slope_v = float(np.nanmax(np.abs(np.diff(iystar, axis=1))) / step)
        col_tile = _pick_tile(slope_v, tap_budget)
    if row_tile is None:
        slope_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0))) / step)
        row_tile = _pick_tile(slope_h, tap_budget)

    # vertical: per-(out row, col tile) base
    ncc = iystar.shape[1]
    n_col_tiles = -(-src_w // col_tile)
    iystar_rows = _interp_rows(iystar, out_h, step)
    base_v = np.zeros((out_h, n_col_tiles), dtype=np.int32)
    span_max = 0.0
    for t in range(n_col_tiles):
        c0 = t * col_tile
        c1 = min((t + 1) * col_tile, src_w)
        k0 = max(0, c0 // step - 1)
        k1 = min(ncc, -(-c1 // step) + 1)
        seg = iystar_rows[:, k0:k1]
        m = seg.min(axis=1)
        base_v[:, t] = np.floor(m).astype(np.int32) - 1
        span_max = max(span_max, float((seg.max(axis=1) - m).max()))
    d_v = int(np.ceil(span_max)) + 4
    if d_v > max_taps:
        return None

    # horizontal: per-(row tile, out col) base
    n_row_tiles = -(-out_h // row_tile)
    ix_cols = _interp_cols(ix64, out_w, step)
    base_h = np.zeros((n_row_tiles, out_w), dtype=np.int32)
    span_max_h = 0.0
    sample_rows = np.arange(ncj) * step
    for t in range(n_row_tiles):
        r0 = t * row_tile
        r1 = min((t + 1) * row_tile, out_h)
        k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
        k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
        seg = ix_cols[k0:k1, :]
        m = seg.min(axis=0)
        base_h[t, :] = np.floor(m).astype(np.int32) - 1
        span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
    d_h = int(np.ceil(span_max_h)) + 4
    if d_h > max_taps:
        return None

    return SRWPlan(
        iystar_c=iystar.astype(np.float32),
        step_vr=step,
        step_vc=step,
        base_v=base_v,
        d_v=d_v,
        col_tile=col_tile,
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        base_h=base_h,
        d_h=d_h,
        row_tile=row_tile,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


def make_srw_fn(plan: SRWPlan, interp_method: str = "bilinear", fill_value=np.nan):
    """Compile the tiled SRW kernel.

    The per-pixel tap positions and the validity mask are functions of the
    geometry alone, so they are materialized ONCE on device at build time
    (a small jitted precompute) and fed to the per-call kernel as
    arguments — the steady-state kernel then runs only taps, weights and
    the fill select, saving ~half the per-call HBM streams."""
    import jax
    import jax.numpy as jnp

    if interp_method not in ("bilinear", "nearest", "triangular"):
        raise ValueError(
            "SRW supports 'bilinear', 'nearest' and 'triangular' only"
        )
    tri = interp_method == "triangular"

    p = plan
    base_v = jnp.asarray(p.base_v)
    base_h = jnp.asarray(p.base_h)

    from .reproject_ops import _interp_field

    n_col_tiles = p.base_v.shape[1]
    n_row_tiles = p.base_h.shape[0]

    def weight(pos, k):
        if interp_method == "nearest":
            return (jnp.round(pos) == k).astype(jnp.float32)
        return jnp.maximum(0.0, 1.0 - jnp.abs(pos - k))

    def dweight(pos, k):
        # the (1, -1) mixed-difference taps of the triangular correction:
        # +1 at floor(pos), -1 at floor(pos)+1 (see kernel note below)
        f = jnp.floor(pos)
        return (f == k).astype(jnp.float32) - (f + 1.0 == k).astype(
            jnp.float32
        )

    @jax.jit
    def precompute(iystar_f, ix_f, iy_f):
        rows = jnp.arange(p.out_h, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(p.src_w, dtype=jnp.float32)[None, :]
        pos_v = _interp_field(iystar_f, rows, cols_src, p.step, jnp)
        cols = jnp.arange(p.out_w, dtype=jnp.float32)[None, :]
        pos_h = _interp_field(ix_f, rows, cols, p.step, jnp)
        ix_full = pos_h  # same field
        iy_full = _interp_field(iy_f, rows, cols, p.step, jnp)
        valid = (
            (ix_full > -0.5)
            & (ix_full < p.src_w - 0.5)
            & (iy_full > -0.5)
            & (iy_full < p.src_h - 0.5)
        )
        if not tri:
            return pos_v, pos_h, valid, jnp.zeros((), jnp.float32)
        # triangular = bilinear - s * Delta with s = min(uv, (1-u)(1-v))
        # (u, v) the x/y fractional parts (reference reproject.py:300-320
        # two-triangle split, rearranged around the bilinear form)
        u = ix_full - jnp.floor(ix_full)
        vf = iy_full - jnp.floor(iy_full)
        s = jnp.minimum(u * vf, (1.0 - u) * (1.0 - vf)).astype(jnp.float32)
        return pos_v, pos_h, valid, s

    pos_v_dev, pos_h_dev, valid_dev, s_dev = precompute(
        jnp.asarray(p.iystar_c), jnp.asarray(p.ix_c), jnp.asarray(p.iy_c)
    )

    @jax.jit
    def kernel(src, pos_v, pos_h, valid, bv, bh, s):
        # vertical pass: (out_h, src_w).  For triangular a second
        # accumulator carries the vertical (1, -1) difference through the
        # SAME taps; the horizontal pass turns it into the quad's mixed
        # second difference Delta = v00 - v01 - v10 + v11, and
        # out = bilinear - s * Delta reproduces the reference's
        # two-triangle interpolation exactly (both branches differ from
        # bilinear by that rank-one term).
        v_tiles = []
        vd_tiles = []
        for t in range(n_col_tiles):
            c0 = t * p.col_tile
            c1 = min((t + 1) * p.col_tile, p.src_w)
            pos = pos_v[:, c0:c1]
            base_t = bv[:, t]
            tile_src = src[..., c0:c1]
            acc = jnp.zeros(src.shape[:-2] + (p.out_h, c1 - c0), dtype=jnp.float32)
            acc_d = acc
            for d in range(p.d_v):
                idx = jnp.clip(base_t + d, 0, p.src_h - 1)
                k = (base_t + d)[:, None].astype(jnp.float32)
                taken = jnp.take(tile_src, idx, axis=-2)
                acc = acc + weight(pos, k) * taken
                if tri:
                    acc_d = acc_d + dweight(pos, k) * taken
            v_tiles.append(acc)
            if tri:
                vd_tiles.append(acc_d)
        v = jnp.concatenate(v_tiles, axis=-1)
        vd = jnp.concatenate(vd_tiles, axis=-1) if tri else None

        # horizontal pass: (out_h, out_w)
        out_tiles = []
        for t in range(n_row_tiles):
            r0 = t * p.row_tile
            r1 = min((t + 1) * p.row_tile, p.out_h)
            pos = pos_h[r0:r1, :]
            base_t = bh[t]
            tile_v = v[..., r0:r1, :]
            tile_vd = vd[..., r0:r1, :] if tri else None
            acc = jnp.zeros(src.shape[:-2] + (r1 - r0, p.out_w), dtype=jnp.float32)
            acc_d = acc
            for d in range(p.d_h):
                idx = jnp.clip(base_t + d, 0, p.src_w - 1)
                k = (base_t + d)[None, :].astype(jnp.float32)
                acc = acc + weight(pos, k) * jnp.take(tile_v, idx, axis=-1)
                if tri:
                    acc_d = acc_d + dweight(pos, k) * jnp.take(
                        tile_vd, idx, axis=-1
                    )
            if tri:
                acc = acc - s[r0:r1, :] * acc_d
            out_tiles.append(acc)
        out = jnp.concatenate(out_tiles, axis=-2)

        fill = jnp.asarray(fill_value, dtype=out.dtype)
        return jnp.where(valid, out, fill)

    def fn(src):
        return kernel(
            src, pos_v_dev, pos_h_dev, valid_dev, base_v, base_h, s_dev
        )

    return fn


def make_srw_fn_batched(
    plan: SRWPlan, interp_method: str = "bilinear", fill_value=np.nan
):
    """Tiled SRW with *batched* tap loops: the per-tile Python loops of
    :func:`make_srw_fn` emit ``n_tiles * d`` XLA ops — fine at a handful
    of tiles, but a compile-time problem at large rasters (e.g. a 20k
    grid with 512-px tiles emits 500+ takes).  Here each tap is a single
    ``take_along_axis`` over a leading tile axis with size-1 index dims
    (a row gather invariant along the minor axis; see
    :func:`make_srw_hybrid_fn`), so the op count is d_v + d_h regardless
    of tile count.  The horizontal pass transposes each row tile so its
    take also indexes rows.
    """
    import jax
    import jax.numpy as jnp

    if interp_method not in ("bilinear", "nearest", "triangular"):
        raise ValueError(
            "SRW supports 'bilinear', 'nearest' and 'triangular' only"
        )
    tri = interp_method == "triangular"

    p = plan
    iystar_c = jnp.asarray(p.iystar_c)
    ix_c = jnp.asarray(p.ix_c)
    iy_c = jnp.asarray(p.iy_c)
    base_v = jnp.asarray(p.base_v)
    base_h = jnp.asarray(p.base_h)

    from .reproject_ops import _interp_field

    n_col_tiles = p.base_v.shape[1]
    n_row_tiles = p.base_h.shape[0]
    src_w_pad = n_col_tiles * p.col_tile
    out_h_pad = n_row_tiles * p.row_tile

    def weight(pos, k):
        if interp_method == "nearest":
            return (jnp.round(pos) == k).astype(jnp.float32)
        return jnp.maximum(0.0, 1.0 - jnp.abs(pos - k))

    def dweight(pos, k):
        # (1, -1) mixed-difference taps of the triangular correction
        # (see make_srw_fn's kernel note)
        f = jnp.floor(pos)
        return (f == k).astype(jnp.float32) - (f + 1.0 == k).astype(
            jnp.float32
        )

    # geometry-static position fields and validity mask, materialized once
    # at build time in the layouts the tap loops consume
    @jax.jit
    def precompute(iystar_f, ix_f, iy_f):
        rows = jnp.arange(p.out_h, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(p.src_w, dtype=jnp.float32)[None, :]
        pos_v = _interp_field(iystar_f, rows, cols_src, p.step, jnp)
        if src_w_pad > p.src_w:
            pos_v = jnp.pad(pos_v, ((0, 0), (0, src_w_pad - p.src_w)))
        pos_t = jnp.moveaxis(
            pos_v.reshape(p.out_h, n_col_tiles, p.col_tile), -2, 0
        )
        cols = jnp.arange(p.out_w, dtype=jnp.float32)[None, :]
        pos_h = _interp_field(ix_f, rows, cols, p.step, jnp)
        iy_full = _interp_field(iy_f, rows, cols, p.step, jnp)
        valid = (
            (pos_h > -0.5)
            & (pos_h < p.src_w - 0.5)
            & (iy_full > -0.5)
            & (iy_full < p.src_h - 0.5)
        )
        if tri:
            u = pos_h - jnp.floor(pos_h)
            vf = iy_full - jnp.floor(iy_full)
            s = jnp.minimum(
                u * vf, (1.0 - u) * (1.0 - vf)
            ).astype(jnp.float32)
        else:
            s = jnp.zeros((), jnp.float32)
        if out_h_pad > p.out_h:
            pos_h = jnp.pad(pos_h, ((0, out_h_pad - p.out_h), (0, 0)))
        pos_ht = jnp.swapaxes(
            pos_h.reshape(n_row_tiles, p.row_tile, p.out_w), -1, -2
        )
        return pos_t, pos_ht, valid, s

    pos_t_dev, pos_ht_dev, valid_dev, s_dev = precompute(
        iystar_c, ix_c, iy_c
    )

    @jax.jit
    def kernel(src, pos_t, pos_ht, valid, bv, bh, s):
        batch = src.shape[:-2]

        src2 = src.astype(jnp.float32)
        if src_w_pad > p.src_w:
            pad = src_w_pad - p.src_w
            src2 = jnp.pad(src2, [(0, 0)] * (src2.ndim - 1) + [(0, pad)])
        src_t = jnp.moveaxis(
            src2.reshape(batch + (p.src_h, n_col_tiles, p.col_tile)), -2, 0
        )
        acc = jnp.zeros(
            (n_col_tiles,) + batch + (p.out_h, p.col_tile), jnp.float32
        )
        acc_d = acc
        bvt = jnp.moveaxis(bv, -1, 0)  # (T, out_h)
        for d in range(p.d_v):
            idx = jnp.clip(bvt + d, 0, p.src_h - 1)
            k = (bvt + d)[..., None].astype(jnp.float32)
            idx_b = idx.reshape(
                (n_col_tiles,) + (1,) * len(batch) + (p.out_h, 1)
            )
            taken = jnp.take_along_axis(src_t, idx_b, axis=-2)
            acc = acc + weight(pos_t, k).reshape(
                (n_col_tiles,) + (1,) * len(batch) + (p.out_h, p.col_tile)
            ) * taken
            if tri:
                acc_d = acc_d + dweight(pos_t, k).reshape(
                    (n_col_tiles,) + (1,) * len(batch)
                    + (p.out_h, p.col_tile)
                ) * taken

        def _h_pass(acc_v, wfun):
            v = jnp.moveaxis(acc_v, 0, -2).reshape(
                batch + (p.out_h, src_w_pad)
            )[..., : p.src_w]
            v2 = v
            if out_h_pad > p.out_h:
                pad = out_h_pad - p.out_h
                v2 = jnp.pad(
                    v2, [(0, 0)] * (v2.ndim - 2) + [(0, pad), (0, 0)]
                )
            v_t = jnp.swapaxes(
                jnp.moveaxis(
                    v2.reshape(
                        batch + (n_row_tiles, p.row_tile, p.src_w)
                    ),
                    -3,
                    0,
                ),
                -1,
                -2,
            )  # (T, ..., src_w, row_tile)
            out_acc = jnp.zeros(
                (n_row_tiles,) + batch + (p.out_w, p.row_tile), jnp.float32
            )
            for d in range(p.d_h):
                idx = jnp.clip(bh + d, 0, p.src_w - 1)
                w = wfun(pos_ht, (bh + d)[:, :, None].astype(jnp.float32))
                idx_b = idx.reshape(
                    (n_row_tiles,) + (1,) * len(batch) + (p.out_w, 1)
                )
                taken = jnp.take_along_axis(v_t, idx_b, axis=-2)
                out_acc = out_acc + w.reshape(
                    (n_row_tiles,) + (1,) * len(batch)
                    + (p.out_w, p.row_tile)
                ) * taken
            return jnp.moveaxis(
                jnp.swapaxes(out_acc, -1, -2), 0, -3
            ).reshape(batch + (out_h_pad, p.out_w))[..., : p.out_h, :]

        out = _h_pass(acc, weight)
        if tri:
            out = out - s * _h_pass(acc_d, dweight)

        fill = jnp.asarray(fill_value, dtype=out.dtype)
        return jnp.where(valid, out, fill)

    def fn(src):
        return kernel(
            src, pos_t_dev, pos_ht_dev, valid_dev, base_v, base_h, s_dev
        )

    return fn


def _mask_fill(out, ix_f, iy_f, p, fill_value, jnp):
    from .reproject_ops import _interp_field

    rows_all = jnp.arange(p.out_h, dtype=jnp.float32)[:, None]
    cols = jnp.arange(p.out_w, dtype=jnp.float32)[None, :]
    ix_full = _interp_field(ix_f, rows_all, cols, p.step, jnp)
    iy_full = _interp_field(iy_f, rows_all, cols, p.step, jnp)
    valid = (
        (ix_full > -0.5)
        & (ix_full < p.src_w - 0.5)
        & (iy_full > -0.5)
        & (iy_full < p.src_h - 0.5)
    )
    fill = jnp.asarray(fill_value, dtype=out.dtype)
    return jnp.where(valid, out, fill)


# ---------------------------------------------------------------------------
# aligned plan (severe warp)
# ---------------------------------------------------------------------------


@dataclass
class SRWAlignedPlan:
    """Aligned-strategy plan: integer shift vectors + per-row/col bases."""

    iystar_c: np.ndarray
    ix_c: np.ndarray
    iy_c: np.ndarray
    step: int
    s_v: np.ndarray  # (src_w,) int32 per-source-column upward shift, >= 0
    bits_v: int
    base_v: np.ndarray  # (out_h,) int32 in shifted row space
    d_v: int
    s_h: np.ndarray  # (out_h,) int32 per-output-row left shift, >= 0
    bits_h: int
    base_h: np.ndarray  # (out_w,) int32 in shifted column space
    d_h: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def plan_srw_aligned(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 16,
    fields: _Fields | None = None,
) -> SRWAlignedPlan | None:
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step

    # vertical alignment: shift each source column by the mid-row value of
    # iy*; the residual then varies along columns only through curvature
    mid = iystar.shape[0] // 2
    cs = np.arange(iystar.shape[1], dtype=np.float64) * step
    s_v_f = np.interp(np.arange(src_w, dtype=np.float64), cs, iystar[mid])
    s_v0 = np.round(s_v_f).astype(np.int64)
    s_v = s_v0 - s_v0.min()
    bits_v = max(1, int(s_v.max()).bit_length())

    # residual position field in shifted space, per output row
    s_v0_coarse = s_v0[np.clip(cs.astype(np.int64), 0, src_w - 1)]
    res_v = iystar - s_v0_coarse[None, :] + s_v0.min()  # == iystar - s_v(c)
    res_rows = _interp_rows(res_v, out_h, step)
    m = np.nanmin(res_rows, axis=1)
    base_v = np.floor(m).astype(np.int32) - 1
    d_v = int(np.ceil(np.nanmax(np.nanmax(res_rows, axis=1) - m))) + 4
    if d_v > max_taps:
        return None

    # horizontal alignment: shift each output row by the mid-column ix
    midc = ix64.shape[1] // 2
    rows_grid = np.arange(ix64.shape[0], dtype=np.float64) * step
    s_h_f = np.interp(np.arange(out_h, dtype=np.float64), rows_grid, ix64[:, midc])
    s_h0 = np.round(s_h_f).astype(np.int64)
    s_h = s_h0 - s_h0.min()
    bits_h = max(1, int(s_h.max()).bit_length())

    s_h0_coarse = s_h0[
        np.clip((rows_grid).astype(np.int64), 0, out_h - 1)
    ]
    res_h = ix64 - s_h0_coarse[:, None] + s_h0.min()
    res_cols = _interp_cols(res_h, out_w, step)
    mh = np.nanmin(res_cols, axis=0)
    base_h = np.floor(mh).astype(np.int32) - 1
    d_h = int(np.ceil(np.nanmax(np.nanmax(res_cols, axis=0) - mh))) + 4
    if d_h > max_taps:
        return None

    return SRWAlignedPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        s_v=s_v.astype(np.int32),
        bits_v=bits_v,
        base_v=base_v,
        d_v=d_v,
        s_h=s_h.astype(np.int32),
        bits_h=bits_h,
        base_h=base_h,
        d_h=d_h,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


def make_srw_aligned_fn(
    plan: SRWAlignedPlan, interp_method: str = "bilinear", fill_value=np.nan
):
    """Compile the aligned SRW kernel (shift passes + per-row-base taps)."""
    import jax
    import jax.numpy as jnp

    if interp_method not in ("bilinear", "nearest"):
        raise ValueError("SRW supports 'bilinear' and 'nearest' only")

    p = plan
    iystar_c = jnp.asarray(p.iystar_c)
    ix_c = jnp.asarray(p.ix_c)
    iy_c = jnp.asarray(p.iy_c)
    s_v = jnp.asarray(p.s_v)
    s_h = jnp.asarray(p.s_h)
    base_v = jnp.asarray(p.base_v)
    base_h = jnp.asarray(p.base_h)
    # the offset removed from s_v/s_h at plan time (min) is already folded
    # into the residual bases

    from .reproject_ops import _interp_field

    def weight(pos, k):
        if interp_method == "bilinear":
            return jnp.maximum(0.0, 1.0 - jnp.abs(pos - k))
        return (jnp.round(pos) == k).astype(jnp.float32)

    # shifted-space taps outside [0, src_h)/[0, src_w) must resolve to the
    # *global* edge, not the shifted array's edge (see make_srw_hybrid_fn)
    r_lo = min(0, int(plan.base_v.min()))
    r_hi = max(0, int(plan.base_v.max()) + plan.d_v - plan.src_h)
    c_lo = min(0, int(plan.base_h.min()))
    c_hi = max(0, int(plan.base_h.max()) + plan.d_h - plan.src_w)

    @jax.jit
    def kernel(src, iystar_f, ix_f, iy_f, sv, sh, bv, bh):
        # --- vertical: align columns upward by s_v via log2 shift passes
        src2 = src.astype(jnp.float32)
        if r_lo or r_hi:
            src2 = jnp.concatenate(
                [jnp.repeat(src2[..., :1, :], -r_lo, axis=-2), src2]
                + ([jnp.repeat(src2[..., -1:, :], r_hi, axis=-2)] if r_hi else []),
                axis=-2,
            )
        ext_h = p.src_h - r_lo + r_hi
        for b in range(p.bits_v):
            k = 1 << b
            rolled = jnp.concatenate(
                [
                    src2[..., k:, :],
                    jnp.repeat(src2[..., -1:, :], k, axis=-2),
                ],
                axis=-2,
            )
            mask = ((sv >> b) & 1).astype(bool)[None, :]
            src2 = jnp.where(mask, rolled, src2)

        rows = jnp.arange(p.out_h, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(p.src_w, dtype=jnp.float32)[None, :]
        pos = (
            _interp_field(iystar_f, rows, cols_src, p.step, jnp)
            - sv[None, :].astype(jnp.float32)
        )
        acc = jnp.zeros(src.shape[:-2] + (p.out_h, p.src_w), dtype=jnp.float32)
        for d in range(p.d_v):
            idx = jnp.clip(bv + d - r_lo, 0, ext_h - 1)
            w = weight(pos, (bv + d)[:, None].astype(jnp.float32))
            acc = acc + w * jnp.take(src2, idx, axis=-2)
        v = acc

        # --- horizontal: align rows leftward by s_h
        v2 = v
        if c_lo or c_hi:
            v2 = jnp.concatenate(
                [jnp.repeat(v2[..., :, :1], -c_lo, axis=-1), v2]
                + ([jnp.repeat(v2[..., :, -1:], c_hi, axis=-1)] if c_hi else []),
                axis=-1,
            )
        ext_w = p.src_w - c_lo + c_hi
        for b in range(p.bits_h):
            k = 1 << b
            rolled = jnp.concatenate(
                [
                    v2[..., :, k:],
                    jnp.repeat(v2[..., :, -1:], k, axis=-1),
                ],
                axis=-1,
            )
            mask = ((sh >> b) & 1).astype(bool)[:, None]
            v2 = jnp.where(mask, rolled, v2)

        cols = jnp.arange(p.out_w, dtype=jnp.float32)[None, :]
        posh = (
            _interp_field(ix_f, rows, cols, p.step, jnp)
            - sh[:, None].astype(jnp.float32)
        )
        out = jnp.zeros(src.shape[:-2] + (p.out_h, p.out_w), dtype=jnp.float32)
        for d in range(p.d_h):
            idx = jnp.clip(bh + d - c_lo, 0, ext_w - 1)
            w = weight(posh, (bh + d)[None, :].astype(jnp.float32))
            out = out + w * jnp.take(v2, idx, axis=-1)

        return _mask_fill(out, ix_f, iy_f, p, fill_value, jnp)

    def fn(src):
        return kernel(src, iystar_c, ix_c, iy_c, s_v, s_h, base_v, base_h)

    return fn


# ---------------------------------------------------------------------------
# hybrid plan (severe, spatially varying warp)
# ---------------------------------------------------------------------------


@dataclass
class SRWHybridPlan:
    """Hybrid strategy: align shifts (as in the aligned plan) collapse the
    bulk rotation, *tiled* residual bases absorb the row/column dependence
    that sinks the pure aligned plan on domain-scale warps (where the local
    rotation/scale varies by tens of degrees, e.g. full-plane 4326->3035).

    Residual structure: with ``s_v(c)`` the per-column shift, the vertical
    tap base may depend on (output row, column tile), so the only quantity
    that must stay small is the *in-tile column spread at fixed row* of
    ``iy*(j,c) - s_v(c)`` — a mixed-derivative term, orders of magnitude
    smaller than the raw rotation slope that bounds the tiled plan.
    """

    iystar_c: np.ndarray
    ix_c: np.ndarray
    iy_c: np.ndarray
    step: int
    s_v: np.ndarray  # (src_w,) int32 >= 0 upward shift per source column
    bits_v: int
    base_v: np.ndarray  # (out_h, n_col_tiles) int32, residual space
    d_v: int
    col_tile: int
    s_h: np.ndarray  # (out_h,) int32 >= 0 left shift per output row
    bits_h: int
    base_h: np.ndarray  # (n_row_tiles, out_w) int32, residual space
    d_h: int
    row_tile: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int


def plan_srw_hybrid(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 32,
    tap_budget: int = 12,
    fields: _Fields | None = None,
    pos_tol: float = 0.5,
) -> SRWHybridPlan | None:
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step

    # curvature gate: the kernel linearly interpolates the coarse iy*/ix
    # fields; near projection singularities their curvature makes that
    # interpolation itself wrong by ~|second difference|/8 pixels.  Reject
    # when the estimated position error exceeds pos_tol (callers can retry
    # with a finer coarse step — the error scales with step^2).
    if _fields_interp_err(fields) > pos_tol:
        return None

    # ---- vertical: derivative-midrange shift — s_v'(c) is the midrange
    # over output rows of d iy*/dc, which minimizes the worst-case in-tile
    # residual slope at any row (the base absorbs all row dependence)
    cs = np.arange(iystar.shape[1], dtype=np.float64) * step
    dv = np.diff(iystar, axis=1)
    mid_slope_v = 0.5 * (dv.max(axis=0) + dv.min(axis=0))
    s_v_coarse = np.concatenate([[0.0], np.cumsum(mid_slope_v)])
    s_v_coarse = np.round(s_v_coarse)
    s_v0 = np.round(
        np.interp(np.arange(src_w, dtype=np.float64), cs, s_v_coarse)
    ).astype(np.int64)
    s_v = s_v0 - s_v0.min()
    bits_v = max(1, int(s_v.max()).bit_length())

    # residual at the coarse grid, using the exact per-pixel shift values
    s_v0_at_cs = s_v0[np.clip(cs.astype(np.int64), 0, src_w - 1)]
    res_v = iystar - (s_v0_at_cs - s_v0.min())[None, :]
    res_rows = _interp_rows(res_v, out_h, step)  # (out_h, ncc)
    ncc = res_v.shape[1]

    def _v_layout(col_tile):
        n_col_tiles = -(-src_w // col_tile)
        base = np.zeros((out_h, n_col_tiles), dtype=np.int32)
        span_max = 0.0
        for t in range(n_col_tiles):
            c0 = t * col_tile
            c1 = min((t + 1) * col_tile, src_w)
            k0 = max(0, c0 // step - 1)
            k1 = min(ncc, -(-c1 // step) + 1)
            seg = res_rows[:, k0:k1]
            m = seg.min(axis=1)
            base[:, t] = np.floor(m).astype(np.int32) - 1
            span_max = max(span_max, float((seg.max(axis=1) - m).max()))
        return base, int(np.ceil(span_max)) + 4

    # the vertical take's minor dimension is col_tile: tiles narrower
    # than 128 columns count their taps as if 128 wide (a tuned penalty
    # on narrow tiles, to be re-tuned on the GPU)
    best_v = None
    for cand in (512, 256, 128, 64, 32):
        base, d = _v_layout(cand)
        eff = d * max(1.0, 128.0 / cand)
        if d <= max_taps and (best_v is None or eff < best_v[0]):
            best_v = (eff, cand, base, d)
    if best_v is None:
        return None
    _, col_tile, base_v, d_v = best_v

    # ---- horizontal: derivative-midrange shift over rows; residual
    # i-dependence is absorbed by the per-column base within each row tile
    rows_grid = np.arange(ix64.shape[0], dtype=np.float64) * step
    dh = np.diff(ix64, axis=0)
    mid_slope_h = 0.5 * (dh.max(axis=1) + dh.min(axis=1))
    s_h_coarse = np.concatenate([[0.0], np.cumsum(mid_slope_h)])
    s_h_coarse = np.round(s_h_coarse)
    s_h0 = np.round(
        np.interp(np.arange(out_h, dtype=np.float64), rows_grid, s_h_coarse)
    ).astype(np.int64)
    s_h = s_h0 - s_h0.min()
    bits_h = max(1, int(s_h.max()).bit_length())

    s_h0_at_rows = s_h0[
        np.clip(rows_grid.astype(np.int64), 0, out_h - 1)
    ]
    res_h = ix64 - (s_h0_at_rows - s_h0.min())[:, None]
    res_cols = _interp_cols(res_h, out_w, step)  # (ncj, out_w)
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step

    def _h_layout(row_tile):
        n_row_tiles = -(-out_h // row_tile)
        base = np.zeros((n_row_tiles, out_w), dtype=np.int32)
        span_max_h = 0.0
        for t in range(n_row_tiles):
            r0 = t * row_tile
            r1 = min((t + 1) * row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = res_cols[k0:k1, :]
            m = seg.min(axis=0)
            base[t, :] = np.floor(m).astype(np.int32) - 1
            span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
        return base, int(np.ceil(span_max_h)) + 4

    # after the kernel's per-tile transpose, row_tile is the minor
    # dimension of the horizontal take: the same narrow-tile penalty
    best_h = None
    for cand in (512, 256, 128, 64, 32, 16):
        base, d = _h_layout(cand)
        eff = d * max(1.0, 128.0 / cand)
        if d <= max_taps and (best_h is None or eff < best_h[0]):
            best_h = (eff, d, cand, base)
    if best_h is None:
        return None
    _, d_h, row_tile, base_h = best_h

    return SRWHybridPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=ix64.astype(np.float32),
        iy_c=iy64.astype(np.float32),
        step=step,
        s_v=s_v.astype(np.int32),
        bits_v=bits_v,
        base_v=base_v,
        d_v=d_v,
        col_tile=col_tile,
        s_h=s_h.astype(np.int32),
        bits_h=bits_h,
        base_h=base_h,
        d_h=d_h,
        row_tile=row_tile,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
    )


def make_srw_hybrid_fn(
    plan: SRWHybridPlan, interp_method: str = "bilinear", fill_value=np.nan
):
    """Compile the hybrid kernel: shift passes + tiled residual taps.

    The tile loops use *batched* takes (``take_along_axis`` over a tile
    axis) so the op count stays at d_v + d_h regardless of tile count —
    XLA lowers the per-tile row gather to streaming loads.
    """
    import jax
    import jax.numpy as jnp

    if interp_method not in ("bilinear", "nearest"):
        raise ValueError("SRW supports 'bilinear' and 'nearest' only")

    p = plan
    iystar_c = jnp.asarray(p.iystar_c)
    ix_c = jnp.asarray(p.ix_c)
    iy_c = jnp.asarray(p.iy_c)
    s_v = jnp.asarray(p.s_v)
    s_h = jnp.asarray(p.s_h)
    base_v = jnp.asarray(p.base_v)
    base_h = jnp.asarray(p.base_h)

    from .reproject_ops import _interp_field

    n_col_tiles = p.base_v.shape[1]
    n_row_tiles = p.base_h.shape[0]
    # padded tiled widths (tiles uniformized to full size; edge tiles pad)
    src_w_pad = n_col_tiles * p.col_tile
    out_h_pad = n_row_tiles * p.row_tile

    def weight(pos, k):
        if interp_method == "bilinear":
            return jnp.maximum(0.0, 1.0 - jnp.abs(pos - k))
        return (jnp.round(pos) == k).astype(jnp.float32)

    # shifted-space tap ranges can leave [0, src_h): clamping there would
    # read row s_v(c) / column s_h(j) instead of the true global edge (the
    # shift moves the array edge per column/row).  Pad so every tap index
    # is in-bounds of an array whose construction already encodes the
    # correct global clamp-to-edge.
    r_lo = min(0, int(plan.base_v.min()))
    r_hi = max(0, int(plan.base_v.max()) + plan.d_v - plan.src_h)
    c_lo = min(0, int(plan.base_h.min()))
    c_hi = max(0, int(plan.base_h.max()) + plan.d_h - plan.src_w)

    # geometry-static position fields / validity, materialized once in the
    # layouts the tap loops consume
    @jax.jit
    def precompute(iystar_f, ix_f, iy_f, sv, sh):
        rows = jnp.arange(p.out_h, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(p.src_w, dtype=jnp.float32)[None, :]
        pos_v = (
            _interp_field(iystar_f, rows, cols_src, p.step, jnp)
            - sv[None, :].astype(jnp.float32)
        )
        if src_w_pad > p.src_w:
            pos_v = jnp.pad(pos_v, ((0, 0), (0, src_w_pad - p.src_w)))
        pos_t = jnp.moveaxis(
            pos_v.reshape(p.out_h, n_col_tiles, p.col_tile), -2, 0
        )
        cols = jnp.arange(p.out_w, dtype=jnp.float32)[None, :]
        ix_full = _interp_field(ix_f, rows, cols, p.step, jnp)
        iy_full = _interp_field(iy_f, rows, cols, p.step, jnp)
        valid = (
            (ix_full > -0.5)
            & (ix_full < p.src_w - 0.5)
            & (iy_full > -0.5)
            & (iy_full < p.src_h - 0.5)
        )
        pos_h = ix_full - sh[:, None].astype(jnp.float32)
        if out_h_pad > p.out_h:
            pos_h = jnp.pad(pos_h, ((0, out_h_pad - p.out_h), (0, 0)))
        pos_ht = jnp.swapaxes(
            pos_h.reshape(n_row_tiles, p.row_tile, p.out_w), -1, -2
        )
        return pos_t, pos_ht, valid

    pos_t_dev, pos_ht_dev, valid_dev = precompute(
        iystar_c, ix_c, iy_c, s_v, s_h
    )

    @jax.jit
    def kernel(src, pos_t, pos_ht, valid, sv, sh, bv, bh):
        batch = src.shape[:-2]

        # --- vertical: align columns upward by s_v via log2 shift passes
        src2 = src.astype(jnp.float32)
        if r_lo or r_hi:
            src2 = jnp.concatenate(
                [jnp.repeat(src2[..., :1, :], -r_lo, axis=-2), src2]
                + ([jnp.repeat(src2[..., -1:, :], r_hi, axis=-2)] if r_hi else []),
                axis=-2,
            )
        ext_h = p.src_h - r_lo + r_hi
        for b in range(p.bits_v):
            k = 1 << b
            rolled = jnp.concatenate(
                [
                    src2[..., k:, :],
                    jnp.repeat(src2[..., -1:, :], k, axis=-2),
                ],
                axis=-2,
            )
            mask = ((sv >> b) & 1).astype(bool)[None, :]
            src2 = jnp.where(mask, rolled, src2)

        if src_w_pad > p.src_w:
            pad = src_w_pad - p.src_w
            src2 = jnp.pad(src2, [(0, 0)] * (src2.ndim - 1) + [(0, pad)])
        # tile axis up front: (T, ..., ext_h, col_tile)
        src_t = jnp.moveaxis(
            src2.reshape(batch + (ext_h, n_col_tiles, p.col_tile)), -2, 0
        )
        acc = jnp.zeros(
            (n_col_tiles,) + batch + (p.out_h, p.col_tile), jnp.float32
        )
        bvt = jnp.moveaxis(bv, -1, 0)  # (T, out_h)
        for d in range(p.d_v):
            idx = jnp.clip(bvt + d - r_lo, 0, ext_h - 1)  # (T, out_h)
            w = weight(pos_t, (bvt + d)[..., None].astype(jnp.float32))
            # size-1 trailing/batch index dims are essential: XLA then sees
            # a row gather invariant along the minor axis (whole rows
            # copied); a materialized full-shape index lowers to a
            # per-element gather
            idx_b = idx.reshape(
                (n_col_tiles,) + (1,) * len(batch) + (p.out_h, 1)
            )
            taken = jnp.take_along_axis(src_t, idx_b, axis=-2)
            acc = acc + w.reshape(
                (n_col_tiles,) + (1,) * len(batch) + (p.out_h, p.col_tile)
            ) * taken
        v = jnp.moveaxis(acc, 0, -2).reshape(
            batch + (p.out_h, src_w_pad)
        )[..., : p.src_w]

        # --- horizontal: align rows leftward by s_h
        v2 = v
        if c_lo or c_hi:
            v2 = jnp.concatenate(
                [jnp.repeat(v2[..., :, :1], -c_lo, axis=-1), v2]
                + ([jnp.repeat(v2[..., :, -1:], c_hi, axis=-1)] if c_hi else []),
                axis=-1,
            )
        ext_w = p.src_w - c_lo + c_hi
        for b in range(p.bits_h):
            k = 1 << b
            rolled = jnp.concatenate(
                [
                    v2[..., :, k:],
                    jnp.repeat(v2[..., :, -1:], k, axis=-1),
                ],
                axis=-1,
            )
            mask = ((sh >> b) & 1).astype(bool)[:, None]
            v2 = jnp.where(mask, rolled, v2)

        if out_h_pad > p.out_h:
            pad = out_h_pad - p.out_h
            v2 = jnp.pad(
                v2, [(0, 0)] * (v2.ndim - 2) + [(0, pad), (0, 0)]
            )
        # transpose each row tile so the take indexes rows (a per-tile
        # row gather with size-1 index dims) instead of columns
        v_t = jnp.swapaxes(
            jnp.moveaxis(
                v2.reshape(batch + (n_row_tiles, p.row_tile, ext_w)), -3, 0
            ),
            -1,
            -2,
        )  # (T, ..., ext_w, row_tile)
        out_acc = jnp.zeros(
            (n_row_tiles,) + batch + (p.out_w, p.row_tile), jnp.float32
        )
        for d in range(p.d_h):
            idx = jnp.clip(bh + d - c_lo, 0, ext_w - 1)  # (T, out_w)
            w = weight(
                pos_ht, (bh + d)[:, :, None].astype(jnp.float32)
            )  # (T, out_w, row_tile)
            idx_b = idx.reshape(
                (n_row_tiles,) + (1,) * len(batch) + (p.out_w, 1)
            )
            taken = jnp.take_along_axis(v_t, idx_b, axis=-2)
            out_acc = out_acc + w.reshape(
                (n_row_tiles,) + (1,) * len(batch) + (p.out_w, p.row_tile)
            ) * taken
        out = jnp.moveaxis(jnp.swapaxes(out_acc, -1, -2), 0, -3).reshape(
            batch + (out_h_pad, p.out_w)
        )[..., : p.out_h, :]

        fill = jnp.asarray(fill_value, dtype=out.dtype)
        return jnp.where(valid, out, fill)

    def fn(src):
        return kernel(
            src, pos_t_dev, pos_ht_dev, valid_dev, s_v, s_h, base_v, base_h
        )

    return fn


# ---------------------------------------------------------------------------
# strategy chooser
# ---------------------------------------------------------------------------


def make_srw_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = 16,
    allow_hybrid: bool = False,
    pos_tol: float = 0.5,
    **plan_kwargs,
):
    """Plan + compile the best SRW strategy, or None when unsuitable
    (callers then use the XLA-gather kernel).

    ``allow_hybrid`` admits the hybrid strategy for extreme warps.  It is
    opt-in because the two-pass decomposition is a *different
    discretization* of the continuous warp than direct bilinear: exact on
    locally-linear fields, ~0.3% on smooth rasters, but visibly different
    near the Nyquist limit when the local rotation is large.  The tiled
    and aligned strategies only engage where the warp is mild enough that
    this difference is within the device path's documented ~1e-2 px
    tolerance; hybrid extends coverage to domain-scale rotations at the
    cost of that guarantee.  (Also via env ``XRTPU_FAST_EXTREME_WARP=1``.)
    """
    import os

    if interp_method not in ("bilinear", "nearest", "triangular"):
        return None
    if os.environ.get("XRTPU_FAST_EXTREME_WARP", "") == "1":
        allow_hybrid = True
    if interp_method == "triangular":
        # only the tiled kernels implement the triangular correction term;
        # severe warps fall through to the exact ESW tier
        allow_hybrid = False
    fields = _coarse_geometry(source_gm, target_gm, step)

    # crop the source to the window the target actually taps: the vertical
    # pass streams (out_h, src_w) intermediates, so a target covering a
    # fraction of the source (e.g. one UTM zone of a global grid) would
    # otherwise pay for every source column on every tap.  Window edges
    # coincide with global edges exactly where positions spill past them,
    # so clamp-to-edge and masking semantics are unchanged.
    if fields is not None:
        w = _source_window_gm(source_gm, fields, margin=8 + 48)
        if w is not None:
            win_gm, (j0, j1, i0, i1) = w
            inner = make_srw_reproject_fn(
                win_gm,
                target_gm,
                interp_method,
                fill_value,
                step=step,
                allow_hybrid=allow_hybrid,
                pos_tol=pos_tol,
                **plan_kwargs,
            )
            if inner is None:
                return None

            def fn(src):
                return inner(src[..., j0:j1, i0:i1])

            return fn
    if fields is None:
        return None
    # central curvature gate (all strategies interpolate the same coarse
    # fields): estimated interpolation error = |second difference| / 8.
    # iy* is gated only on the columns the horizontal taps can reach —
    # outside each row's ix range it is linearly extrapolated bookkeeping
    # whose curvature never affects output pixels.
    if _fields_interp_err(fields) > pos_tol:
        return None
    # two-pass fidelity gate (default path only): the Catmull-Smith
    # decomposition deviates from direct bilinear by ~slope/4 pixels on
    # worst-case (noise) data, where slope is the per-pixel variation of
    # the reparametrized fields.  The default path promises near-direct
    # results, so rotation-heavy warps (slope > 0.2 -> ~0.05 px) fall back
    # to the exact gather kernel; the opt-in fast mode (allow_hybrid)
    # explicitly accepts two-pass filter semantics.
    if not allow_hybrid and _twopass_slope(fields) > 0.2:
        return None
    tiled = plan_srw(source_gm, target_gm, step=step, fields=fields, **plan_kwargs)
    aligned = (
        plan_srw_aligned(
            source_gm, target_gm, step=step, fields=fields, max_taps=24
        )
        if interp_method != "triangular"
        else None
    )
    hybrid = (
        plan_srw_hybrid(
            source_gm, target_gm, step=step, fields=fields, pos_tol=pos_tol
        )
        if allow_hybrid
        else None
    )
    # cost model: one full-array stream per tap / per shift pass (hybrid
    # pays a couple of extra reshuffle streams for its tile batching)
    candidates = []
    if tiled is not None:
        candidates.append((tiled.d_v + tiled.d_h, "tiled", tiled))
    if aligned is not None:
        candidates.append(
            (
                aligned.bits_v + aligned.bits_h + aligned.d_v + aligned.d_h,
                "aligned",
                aligned,
            )
        )
    if hybrid is not None:
        candidates.append(
            (
                hybrid.bits_v + hybrid.bits_h + hybrid.d_v + hybrid.d_h + 4,
                "hybrid",
                hybrid,
            )
        )
    if not candidates:
        return None
    _, kind, best = min(candidates, key=lambda c: c[0])
    if kind == "tiled":
        # per-tile Python loops emit n_tiles * d ops: switch to the
        # batched formulation when that would bloat compilation.  The
        # batched kernel materializes several full-raster temporaries
        # (tile-axis reshuffles, transposed row tiles), so it is only
        # used when the working set stays small; big rasters keep the
        # loop kernel, which streams tile slices.
        n_ops = (
            best.base_v.shape[1] * best.d_v + best.base_h.shape[0] * best.d_h
        )
        n_elems = best.src_h * best.src_w + best.out_h * best.out_w
        if n_ops > 128 and n_elems < 64_000_000:
            return make_srw_fn_batched(best, interp_method, fill_value)
        return make_srw_fn(best, interp_method, fill_value)
    if kind == "aligned":
        return make_srw_aligned_fn(best, interp_method, fill_value)
    return make_srw_hybrid_fn(best, interp_method, fill_value)


# ---------------------------------------------------------------------------
# region decomposition (domain-scale warps beyond any single plan)
# ---------------------------------------------------------------------------


def _source_window_gm(source_gm: GridMapping, fields: _Fields, margin: int):
    """Crop the source to the rows/columns a region actually taps,
    returning (window_gm, (j0, j1, i0, i1)) or None for full coverage.

    Offsets are aligned down to the coarse-field step so the window's
    iy*-reparametrization samples the same source-column phase as the
    uncropped grid — the cropped kernels then see identical (shifted)
    coordinate fields, not a different piecewise-linear approximation."""
    ix, iy = fields.ix64, fields.iy64
    finite = np.isfinite(ix) & np.isfinite(iy)
    if not finite.any():
        return None
    step = fields.step
    i0 = max(0, int(np.floor(ix[finite].min())) - margin) // step * step
    i1 = min(fields.src_w, int(np.ceil(ix[finite].max())) + margin + 1)
    j0 = max(0, int(np.floor(iy[finite].min())) - margin) // step * step
    j1 = min(fields.src_h, int(np.ceil(iy[finite].max())) + margin + 1)
    if i1 - i0 < 8 or j1 - j0 < 8:
        return None
    if (i1 - i0) * (j1 - j0) > 0.8 * fields.src_w * fields.src_h:
        return None  # not worth cropping
    x_res = float(source_gm.x_res)
    y_res = float(source_gm.y_res)
    if bool(source_gm.is_j_axis_up):
        y_min = float(source_gm.y_min) + j0 * y_res
    else:
        y_min = float(source_gm.y_max) - j1 * y_res
    win_gm = GridMapping.regular(
        size=(i1 - i0, j1 - j0),
        xy_min=(float(source_gm.x_min) + i0 * x_res, y_min),
        xy_res=(x_res, y_res),
        crs=source_gm.crs,
        is_j_axis_up=bool(source_gm.is_j_axis_up),
    )
    return win_gm, (j0, j1, i0, i1)


def make_region_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = 16,
    base_split: int = 4,
    max_depth: int = 3,
    allow_hybrid: bool = True,
    exact: bool = False,
):
    """Gather-free reprojection for warps too severe for any single SRW
    plan: recursively quadtree-split the *target*, plan each region against
    its own cropped source window (rotation/scale vary far less inside a
    region, and cropping shrinks every tap stream), and fall back to the
    XLA gather kernel only for regions that still refuse to plan (e.g.
    near projection singularities).

    With ``exact=True`` the pieces use the exact separable warp
    (ops/esw.py — direct-bilinear semantics, no two-pass filter
    deviation) instead of the SRW strategy chooser; this is the default
    extreme-warp path.

    Replaces the reference's uniformized-window tile mosaic
    (reference reproject.py:385-469) with per-region *planned* kernels.
    Returns ``fn(src) -> target`` or None when the decomposition cannot
    beat plain gather (no region plans at all).
    """
    import jax.numpy as jnp

    from .reproject_ops import make_fused_reproject_fn

    if exact:
        from .esw import make_esw_region_fn

        return make_esw_region_fn(
            source_gm,
            target_gm,
            interp_method,
            fill_value,
            step=step,
        )

    if interp_method not in ("bilinear", "nearest"):
        return None

    out_h, out_w = target_gm.height, target_gm.width
    x_res = float(target_gm.x_res)
    y_res = float(target_gm.y_res)
    j_up = bool(target_gm.is_j_axis_up)

    def region_gm(r0, r1, c0, c1):
        if j_up:
            y_min = float(target_gm.y_min) + r0 * y_res
        else:
            y_min = float(target_gm.y_max) - r1 * y_res
        return GridMapping.regular(
            size=(c1 - c0, r1 - r0),
            xy_min=(float(target_gm.x_min) + c0 * x_res, y_min),
            xy_res=(x_res, y_res),
            crs=target_gm.crs,
            is_j_axis_up=j_up,
        )

    pieces = []  # (r0, r1, c0, c1, window or None, fn)
    n_planned = 0

    def build(r0, r1, c0, c1, depth):
        nonlocal n_planned
        gm = region_gm(r0, r1, c0, c1)
        fields = _coarse_geometry(source_gm, gm, step)
        win = None
        src_gm_here = source_gm
        if fields is not None:
            w = _source_window_gm(source_gm, fields, margin=8 + 48)
            if w is not None:
                src_gm_here, win = w
        # a finer coarse step rescues high-curvature regions: the field
        # interpolation error that gates planning scales with step^2
        for step_try in (step, 4):
            fn = make_srw_reproject_fn(
                src_gm_here, gm, interp_method, fill_value,
                step=step_try, allow_hybrid=allow_hybrid,
            )
            if fn is not None:
                n_planned += 1
                pieces.append((r0, r1, c0, c1, win, fn))
                return
        if depth < max_depth and (r1 - r0) >= 128 and (c1 - c0) >= 128:
            rm = (r0 + r1) // 2
            cm = (c0 + c1) // 2
            build(r0, rm, c0, cm, depth + 1)
            build(r0, rm, cm, c1, depth + 1)
            build(rm, r1, c0, cm, depth + 1)
            build(rm, r1, cm, c1, depth + 1)
            return
        gfn = make_fused_reproject_fn(
            src_gm_here, gm, interp_method, fill_value
        )
        pieces.append((r0, r1, c0, c1, win, gfn))

    rb = -(-out_h // base_split)
    cb = -(-out_w // base_split)
    for bj in range(base_split):
        for bi in range(base_split):
            r0, r1 = bj * rb, min((bj + 1) * rb, out_h)
            c0, c1 = bi * cb, min((bi + 1) * cb, out_w)
            if r1 > r0 and c1 > c0:
                build(r0, r1, c0, c1, 0)

    if n_planned == 0:
        return None  # nothing planned: plain gather on the full grid wins

    import jax

    # one jitted dispatch for the whole mosaic: per-piece eager calls would
    # pay a dispatch each; fused, the pieces also share layout/fusion
    # decisions
    @jax.jit
    def fn(src):
        src = jnp.asarray(src)
        out = jnp.full(
            src.shape[:-2] + (out_h, out_w),
            jnp.float32(fill_value),
            dtype=jnp.float32,
        )
        for r0, r1, c0, c1, win, piece_fn in pieces:
            piece_src = (
                src[..., win[0] : win[1], win[2] : win[3]]
                if win is not None
                else src
            )
            out = out.at[..., r0:r1, c0:c1].set(piece_fn(piece_src))
        return out

    return fn
