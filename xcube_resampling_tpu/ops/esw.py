"""Exact separable warp (ESW): gather-free reprojection that reproduces the
direct bilinear/nearest gather kernel EXACTLY (bit-exact for nearest, a
couple of float32 ulp for bilinear — lerp-order only).

The SRW strategies (ops/srw.py) evaluate each source column's vertical
profile at the *reparametrized* row position iy*(r, c), which deviates from
the pixel's true row position iy(r, x) by up to the warp's local rotation
slope — hence the default-path fidelity gate (slope <= 0.2).  ESW removes
the approximation instead of gating it:

* The **vertical pass** does not interpolate.  For every (output row r,
  source column c) it *selects* S consecutive source rows anchored at
  m(r,c) = floor(iy*(r,c) - (S-2)/2), producing S sample fields
  ``V_s[r,c] = src[m(r,c)+s, c]``.
* The **horizontal pass** knows the pixel's TRUE clamped row position
  iy(r,x) (interpolated from the same float32 coarse field the gather
  kernel uses, in GLOBAL source index space) and evaluates the piecewise-
  linear column profile exactly from the S samples: with y0 = floor(iy_cl)
  and fy = iy_cl - y0,
  ``colval(c) = V[y0-m] + fy * (V[y0-m+1] - V[y0-m])`` — identical to the
  gather kernel's per-column vertical lerp, because the sample window
  covers [y0, y0+1] whenever |iy - iy*| <= (S-2)/2 (verified at plan time
  with margin).  The two column taps i0, i0+1 are then combined as
  ``cv0 + fx*(cv1-cv0)`` — the gather formula.

Both passes use the tiled-tap layout of the fast SRW kernel (ops/srw.py
make_srw_fn): per-(row, col-tile) tap bases, row-shared ``jnp.take``
gathers and elementwise selects, which XLA fuses into single streaming
passes — no transposes, no materialized (S, out_h, out_w) intermediates.

When the kernel runs on a cropped source window, positions / floors /
clamps still use the GLOBAL float32 coordinate fields (bit-identical to
the gather kernel) and the integer window offset is subtracted only after
rounding — float subtraction before floor/rint could flip ties.

The result: direct-bilinear semantics (no two-pass filter deviation, no
fidelity gate) at streaming speed, valid for local rotation slopes up to
~(S-2)/2 px/px (S adapts, default cap 10 -> slope ~4, rotation ~76 deg).

Reference behavior matched: xcube_resampling/reproject.py:268-335 (the
per-pixel inverse-transform + bilinear gather semantics).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..gridmapping import GridMapping
from .reproject_ops import _interp_field
from .srw import (
    _Fields,
    _coarse_geometry,
    _interp_cols,
    _interp_rows,
)


@dataclass
class ESWPlan:
    """Tiled exact-warp plan (see module docstring).

    ``ix_c``/``iy_c`` hold GLOBAL source indices (float32 casts of the same
    float64 fields the gather kernel uses) even when the kernel runs on a
    cropped source window; ``iystar_c`` and the tap bases are window-
    relative."""

    iystar_c: np.ndarray  # (ncj, ncc) float32 coarse reparametrized rows
    ix_c: np.ndarray  # (ncj, nci) float32 coarse source-col field (global)
    iy_c: np.ndarray  # (ncj, nci) float32 coarse source-row field (global)
    step: int
    n_samples: int  # S: consecutive source rows kept per (r, c)
    base_v: np.ndarray  # (out_h, n_col_tiles) int32 vertical tap bases
    d_v: int
    col_tile: int
    base_h: np.ndarray  # (n_row_tiles, out_w) int32 horizontal tap bases
    d_h: int
    row_tile: int
    # optional shift alignment (rotation-heavy warps): log2 roll passes
    # remove the mean coordinate trend so the per-tile tap spans stay
    # small; bases/selection then live in the shifted (residual) space
    s_v: np.ndarray | None  # (src_w,) int32 >= 0 upward shift per src col
    bits_v: int
    s_h: np.ndarray | None  # (out_h,) int32 >= 0 left shift per out row
    bits_h: int
    src_h: int  # window dims (== global when not cropped)
    src_w: int
    out_h: int
    out_w: int
    src_h_g: int  # global source dims (validity/clamping space)
    src_w_g: int
    j_off: int  # window origin in global source indices
    i_off: int
    # optional static-cover formulation (see _static_cover): the tap loop
    # becomes ONE shared row/column gather + jv/jh STATIC slices,
    # trading d dynamic takes for a longer select chain
    cov_v: np.ndarray | None = None  # (out_h + jv, n_col_tiles) int32
    jv: int = 0
    cov_h: np.ndarray | None = None  # (n_row_tiles, out_w + jh) int32
    jh: int = 0
    # per-tile tap/slice counts (maxima of the scalars above): the kernel
    # unrolls its tile loops in Python, so each tile can stop at its OWN
    # count — mild interior tiles stop paying the worst tile's diversity
    d_v_t: tuple | None = None  # len n_col_tiles
    d_h_t: tuple | None = None  # len n_row_tiles
    jv_t: tuple | None = None  # len n_col_tiles
    jh_t: tuple | None = None  # len n_row_tiles


def _max_row_deviation(fields: _Fields, refine: int = 2) -> float:
    """Max over valid sample points of |iy_cl(r,x) - iy*(r, c_tap)| for both
    column taps c_tap in {floor(ix_cl), floor(ix_cl)+1}.

    Evaluated on a ``refine``-times refined coarse grid (O(ncj*nci), not
    O(out*src) — the planner runs on a single host core): between nodes all
    fields interpolate (bi)linearly, so the composition's interior extrema
    are quadratic-ish in the cell and half-step sampling bounds them to
    within a fraction the caller's sample margin absorbs."""
    step = fields.step
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    iystar = fields.iystar64

    fine = step / refine
    rows = np.arange(0, out_h, fine, dtype=np.float64)[:, None]
    cols = np.arange(0, out_w, fine, dtype=np.float64)[None, :]
    ix = _interp_field(fields.ix64, rows, cols, step, np)
    iy = _interp_field(fields.iy64, rows, cols, step, np)

    valid = (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
    if not valid.any():
        return 0.0
    ix_cl = np.clip(ix, 0, src_w - 1)
    iy_cl = np.clip(iy, 0, src_h - 1)

    # iy* interpolated to the refined output rows
    rr = rows[:, 0] / step
    j0 = np.clip(rr.astype(np.int64), 0, iystar.shape[0] - 2)
    fj = (rr - j0)[:, None]
    p_rows = iystar[j0, :] * (1 - fj) + iystar[j0 + 1, :] * fj

    ncc = iystar.shape[1]
    dev = np.zeros_like(ix_cl)
    for c_tap in (np.floor(ix_cl), np.floor(ix_cl) + 1):
        c_tap = np.minimum(c_tap, src_w - 1)
        k0 = np.clip((c_tap / step).astype(np.int64), 0, ncc - 2)
        frac = c_tap / step - k0
        pa = np.take_along_axis(p_rows, k0, axis=1)
        pb = np.take_along_axis(p_rows, k0 + 1, axis=1)
        p = pa + frac * (pb - pa)
        dev = np.maximum(dev, np.abs(iy_cl - p))
    return float(dev[valid].max())


def _static_cover(base: np.ndarray, d: int, axis: int):
    """Monotone unit-increment cover sequences for the static-slice tap
    formulation.

    For each 1-D lane of ``base`` (per column when ``axis=0``, per row when
    ``axis=1``) build ``cov`` of length ``n + J`` with increments in {0, 1}
    such that for every position r the window ``cov[r : r + J]`` contains
    every integer in ``[base[r], base[r] + d)`` — then the kernel can
    resample once through ``cov`` (one shared gather) and reach every tap
    through J STATIC slices, instead of issuing d dynamic takes.

    ``d`` may be a scalar or a per-lane array (per-tile tap diversity):
    per-lane targets keep low-diversity lanes' windows short, so the
    per-lane slice counts ``J_t`` shrink where the warp is mild.

    Returns ``(cov, J_t)`` with ``cov`` shaped like ``base`` extended by
    ``max(J_t)`` along ``axis`` and ``J_t`` an int array of per-lane slice
    counts, or ``(None, None)`` when no cover exists (the base advances
    faster than one source index per output index somewhere —
    downscale-like warps keep the dynamic formulation)."""
    b = base if axis == 0 else base.T  # (n, lanes)
    n, lanes = b.shape
    b64 = b.astype(np.int64)
    # largest valid cover: backward running min (nondecreasing, <= base)
    cov = np.minimum.accumulate(b64[::-1], axis=0)[::-1]
    if n > 1 and (np.diff(cov, axis=0) > 1).any():
        return None, None
    d_lane = np.broadcast_to(np.asarray(d, dtype=np.int64), (lanes,))
    targets = b64 + d_lane[None, :] - 1
    tail = int(max(0, targets.max() - cov[-1].min()))
    cov_ext = np.concatenate(
        [cov, cov[-1][None, :] + 1 + np.arange(tail, dtype=np.int64)[:, None]]
    )
    # first k >= r with cov_ext[k] >= target[r], per lane
    J_t = np.ones(lanes, dtype=np.int64)
    for c in range(lanes):
        k = np.searchsorted(cov_ext[:, c], targets[:, c], side="left")
        J_t[c] = max(1, int((k - np.arange(n)).max()) + 1)
    J = int(J_t.max())
    out = cov_ext[: n + J]
    if out.shape[0] < n + J:  # tail too short (all-flat targets edge case)
        extra = n + J - out.shape[0]
        out = np.concatenate(
            [out, out[-1][None, :] + 1 + np.arange(extra, dtype=np.int64)[:, None]]
        )
    out = out.astype(np.int32)
    return (out if axis == 0 else out.T), J_t


def _pad_cover(cov: np.ndarray, n: int, J: int, axis: int) -> np.ndarray:
    """Extend a cover sequence to group length ``n + J`` with unit-step
    tail values (harmless: extra slices only ever select rows by VALUE)."""
    c = cov if axis == 0 else cov.T
    extra = n + J - c.shape[0]
    if extra <= 0:
        return cov
    c = np.concatenate(
        [c, c[-1][None, :] + 1 + np.arange(extra, dtype=np.int32)[:, None]]
    )
    return c if axis == 0 else c.T


# static-cover cost gates, per axis: the static formulation engages where
# its slice count J is at most ratio * d, the tap count of the dynamic
# takes it replaces.  Tuned values, to be re-tuned on the GPU.
_STATIC_J_RATIO_V = 3.0
_STATIC_J_RATIO_H = 3.5


def plan_esw(
    source_gm: GridMapping,
    target_gm: GridMapping,
    step: int = 16,
    max_taps: int = 40,
    max_samples: int = 10,
    fields: _Fields | None = None,
    fields_global: _Fields | None = None,
    win: tuple[int, int, int, int] | None = None,
    force: dict | None = None,
) -> ESWPlan | None:
    """Build an exact-warp plan, or None when the mapping is unsuitable
    (non-monotone rows near a projection singularity, a row deviation that
    would need more than ``max_samples`` kept rows, or tap counts beyond
    ``max_taps`` at every tile size).

    For a cropped source window, pass the window-relative ``fields`` (the
    tap machinery plans in window space), the uncropped ``fields_global``
    and the window ``win`` = (j0, j1, i0, i1): the plan then stores the
    global coordinate fields for bit-exact positions.

    ``force`` (mosaic use) pins the layout decisions — keys ``n_samples``,
    ``col_tile``, ``row_tile``, ``use_shift_v``, ``use_shift_h`` — so all
    pieces of a mosaic group share one kernel signature; the per-piece tap
    counts and bases still come from the piece's own geometry."""
    if fields is None:
        fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    if fields_global is None:
        fields_global = fields
    j_off, i_off = (win[0], win[2]) if win is not None else (0, 0)

    iystar = fields.iystar64
    ix64 = fields.ix64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w
    step = fields.step

    # sample count: window [m, m+S-1] covers [y0, y0+1] whenever
    # |iy - iy*| <= (S-2)/2; the deviation is measured on a refined coarse
    # grid, the margin covers interior curvature + float32 interp noise
    margin = 0.35
    dev = _max_row_deviation(fields)
    n_samples = int(np.ceil(2.0 * (dev + margin))) + 2
    n_samples = max(3, n_samples)
    if force is not None:
        if n_samples > force["n_samples"]:
            return None
        n_samples = force["n_samples"]
    if n_samples > max_samples:
        return None
    half = (n_samples - 2) / 2.0

    # ---- vertical tap layout: per-(output row, source col tile) bases,
    # optionally in shift-aligned residual space (derivative-midrange
    # integer shift per source column removes the mean rotation trend)
    ncc = iystar.shape[1]
    cs = np.arange(ncc, dtype=np.float64) * step

    def _v_layout(res_rows, col_tile):
        n_col_tiles = -(-src_w // col_tile)
        base = np.zeros((out_h, n_col_tiles), dtype=np.int32)
        d_t = np.zeros(n_col_tiles, dtype=np.int64)
        for t in range(n_col_tiles):
            c0 = t * col_tile
            c1 = min((t + 1) * col_tile, src_w)
            k0 = max(0, c0 // step - 1)
            k1 = min(ncc, -(-c1 // step) + 1)
            seg = res_rows[:, k0:k1]
            m = seg.min(axis=1)
            base[:, t] = np.floor(m - half).astype(np.int32) - 2
            # taps must cover the whole window [m, m+S-1] for every column
            # of the tile: tile span + S samples + float/interp safety
            d_t[t] = (
                int(np.ceil(float((seg.max(axis=1) - m).max())))
                + n_samples
                + 4
            )
        return base, d_t

    def _best_tiling(layout_fn, res, candidates):
        best = None
        for cand in candidates:
            base, d_t = layout_fn(res, cand)
            # per-tile counts: cost follows the MEAN tap count (the kernel
            # stops each tile at its own diversity), feasibility the max
            d = int(d_t.max())
            eff = float(d_t.mean()) * max(1.0, 96.0 / cand)
            if d <= max_taps and (best is None or eff < best[0]):
                best = (eff, cand, base, d_t)
        return best

    def _sv_full():
        dv_ = np.diff(iystar, axis=1)
        mid_slope_v = 0.5 * (dv_.max(axis=0) + dv_.min(axis=0))
        s_v_coarse = np.round(np.concatenate([[0.0], np.cumsum(mid_slope_v)]))
        s_v0 = np.round(
            np.interp(np.arange(src_w, dtype=np.float64), cs, s_v_coarse)
        ).astype(np.int64)
        s_v0_at_cs = s_v0[np.clip(cs.astype(np.int64), 0, src_w - 1)]
        return (
            (s_v0 - s_v0.min()).astype(np.int32),
            iystar - (s_v0_at_cs - s_v0.min())[None, :],
        )

    tiles_v = (512, 256, 128, 64, 32, 16)
    if force is not None:
        ct_f = force["col_tile"]
        if force["use_shift_v"]:
            s_v_full, res_v = _sv_full()
            base_v, dv_t = _v_layout(_interp_rows(res_v, out_h, step), ct_f)
            s_v = s_v_full
            bits_v = int(s_v_full.max()).bit_length()
        else:
            base_v, dv_t = _v_layout(
                _interp_rows(iystar, out_h, step), ct_f
            )
            s_v = None
            bits_v = 0
        col_tile = ct_f
        if int(dv_t.max()) > 2 * max_taps:
            return None
    else:
        plain_v = _best_tiling(
            _v_layout, _interp_rows(iystar, out_h, step), tiles_v
        )

        # shifted-space candidate (skipped when plain span already tiny)
        s_v_full, res_v = _sv_full()
        shifted_v = None
        if s_v_full.max() > 0 and (
            plain_v is None or int(plain_v[3].max()) > n_samples + 8
        ):
            shifted_v = _best_tiling(
                _v_layout, _interp_rows(res_v, out_h, step), tiles_v
            )

        bits_v = int(s_v_full.max()).bit_length()
        # vertical taps touch (out_h, src_w)-sized streams (1 take + S
        # selects each); roll passes touch the (src_h, src_w) source once
        # per bit — weight them by the array-size ratio.  Costs compare
        # MEAN per-tile counts (the kernel stops each tile at its own)
        roll_w_v = src_h / max(1, out_h * (1 + n_samples))
        use_shift_v = shifted_v is not None and (
            plain_v is None
            or float(shifted_v[3].mean()) + roll_w_v * bits_v
            < float(plain_v[3].mean())
        )
        chosen_v = shifted_v if use_shift_v else plain_v
        if chosen_v is None:
            return None
        _, col_tile, base_v, dv_t = chosen_v
        s_v = s_v_full if use_shift_v else None
        if not use_shift_v:
            bits_v = 0
    d_v = int(dv_t.max())

    # ---- horizontal tap layout: per-(row tile, output col) bases,
    # optionally shift-aligned per output row
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step

    def _h_layout(res_cols, row_tile):
        n_row_tiles = -(-out_h // row_tile)
        base = np.zeros((n_row_tiles, out_w), dtype=np.int32)
        d_t = np.zeros(n_row_tiles, dtype=np.int64)
        for t in range(n_row_tiles):
            r0 = t * row_tile
            r1 = min((t + 1) * row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = res_cols[k0:k1, :]
            m = seg.min(axis=0)
            base[t, :] = np.floor(m).astype(np.int32) - 2
            # +1 for the right column tap, + float/interp safety
            d_t[t] = int(np.ceil(float((seg.max(axis=0) - m).max()))) + 5
        return base, d_t

    def _sh_full():
        dh_ = np.diff(ix64, axis=0)
        mid_slope_h = 0.5 * (dh_.max(axis=1) + dh_.min(axis=1))
        s_h_coarse = np.round(np.concatenate([[0.0], np.cumsum(mid_slope_h)]))
        rows_grid = np.arange(ncj, dtype=np.float64) * step
        s_h0 = np.round(
            np.interp(
                np.arange(out_h, dtype=np.float64), rows_grid, s_h_coarse
            )
        ).astype(np.int64)
        s_h0_at_rows = s_h0[np.clip(rows_grid.astype(np.int64), 0, out_h - 1)]
        return (
            (s_h0 - s_h0.min()).astype(np.int32),
            ix64 - (s_h0_at_rows - s_h0.min())[:, None],
        )

    tiles_h = (512, 256, 128, 64, 32, 16)
    h_sweep = None
    if force is not None:
        rt_f = force["row_tile"]
        if force["use_shift_h"]:
            s_h_full, res_h = _sh_full()
            res_cols_f = _interp_cols(res_h, out_w, step)
            s_h = s_h_full
            bits_h = int(s_h_full.max()).bit_length()
        else:
            res_cols_f = _interp_cols(ix64, out_w, step)
            s_h = None
            bits_h = 0
        base_h, dh_t = _h_layout(res_cols_f, rt_f)
        # mosaic groups share one forced row tile; d_h scales with the
        # per-tile row span (vertical shear x tile height), so the caller
        # can request per-candidate layouts and pick the group-cheapest
        # AFTER seeing every member's needs (see make_esw_region_fn)
        sweep = force.get("row_tile_sweep")
        if sweep:
            h_sweep = {
                rt: _h_layout(res_cols_f, rt)
                for rt in sweep
                if rt <= out_h and rt != rt_f
            }
            h_sweep[rt_f] = (base_h, dh_t)
        row_tile = rt_f
        if int(dh_t.max()) > 2 * max_taps:
            return None
    else:
        plain_h = _best_tiling(
            _h_layout, _interp_cols(ix64, out_w, step), tiles_h
        )

        s_h_full, res_h = _sh_full()
        shifted_h = None
        if s_h_full.max() > 0 and (
            plain_h is None or int(plain_h[3].max()) > 10
        ):
            shifted_h = _best_tiling(
                _h_layout, _interp_cols(res_h, out_w, step), tiles_h
            )

        bits_h = int(s_h_full.max()).bit_length()
        # horizontal taps read S+1 (rt, out_w)-sized streams each; rolls
        # move the S (out_h, src_w) sample fields once per bit
        roll_w_h = (n_samples * src_w) / max(1, (1 + n_samples) * out_w)
        use_shift_h = shifted_h is not None and (
            plain_h is None
            or float(shifted_h[3].mean()) + roll_w_h * bits_h
            < float(plain_h[3].mean())
        )
        chosen_h = shifted_h if use_shift_h else plain_h
        if chosen_h is None:
            return None
        _, row_tile, base_h, dh_t = chosen_h
        s_h = s_h_full if use_shift_h else None
        if not use_shift_h:
            bits_h = 0
    d_h = int(dh_t.max())

    # ---- static-cover formulation (one shared gather + static slices)
    # where the cover exists and its length passes the ratio gate above;
    # XRTPU_ESW_STATIC=0 disables, =1 ignores the ratio gate
    static_env = os.environ.get("XRTPU_ESW_STATIC", "")
    rv = float(os.environ.get("XRTPU_ESW_STATIC_RV", _STATIC_J_RATIO_V))
    rh = float(os.environ.get("XRTPU_ESW_STATIC_RH", _STATIC_J_RATIO_H))
    cov_v = cov_h = None
    jv = jh = 0
    jv_t = jh_t = None
    if static_env != "0":
        cv_, jvt_ = _static_cover(base_v, dv_t, axis=0)
        if cv_ is not None and (
            static_env == "1"
            or float(jvt_.mean()) <= rv * float(dv_t.mean())
        ):
            cov_v, jv = cv_, int(jvt_.max())
            jv_t = tuple(int(x) for x in jvt_)
        ch_, jht_ = _static_cover(base_h, dh_t, axis=1)
        if ch_ is not None and (
            static_env == "1"
            or float(jht_.mean()) <= rh * float(dh_t.mean())
        ):
            cov_h, jh = ch_, int(jht_.max())
            jh_t = tuple(int(x) for x in jht_)

    plan = ESWPlan(
        iystar_c=iystar.astype(np.float32),
        ix_c=fields_global.ix64.astype(np.float32),
        iy_c=fields_global.iy64.astype(np.float32),
        step=step,
        n_samples=n_samples,
        base_v=base_v,
        d_v=d_v,
        col_tile=col_tile,
        base_h=base_h,
        d_h=d_h,
        row_tile=row_tile,
        s_v=s_v,
        bits_v=bits_v,
        s_h=s_h,
        bits_h=bits_h,
        src_h=src_h,
        src_w=src_w,
        out_h=out_h,
        out_w=out_w,
        src_h_g=fields_global.src_h,
        src_w_g=fields_global.src_w,
        j_off=j_off,
        i_off=i_off,
        cov_v=cov_v,
        jv=jv,
        cov_h=cov_h,
        jh=jh,
        d_v_t=tuple(int(x) for x in dv_t),
        d_h_t=tuple(int(x) for x in dh_t),
        jv_t=jv_t,
        jh_t=jh_t,
    )
    if h_sweep is not None:
        plan.h_sweep = h_sweep
    return plan


class _KernelCfg:
    """Hashable static trace config for the shared exact-warp kernel.

    All pieces of a uniformized mosaic share one (cfg, shapes) signature,
    so XLA compiles the kernel ONCE per piece-shape group instead of once
    per piece (a deep quadtree would otherwise issue dozens of
    compiles)."""

    __slots__ = (
        "n_samples", "d_v", "d_h", "col_tile", "row_tile", "bits_v",
        "bits_h", "r_lo", "r_hi", "c_lo", "c_hi", "interp", "jv", "jh",
        # optional per-tile tap/slice counts (tuples; None = the scalar
        # maxima above apply to every tile)
        "d_v_t", "d_h_t", "jv_t", "jh_t",
    )

    def __init__(self, **kw):
        kw.setdefault("d_v_t", None)
        kw.setdefault("d_h_t", None)
        kw.setdefault("jv_t", None)
        kw.setdefault("jh_t", None)
        for k in self.__slots__:
            setattr(self, k, kw[k])

    def _key(self):
        return tuple(getattr(self, k) for k in self.__slots__)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, _KernelCfg) and self._key() == other._key()


def _norm_tile_tuple(t: tuple | None, scalar: int) -> tuple | None:
    """None when every per-tile entry equals the scalar maximum — plans
    with uniform tap diversity then share one kernel cfg, keeping the
    documented cross-plan jit-cache sharing instead of compiling a
    near-identical program per plan."""
    if t is not None and all(x == scalar for x in t):
        return None
    return t


_IMPLS: dict = {}


def _get_impls():
    """Build (once) the module-level jitted precompute/kernel impls.  All
    geometry enters as arguments; loop bounds and layout come from the
    static ``cfg`` — jax's jit cache then shares compilations across every
    plan with the same cfg and shapes."""
    if _IMPLS:
        return _IMPLS["pre"], _IMPLS["kernel"]
    from functools import partial

    import jax
    import jax.numpy as jnp

    @partial(
        jax.jit,
        static_argnames=(
            "step", "half", "out_h", "out_w", "src_w", "src_h_g", "src_w_g",
            "c_lo", "ext_w",
        ),
    )
    def precompute(iystar_f, ix_f, iy_f, sv, sh, *, step, half, out_h, out_w,
                   src_w, src_h_g, src_w_g, c_lo, ext_w):
        rows = jnp.arange(out_h, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(src_w, dtype=jnp.float32)[None, :]
        # anchor field m(r, c) in window row space (float32, integer-valued)
        pos_v = _interp_field(iystar_f, rows, cols_src, step, jnp)
        m = jnp.floor(pos_v - half)
        # vertical selection space: anchors minus the per-column shift
        m_v = m - sv[None, :].astype(jnp.float32) if sv is not None else m
        # horizontal tap space: anchor VALUES at the extended shift-aligned
        # positions (index i holds m[r, clip(i + c_lo + s_h[r])])
        if sh is not None:
            cidx = jnp.clip(
                jnp.arange(ext_w, dtype=jnp.int32)[None, :] + c_lo + sh[:, None],
                0,
                src_w - 1,
            )
            m_h = jnp.take_along_axis(m, cidx, axis=1)
        else:
            m_h = m

        # positions/validity/clamps in GLOBAL source index space — the
        # float32 arithmetic is bit-identical to the gather kernel's
        cols = jnp.arange(out_w, dtype=jnp.float32)[None, :]
        ix_full = _interp_field(ix_f, rows, cols, step, jnp)
        iy_full = _interp_field(iy_f, rows, cols, step, jnp)
        valid = (
            (ix_full > -0.5)
            & (ix_full < src_w_g - 0.5)
            & (iy_full > -0.5)
            & (iy_full < src_h_g - 0.5)
        )
        ix_cl = jnp.clip(ix_full, 0, src_w_g - 1)
        iy_cl = jnp.clip(iy_full, 0, src_h_g - 1)
        return m_v, m_h, ix_cl, iy_cl, valid

    @partial(jax.jit, static_argnames=("cfg",))
    def kernel(src, m_v, m_h, ixc, iyc, valid, bv, bh, sv, sh, j_off, i_off,
               fill, *, cfg):
        S = cfg.n_samples
        nearest = cfg.interp == "nearest"
        triangular = cfg.interp == "triangular"
        r_lo, r_hi, c_lo, c_hi = cfg.r_lo, cfg.r_hi, cfg.c_lo, cfg.c_hi
        out_h, out_w = ixc.shape
        src_h, src_w = src.shape[-2], src.shape[-1]
        ext_h = src_h - r_lo + r_hi
        ext_w = src_w - c_lo + c_hi
        n_col_tiles = -(-src_w // cfg.col_tile)
        n_row_tiles = -(-out_h // cfg.row_tile)

        src2 = src.astype(jnp.float32)
        batch = src.shape[:-2]

        # --- optional vertical shift alignment: edge-extend, then roll
        # each source column up by s_v[c] in log2 passes, so the per-tile
        # tap spans stay small under rotation.  Shifted-space tap ids must
        # clamp AFTER the shift is re-applied (clip(i + s) != clip(i) + s),
        # hence the extended array whose index i holds clip(i + lo + s).
        if sv is not None:
            if r_lo or r_hi:
                parts = [src2]
                if r_lo:
                    parts.insert(0, jnp.repeat(src2[..., :1, :], -r_lo, axis=-2))
                if r_hi:
                    parts.append(jnp.repeat(src2[..., -1:, :], r_hi, axis=-2))
                src2 = jnp.concatenate(parts, axis=-2)
            n_ext = src2.shape[-2]
            for b in range(cfg.bits_v):
                # shifts past the window bottom saturate to the edge row
                # (k can exceed the window height when the rotation trend
                # is steeper than the window is tall)
                k = min(1 << b, n_ext)
                rolled = jnp.concatenate(
                    [src2[..., k:, :], jnp.repeat(src2[..., -1:, :], k, axis=-2)],
                    axis=-2,
                )
                mask = ((sv >> b) & 1).astype(bool)[None, :]
                src2 = jnp.where(mask, rolled, src2)

        # --- vertical pass: S sample fields V_s (out_h, src_w), built per
        # source-column tile from lane-shared row takes + exact selects.
        # Tap rows are clipped to the window edge; the anchor match uses
        # the UNclipped row id, so out-of-range sample slots simply keep
        # their zero init (they are never selected by a valid pixel).
        v_tiles = [[] for _ in range(S)]
        for t in range(n_col_tiles):
            c0 = t * cfg.col_tile
            c1 = min((t + 1) * cfg.col_tile, src_w)
            tile_src = src2[..., c0:c1]
            m_t = m_v[:, c0:c1]  # (out_h, ct) float32 integer-valued
            base_t = bv[:, t]  # (out_h,) tap bases, or (out_h + jv,) cover
            # per-tile counts: the Python tile loop unrolls, so each tile
            # stops at its own diversity instead of the plan/group max
            jv_tile = cfg.jv_t[t] if cfg.jv_t is not None else cfg.jv
            dv_tile = cfg.d_v_t[t] if cfg.d_v_t is not None else cfg.d_v
            accs = [
                jnp.zeros(batch + (out_h, c1 - c0), jnp.float32)
                for _ in range(S)
            ]
            if cfg.jv:
                # static-cover formulation: ONE shared row gather through
                # the monotone cover, then jv static slices — each output
                # row r reaches every tap row in [base(r), base(r)+d_v)
                # by VALUE via cov[r : r + jv] (see _static_cover)
                used = base_t[: out_h + jv_tile]
                rid_all = used.astype(jnp.float32)
                R = jnp.take(
                    tile_src,
                    jnp.clip(used - r_lo, 0, ext_h - 1),
                    axis=-2,
                )  # (..., out_h + jv_tile, ct)
                for j in range(jv_tile):
                    taken = R[..., j : j + out_h, :]
                    rid = rid_all[j : j + out_h][:, None]
                    for s in range(S):
                        accs[s] = jnp.where(m_t == rid - s, taken, accs[s])
            else:
                for d in range(dv_tile):
                    idx = jnp.clip(base_t + d - r_lo, 0, ext_h - 1)
                    taken = jnp.take(tile_src, idx, axis=-2)
                    rid = (base_t + d).astype(jnp.float32)[:, None]
                    for s in range(S):
                        accs[s] = jnp.where(m_t == rid - s, taken, accs[s])
            for s in range(S):
                v_tiles[s].append(accs[s])
        fields = [jnp.concatenate(v_tiles[s], axis=-1) for s in range(S)]

        # --- optional horizontal shift alignment of the sample fields
        # (the anchor field was pre-shifted once at build time): edge-
        # extend, then roll each output row left by s_h[r] in log2 passes
        if sh is not None:
            mask_rows = [
                ((sh >> b) & 1).astype(bool)[:, None] for b in range(cfg.bits_h)
            ]
            shifted = []
            for f in fields:
                if c_lo or c_hi:
                    parts = [f]
                    if c_lo:
                        parts.insert(0, jnp.repeat(f[..., :, :1], -c_lo, axis=-1))
                    if c_hi:
                        parts.append(jnp.repeat(f[..., :, -1:], c_hi, axis=-1))
                    f = jnp.concatenate(parts, axis=-1)
                for b in range(cfg.bits_h):
                    # saturating shift, as in the vertical pass
                    k = min(1 << b, f.shape[-1])
                    rolled = jnp.concatenate(
                        [f[..., :, k:], jnp.repeat(f[..., :, -1:], k, axis=-1)],
                        axis=-1,
                    )
                    f = jnp.where(mask_rows[b], rolled, f)
                shifted.append(f)
            fields = shifted

        # --- horizontal pass: per row tile, the true vertical lerp from
        # the S samples at both column taps, routed by exact index match
        out_tiles = []
        for t in range(n_row_tiles):
            r0 = t * cfg.row_tile
            r1 = min((t + 1) * cfg.row_tile, out_h)
            base_t = bh[t]  # (out_w,)
            ixc_t = ixc[r0:r1, :]
            iyc_t = iyc[r0:r1, :]
            m_rows = m_h[r0:r1, :]
            f_rows = [f[..., r0:r1, :] for f in fields]

            # window offset, tap base and shift are removed in integer
            # space AFTER floor/rint (float subtraction before rounding
            # could flip ties relative to the gather kernel)
            if nearest:
                y0g = jnp.rint(iyc_t)
                i0 = jnp.rint(ixc_t).astype(jnp.int32) - i_off
            else:
                y0f = jnp.floor(iyc_t)
                fy = iyc_t - y0f
                y0g = y0f
                x0 = jnp.floor(ixc_t)
                fx = ixc_t - x0
                i0 = x0.astype(jnp.int32) - i_off
            if sh is not None:
                i0 = i0 - sh[r0:r1][:, None]
            y0w = y0g - j_off  # window row, float32 integer-valued

            zero = jnp.zeros(batch + (r1 - r0, out_w), jnp.float32)
            cv0 = zero
            cv1 = zero
            # triangular blends the 2x2 taps per-triangle, so the two row
            # samples must survive to the end instead of lerping early
            tv = [zero, zero, zero, zero] if triangular else None

            jh_tile = cfg.jh_t[t] if cfg.jh_t is not None else cfg.jh
            dh_tile = cfg.d_h_t[t] if cfg.d_h_t is not None else cfg.d_h
            if cfg.jh:
                # static-cover formulation (see _static_cover): resample
                # the anchor row and the S sample fields ONCE through the
                # monotone cover, then jh static slices route by value
                used_h = base_t[: out_w + jh_tile]
                idx_all = jnp.clip(used_h - c_lo, 0, ext_w - 1)
                Am = jnp.take(m_rows, idx_all, axis=-1)
                Af = [jnp.take(f, idx_all, axis=-1) for f in f_rows]

                def taps():
                    for j in range(jh_tile):
                        yield (
                            Am[..., :, j : j + out_w],
                            [a_[..., :, j : j + out_w] for a_ in Af],
                            used_h[j : j + out_w][None, :],
                        )
            else:

                def taps():
                    for d in range(dh_tile):
                        idx = jnp.clip(base_t + d - c_lo, 0, ext_w - 1)
                        yield (
                            jnp.take(m_rows, idx, axis=-1),  # (rt, out_w)
                            [jnp.take(f, idx, axis=-1) for f in f_rows],
                            (base_t + d)[None, :],
                        )

            for mg, taken, rid_h in taps():
                # s0 = y0 - m selects the lerp's lower sample; for nearest
                # rint may land on the window's top row S-1
                s0 = jnp.clip(y0w - mg, 0, S - 1 if nearest else S - 2)
                a = taken[0]
                bb = taken[1]
                for s in range(1, S):
                    a = jnp.where(s0 >= s - 0.5, taken[s], a)
                    if s >= 2:
                        bb = jnp.where(s0 >= s - 1.5, taken[s], bb)
                if triangular:
                    sel0 = i0 == rid_h
                    sel1 = (i0 + 1) == rid_h
                    tv[0] = jnp.where(sel0, a, tv[0])  # v00
                    tv[1] = jnp.where(sel0, bb, tv[1])  # v10
                    tv[2] = jnp.where(sel1, a, tv[2])  # v01
                    tv[3] = jnp.where(sel1, bb, tv[3])  # v11
                    continue
                colval = a if nearest else a + fy * (bb - a)
                cv0 = jnp.where(i0 == rid_h, colval, cv0)
                if not nearest:
                    cv1 = jnp.where(i0 + 1 == rid_h, colval, cv1)
            if triangular:
                # reference two-triangle split (gather.grid_sample): the
                # u+v<1 triangle anchors at v00, the far one at v11
                v00, v10, v01, v11 = tv
                near = v00 + fx * (v01 - v00) + fy * (v10 - v00)
                far = (
                    v11
                    + (1.0 - fx) * (v10 - v11)
                    + (1.0 - fy) * (v01 - v11)
                )
                out_tiles.append(jnp.where(fx + fy < 1.0, near, far))
            else:
                out_tiles.append(cv0 if nearest else cv0 + fx * (cv1 - cv0))
        out = jnp.concatenate(out_tiles, axis=-2)

        return jnp.where(valid, out, fill)

    _IMPLS["pre"] = precompute
    _IMPLS["kernel"] = kernel
    return precompute, kernel


def make_esw_fn(
    plan: ESWPlan,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    return_parts: bool = False,
    uniform: dict | None = None,
):
    """Compile the exact-warp kernel (see module docstring).

    Geometry-static quantities (anchor fields, clamped positions,
    validity) are materialized once on device at build time; the steady-
    state kernel runs lane-shared takes and elementwise selects only, in
    the same tiled layout as the fast SRW kernel.

    ``uniform`` (mosaic use) overrides the trace-static layout values
    (n_samples/d_v/d_h/tiles/bits/margins) with the piece group's maxima
    so every piece of the group shares ONE compiled kernel.
    """
    import jax.numpy as jnp

    if interp_method not in ("bilinear", "nearest", "triangular"):
        raise ValueError(
            "ESW supports 'bilinear', 'nearest' and 'triangular' only"
        )

    p = plan
    u = uniform or {}
    S = u.get("n_samples", p.n_samples)
    half = (S - 2) / 2.0
    bits_v = u.get("bits_v", p.bits_v)
    bits_h = u.get("bits_h", p.bits_h)

    s_v = p.s_v
    if s_v is None and bits_v > 0:
        s_v = np.zeros(p.src_w, dtype=np.int32)
    s_h = p.s_h
    if s_h is None and bits_h > 0:
        s_h = np.zeros(p.out_h, dtype=np.int32)

    d_v = u.get("d_v", p.d_v)
    d_h = u.get("d_h", p.d_h)
    if "r_lo" in u:
        r_lo, r_hi = u["r_lo"], u["r_hi"]
        c_lo, c_hi = u["c_lo"], u["c_hi"]
    else:
        r_lo = min(0, int(p.base_v.min())) if s_v is not None else 0
        r_hi = (
            max(0, int(p.base_v.max()) + d_v - p.src_h)
            if s_v is not None
            else 0
        )
        c_lo = min(0, int(p.base_h.min())) if s_h is not None else 0
        c_hi = (
            max(0, int(p.base_h.max()) + d_h - p.src_w)
            if s_h is not None
            else 0
        )

    # static-cover formulation: group-uniform slice counts; a piece whose
    # own cover is shorter pads it (extra slices select by value, no-ops)
    jv = u.get("jv", p.jv)
    jh = u.get("jh", p.jh)
    bv_arr = p.base_v
    bh_arr = p.base_h
    if jv:
        bv_arr = _pad_cover(p.cov_v, p.out_h, jv, axis=0)
    if jh:
        bh_arr = _pad_cover(p.cov_h, p.out_w, jh, axis=1)

    # per-tile counts ride along only when the layout is the plan's own
    # (uniform mode shares ONE kernel across pieces, whose per-tile needs
    # differ — the region fn rebuilds per-piece cfgs for the unrolled
    # loop instead, see make_esw_region_fn)
    pertile = uniform is None and (
        os.environ.get("XRTPU_ESW_PERTILE", "1") != "0"
    )
    cfg = _KernelCfg(
        n_samples=S,
        d_v=d_v,
        d_h=d_h,
        col_tile=u.get("col_tile", p.col_tile),
        row_tile=u.get("row_tile", p.row_tile),
        bits_v=bits_v,
        bits_h=bits_h,
        r_lo=r_lo,
        r_hi=r_hi,
        c_lo=c_lo,
        c_hi=c_hi,
        interp=interp_method,
        jv=jv,
        jh=jh,
        d_v_t=_norm_tile_tuple(p.d_v_t, d_v) if pertile else None,
        d_h_t=_norm_tile_tuple(p.d_h_t, d_h) if pertile else None,
        jv_t=(_norm_tile_tuple(p.jv_t, jv) if (pertile and jv) else None),
        jh_t=(_norm_tile_tuple(p.jh_t, jh) if (pertile and jh) else None),
    )
    precompute, kernel = _get_impls()

    pre_kwargs = dict(
        step=p.step,
        half=half,
        out_h=p.out_h,
        out_w=p.out_w,
        src_w=p.src_w,
        src_h_g=p.src_h_g,
        src_w_g=p.src_w_g,
        c_lo=c_lo,
        ext_w=p.src_w - c_lo + c_hi,
    )
    if return_parts == "cfg_raw":
        # for vmapped mosaic groups: the caller stacks the RAW coarse
        # inputs across pieces and runs ONE vmapped precompute per group
        # (N eager precompute dispatches -> 1)
        return cfg, (
            p.iystar_c, p.ix_c, p.iy_c, s_v, s_h,
            bv_arr, bh_arr, p.j_off, p.i_off,
        ), pre_kwargs

    _statics_cell: list = []

    def _statics():
        """Precompute fields on FIRST use, not at plan time: the eager
        precompute dispatch (trace + compile + run) was the dominant cost
        of cold planning; deferring it moves the cost into the first
        kernel call's warmup without touching warm throughput."""
        if not _statics_cell:
            sv_j = jnp.asarray(s_v) if s_v is not None else None
            sh_j = jnp.asarray(s_h) if s_h is not None else None
            mv_dev, mh_dev, ixc_dev, iyc_dev, valid_dev = precompute(
                jnp.asarray(p.iystar_c),
                jnp.asarray(p.ix_c),
                jnp.asarray(p.iy_c),
                sv_j,
                sh_j,
                **pre_kwargs,
            )
            _statics_cell.append(
                (
                    mv_dev,
                    mh_dev,
                    ixc_dev,
                    iyc_dev,
                    valid_dev,
                    jnp.asarray(bv_arr),
                    jnp.asarray(bh_arr),
                    sv_j,
                    sh_j,
                    jnp.float32(p.j_off),
                    jnp.int32(p.i_off),
                    jnp.float32(fill_value),
                )
            )
        return _statics_cell[0]

    def fn(src, *args):
        return kernel(src, *(args or _statics()), cfg=cfg)

    if return_parts == "raw":
        # for vmapped mosaic groups: the caller stacks statics across
        # pieces and maps the shared impl once per group
        return cfg, _statics()
    if return_parts:
        # for mosaic composition: the caller passes the statics as jit
        # ARGUMENTS (closing over them inside an outer jit would embed
        # them as program constants — hundreds of MB for big pieces)
        return fn, _statics()
    return fn


def make_esw_reproject_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = 16,
    **plan_kwargs,
):
    """Plan + compile the exact-warp kernel with source-window cropping,
    or None when the mapping is unsuitable (callers fall back to the
    region mosaic or the XLA-gather kernel).  The plan keeps the GLOBAL
    coordinate fields, so cropping does not change a single output bit."""
    from .srw import _source_window_gm

    if interp_method not in ("bilinear", "nearest", "triangular"):
        return None
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    win = None
    f_plan = fields
    w = _source_window_gm(source_gm, fields, margin=8 + 48)
    if w is not None:
        _, win = w
        f_plan = _offset_fields(fields, *win)
    plan = plan_esw(
        source_gm,
        target_gm,
        step=step,
        fields=f_plan,
        fields_global=fields,
        win=win,
        **plan_kwargs,
    )
    if plan is None:
        return None
    inner = make_esw_fn(plan, interp_method, fill_value)
    if win is None:
        return inner
    j0, j1, i0, i1 = win

    def fn(src):
        return inner(src[..., j0:j1, i0:i1])

    return fn


def _slice_raw(ix64, iy64, step, r0, r1, c0, c1):
    """Slice the whole-target raw coarse fields to the target sub-window
    [r0:r1) x [c0:c1) (r0/c0 step-aligned by construction of the quadtree):
    the slice keeps the parent's float64 values bit-for-bit, so every piece
    sees exactly the coordinate field the whole-target gather kernel sees."""
    jr0, ji0 = r0 // step, c0 // step
    njr = (r1 - r0 - 1) // step + 2
    nji = (c1 - c0 - 1) // step + 2
    return (
        ix64[jr0 : jr0 + njr, ji0 : ji0 + nji],
        iy64[jr0 : jr0 + njr, ji0 : ji0 + nji],
    )


def _offset_fields(fields: _Fields, j0: int, j1: int, i0: int, i1: int):
    """Re-express coarse fields relative to the source window
    [j0:j1) x [i0:i1); j0 and i0 must be aligned to the coarse step (as
    produced by _source_window_gm)."""
    step = fields.step
    k0 = i0 // step
    ncc = (i1 - i0 - 1) // step + 2
    return _Fields(
        fields.ix64 - i0,
        fields.iy64 - j0,
        fields.iystar64[:, k0 : k0 + ncc] - j0,
        step,
        j1 - j0,
        i1 - i0,
        fields.out_h,
        fields.out_w,
    )


def make_esw_region_fn(
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_method: str = "bilinear",
    fill_value=np.nan,
    step: int = 16,
    base_split: int = 2,
    max_depth: int = 4,
    op_budget: int | None = None,
    **plan_kwargs,
):
    """Exact reprojection for domain-scale warps no single ESW plan covers
    (e.g. a projection singularity inside the target): quadtree-split the
    target, plan each region's exact-warp kernel against its own cropped
    source window, and fall back to the XLA gather kernel only for regions
    that still refuse to plan.

    Region coarse fields are float64 slices of the whole-target fields
    (computed once), so the quadtree descent costs no new transform
    evaluations AND every piece — planned or gather-fallback — computes
    positions from the exact same float32 coarse nodes as the whole-target
    gather kernel: the mosaic is bit-seamless by construction.

    Returns ``fn(src) -> target`` or None when nothing plans (callers use
    plain gather) or the interpolation method is unsupported.

    Replaces the reference's uniformized-window tile mosaic
    (reference reproject.py:385-469) with per-region planned kernels.
    """
    from .reproject_ops import make_gather_piece_fn
    from .srw import _iystar_from_fields, _raw_coarse_fields, _source_window_gm

    if interp_method not in ("bilinear", "nearest", "triangular"):
        return None

    if op_budget is None:
        # the estimated op count above which a region splits into four
        # children; 7000 keeps most 1024^2 regions of the global config
        # whole instead of splitting them into 512^2 pieces.  A tuned
        # value, to be re-tuned on the GPU.
        op_budget = int(os.environ.get("XRTPU_ESW_OPBUDGET", "7000"))

    out_h, out_w = target_gm.height, target_gm.width
    src_h_g, src_w_g = source_gm.height, source_gm.width
    ix_r, iy_r = _raw_coarse_fields(source_gm, target_gm, step)

    esw_desc = []  # (r0, r1, c0, c1, f, win, probe_plan)
    gather_desc = []  # (r0, r1, c0, c1, ixs, iys)

    def build(r0, r1, c0, c1, depth):
        ixs, iys = _slice_raw(ix_r, iy_r, step, r0, r1, c0, c1)
        finite = np.isfinite(ixs) & np.isfinite(iys)
        plan = None
        win = None
        f = None
        if finite.all():
            iystar_s = _iystar_from_fields(ixs, iys, src_w_g, step)
            if iystar_s is not None:
                f = _Fields(
                    ixs, iys, iystar_s, step, src_h_g, src_w_g,
                    r1 - r0, c1 - c0,
                )
                f_plan = f
                w = _source_window_gm(source_gm, f, margin=8 + 48)
                if w is not None:
                    _, win = w
                    f_plan = _offset_fields(f, *win)
                plan = plan_esw(
                    source_gm,
                    target_gm,
                    step=step,
                    fields=f_plan,
                    fields_global=f,
                    win=win,
                    **plan_kwargs,
                )
        if plan is not None:
            # trace-size estimate: tap loops unroll, so extreme-rotation
            # pieces (near the projection singularity) can emit kernels
            # the XLA service takes minutes to compile.  Demote those to
            # the gather kernel — they are small and the quadtree already
            # isolated them
            # effective unrolled-loop counts: the static-cover formulation
            # emits jv/jh slice+select steps instead of d take+select steps
            eff_v = plan.jv if plan.jv else plan.d_v
            eff_h = plan.jh if plan.jh else plan.d_h
            est_ops = (
                -(-plan.src_w // plan.col_tile)
                * eff_v
                * (1 + plan.n_samples)
                + -(-plan.out_h // plan.row_tile)
                * eff_h
                * (2 * plan.n_samples + 6)
            )
            if est_ops <= op_budget:
                esw_desc.append((r0, r1, c0, c1, f, win, plan))
                return
            plan = None
        half_r = (r1 - r0) // 2 // step * step
        half_c = (c1 - c0) // 2 // step * step
        if depth < max_depth and half_r >= 128 and half_c >= 128:
            rm, cm = r0 + half_r, c0 + half_c
            build(r0, rm, c0, cm, depth + 1)
            build(r0, rm, cm, c1, depth + 1)
            build(rm, r1, c0, cm, depth + 1)
            build(rm, r1, cm, c1, depth + 1)
            return
        if not finite.any():
            # every coarse node is outside the transform's domain: the
            # whole-target gather yields fill here, which the mosaic
            # buffer already holds
            return
        gather_desc.append((r0, r1, c0, c1, ixs, iys))

    rb = (-(-out_h // base_split) + step - 1) // step * step
    cb = (-(-out_w // base_split) + step - 1) // step * step
    for bj in range(base_split):
        for bi in range(base_split):
            r0, r1 = bj * rb, min((bj + 1) * rb, out_h)
            c0, c1 = bi * cb, min((bi + 1) * cb, out_w)
            if r1 > r0 and c1 > c0:
                build(r0, r1, c0, c1, 0)

    if not esw_desc:
        return None

    # ---- uniformize per piece-shape group so every group shares ONE
    # compiled kernel (the reference's uniformized-window idea applied at
    # the compilation level): same forced layout decisions, same padded
    # window shape, group-max tap counts/margins.  Each group then runs
    # as ONE vmapped dispatch over its pieces — compile count and
    # per-piece dispatch overhead both collapse to the group count.
    pieces = []  # (r0, r1, c0, c1, window or None, kernel, statics)
    vgroups = []  # (cfg, gh, gw, wh, ww, [(r0, c0, j0, i0, statics)])

    def _win_or_full(win):
        return win if win is not None else (0, src_h_g, 0, src_w_g)

    # group by piece shape AND tap-diversity octave; the group maxima
    # (n_samples, d_v, d_h, window) set every member's cost, so a
    # singularity-adjacent piece with d ~ 70 must not share a kernel with
    # the d ~ 12 bulk — banding by the forced-layout cost estimate keeps
    # each kernel's diversity within 2x of its cheapest member while the
    # compile/dispatch count stays ~2-3 per shape
    groups: dict = {}
    for desc in esw_desc:
        p = desc[6]
        est_v = p.d_v * max(1, 128 // max(p.col_tile, 1))
        est_h = p.d_h * max(1, 128 // max(p.row_tile, 1))
        key = (
            desc[1] - desc[0],
            desc[3] - desc[2],
            max(int(est_v), 1).bit_length(),
            max(int(est_h), 1).bit_length(),
        )
        groups.setdefault(key, []).append(desc)

    def _demote_to_gather(desc):
        r0, r1, c0, c1 = desc[:4]
        ixs, iys = _slice_raw(ix_r, iy_r, step, r0, r1, c0, c1)
        gather_desc.append((r0, r1, c0, c1, ixs, iys))

    for (gh, gw, *_band), descs in groups.items():
        g_S = max(d[6].n_samples for d in descs)
        force = {
            "n_samples": g_S,
            "col_tile": 128,
            "row_tile": min(128, gh),
            # sweep layouts are only planned when the env knob asks for
            # them (d_h has an interpolation floor, so finer tiles shave
            # little volume while multiplying per-tile fixed costs)
            "row_tile_sweep": (
                tuple(t for t in (128, 64, 32, 16) if t <= gh)
                if os.environ.get("XRTPU_MOSAIC_ROW_TILE", "")
                else None
            ),
            "use_shift_v": any(d[6].s_v is not None for d in descs),
            "use_shift_h": any(d[6].s_h is not None for d in descs),
        }
        wins = [_win_or_full(d[5]) for d in descs]
        wh = min(
            src_h_g,
            -(-max(w[1] - w[0] for w in wins) // step) * step,
        )
        ww = min(
            src_w_g,
            -(-max(w[3] - w[2] for w in wins) // step) * step,
        )
        replans = []
        for desc, w0 in zip(descs, wins):
            r0, r1, c0, c1, f, _, probe = desc
            j0 = max(0, min(w0[0], src_h_g - wh)) // step * step
            i0 = max(0, min(w0[2], src_w_g - ww)) // step * step
            win2 = (j0, j0 + wh, i0, i0 + ww)
            plan2 = plan_esw(
                source_gm,
                target_gm,
                step=step,
                fields=_offset_fields(f, *win2),
                fields_global=f,
                win=win2,
                force=force,
                **plan_kwargs,
            )
            replans.append((desc, win2, plan2))

        # measurement-only group row tile override (XRTPU_MOSAIC_ROW_TILE:
        # a number forces that shared tile, "adaptive" picks the candidate
        # minimizing group-max d_h).  NOT the default: d_h bottoms out at
        # an interpolation floor, so the volume model's gains need not
        # survive the per-tile fixed costs
        planned = [rp[2] for rp in replans if rp[2] is not None]
        if planned and all(getattr(p, "h_sweep", None) for p in planned):
            rt_env = os.environ.get("XRTPU_MOSAIC_ROW_TILE", "")
            cands = sorted(
                set.intersection(*(set(p.h_sweep) for p in planned)),
                reverse=True,
            )
            if rt_env and rt_env != "adaptive":
                best_rt = int(rt_env) if int(rt_env) in cands else None
            else:
                # trace guard: the unrolled tile loop emits
                # n_tiles x d_h HLO ops — don't trade a runtime win for
                # an unbounded compile-time regression
                big = cands[0]
                trace0 = max(
                    int(p.h_sweep[big][1].sum()) for p in planned
                )
                best_rt = None
                best_cost = None
                for rt in cands:  # descending: ties keep the larger tile
                    cost = max(
                        float(p.h_sweep[rt][1].mean()) for p in planned
                    )
                    trace = max(
                        int(p.h_sweep[rt][1].sum()) for p in planned
                    )
                    if trace > 1.7 * trace0:
                        continue
                    if best_cost is None or cost < 0.95 * best_cost:
                        best_rt, best_cost = rt, cost
            if best_rt is not None:
                force["row_tile"] = best_rt
                for p in planned:
                    base_h2, dh_t2 = p.h_sweep[best_rt]
                    p.base_h = base_h2
                    p.d_h = int(dh_t2.max())
                    p.d_h_t = tuple(int(x) for x in dh_t2)
                    p.row_tile = best_rt
                    # the measurement-only sweep replaces base_h; the
                    # cover no longer matches it — drop to dynamic taps
                    p.cov_h, p.jh, p.jh_t = None, 0, None

        # group tap counts are maxima: demote the most expensive members
        # to the gather kernel until the shared kernel's trace-size
        # estimate fits the budget (they are small singularity-adjacent
        # pieces; gather on a cropped window is fine there)
        def group_est(rps):
            d_v = max(rp[2].d_v for rp in rps)
            d_h = max(rp[2].d_h for rp in rps)
            if all(rp[2].jv for rp in rps):
                d_v = max(rp[2].jv for rp in rps)
            if all(rp[2].jh for rp in rps):
                d_h = max(rp[2].jh for rp in rps)
            return (
                -(-ww // force["col_tile"]) * d_v * (1 + g_S)
                + -(-gh // force["row_tile"]) * d_h * (2 * g_S + 6)
            )

        ok = [rp for rp in replans if rp[2] is not None]
        ok.sort(key=lambda rp: rp[2].d_v + rp[2].d_h)
        while len(ok) > 1 and group_est(ok) > 2 * op_budget:
            _demote_to_gather(ok.pop()[0])
        if len(ok) == 1 and group_est(ok) > 3 * op_budget:
            _demote_to_gather(ok.pop()[0])
        kept = {id(rp[0]) for rp in ok}
        replans = [
            rp
            for rp in replans
            if rp[2] is not None and id(rp[0]) in kept
        ] + [rp for rp in replans if rp[2] is None]
        if ok:
            d_v = max(rp[2].d_v for rp in ok)
            d_h = max(rp[2].d_h for rp in ok)
            # static-cover slice counts are trace-static, so the group can
            # use the formulation only when EVERY member's cover exists;
            # members pad their covers to the group maximum
            jv_g = (
                max(rp[2].jv for rp in ok)
                if all(rp[2].jv for rp in ok)
                else 0
            )
            jh_g = (
                max(rp[2].jh for rp in ok)
                if all(rp[2].jh for rp in ok)
                else 0
            )
            uniform = {
                "n_samples": force["n_samples"],
                "d_v": d_v,
                "d_h": d_h,
                "jv": jv_g,
                "jh": jh_g,
                "col_tile": force["col_tile"],
                "row_tile": force["row_tile"],
                "bits_v": max(rp[2].bits_v for rp in ok),
                "bits_h": max(rp[2].bits_h for rp in ok),
                "r_lo": min(
                    min(0, int(rp[2].base_v.min())) for rp in ok
                )
                if force["use_shift_v"]
                else 0,
                "r_hi": max(
                    max(0, int(rp[2].base_v.max()) + d_v - wh) for rp in ok
                )
                if force["use_shift_v"]
                else 0,
                "c_lo": min(
                    min(0, int(rp[2].base_h.min())) for rp in ok
                )
                if force["use_shift_h"]
                else 0,
                "c_hi": max(
                    max(0, int(rp[2].base_h.max()) + d_h - ww) for rp in ok
                )
                if force["use_shift_h"]
                else 0,
            }
        members = []  # (r0, c0, j0, i0, raw_parts) — the vmapped group
        member_taps = []  # per-member (d_v, d_h, jv, jh) from its own plan
        group_cfg = None
        group_prekw = None
        for desc, win2, plan2 in replans:
            r0, r1, c0, c1 = desc[:4]
            if plan2 is not None:
                group_cfg, raw, group_prekw = make_esw_fn(
                    plan2, interp_method, fill_value,
                    return_parts="cfg_raw", uniform=uniform,
                )
                members.append((r0, c0, win2[0], win2[2], raw))
                member_taps.append(
                    (
                        plan2.d_v, plan2.d_h, plan2.jv, plan2.jh,
                        plan2.d_v_t, plan2.d_h_t, plan2.jv_t, plan2.jh_t,
                    )
                )
            else:
                # forced layout did not fit this piece: fall back to its
                # own probe plan (costs one extra compile + dispatch)
                kernel, statics = make_esw_fn(
                    desc[6], interp_method, fill_value, return_parts=True
                )
                pieces.append((r0, r1, c0, c1, desc[5], kernel, statics))
        if members:
            # per-piece kernel configs (unrolled piece loop only): the
            # group maxima exist to share ONE compiled kernel, but the
            # unrolled loop inlines each piece's HLO anyway — so each
            # piece can run at its OWN tap counts (bulk members at
            # d ~ 8-10 stop paying a d ~ 14 group max).  The stacked
            # covers/bases stay group-max padded; a kernel that reads
            # fewer slices of them is correct by the member's own plan.
            # The member's static-vs-dynamic choice must match the
            # group's (the stacked arrays hold covers XOR bases).
            per_cfgs = None
            if os.environ.get("XRTPU_MOSAIC_PERPIECE", "1") != "0":
                pertile = os.environ.get("XRTPU_ESW_PERTILE", "1") != "0"
                base_kw = {
                    k: getattr(group_cfg, k) for k in _KernelCfg.__slots__
                }
                per_cfgs = [
                    _KernelCfg(
                        **{
                            **base_kw,
                            "d_v": dv,
                            "d_h": dh,
                            "jv": jv_m if group_cfg.jv else 0,
                            "jh": jh_m if group_cfg.jh else 0,
                            "d_v_t": (
                                _norm_tile_tuple(dv_t, dv)
                                if pertile else None
                            ),
                            "d_h_t": (
                                _norm_tile_tuple(dh_t, dh)
                                if pertile else None
                            ),
                            "jv_t": (
                                _norm_tile_tuple(jv_t, jv_m)
                                if (pertile and group_cfg.jv)
                                else None
                            ),
                            "jh_t": (
                                _norm_tile_tuple(jh_t, jh_m)
                                if (pertile and group_cfg.jh)
                                else None
                            ),
                        }
                    )
                    for (
                        dv, dh, jv_m, jh_m, dv_t, dh_t, jv_t, jh_t
                    ) in member_taps
                ]
            vgroups.append(
                (
                    group_cfg, per_cfgs, group_prekw, gh, gw, wh, ww,
                    members,
                    # debug/bucket tag: this group's OWN sample/tap counts
                    # (reading the planning loop's `uniform` later would
                    # leak the LAST group's values into every tag)
                    (uniform["n_samples"], uniform["d_v"], uniform["d_h"]),
                )
            )
            if os.environ.get("XRTPU_MOSAIC_DEBUG", ""):
                print(
                    f"[mosaic] esw group out={gh}x{gw} n={len(members)} "
                    f"win={wh}x{ww} S={uniform['n_samples']} "
                    f"d_v={uniform['d_v']} d_h={uniform['d_h']} "
                    f"shift=({force['use_shift_v']},{force['use_shift_h']}) "
                    f"per-piece (S, d_v, d_h): "
                    f"{sorted((rp[2].n_samples, rp[2].d_v, rp[2].d_h) for rp in ok)}",
                    flush=True,
                )

    # gather pieces: batch same-shaped pieces into one vmapped program
    # (the quadtree emits many identically-sized singularity-adjacent
    # leaves — compiling and dispatching each separately costs a compile
    # and a dispatch apiece); singletons keep the baked-offset kernel
    ggroups: dict = {}
    for d in gather_desc:
        ggroups.setdefault((d[1] - d[0], d[3] - d[2]), []).append(d)
    if os.environ.get("XRTPU_MOSAIC_DEBUG", "") and gather_desc:
        g_pix = sum((d[1] - d[0]) * (d[3] - d[2]) for d in gather_desc)
        print(
            f"[mosaic] gather pieces n={len(gather_desc)} "
            f"pixels={g_pix} ({100.0 * g_pix / (out_h * out_w):.2f}% of "
            f"target) shapes="
            f"{sorted(((gh, gw), len(v)) for (gh, gw), v in ggroups.items())}",
            flush=True,
        )
    gather_vgroups = []  # (kernel, gh, gw, wh, ww, members)
    for (gh, gw), ds_ in ggroups.items():
        wins = []
        for r0, r1, c0, c1, ixs, iys in ds_:
            fr = _Fields(
                ixs, iys, None, step, src_h_g, src_w_g, r1 - r0, c1 - c0
            )
            w = _source_window_gm(source_gm, fr, margin=8)
            wins.append(w[1] if w is not None else (0, src_h_g, 0, src_w_g))
        if len(ds_) == 1:
            (r0, r1, c0, c1, ixs, iys), w0 = ds_[0], wins[0]
            win = None if w0 == (0, src_h_g, 0, src_w_g) else w0
            j_off, i_off = (win[0], win[2]) if win is not None else (0, 0)
            kernel, statics = make_gather_piece_fn(
                ixs.astype(np.float32),
                iys.astype(np.float32),
                step,
                r1 - r0,
                c1 - c0,
                src_h_g,
                src_w_g,
                j_off,
                i_off,
                interp_method,
                fill_value,
                return_parts=True,
            )
            pieces.append((r0, r1, c0, c1, win, kernel, statics))
            continue
        from .reproject_ops import make_gather_piece_kernel_dyn

        wh = min(src_h_g, max(w[1] - w[0] for w in wins))
        ww = min(src_w_g, max(w[3] - w[2] for w in wins))
        kernel = make_gather_piece_kernel_dyn(
            step, gh, gw, src_h_g, src_w_g, interp_method, fill_value
        )
        members = []
        for (r0, r1, c0, c1, ixs, iys), w0 in zip(ds_, wins):
            j0 = max(0, min(w0[0], src_h_g - wh))
            i0 = max(0, min(w0[2], src_w_g - ww))
            members.append(
                (
                    r0, c0, j0, i0,
                    (
                        ixs.astype(np.float32),
                        iys.astype(np.float32),
                    ),
                )
            )
        gather_vgroups.append((kernel, gh, gw, wh, ww, members))

    import jax
    import jax.numpy as jnp
    from functools import partial

    precompute_impl, kernel_impl = _get_impls()

    def _jit_canvas(fun, out_argnum):
        # donate the canvas so the per-group update is in place (one
        # full-canvas copy saved per program); CPU ignores donation and
        # warns, so only donate on accelerators
        if jax.default_backend() == "cpu":
            return jax.jit(fun)
        return jax.jit(fun, donate_argnums=(out_argnum,))

    # one traced BODY per group: vmap the shared kernel over the group's
    # pieces (window slicing via per-piece dynamic_slice starts) and
    # scatter the stacked results into the canvas.  Bodies are then
    # fused into a handful of jitted bucket programs (see below): every
    # extra program costs a dispatch, while one whole-mosaic jit makes
    # one very long compile
    bodies = []  # (run_unjitted(src, out, *args) -> out, args or () -> args)
    for (
        group_cfg, per_cfgs, group_prekw, gh, gw, wh, ww, members, tag_sdh
    ) in vgroups:
        # stack the RAW coarse inputs on the host; the ONE vmapped
        # precompute per group (trace + compile + run) happens lazily at
        # the FIRST mosaic dispatch — the 30-odd eager precompute
        # programs were ~75% of cold planning wall time
        raws = [m[4] for m in members]
        iystar_np = np.stack([r[0] for r in raws])
        ix_np = np.stack([r[1] for r in raws])
        iy_np = np.stack([r[2] for r in raws])
        sv_np = (
            np.stack([r[3] for r in raws])
            if raws[0][3] is not None
            else None
        )
        sh_np = (
            np.stack([r[4] for r in raws])
            if raws[0][4] is not None
            else None
        )
        n_m = len(members)
        offs_np = np.asarray(
            [[m[2], m[3]] for m in members], dtype=np.int32
        )
        bv_np = np.stack([r[5] for r in raws])
        bh_np = np.stack([r[6] for r in raws])
        joff_np = np.asarray([r[7] for r in raws], dtype=np.float32)
        ioff_np = np.asarray([r[8] for r in raws], dtype=np.int32)

        def make_args_thunk(
            iystar_np=iystar_np, ix_np=ix_np, iy_np=iy_np,
            sv_np=sv_np, sh_np=sh_np, bv_np=bv_np, bh_np=bh_np,
            joff_np=joff_np, ioff_np=ioff_np, offs_np=offs_np,
            group_prekw=group_prekw, n_m=n_m,
        ):
            cell: list = []

            def thunk():
                if not cell:
                    sv_st = (
                        jnp.asarray(sv_np) if sv_np is not None else None
                    )
                    sh_st = (
                        jnp.asarray(sh_np) if sh_np is not None else None
                    )
                    pre1 = partial(precompute_impl, **group_prekw)
                    mv, mh, ixc, iyc, valid = jax.vmap(
                        pre1,
                        in_axes=(
                            0, 0, 0,
                            0 if sv_np is not None else None,
                            0 if sh_np is not None else None,
                        ),
                    )(
                        jnp.asarray(iystar_np),
                        jnp.asarray(ix_np),
                        jnp.asarray(iy_np),
                        sv_st,
                        sh_st,
                    )
                    cell.append(
                        (jnp.asarray(offs_np),)
                        + (
                            mv, mh, ixc, iyc, valid,
                            jnp.asarray(bv_np),
                            jnp.asarray(bh_np),
                            sv_st,
                            sh_st,
                            jnp.asarray(joff_np),
                            jnp.asarray(ioff_np),
                            jnp.asarray(
                                np.full(n_m, fill_value, dtype=np.float32)
                            ),
                        )
                    )
                return cell[0]

            return thunk

        starts_rc = [(m[0], m[1]) for m in members]
        piece_kernel = partial(kernel_impl, cfg=group_cfg)
        # which of the 12 stacked args are None (absent shift tables):
        # decides vmap axes without materializing the precompute
        absent = (sv_np is None, sh_np is None)

        def make_group_body(absent, starts_rc, piece_kernel, wh, ww,
                            per_cfgs=per_cfgs):
            sv_absent, sh_absent = absent
            in_axes = (0,) + tuple(
                None if (k == 7 and sv_absent) or (k == 8 and sh_absent)
                else 0
                for k in range(12)
            )

            def one(src, off, *st, kern=piece_kernel):
                zero = jax.lax.convert_element_type(0, off.dtype)
                start = (zero,) * (src.ndim - 2) + (off[0], off[1])
                win = jax.lax.dynamic_slice(
                    src, start, src.shape[:-2] + (wh, ww)
                )
                return kern(win, *st)

            # unrolled piece loop: one program per piece instead of a
            # vmapped batch; trace size scales with the member count, so
            # XRTPU_MOSAIC_VMAP=1 restores the vmap
            unroll = os.environ.get("XRTPU_MOSAIC_VMAP", "") != "1"

            def run(src, out, offs, *stacked):
                if unroll:
                    for i, (r0, c0) in enumerate(starts_rc):
                        st = tuple(
                            a if ax is None else a[i]
                            for a, ax in zip(stacked, in_axes[1:])
                        )
                        kern = (
                            partial(kernel_impl, cfg=per_cfgs[i])
                            if per_cfgs is not None
                            else piece_kernel
                        )
                        piece = one(src, offs[i], *st, kern=kern)
                        out = jax.lax.dynamic_update_slice(
                            out,
                            piece,
                            (0,) * (out.ndim - 2) + (r0, c0),
                        )
                    return out

                out_stack = jax.vmap(
                    lambda off, *st: one(src, off, *st), in_axes=in_axes
                )(offs, *stacked)
                for i, (r0, c0) in enumerate(starts_rc):
                    out = jax.lax.dynamic_update_slice(
                        out,
                        out_stack[i],
                        (0,) * (out.ndim - 2) + (r0, c0),
                    )
                return out

            return run

        bodies.append(
            (
                make_group_body(absent, starts_rc, piece_kernel, wh, ww),
                make_args_thunk(),
                ("esw", gh, gw, wh, ww, n_m) + tag_sdh,
            )
        )

    for g_kernel, gh, gw, wh, ww, members in gather_vgroups:
        ix_st = jnp.stack([jnp.asarray(m[4][0]) for m in members])
        iy_st = jnp.stack([jnp.asarray(m[4][1]) for m in members])
        offs = jnp.asarray(
            [[m[2], m[3]] for m in members], dtype=jnp.int32
        )
        starts_rc = [(m[0], m[1]) for m in members]

        def make_gather_group_body(kernel, starts_rc, wh, ww):
            def run(src, out, offs, ix_st, iy_st):
                def one(off, ixc, iyc):
                    zero = jax.lax.convert_element_type(0, off.dtype)
                    start = (zero,) * (src.ndim - 2) + (off[0], off[1])
                    win = jax.lax.dynamic_slice(
                        src, start, src.shape[:-2] + (wh, ww)
                    )
                    return kernel(win, ixc, iyc, off[0], off[1])

                out_stack = jax.vmap(one)(offs, ix_st, iy_st)
                for i, (r0, c0) in enumerate(starts_rc):
                    out = jax.lax.dynamic_update_slice(
                        out,
                        out_stack[i],
                        (0,) * (out.ndim - 2) + (r0, c0),
                    )
                return out

            return run

        bodies.append(
            (
                make_gather_group_body(g_kernel, starts_rc, wh, ww),
                (offs, ix_st, iy_st),
                ("gather", gh, gw, wh, ww, len(members)),
            )
        )

    # singleton pieces (own probe plan / baked-offset gather): fold them
    # into the bucket programs too; their statics travel as jit
    # ARGUMENTS (closing over them would bake program constants)
    def make_piece_body(piece_fn, win, r0, c0):
        def run(src, out, *statics):
            piece_src = (
                src[..., win[0] : win[1], win[2] : win[3]]
                if win is not None
                else src
            )
            piece = piece_fn(piece_src, *statics)
            return jax.lax.dynamic_update_slice(
                out, piece, (0,) * (out.ndim - 2) + (r0, c0)
            )

        return run

    for r0, r1, c0, c1, win, piece_fn, statics in pieces:
        bodies.append(
            (
                make_piece_body(piece_fn, win, r0, c0),
                statics,
                ("piece", r0, r1, c0, c1,
                 None if win is None else (win[1] - win[0], win[3] - win[2])),
            )
        )

    # ---- fuse bodies into a few jitted bucket programs.  Each bucket
    # threads the donated canvas through its bodies in one trace: the
    # host pays one dispatch round trip per BUCKET instead of per group,
    # and XLA sees the full canvas dataflow (in-place piece scatters, no
    # inter-program canvas handoffs).  XRTPU_MOSAIC_PROGS sets the
    # bucket count (default 12, a tuned value to be re-tuned on the GPU):
    # more buckets mean more dispatches but shorter compiles each
    n_progs = max(1, int(os.environ.get("XRTPU_MOSAIC_PROGS", "12")))
    n_progs = min(n_progs, len(bodies))
    bucket_fns = []
    bounds = [
        (len(bodies) * k) // n_progs for k in range(n_progs + 1)
    ]

    def make_bucket_fn(specs):
        # args may be tuples or zero-arg thunks (lazy group precomputes);
        # resolve on the FIRST dispatch so plan time stays free of eager
        # device programs
        state: dict = {}

        def bucket_fn(src, out):
            if not state:
                args_lists = [
                    tuple(a() if callable(a) else a) for _, a, _ in specs
                ]
                sizes = [len(a) for a in args_lists]

                def run(src, out, *flat):
                    i = 0
                    for (body, _, _), n in zip(specs, sizes):
                        out = body(src, out, *flat[i : i + n])
                        i += n
                    return out

                state["jrun"] = _jit_canvas(run, 1)
                state["flat"] = [x for a in args_lists for x in a]
            return state["jrun"](src, out, *state["flat"])

        bucket_fn._meta = [m for _, _, m in specs]
        return bucket_fn

    for k in range(n_progs):
        specs = bodies[bounds[k] : bounds[k + 1]]
        if specs:
            bucket_fns.append(make_bucket_fn(specs))

    def fn(src):
        src = jnp.asarray(src)
        out = jnp.full(
            src.shape[:-2] + (out_h, out_w),
            jnp.float32(fill_value),
            dtype=jnp.float32,
        )
        for bucket_fn in bucket_fns:
            out = bucket_fn(src, out)
        return out

    fn._buckets = bucket_fns  # diagnostics: per-bucket timing probes
    return fn
