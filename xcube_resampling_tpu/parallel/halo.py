"""Sharded regridding with genuine halo exchange.

The reference achieves tile overlap by redundant gathering — every target
tile independently slices an enlarged source window (reference
reproject.py:405-423, rectify.py:342-345).  On a device mesh the idiomatic
equivalent is *halo exchange*: the source raster is sharded in row bands
across devices, each device swaps ``halo`` boundary rows with its
neighbours over the device interconnect (``lax.ppermute``), then runs the
fused gather kernel
on its extended band to produce its target band.  No device ever
materialises more than its band + halo, and the exchange rides the
interconnect instead of re-gathering from host storage.

Coordinates use the approximate-field strategy of
:mod:`..ops.reproject_ops`: a small float32 fractional-index field
(computed on host in float64) is replicated to every device; each band
interpolates its own rows of it.

Validity domain: the target->source row mapping must stay within ±halo of
the proportional band (monotone row-wise reprojection — the common case
for continental-scale CRS pairs); pixels needing farther rows resolve to
the fill value.  :func:`required_halo` sizes the halo from the actual
coordinate mapping.
"""

from __future__ import annotations

import logging

import numpy as np

from ..gridmapping import GridMapping

LOG = logging.getLogger("xcube.resampling")
from ..ops.reproject_ops import _interp_field, coarse_coord_field, gather_interp
from ..ops.srw import (
    _coarse_geometry,
    _interp_cols,
    _interp_rows,
    _pick_tile,
    _source_window_gm,
    _twopass_slope,
)


def _exchange_halo(src_band, halo, band_h, n, axis_name, lax, jnp):
    """Extend a device's row band by *halo* rows on each side via
    multi-hop ``ppermute``: hop k brings the full band of the k-th
    neighbour, so halos larger than one band (strongly non-proportional
    row mappings, tiny bands) still resolve.  Devices past the mesh edge
    contribute zeros — those rows are always masked or out of the tap
    range.  Returns (..., band_h + 2*halo, W)."""
    k_hops = -(-halo // band_h)
    above_parts = []
    below_parts = []
    for hop in range(k_hops, 0, -1):
        above_parts.append(
            lax.ppermute(
                src_band, axis_name,
                [(i, i + hop) for i in range(n - hop)],
            )
        )
    for hop in range(1, k_hops + 1):
        below_parts.append(
            lax.ppermute(
                src_band, axis_name,
                [(i + hop, i) for i in range(n - hop)],
            )
        )
    ext = jnp.concatenate(above_parts + [src_band] + below_parts, axis=-2)
    # trim the over-fetched rows to exactly band_h + 2*halo
    lead = k_hops * band_h - halo
    return ext[..., lead : lead + band_h + 2 * halo, :]


def required_halo(
    source_gm: GridMapping,
    target_gm: GridMapping,
    n_bands: int,
    coord_fields=None,
) -> int:
    """Worst-case extra source rows a device needs beyond its proportional
    band, measured from the actual inverse coordinate mapping."""
    if coord_fields is None:
        coord_fields = coarse_coord_field(source_gm, target_gm)
    _, iy_c, step = coord_fields
    band_h = -(-source_gm.height // n_bands)
    out_band_h = -(-target_gm.height // n_bands)
    # evaluate the row mapping at every band's first and last target row
    # (linear interpolation of the coarse field — the same approximation
    # the device kernel uses), vectorized over bands x columns
    ks = np.arange(n_bands)
    r0s = ks * out_band_h
    r1s = np.minimum((ks + 1) * out_band_h - 1, target_gm.height - 1)
    rows = np.concatenate([r0s, r1s]).astype(np.float64)
    band_starts = np.concatenate([ks, ks]).astype(np.float64) * band_h
    rr = rows / step
    j0 = np.clip(rr.astype(np.int64), 0, iy_c.shape[0] - 2)
    fj = (rr - j0)[:, None]
    iy_rows = iy_c[j0, :] * (1 - fj) + iy_c[j0 + 1, :] * fj  # (2n, ncols)
    with np.errstate(invalid="ignore"):
        above = np.nanmax(band_starts[:, None] - iy_rows, axis=1)
        below = np.nanmax(
            iy_rows - (band_starts + band_h - 1)[:, None], axis=1
        )
    edges = np.concatenate([above, below])
    edges = edges[np.isfinite(edges)]
    dev = float(edges.max()) if edges.size else 0.0
    return int(np.ceil(max(0.0, dev))) + 2


def make_sharded_regrid_step(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    halo: int | None = None,
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
    step: int = 16,
):
    """Build the jitted shard_map step: halo exchange + fused gather.

    Returns (step_fn, (src_pad_h, out_h)).  ``step_fn(src)`` expects the
    (padded) source with rows sharded over ``mesh[axis_name]`` and returns
    the target raster sharded the same way.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis_name]

    src_h, src_w = source_gm.height, source_gm.width
    out_h, out_w = target_gm.height, target_gm.width
    band_h = -(-src_h // n)
    out_band_h = -(-out_h // n)
    src_pad_h = band_h * n - src_h

    fields = coarse_coord_field(source_gm, target_gm, step)
    need = required_halo(source_gm, target_gm, n, fields)
    if halo is None:
        halo = need
    elif halo < min(need, (n - 1) * band_h):
        LOG.warning(
            "sharded regrid halo=%d is smaller than the %d rows the "
            "row mapping requires: pixels whose source rows fall outside "
            "the exchanged band resolve to the fill value",
            halo,
            need,
        )
    halo = min(halo, (n - 1) * band_h)
    ix_c = jnp.asarray(fields[0])
    iy_c = jnp.asarray(fields[1])

    use_halo = n > 1 and halo > 0

    def band_step(src_band, ix_field, iy_field):
        # src_band: (..., band_h, W) per device; coordinate fields are
        # replicated arguments (not captured constants — see reproject_ops)
        idx = lax.axis_index(axis_name)
        if use_halo:
            ext = _exchange_halo(
                src_band, halo, band_h, n, axis_name, lax, jnp
            )
        else:
            ext = src_band
        ext_h = ext.shape[-2]

        row0 = (idx * out_band_h).astype(jnp.float32)
        rows = row0 + jnp.arange(out_band_h, dtype=jnp.float32)[:, None]
        cols = jnp.arange(out_w, dtype=jnp.float32)[None, :]
        ix = _interp_field(ix_field, rows, cols, step, jnp)
        iy = _interp_field(iy_field, rows, cols, step, jnp)

        # global bounds mask, clamp to the real source extent (clamp-to-edge
        # like the single-chip kernel), then rebase into the extended band
        in_src = (
            (ix > -0.5) & (ix < src_w - 0.5) & (iy > -0.5) & (iy < src_h - 0.5)
        )
        iy_g = jnp.clip(iy, 0, src_h - 1)
        local_off = (idx * band_h - (halo if use_halo else 0)).astype(jnp.float32)
        iy_local = iy_g - local_off
        in_band = (iy_local > -0.5) & (iy_local < ext_h - 0.5)
        vals = gather_interp(
            ext,
            ix,
            jnp.clip(iy_local, 0, ext_h - 1),
            interp_method,
            fill_value,
            jnp,
            valid=in_src & in_band,
        )
        return vals

    batch_spec = [None] * src_batch_dims
    shard_map = jax.shard_map
    mapped = shard_map(
        band_step,
        mesh=mesh,
        in_specs=(
            P(*batch_spec, axis_name, None),
            P(None, None),
            P(None, None),
        ),
        out_specs=P(*batch_spec, axis_name, None),
    )
    jitted = jax.jit(mapped)

    def step_fn(src):
        return jitted(src, ix_c, iy_c)

    return step_fn, (src_pad_h, out_h)


def make_sharded_srw_step(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
    step: int = 16,
    max_taps: int = 48,
    tap_budget: int = 12,
):
    """Sharded tiled-SRW regrid: halo exchange + gather-free tap kernel.

    The tiled SRW decomposition (:mod:`..ops.srw`) shards naturally over
    target rows: the vertical pass reads a contiguous source-row window per
    band (supplied by the ``ppermute`` halo exchange) and the horizontal
    pass is row-local, needing no communication at all.  Per-band plan data
    (``base_v`` per target row, ``base_h`` per band row tile) ship as
    sharded arguments; coarse coordinate fields are replicated.  Planning
    happens here (not via :func:`..ops.srw.plan_srw`) because the
    horizontal row tiles must align with the output bands — the last tile
    of each band overlaps its predecessor instead of padding the band,
    which would break the proportional band<->band correspondence that
    keeps the halo small.

    Returns ``(step_fn, (src_pad_h, out_h))`` or ``None`` when the mapping
    is unsuitable (callers then use :func:`make_sharded_regrid_step`'s
    gather formulation).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    if interp_method not in ("bilinear", "nearest", "triangular"):
        return None
    tri = interp_method == "triangular"
    n = mesh.shape[axis_name]
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    # same two-pass fidelity gate as the single-chip default path
    if _twopass_slope(fields) > 0.2:
        return None
    ix64, iystar = fields.ix64, fields.iystar64
    iy64 = fields.iy64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w

    band_h = -(-src_h // n)
    src_pad_h = band_h * n - src_h
    out_band_h = -(-out_h // n)  # exact: bands stay proportionally aligned
    out_h_pad = out_band_h * n

    # ---- vertical plan: per-(output row, column tile) integer base
    slope_v = float(np.nanmax(np.abs(np.diff(iystar, axis=1))) / step)
    col_tile = _pick_tile(slope_v, tap_budget)
    ncc = iystar.shape[1]
    n_col_tiles = -(-src_w // col_tile)
    iystar_rows = _interp_rows(iystar, out_h, step)
    if out_h_pad > out_h:  # padded rows replicate the last real row
        iystar_rows = np.concatenate(
            [iystar_rows, np.repeat(iystar_rows[-1:], out_h_pad - out_h, 0)]
        )
    base_v = np.zeros((out_h_pad, n_col_tiles), dtype=np.int32)
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

    # ---- horizontal plan: per-(band, row tile) base with an overlapping
    # last tile (tiles never straddle band boundaries)
    slope_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0))) / step)
    row_tile = min(_pick_tile(slope_h, tap_budget), out_band_h)
    tiles_per_band = -(-out_band_h // row_tile)
    tile_starts = [t * row_tile for t in range(tiles_per_band - 1)]
    tile_starts.append(out_band_h - row_tile)
    ix_cols = _interp_cols(ix64, out_w, step)
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step
    base_h = np.zeros((n * tiles_per_band, out_w), dtype=np.int32)
    span_max_h = 0.0
    for k in range(n):
        for t, s0 in enumerate(tile_starts):
            r0 = min(k * out_band_h + s0, out_h - 1)
            r1 = min(r0 + row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = ix_cols[k0:k1, :]
            m = seg.min(axis=0)
            base_h[k * tiles_per_band + t, :] = (
                np.floor(m).astype(np.int32) - 1
            )
            span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
    d_h = int(np.ceil(span_max_h)) + 4
    if d_h > max_taps:
        return None

    # ---- halo: worst-case deviation of any band's (globally clamped)
    # vertical taps from its proportional source band
    lo_tap = np.clip(base_v.min(axis=1), 0, src_h - 1)
    hi_tap = np.clip(base_v.max(axis=1) + d_v - 1, 0, src_h - 1)
    halo = 0
    for k in range(n):
        r0, r1 = k * out_band_h, (k + 1) * out_band_h
        off = k * band_h
        halo = max(
            halo,
            int(off - lo_tap[r0:r1].min()),
            int(hi_tap[r0:r1].max() - (off + band_h - 1)),
        )
    halo = max(halo, 0)
    halo = min(halo, (n - 1) * band_h)

    iystar_c = jnp.asarray(iystar.astype(np.float32))
    ix_c = jnp.asarray(ix64.astype(np.float32))
    iy_c = jnp.asarray(iy64.astype(np.float32))
    bv_j = jnp.asarray(base_v)
    bh_j = jnp.asarray(base_h)

    use_halo = n > 1 and halo > 0
    out_h_pad = out_band_h * n

    # geometry-static per-pixel fields, materialized once at build time
    # with the exact f32 ops the band kernel used to run per call (the
    # global row index arange equals each band's local arange + offset
    # bitwise, so sharding these over rows changes nothing numerically)
    import jax as _jax

    @_jax.jit
    def _precompute(iystar_f, ix_f, iy_f):
        rows_col = jnp.arange(out_h_pad, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(src_w, dtype=jnp.float32)[None, :]
        pos_v = _interp_field(iystar_f, rows_col, cols_src, step, jnp)
        cols = jnp.arange(out_w, dtype=jnp.float32)[None, :]
        pos_h = _interp_field(ix_f, rows_col, cols, step, jnp)
        iy_full = _interp_field(iy_f, rows_col, cols, step, jnp)
        valid = (
            (pos_h > -0.5)
            & (pos_h < src_w - 0.5)
            & (iy_full > -0.5)
            & (iy_full < src_h - 0.5)
        )
        if not tri:
            return pos_v, pos_h, valid
        # triangular = bilinear - s * Delta (see ops/srw.py make_srw_fn)
        u = pos_h - jnp.floor(pos_h)
        vf = iy_full - jnp.floor(iy_full)
        s = jnp.minimum(u * vf, (1.0 - u) * (1.0 - vf)).astype(jnp.float32)
        return pos_v, pos_h, valid, s

    s_dev = None
    if tri:
        pos_v_dev, pos_h_dev, valid_dev, s_dev = _precompute(
            iystar_c, ix_c, iy_c
        )
    else:
        pos_v_dev, pos_h_dev, valid_dev = _precompute(iystar_c, ix_c, iy_c)

    def weight(pos, k):
        if interp_method == "nearest":
            return (jnp.round(pos) == k).astype(jnp.float32)
        return jnp.maximum(0.0, 1.0 - jnp.abs(pos - k))

    def dweight(pos, k):
        f = jnp.floor(pos)
        return (f == k).astype(jnp.float32) - (f + 1.0 == k).astype(
            jnp.float32
        )

    def band_step(
        src_band, pos_v_band, pos_h_band, valid_band, bv_band, bh_band,
        *s_args,
    ):
        s_band = s_args[0] if tri else None
        idx = lax.axis_index(axis_name)
        if use_halo:
            ext = _exchange_halo(
                src_band, halo, band_h, n, axis_name, lax, jnp
            )
        else:
            ext = src_band
        # global row index of ext row 0 (negative on device 0: those halo
        # rows are zero-filled by ppermute and never tapped)
        off = idx * band_h - (halo if use_halo else 0)

        # vertical pass: (out_band_h, src_w), per column tile; triangular
        # carries the (1, -1) difference through the same taps
        v_tiles = []
        vd_tiles = []
        for t in range(n_col_tiles):
            c0 = t * col_tile
            c1 = min((t + 1) * col_tile, src_w)
            pos = pos_v_band[:, c0:c1]
            base_t = bv_band[:, t]
            tile_src = ext[..., c0:c1]
            acc = jnp.zeros(
                src_band.shape[:-2] + (out_band_h, c1 - c0), dtype=jnp.float32
            )
            acc_d = acc
            for d in range(d_v):
                idx_g = jnp.clip(base_t + d, 0, src_h - 1)
                k = (base_t + d)[:, None].astype(jnp.float32)
                taken = jnp.take(tile_src, idx_g - off, axis=-2)
                acc = acc + weight(pos, k) * taken
                if tri:
                    acc_d = acc_d + dweight(pos, k) * taken
            v_tiles.append(acc)
            if tri:
                vd_tiles.append(acc_d)
        v = jnp.concatenate(v_tiles, axis=-1)
        vd = jnp.concatenate(vd_tiles, axis=-1) if tri else None

        # horizontal pass: row-local, per in-band row tile; the final
        # (overlapping) tile contributes only its uncovered tail rows
        out_tiles = []
        for t, s0 in enumerate(tile_starts):
            pos = pos_h_band[s0 : s0 + row_tile]
            base_t = bh_band[t]
            tile_v = v[..., s0 : s0 + row_tile, :]
            tile_vd = vd[..., s0 : s0 + row_tile, :] if tri else None
            acc = jnp.zeros(
                src_band.shape[:-2] + (row_tile, out_w), dtype=jnp.float32
            )
            acc_d = acc
            for d in range(d_h):
                idx2 = jnp.clip(base_t + d, 0, src_w - 1)
                k = (base_t + d)[None, :].astype(jnp.float32)
                acc = acc + weight(pos, k) * jnp.take(tile_v, idx2, axis=-1)
                if tri:
                    acc_d = acc_d + dweight(pos, k) * jnp.take(
                        tile_vd, idx2, axis=-1
                    )
            if tri:
                acc = acc - s_band[s0 : s0 + row_tile] * acc_d
            if t == tiles_per_band - 1 and tiles_per_band > 1:
                keep = out_band_h - (tiles_per_band - 1) * row_tile
                acc = acc[..., row_tile - keep :, :]
            out_tiles.append(acc)
        out = jnp.concatenate(out_tiles, axis=-2)

        # validity mask on this band's rows (same bounds as single-chip)
        return jnp.where(
            valid_band, out, jnp.asarray(fill_value, out.dtype)
        )

    batch_spec = [None] * src_batch_dims
    shard_map = jax.shard_map
    in_specs = (
        P(*batch_spec, axis_name, None),
        P(axis_name, None),
        P(axis_name, None),
        P(axis_name, None),
        P(axis_name, None),
        P(axis_name, None),
    )
    if tri:
        in_specs = in_specs + (P(axis_name, None),)
    mapped = shard_map(
        band_step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(*batch_spec, axis_name, None),
    )
    jitted = jax.jit(mapped)

    def step_fn(src):
        if tri:
            return jitted(
                src, pos_v_dev, pos_h_dev, valid_dev, bv_j, bh_j, s_dev
            )
        return jitted(src, pos_v_dev, pos_h_dev, valid_dev, bv_j, bh_j)

    return step_fn, (src_pad_h, out_h)


def make_sharded_esw_step(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
    step: int = 16,
    max_taps: int = 48,
    tap_budget: int = 16,
    max_samples: int = 10,
):
    """Sharded exact-separable-warp regrid: halo exchange + the exact
    selection kernel of :mod:`..ops.esw`, band-aligned.

    Reproduces the gather kernel built on the same grid mappings (bit-exact
    nearest, <= 2 float32 ulp bilinear from lerp order) — no two-pass
    fidelity gate, so rotation-heavy warps scale across the mesh too
    (a gap of the aligned/hybrid kernels).  The vertical pass selects S
    consecutive source rows per (row, column) from the halo-extended band;
    the horizontal pass is row-local.  Planning is band-aligned like
    :func:`make_sharded_srw_step` (tiles never straddle band boundaries);
    shift alignment is not used — vertical shifts would move data across
    band boundaries (bigger halos), and the tap budget covers the
    supported slopes without them.

    Returns ``(step_fn, (src_pad_h, out_h))`` or None when the mapping is
    unsuitable (non-monotone rows, or tap/sample counts out of budget).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from ..ops.esw import _max_row_deviation

    if interp_method not in ("bilinear", "nearest", "triangular"):
        return None
    nearest = interp_method == "nearest"
    triangular = interp_method == "triangular"
    n = mesh.shape[axis_name]
    fields = _coarse_geometry(source_gm, target_gm, step)
    if fields is None:
        return None
    ix64, iy64, iystar = fields.ix64, fields.iy64, fields.iystar64
    src_h, src_w = fields.src_h, fields.src_w
    out_h, out_w = fields.out_h, fields.out_w

    margin = 0.35
    dev = _max_row_deviation(fields)
    S = max(3, int(np.ceil(2.0 * (dev + margin))) + 2)
    if S > max_samples:
        return None
    half = (S - 2) / 2.0

    band_h = -(-src_h // n)
    src_pad_h = band_h * n - src_h
    out_band_h = -(-out_h // n)
    out_h_pad = out_band_h * n

    # ---- vertical plan: per-(padded output row, column tile) bases with
    # the S-sample margin
    slope_v = float(np.nanmax(np.abs(np.diff(iystar, axis=1))) / step)
    col_tile = _pick_tile(slope_v, tap_budget)
    ncc = iystar.shape[1]
    n_col_tiles = -(-src_w // col_tile)
    iystar_rows = _interp_rows(iystar, out_h, step)
    if out_h_pad > out_h:
        iystar_rows = np.concatenate(
            [iystar_rows, np.repeat(iystar_rows[-1:], out_h_pad - out_h, 0)]
        )
    base_v = np.zeros((out_h_pad, n_col_tiles), dtype=np.int32)
    span_max = 0.0
    for t in range(n_col_tiles):
        c0 = t * col_tile
        c1 = min((t + 1) * col_tile, src_w)
        k0 = max(0, c0 // step - 1)
        k1 = min(ncc, -(-c1 // step) + 1)
        seg = iystar_rows[:, k0:k1]
        m = seg.min(axis=1)
        base_v[:, t] = np.floor(m - half).astype(np.int32) - 2
        span_max = max(span_max, float((seg.max(axis=1) - m).max()))
    d_v = int(np.ceil(span_max)) + S + 4
    if d_v > max_taps:
        return None

    # ---- horizontal plan: per-(band, row tile) base, overlapping last
    # tile so tiles never straddle bands
    slope_h = float(np.nanmax(np.abs(np.diff(ix64, axis=0))) / step)
    row_tile = min(_pick_tile(slope_h, tap_budget), out_band_h)
    tiles_per_band = -(-out_band_h // row_tile)
    tile_starts = [t * row_tile for t in range(tiles_per_band - 1)]
    tile_starts.append(out_band_h - row_tile)
    ix_cols = _interp_cols(ix64, out_w, step)
    ncj = ix64.shape[0]
    sample_rows = np.arange(ncj) * step
    base_h = np.zeros((n * tiles_per_band, out_w), dtype=np.int32)
    span_max_h = 0.0
    for k in range(n):
        for t, s0 in enumerate(tile_starts):
            r0 = min(k * out_band_h + s0, out_h - 1)
            r1 = min(r0 + row_tile, out_h)
            k0 = max(0, int(np.searchsorted(sample_rows, r0)) - 1)
            k1 = min(ncj, int(np.searchsorted(sample_rows, r1)) + 2)
            seg = ix_cols[k0:k1, :]
            m = seg.min(axis=0)
            base_h[k * tiles_per_band + t, :] = (
                np.floor(m).astype(np.int32) - 2
            )
            span_max_h = max(span_max_h, float((seg.max(axis=0) - m).max()))
    d_h = int(np.ceil(span_max_h)) + 5
    if d_h > max_taps:
        return None

    # ---- halo: worst-case deviation of any band's (globally clamped)
    # vertical taps from its proportional source band
    lo_tap = np.clip(base_v.min(axis=1), 0, src_h - 1)
    hi_tap = np.clip(base_v.max(axis=1) + d_v - 1, 0, src_h - 1)
    halo = 0
    for k in range(n):
        r0, r1 = k * out_band_h, (k + 1) * out_band_h
        off = k * band_h
        halo = max(
            halo,
            int(off - lo_tap[r0:r1].min()),
            int(hi_tap[r0:r1].max() - (off + band_h - 1)),
        )
    halo = max(halo, 0)
    halo = min(halo, (n - 1) * band_h)
    use_halo = n > 1 and halo > 0

    iystar_c = jnp.asarray(iystar.astype(np.float32))
    ix_c = jnp.asarray(ix64.astype(np.float32))
    iy_c = jnp.asarray(iy64.astype(np.float32))
    bv_j = jnp.asarray(base_v)
    bh_j = jnp.asarray(base_h)

    # geometry-static per-pixel fields, materialized once at build time;
    # sharding them over rows changes nothing numerically (the global row
    # arange equals each band's local arange + offset bitwise)
    @jax.jit
    def _precompute(iystar_f, ix_f, iy_f):
        rows_col = jnp.arange(out_h_pad, dtype=jnp.float32)[:, None]
        cols_src = jnp.arange(src_w, dtype=jnp.float32)[None, :]
        pos_v = _interp_field(iystar_f, rows_col, cols_src, step, jnp)
        m = jnp.floor(pos_v - half)
        cols = jnp.arange(out_w, dtype=jnp.float32)[None, :]
        ix_full = _interp_field(ix_f, rows_col, cols, step, jnp)
        iy_full = _interp_field(iy_f, rows_col, cols, step, jnp)
        valid = (
            (ix_full > -0.5)
            & (ix_full < src_w - 0.5)
            & (iy_full > -0.5)
            & (iy_full < src_h - 0.5)
        )
        ix_cl = jnp.clip(ix_full, 0, src_w - 1)
        iy_cl = jnp.clip(iy_full, 0, src_h - 1)
        return m, ix_cl, iy_cl, valid

    m_dev, ixc_dev, iyc_dev, valid_dev = _precompute(iystar_c, ix_c, iy_c)

    def band_step(src_band, m_band, ixc_band, iyc_band, valid_band, bv_band, bh_band):
        idx = lax.axis_index(axis_name)
        if use_halo:
            ext = _exchange_halo(
                src_band, halo, band_h, n, axis_name, lax, jnp
            )
        else:
            ext = src_band
        ext = ext.astype(jnp.float32)
        off = idx * band_h - (halo if use_halo else 0)
        batch = src_band.shape[:-2]

        # vertical pass: S sample fields per column tile, exact selection
        v_tiles = [[] for _ in range(S)]
        for t in range(n_col_tiles):
            c0 = t * col_tile
            c1 = min((t + 1) * col_tile, src_w)
            tile_src = ext[..., c0:c1]
            m_t = m_band[:, c0:c1]
            base_t = bv_band[:, t]
            accs = [
                jnp.zeros(batch + (out_band_h, c1 - c0), jnp.float32)
                for _ in range(S)
            ]
            for d in range(d_v):
                idx_g = jnp.clip(base_t + d, 0, src_h - 1)
                taken = jnp.take(tile_src, idx_g - off, axis=-2)
                rid = (base_t + d).astype(jnp.float32)[:, None]
                for s in range(S):
                    accs[s] = jnp.where(m_t == rid - s, taken, accs[s])
            for s in range(S):
                v_tiles[s].append(accs[s])
        fields_v = [jnp.concatenate(v_tiles[s], axis=-1) for s in range(S)]

        # horizontal pass: row-local, per in-band row tile (the final
        # overlapping tile contributes only its uncovered tail rows)
        out_tiles = []
        for t, s0 in enumerate(tile_starts):
            base_t = bh_band[t]
            ixc_t = ixc_band[s0 : s0 + row_tile, :]
            iyc_t = iyc_band[s0 : s0 + row_tile, :]
            m_rows = m_band[s0 : s0 + row_tile, :]
            f_rows = [f[..., s0 : s0 + row_tile, :] for f in fields_v]
            if nearest:
                y0w = jnp.rint(iyc_t)
                i0 = jnp.rint(ixc_t).astype(jnp.int32)
            else:
                y0w = jnp.floor(iyc_t)
                fy = iyc_t - y0w
                x0 = jnp.floor(ixc_t)
                fx = ixc_t - x0
                i0 = x0.astype(jnp.int32)
            cv0 = jnp.zeros(batch + (row_tile, out_w), jnp.float32)
            cv1 = cv0
            tv = [cv0, cv0, cv0, cv0] if triangular else None
            for d in range(d_h):
                idx2 = jnp.clip(base_t + d, 0, src_w - 1)
                mg = jnp.take(m_rows, idx2, axis=-1)
                s0_sel = jnp.clip(y0w - mg, 0, S - 1 if nearest else S - 2)
                taken = [jnp.take(f, idx2, axis=-1) for f in f_rows]
                a = taken[0]
                bb = taken[1]
                for s in range(1, S):
                    a = jnp.where(s0_sel >= s - 0.5, taken[s], a)
                    if s >= 2:
                        bb = jnp.where(s0_sel >= s - 1.5, taken[s], bb)
                if triangular:
                    sel0 = i0 == base_t + d
                    sel1 = (i0 + 1) == base_t + d
                    tv[0] = jnp.where(sel0, a, tv[0])  # v00
                    tv[1] = jnp.where(sel0, bb, tv[1])  # v10
                    tv[2] = jnp.where(sel1, a, tv[2])  # v01
                    tv[3] = jnp.where(sel1, bb, tv[3])  # v11
                    continue
                colval = a if nearest else a + fy * (bb - a)
                cv0 = jnp.where(i0 == base_t + d, colval, cv0)
                if not nearest:
                    cv1 = jnp.where(i0 + 1 == base_t + d, colval, cv1)
            if triangular:
                v00, v10, v01, v11 = tv
                near = v00 + fx * (v01 - v00) + fy * (v10 - v00)
                far = (
                    v11
                    + (1.0 - fx) * (v10 - v11)
                    + (1.0 - fy) * (v01 - v11)
                )
                acc = jnp.where(fx + fy < 1.0, near, far)
            else:
                acc = cv0 if nearest else cv0 + fx * (cv1 - cv0)
            if t == tiles_per_band - 1 and tiles_per_band > 1:
                keep = out_band_h - (tiles_per_band - 1) * row_tile
                acc = acc[..., row_tile - keep :, :]
            out_tiles.append(acc)
        out = jnp.concatenate(out_tiles, axis=-2)

        return jnp.where(
            valid_band, out, jnp.asarray(fill_value, out.dtype)
        )

    batch_spec = [None] * src_batch_dims
    shard_map = jax.shard_map
    mapped = shard_map(
        band_step,
        mesh=mesh,
        in_specs=(
            P(*batch_spec, axis_name, None),
            P(axis_name, None),
            P(axis_name, None),
            P(axis_name, None),
            P(axis_name, None),
            P(axis_name, None),
            P(axis_name, None),
        ),
        out_specs=P(*batch_spec, axis_name, None),
    )
    jitted = jax.jit(mapped)

    def step_fn(src):
        return jitted(
            src, m_dev, ixc_dev, iyc_dev, valid_dev, bv_j, bh_j
        )

    return step_fn, (src_pad_h, out_h)


def make_sharded_rectify_step(
    mesh,
    ij_map,
    src_shape: tuple[int, int],
    axis_name: str = "bands",
    interp_method: str = "nearest",
    fill_value: float = np.nan,
    src_batch_dims: int = 0,
):
    """Sharded rectify Phase B: gather source bands through a fractional
    source-index map (rectify Phase A's output) across a device mesh.

    ``ij_map`` may be a host numpy array, a jax array, or a
    :class:`~xcube_resampling_tpu.ops.rectify_ops.DeviceIJMap` — with the
    device forms the map stays resident: halo sizing fetches only the 2n
    per-band extents and the reshard rides the device interconnect,
    never the host.

    The map's rows ARE the target rows, so the map is sharded over
    ``mesh[axis_name]`` alongside the output; the source swath is sharded
    in proportional row bands and each device extends its band by a halo
    sized exactly from the map's per-band source-row extents
    (``lax.ppermute`` multi-hop exchange, the same machinery as the
    sharded reproject steps).

    Bit-exactness contract: fractional weights and tap rows are derived
    from the *absolute* float32 source row exactly as the single-chip
    device kernel does (ops/reproject_ops.py:gather_interp), and only the
    integer tap index is rebased into the extended band — so the sharded
    result equals the single-chip device result bit for bit, mirroring
    the reference's chunking-invariance contract
    (/root/reference/tests/test_rectify.py:295-388) on the mesh.

    Returns (step_fn, (src_pad_h, out_h)); ``step_fn(src)`` expects the
    row-padded source sharded over ``axis_name``.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.shape[axis_name]
    src_h, src_w = src_shape

    # the map may be host-side (np.ndarray) or device-resident (a
    # rectify_ops.DeviceIJMap or jax array).  The device form keeps the
    # multi-device pipeline free of full-map host round trips: halo
    # sizing only needs two scalars per band
    if hasattr(ij_map, "device_map"):
        map_arr = ij_map.device_map()
    elif isinstance(ij_map, jax.Array):
        map_arr = ij_map
    else:
        ij_map = np.asarray(ij_map)
        map_arr = None

    out_h, out_w = ij_map.shape[-2], ij_map.shape[-1]
    band_h = -(-src_h // n)
    out_band_h = -(-out_h // n)
    src_pad_h = band_h * n - src_h
    out_pad_h = out_band_h * n - out_h

    # halo = worst-case distance of any target band's source-row taps from
    # its proportional source band, read off the exact map (+1 for the
    # second bilinear tap, +1 slack).  Device-resident maps reduce the
    # per-band extents on device and fetch 2n floats
    need = 0.0
    if map_arr is None:
        with np.errstate(invalid="ignore"):
            for k in range(n):
                rows = ij_map[1][
                    k * out_band_h : min((k + 1) * out_band_h, out_h)
                ]
                if rows.size == 0 or not np.isfinite(rows).any():
                    continue
                lo = float(np.nanmin(rows))
                hi = float(np.nanmax(rows)) + 1.0
                need = max(
                    need, k * band_h - lo, hi - (k * band_h + band_h - 1)
                )
    else:
        rows_d = map_arr[1]
        if out_pad_h:
            rows_d = jnp.pad(
                rows_d, ((0, out_pad_h), (0, 0)),
                constant_values=jnp.nan,
            )
        rows_d = rows_d.reshape(n, out_band_h, out_w)
        los = np.asarray(jnp.nanmin(rows_d, axis=(1, 2)))
        his = np.asarray(jnp.nanmax(rows_d, axis=(1, 2)))
        for k in range(n):
            if not np.isfinite(los[k]):
                continue
            lo = float(los[k])
            hi = float(his[k]) + 1.0
            need = max(
                need, k * band_h - lo, hi - (k * band_h + band_h - 1)
            )
    halo = min(int(np.ceil(max(0.0, need))) + 1, (n - 1) * band_h)
    use_halo = n > 1 and halo > 0

    if map_arr is None:
        map_p = ij_map
        if out_pad_h:
            map_p = np.pad(
                map_p,
                [(0, 0)] * (map_p.ndim - 2) + [(0, out_pad_h), (0, 0)],
                constant_values=np.nan,
            )
        map_j = jnp.asarray(map_p, dtype=jnp.float32)
    else:
        map_j = map_arr.astype(jnp.float32)
        if out_pad_h:
            map_j = jnp.pad(
                map_j,
                [(0, 0)] * (map_j.ndim - 2) + [(0, out_pad_h), (0, 0)],
                constant_values=jnp.nan,
            )
    map_d = jax.device_put(
        map_j,
        NamedSharding(mesh, P(None, axis_name, None)),
    )

    def band_step(src_band, map_band):
        idx = lax.axis_index(axis_name)
        if use_halo:
            ext = _exchange_halo(
                src_band, halo, band_h, n, axis_name, lax, jnp
            )
        else:
            ext = src_band
        ext_h = ext.shape[-2]
        off = idx * band_h - (halo if use_halo else 0)

        valid = jnp.isfinite(map_band[0]) & jnp.isfinite(map_band[1])
        # absolute f32 coordinates, clamped exactly like the single-chip
        # kernel; weights and tap rows derive from these, the rebase below
        # is integer-only
        ix = jnp.clip(
            jnp.nan_to_num(map_band[0], nan=0.0), 0, src_w - 1
        )
        iy = jnp.clip(
            jnp.nan_to_num(map_band[1], nan=0.0), 0, src_h - 1
        )
        if interp_method == "nearest":
            jx = jnp.rint(ix).astype(jnp.int32)
            jy = jnp.rint(iy).astype(jnp.int32)
            jy_l = jnp.clip(jy - off, 0, ext_h - 1)
            vals = ext[..., jy_l, jx]
            in_band = (jy >= off) & (jy < off + ext_h)
        else:
            x0f = jnp.floor(ix)
            y0f = jnp.floor(iy)
            fx = ix - x0f
            fy = iy - y0f
            x0 = x0f.astype(jnp.int32)
            y0 = y0f.astype(jnp.int32)
            x1 = jnp.clip(x0 + 1, 0, src_w - 1)
            y1 = jnp.clip(y0 + 1, 0, src_h - 1)
            y0_l = jnp.clip(y0 - off, 0, ext_h - 1)
            y1_l = jnp.clip(y1 - off, 0, ext_h - 1)
            v00 = ext[..., y0_l, x0]
            v01 = ext[..., y0_l, x1]
            v10 = ext[..., y1_l, x0]
            v11 = ext[..., y1_l, x1]
            if interp_method == "triangular":
                near = v00 + fx * (v01 - v00) + fy * (v10 - v00)
                far = v11 + (1.0 - fx) * (v10 - v11) + (1.0 - fy) * (
                    v01 - v11
                )
                vals = jnp.where(fx + fy < 1.0, near, far)
            else:
                vu0 = v00 + fx * (v01 - v00)
                vu1 = v10 + fx * (v11 - v10)
                vals = vu0 + fy * (vu1 - vu0)
            in_band = (y0 >= off) & (y1 < off + ext_h)
        fill = jnp.asarray(fill_value, dtype=vals.dtype)
        return jnp.where(valid & in_band, vals, fill)

    batch_spec = [None] * src_batch_dims
    shard_map = jax.shard_map
    mapped = shard_map(
        band_step,
        mesh=mesh,
        in_specs=(
            P(*batch_spec, axis_name, None),
            P(None, axis_name, None),
        ),
        out_specs=P(*batch_spec, axis_name, None),
    )
    jitted = jax.jit(mapped)

    def step_fn(src):
        return jitted(src, map_d)

    return step_fn, (src_pad_h, out_h)


def sharded_phase_a(
    mesh,
    source_gm: GridMapping,
    target_gm: GridMapping,
    axis_name: str = "bands",
    uv_delta: float | None = None,
    tile: int = 16,
    margin: int = 2,
):
    """Rectify Phase A banded over ``mesh[axis_name]``: every device runs
    the hybrid walk-seeded stencil (ops/rectify_ops.py) for its own
    target row band against the replicated swath coordinates, so the most
    expensive rectify step no longer idles n-1 chips.

    Banding is exact, not approximate: a shard's band is the full target
    grid with the row origin shifted by ``r0`` — implemented as
    ``gy - r0`` on the normalized coordinates — so each shard runs the
    very same seed/dense kernels as the single chip.  Two stages mirror
    the single-chip orchestration: a seed ``shard_map`` returns each
    band's gate + exact per-axis window needs (one (n, 3) int fetch), the
    host picks ONE shared window bucket from the shard maxima (the same
    bucket the single chip would pick: the global need is the max over
    bands), and a second ``shard_map`` re-seeds and runs the dense
    min-rank acceptance per band.

    Returns the (2, H, W) fractional source-index map with rows sharded
    over ``mesh[axis_name]``, or None when the geometry is outside the
    hybrid envelope (callers fall back to the single-device tiers).
    The per-pixel semantics match the single-chip hybrid map: min
    row-major quad rank over the accepting window (reference
    first-writer-wins, /root/reference/xcube_resampling/rectify.py:544-576).
    """
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..constants import UV_DELTA
    from ..ops import rectify_ops

    if uv_delta is None:
        uv_delta = UV_DELTA

    n = int(mesh.shape[axis_name])
    dst_h, dst_w = target_gm.height, target_gm.width
    src_h, src_w = source_gm.height, source_gm.width
    if src_h < 2 or src_w < 2 or dst_h < 4 * n or dst_w < 4:
        return None

    # tile-aligned band height: band boundaries on the tile grid keep the
    # per-tile windows of every shard identical to a single-chip run
    band = -(-(-(-dst_h // n)) // tile) * tile
    pad_h = band * n - dst_h

    if jax.config.read("jax_enable_x64") and jax.default_backend() == "cpu":
        dt, np_dt = jnp.float64, np.float64
    else:
        dt, np_dt = jnp.float32, np.float32

    # normalized swath coordinates, exactly as the single-chip device
    # tier builds them (rectify.py -> inverse_ij_map_hybrid)
    x1, y1, x2, y2 = target_gm.xy_bbox
    x_res, y_res = target_gm.xy_res
    j_up = target_gm.is_j_axis_up
    swath = np.asarray(source_gm.xy_coords.data, dtype=np.float64)
    gx_n = ((swath[0] - x1) / x_res).astype(np_dt)
    gy_n = (
        (swath[1] - (y1 if j_up else y2)) / (y_res if j_up else -y_res)
    ).astype(np_dt)

    shard_map = jax.shard_map
    max_edge = float(max(dst_h, dst_w))
    coarse_iters, refine_iters = 24, 6
    seed_fn = rectify_ops._build_hybrid_seed_kernel(
        (src_h, src_w), (band, dst_w), dt, tile,
        coarse_iters, refine_iters, max_edge, margin,
    )

    repl = NamedSharding(mesh, P())
    gx_d = jax.device_put(jnp.asarray(gx_n, dtype=dt), repl)
    gy_d = jax.device_put(jnp.asarray(gy_n, dtype=dt), repl)

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(axis_name),
    )
    def seed_step(gx, gy):
        r0 = (lax.axis_index(axis_name) * band).astype(gy.dtype)
        _, _, meta = seed_fn(gx, gy - r0)
        return meta[None]

    metas = np.asarray(seed_step(gx_d, gy_d))  # (n, 3) int32
    if not bool(metas[:, 0].all()):
        return None
    need_j = int(metas[:, 1].max())
    need_i = int(metas[:, 2].max())

    def pick(need, src_dim):
        for bucket in rectify_ops._HYBRID_WINS:
            if min(bucket, src_dim) >= need:
                return min(bucket, src_dim)
        return None

    win_j, win_i = pick(need_j, src_h), pick(need_i, src_w)
    if win_j is None or win_i is None:
        return None

    dense_fn = rectify_ops._build_hybrid_dense_kernel(
        (src_h, src_w), (band, dst_w), dt, float(uv_delta),
        tile, win_j, win_i, margin,
    )

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(None, axis_name, None),
    )
    def dense_step(gx, gy):
        r0 = (lax.axis_index(axis_name) * band).astype(gy.dtype)
        cqj, cqi, _ = seed_fn(gx, gy - r0)
        return dense_fn(gx, gy - r0, cqj, cqi)

    full = dense_step(gx_d, gy_d)  # (2, n*band, dst_w), rows sharded
    if pad_h:
        full = full[:, :dst_h, :]
    return full


def sharded_rectify(
    src,
    source_gm: GridMapping,
    target_gm: GridMapping,
    mesh,
    axis_name: str = "bands",
    interp_method: str = "nearest",
    fill_value: float = np.nan,
    ij_map: np.ndarray | None = None,
):
    """Rectify *src* (an irregular-swath band stack) onto *target_gm*
    across a device mesh: Phase A once on the host/device tier, Phase B
    as the sharded halo-exchange gather of
    :func:`make_sharded_rectify_step`.  Returns the target raster with
    rows sharded over ``mesh[axis_name]``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if ij_map is None:
        # Phase A itself runs banded over the mesh when the hybrid
        # stencil serves the geometry — every chip computes its own
        # target rows' map (the map stays device-resident and sharded)
        ij_map = sharded_phase_a(mesh, source_gm, target_gm, axis_name)
    if ij_map is None:
        from ..constants import UV_DELTA
        from ..rectify import _compute_target_source_ij

        # a DeviceIJMap from the device Phase-A tiers is consumed
        # resident: make_sharded_rectify_step sizes the halo from a tiny
        # on-device reduction and reshards the map between devices — the full
        # map never crosses the host boundary
        ij_map = _compute_target_source_ij(source_gm, target_gm, UV_DELTA)

    step_fn, (src_pad_h, out_h) = make_sharded_rectify_step(
        mesh,
        ij_map,
        (source_gm.height, source_gm.width),
        axis_name=axis_name,
        interp_method=interp_method,
        fill_value=fill_value,
        src_batch_dims=src.ndim - 2,
    )
    if src_pad_h:
        pad = [(0, 0)] * (src.ndim - 2) + [(0, src_pad_h), (0, 0)]
        src = jnp.pad(src, pad, constant_values=fill_value)
    spec = P(*([None] * (src.ndim - 2)), axis_name, None)
    src = jax.device_put(src, NamedSharding(mesh, spec))
    out = step_fn(src)
    return out[..., :out_h, :]


def sharded_reproject(
    src,
    source_gm: GridMapping,
    target_gm: GridMapping,
    mesh,
    axis_name: str = "bands",
    halo: int | None = None,
    interp_method: str = "bilinear",
    fill_value: float = np.nan,
    use_srw: bool = True,
):
    """Reproject *src* with its rows sharded over ``mesh[axis_name]``;
    returns the full target raster (rows sharded the same way).

    Engine tiers mirror the single-chip dispatch: the gather-free sharded
    SRW kernel where its fidelity gate admits the mapping, the exact
    sharded ESW kernel for rotation-heavy warps beyond the gate, and the
    halo-exchange gather formulation as the final fallback."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    # crop the source to the tapped window before banding: a target
    # covering a subset of a global source would otherwise (a) stream
    # every column on every tap and (b) break the proportional
    # band<->band row correspondence the halo model assumes (all target
    # rows would map into one device's band)
    fields = _coarse_geometry(source_gm, target_gm, 16)
    if fields is not None:
        w = _source_window_gm(source_gm, fields, margin=8 + 48)
        if w is not None:
            source_gm, (j0, j1, i0, i1) = w
            src = src[..., j0:j1, i0:i1]

    built = None
    if use_srw:
        built = make_sharded_srw_step(
            mesh,
            source_gm,
            target_gm,
            axis_name=axis_name,
            interp_method=interp_method,
            fill_value=fill_value,
            src_batch_dims=src.ndim - 2,
        )
    if built is None:
        built = make_sharded_esw_step(
            mesh,
            source_gm,
            target_gm,
            axis_name=axis_name,
            interp_method=interp_method,
            fill_value=fill_value,
            src_batch_dims=src.ndim - 2,
        )
    if built is None:
        built = make_sharded_regrid_step(
            mesh,
            source_gm,
            target_gm,
            axis_name=axis_name,
            halo=halo,
            interp_method=interp_method,
            fill_value=fill_value,
            src_batch_dims=src.ndim - 2,
        )
    step_fn, (src_pad_h, out_h) = built
    if src_pad_h:
        pad = [(0, 0)] * (src.ndim - 2) + [(0, src_pad_h), (0, 0)]
        src = jnp.pad(src, pad, constant_values=fill_value)
    spec = P(*([None] * (src.ndim - 2)), axis_name, None)
    src = jax.device_put(src, NamedSharding(mesh, spec))
    out = step_fn(src)
    return out[..., :out_h, :]
