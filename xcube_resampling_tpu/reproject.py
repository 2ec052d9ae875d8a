"""Reprojection engine (regular -> regular grids across CRSs).

Semantics track reference ``reproject.py:51-530`` (see NOTICE) with a
device-first compute design.  The reference stages pyproj host calls per dask
block and gathers through a uniformized source-window mosaic; here the
coordinate transform is the native CRS engine (float64 numpy on the host
for the golden path — and fully fused into the device kernel in the
ops/reproject fast paths used by the benchmarks), and per-target-tile
source windows are sliced directly from the (padded) source array with
static, uniform shapes — the shape discipline XLA needs, identical
numerics to the reference's mosaic.

The window planning (:func:`_plan_source_windows`) is vectorized numpy end
to end: per-tile bboxes are uniformized and their origin-coordinate stacks
gathered in single fancy-indexing passes instead of the reference's
per-tile Python loops.
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable, Hashable, Iterable
from dataclasses import dataclass

import numpy as np

from .affine import affine_transform_dataset
from .constants import (
    LOG,
    SCALE_LIMIT,
    AggMethods,
    FillValues,
    InterpMethods,
    RecoverNans,
)
from .crs import Transformer
from .gridmapping import GridMapping
from .ops import gather
from .profiling import GLOBAL_TIMER as TIMER
from .utils import (
    _get_fill_value,
    _get_interp_method_str,
    _prep_interp_methods_downscale,
    _select_variables,
    assemble_target_shell,
    clip_dataset_by_bbox,
    normalize_grid_mapping,
)
from .xrlite import DataArray, Dataset


def reproject_dataset(
    source_ds: Dataset,
    target_gm: GridMapping,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
) -> Dataset:
    """Reproject a dataset's 2D spatial variables into the CRS and grid of
    *target_gm*.  Per-variable interpolation/aggregation/fill options follow
    the reference semantics (reproject.py:51-111)."""
    with TIMER("reproject.gm_inference"):
        if source_gm is None:
            source_gm = GridMapping.from_dataset(source_ds)
        if source_gm.is_j_axis_up:
            # host plan math assumes j-axis-down sources; flip rows once
            row_var = source_gm.xy_var_names[1]
            source_ds = source_ds.isel({row_var: slice(None, None, -1)})
            source_gm = GridMapping.from_dataset(source_ds)

        source_ds = normalize_grid_mapping(source_ds, source_gm)
        source_ds = _select_variables(source_ds, variables)

        # target -> source, for the inverse-mapping resample
        inv = Transformer.from_crs(target_gm.crs, source_gm.crs, always_xy=True)

    with TIMER("reproject.pre_downscale"):
        source_ds, source_gm = _maybe_downscale(
            source_ds, source_gm, target_gm, inv,
            interp_methods, agg_methods, recover_nans,
        )

    @functools.cache
    def host_plan():
        # built on first use: device-backed variables never read it, and
        # at a 20k^2 target the center grid alone is ~7 GB of float64
        with TIMER("reproject.plan"):
            plan = _plan_source_windows(inv, source_gm, target_gm)
            # inverse-transform the target pixel-center grid
            src_xx, src_yy = _target_centers_in_source(inv, target_gm)
        return src_xx, src_yy, plan

    target_ds = assemble_target_shell(
        source_ds,
        source_gm,
        target_gm,
        dict(zip(target_gm.xy_var_names, (target_gm.x_coords, target_gm.y_coords))),
    )

    grid_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    for name, var in source_ds.items():
        if var.dims[-2:] == grid_dims:
            assert len(var.dims) in (2, 3), (
                f"Data variable {name} has {len(var.dims)} dimensions."
            )
            target_ds[name] = _reproject_variable(
                var, name, source_gm, target_gm, host_plan,
                interp_methods, fill_values,
            )
        elif not set(grid_dims) & set(var.dims):
            target_ds[name] = var

    return target_ds


def _is_jax_array(data) -> bool:
    return type(data).__module__.startswith("jax")


@dataclass
class _WindowPlan:
    """Per-target-tile uniform source windows: int32 bboxes ``(4, ny, nx)``
    in padded-source pixel space, float32 window-origin coordinate stacks,
    and the padding that embeds out-of-extent windows."""

    bboxes: np.ndarray  # (4, ny, nx): i0, j0, i1, j1
    x_stack: np.ndarray  # (win_w, ny, nx)
    y_stack: np.ndarray  # (win_h, ny, nx)
    pad_width: tuple


def _reproject_variable(
    var: DataArray,
    name: Hashable,
    source_gm: GridMapping,
    target_gm: GridMapping,
    host_plan: Callable[[], tuple[np.ndarray, np.ndarray, _WindowPlan]],
    interp_methods: InterpMethods | None = None,
    fill_values: FillValues | None = None,
) -> DataArray:
    had_band_axis = len(var.dims) == 3
    if not had_band_axis:
        var = var.expand_dims({"dummy": 1})

    fill_value = _get_fill_value(fill_values, name, var)
    interp = _get_interp_method_str(interp_methods, name, var)

    if _is_jax_array(var.data):
        # device fast path: variables backed by JAX arrays stay on device
        # and run through the fused kernels (SRW when the mapping allows,
        # XLA gather otherwise); results use the approximate coordinate
        # field (sub-1e-2 px), see ops/reproject_ops.  Planning (cold:
        # tier selection and the tier's host plan) and the call are timed
        # apart; the call's phase name carries the tier the dispatch chose.
        with TIMER("reproject.device_plan"):
            tier, fn = _device_reproject_fn(
                source_gm, target_gm, interp, fill_value
            )
        with TIMER(f"reproject.device.{tier}"):
            image = fn(var.data)
        return _as_target_array(var, image, target_gm, had_band_axis)

    src_xx, src_yy, plan = host_plan()
    image = _gather_through_windows(
        np.asarray(var.data), source_gm, target_gm,
        src_xx, src_yy, plan, interp, fill_value,
    )
    return _as_target_array(var, image, target_gm, had_band_axis)


def _gather_through_windows(
    array: np.ndarray,
    source_gm: GridMapping,
    target_gm: GridMapping,
    src_xx: np.ndarray,
    src_yy: np.ndarray,
    plan: _WindowPlan,
    interp: str,
    fill_value,
) -> np.ndarray:
    """Host golden path: pad the source once, then gather every target tile
    through its planned window (reference reproject.py:268-335 math, int32
    indices — the reference's int16 cast limited padded windows to 32k
    pixels; that constraint is consciously lifted here)."""
    with TIMER("reproject.host_gather"):
        padded = np.pad(
            array, plan.pad_width, mode="constant", constant_values=fill_value
        )

    ny, nx = plan.bboxes.shape[1], plan.bboxes.shape[2]
    tile_h, tile_w = target_gm.tile_height, target_gm.tile_width
    out_h, out_w = target_gm.height, target_gm.width
    out = np.empty(array.shape[:-2] + (out_h, out_w), dtype=array.dtype)

    with TIMER("reproject.host_kernel"):
        for tj in range(ny):
            rows = slice(tj * tile_h, min((tj + 1) * tile_h, out_h))
            for ti in range(nx):
                cols = slice(ti * tile_w, min((ti + 1) * tile_w, out_w))
                i0, j0, i1, j1 = plan.bboxes[:, tj, ti]
                window = padded[..., j0:j1, i0:i1]
                ix = (src_xx[rows, cols] - plan.x_stack[0, tj, ti]) / source_gm.x_res
                iy = (src_yy[rows, cols] - plan.y_stack[0, tj, ti]) / -source_gm.y_res
                sampled = gather.grid_sample(window, ix, iy, interp)
                if sampled.dtype != array.dtype:
                    if np.dtype(array.dtype).kind in "ui":
                        sampled = np.rint(sampled).astype(array.dtype)
                    else:
                        sampled = sampled.astype(array.dtype)
                out[..., rows, cols] = sampled
    return out


_DEVICE_FN_CACHE: "dict[tuple, object]" = {}
_DEVICE_FN_CACHE_MAX = 4


def _gm_fingerprint(gm) -> tuple:
    return (
        str(gm.crs), tuple(gm.size), tuple(gm.xy_res), tuple(gm.xy_bbox),
        bool(gm.is_j_axis_up),
    )


def _device_reproject_fn(source_gm, target_gm, interp_method, fill_value):
    """``(tier, fn)`` of the tiered device reproject, with a small plan
    memo: the compiled tier function depends only on the grid-mapping
    pair, interp, fill and the tier env flags — per-variable and
    repeated-call workloads reuse it instead of replanning (the
    exact-mosaic tier plans for seconds per geometry)."""
    import os

    key = (
        _gm_fingerprint(source_gm), _gm_fingerprint(target_gm),
        interp_method, repr(float(fill_value)),
        os.environ.get("XRTPU_EXACT", ""),
        os.environ.get("XRTPU_FAST_EXTREME_WARP", ""),
        os.environ.get("XRTPU_NO_EXACT_MOSAIC", ""),
    )
    built = _DEVICE_FN_CACHE.pop(key, None)
    if built is None:
        built = _build_device_reproject_fn(
            source_gm, target_gm, interp_method, fill_value
        )
    _DEVICE_FN_CACHE[key] = built  # (re-)insert: LRU order
    while len(_DEVICE_FN_CACHE) > _DEVICE_FN_CACHE_MAX:
        # oldest entry out (its device statics can be hundreds of MB)
        _DEVICE_FN_CACHE.pop(next(iter(_DEVICE_FN_CACHE)))
    return built


def _build_device_reproject_fn(source_gm, target_gm, interp_method, fill_value):
    import os

    from .ops.esw import make_esw_reproject_fn
    from .ops.reproject_ops import make_fused_reproject_fn
    from .ops.srw import make_region_reproject_fn, make_srw_reproject_fn

    # Engine tiers, first that plans wins:
    #   1. "srw": gated two-pass separable warp; positions within ~0.05 px
    #      of the direct gather (mild warps only: the slope gate rejects
    #      rotation-heavy cases)
    #   2. "esw": exact separable warp — reproduces the direct gather
    #      kernel (bit-exact nearest, <= 2 ulp bilinear) and covers local
    #      rotation slopes to ~4 px/px
    #   3. "esw-mosaic": exact region mosaic for domain-scale warps with a
    #      projection singularity inside the target; same exact
    #      semantics, one-time multi-program compile per geometry
    #   4. "gather": the plain fused gather; exact, no planning constraints
    # The order was set on other hardware and is to be re-ranked from
    # GPU measurements.  XRTPU_EXACT=1 skips tier 1 (exact semantics
    # everywhere); XRTPU_FAST_EXTREME_WARP=1 swaps tier 3 for the
    # two-pass region mosaic ("region-srw", two-pass filter semantics);
    # XRTPU_NO_EXACT_MOSAIC=1 skips tier 3 (gather instead — avoids the
    # one-time compile for throwaway geometries).
    if os.environ.get("XRTPU_EXACT", "") != "1":
        fn = make_srw_reproject_fn(
            source_gm, target_gm, interp_method, fill_value
        )
        if fn is not None:
            return "srw", fn
    if os.environ.get("XRTPU_FAST_EXTREME_WARP", "") == "1":
        fn = make_region_reproject_fn(
            source_gm, target_gm, interp_method, fill_value
        )
        if fn is not None:
            return "region-srw", fn
    fn = make_esw_reproject_fn(source_gm, target_gm, interp_method, fill_value)
    if fn is not None:
        return "esw", fn
    if os.environ.get("XRTPU_NO_EXACT_MOSAIC", "") != "1":
        LOG.info(
            "reproject: domain-scale warp, building the exact region "
            "mosaic (one-time planning + compilation per geometry; set "
            "XRTPU_NO_EXACT_MOSAIC=1 to use the plain gather kernel)"
        )
        fn = make_region_reproject_fn(
            source_gm, target_gm, interp_method, fill_value, exact=True
        )
        if fn is not None:
            return "esw-mosaic", fn
    return "gather", make_fused_reproject_fn(
        source_gm, target_gm, interp_method, fill_value
    )


def _as_target_array(var, image, target_gm, had_band_axis) -> DataArray:
    tile_hw = (target_gm.tile_height, target_gm.tile_width)
    chunks = None
    if var.chunks is not None:
        chunks = tuple(c[0] for c in var.chunks[:-2]) + tile_hw

    grid_dims = (target_gm.xy_dim_names[1], target_gm.xy_dim_names[0])
    if had_band_axis:
        dims = (var.dims[0],) + grid_dims
    else:
        image = image[0, :, :]
        dims = grid_dims
        if chunks is not None:
            chunks = chunks[1:]
    return DataArray(data=image, dims=dims, attrs=dict(var.attrs), chunks=chunks)


def _maybe_downscale(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
    inv: Transformer,
    interp_methods: InterpMethods | None,
    agg_methods: AggMethods | None,
    recover_nans: RecoverNans,
) -> tuple[Dataset, GridMapping]:
    """Clip + affine-downscale the source when its resolution is finer than
    the target's (reference reproject.py:338-382; SCALE_LIMIT gate)."""
    span = inv.transform_bounds(*target_gm.xy_bbox)
    _assert_target_overlaps_source(span, source_gm, target_gm)
    res_in_source = (
        (span[2] - span[0]) / target_gm.width,
        (span[3] - span[1]) / target_gm.height,
    )
    x_scale = source_gm.x_res / res_in_source[0]
    y_scale = source_gm.y_res / res_in_source[1]
    if x_scale >= SCALE_LIMIT and y_scale >= SCALE_LIMIT:
        return source_ds, source_gm

    margin_x, margin_y = 2 * source_gm.x_res, 2 * source_gm.y_res
    clip_bbox = (
        span[0] - margin_x,
        span[1] - margin_y,
        span[2] + margin_x,
        span[3] + margin_y,
    )
    source_ds = clip_dataset_by_bbox(source_ds, clip_bbox, source_gm.xy_dim_names)
    source_gm = GridMapping.from_dataset(source_ds)

    new_size = tuple(
        max(2, round(scale * extent))
        for scale, extent in (
            (x_scale, source_gm.width),
            (y_scale, source_gm.height),
        )
    )
    coarse_gm = GridMapping.regular(
        size=new_size,
        xy_min=(source_gm.xy_bbox[0], source_gm.xy_bbox[1]),
        xy_res=res_in_source,
        crs=source_gm.crs,
        tile_size=source_gm.tile_size,
    )
    old_names = source_gm.xy_var_names
    old_dims = source_gm.xy_dim_names
    source_ds = affine_transform_dataset(
        source_ds,
        coarse_gm,
        source_gm=source_gm,
        interp_methods=_prep_interp_methods_downscale(interp_methods),
        agg_methods=agg_methods,
        recover_nans=recover_nans,
    )
    # the affine keeps variable dims from the source, but assigns coords
    # under the downscale GM's default names — for e.g. a geographic
    # dataset whose coords are named x/y the two diverge and the dataset
    # would stop being self-consistent (vars silently skipped downstream).
    # Re-assign under the source's names.
    if coarse_gm.xy_var_names != old_names:
        stale = [
            n for n in coarse_gm.xy_var_names if n in source_ds.variables
        ]
        source_ds = source_ds.drop_vars(stale).assign_coords(
            {
                old_names[0]: DataArray(
                    np.asarray(coarse_gm.x_coords.data), dims=(old_dims[0],)
                ),
                old_names[1]: DataArray(
                    np.asarray(coarse_gm.y_coords.data), dims=(old_dims[1],)
                ),
            }
        )
    return source_ds, GridMapping.from_dataset(source_ds)


def _assert_target_overlaps_source(
    span: tuple[float, float, float, float],
    source_gm: GridMapping,
    target_gm: GridMapping,
) -> None:
    """Raise early when the target grid, transformed into the source CRS,
    is disjoint from the source extent.  Without this the failure surfaces
    far downstream as a zero-sized clip plus a misleading "cannot find any
    grid mapping in dataset" (the reference fails the same confusing way,
    /root/reference/xcube_resampling/utils.py:119-124 → downstream).

    Conservative on purpose: only raises when the transformed bounds are
    finite and non-wrapping and still clearly disjoint.
    """
    if not all(math.isfinite(v) for v in span):
        return
    if span[0] > span[2] or span[1] > span[3]:
        # wrapped/degenerate transform (e.g. antimeridian) — let the
        # regular pipeline handle it
        return
    sx0, sy0, sx1, sy1 = source_gm.xy_bbox
    if span[2] < sx0 or span[0] > sx1 or span[3] < sy0 or span[1] > sy1:
        raise ValueError(
            "target grid does not overlap the source extent: target bbox"
            f" {tuple(target_gm.xy_bbox)} ({target_gm.crs}) maps to"
            f" {tuple(span)} in the source CRS, but the source bbox is"
            f" {(sx0, sy0, sx1, sy1)} ({source_gm.crs})"
        )


def _plan_source_windows(
    inv: Transformer,
    source_gm: GridMapping,
    target_gm: GridMapping,
) -> _WindowPlan:
    """Per-target-tile source pixel windows, uniformized to the largest
    window (static shapes), plus per-tile window-origin coordinate stacks
    and the source padding needed where windows exceed the source extent
    (reference reproject.py:385-469, vectorized)."""
    ny = math.ceil(target_gm.height / target_gm.tile_height)
    nx = math.ceil(target_gm.width / target_gm.tile_width)
    x_res, y_res = source_gm.x_res, source_gm.y_res
    x0 = float(np.asarray(source_gm.x_coords.data)[0])
    y_vals = np.asarray(source_gm.y_coords.data)
    y0 = float(y_vals[0])

    # analytic per-tile source bboxes via densified bounds transform
    spans = np.asarray(
        [inv.transform_bounds(*xy_bbox) for xy_bbox in target_gm.xy_bboxes]
    )  # (ny*nx, 4): x_lo, y_lo, x_hi, y_hi in source coords
    i_lo = np.floor((spans[:, 0] - x0) / x_res).astype(np.int64)
    i_hi = np.ceil((spans[:, 2] - x0) / x_res).astype(np.int64)
    j_lo = np.floor((y0 - spans[:, 3]) / y_res).astype(np.int64)
    j_hi = np.ceil((y0 - spans[:, 1]) / y_res).astype(np.int64)

    # uniformize: grow every window (centered) to the largest extent so
    # each tile's source window has the same, trace-static shape
    win_w = int(np.max(i_hi - i_lo)) + 1
    win_h = int(np.max(j_hi - j_lo)) + 1
    i_start = i_lo - (win_w - (i_hi - i_lo)) // 2
    j_start = j_lo - (win_h - (j_hi - j_lo)) // 2

    i_min, i_max = int(i_start.min()), int(i_start.max()) + win_w
    j_min, j_max = int(j_start.min()), int(j_start.max()) + win_h

    # Window-origin coordinate stacks, gathered in one fancy-indexing pass
    # per axis.  float32 like the reference (reproject.py:427-428): the
    # goldens encode this quantization of the window origin; the fused
    # device path keeps full precision instead.
    x_line = x0 + (i_min + np.arange(i_max - i_min)) * x_res
    y_step = float(y_vals[1] - y_vals[0])
    y_line = y0 + (j_min + np.arange(j_max - j_min)) * y_step
    taps_w = np.arange(win_w)[:, None]
    taps_h = np.arange(win_h)[:, None]
    x_stack = (
        x_line[(i_start - i_min)[None, :] + taps_w]
        .astype(np.float32)
        .reshape(win_w, ny, nx)
    )
    y_stack = (
        y_line[(j_start - j_min)[None, :] + taps_h]
        .astype(np.float32)
        .reshape(win_h, ny, nx)
    )

    pad_width = (
        (0, 0),
        (-min(0, j_min), max(0, j_max - source_gm.height)),
        (-min(0, i_min), max(0, i_max - source_gm.width)),
    )
    bboxes = np.stack(
        [
            i_start + pad_width[2][0],
            j_start + pad_width[1][0],
            i_start + pad_width[2][0] + win_w,
            j_start + pad_width[1][0] + win_h,
        ]
    ).astype(np.int32)

    return _WindowPlan(
        bboxes=bboxes.reshape(4, ny, nx),
        x_stack=x_stack,
        y_stack=y_stack,
        pad_width=pad_width,
    )


def _target_centers_in_source(
    inv: Transformer, target_gm: GridMapping
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-transform all target pixel centers into source CRS
    coordinates (reference reproject.py:472-496; here a single vectorized
    float64 evaluation of the native projection pipeline)."""
    centers_x = np.asarray(target_gm.x_coords.data, dtype=np.float64)
    centers_y = np.asarray(target_gm.y_coords.data, dtype=np.float64)
    grid_xx, grid_yy = np.meshgrid(centers_x, centers_y)
    out_xx, out_yy = inv.transform(grid_xx, grid_yy)
    return np.asarray(out_xx), np.asarray(out_yy)
