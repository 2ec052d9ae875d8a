"""Affine resampling engine (same-CRS regular -> regular grids).

Behavioral parity: reference affine.py:52-363.  The compute tier is
redesigned for the device: instead of dask_image's per-block scipy spline
kernel, the whole transform is one vectorized gather
(:mod:`..ops.gather`) plus a window reduction
(:mod:`..ops.coarsen_ops`) for the downscale split — both trace into a
single fused XLA kernel on device, or run in float64 numpy on the host.

Structure: the dataset-level entry points classify variables, then each
spatial variable flows through a small pipeline —
``_scale_split`` (integral window + residual matrix) ->
``_gather_resample`` (the device/host gather, with the two-pass NaN
recovery trick of reference affine.py:344-360) ->
``coarsen_ops.coarsen`` for the integral part.
"""

from __future__ import annotations

import math
from collections.abc import Iterable, Sequence

import numpy as np

from .constants import (
    AffineTransformMatrix,
    AggFunction,
    AggMethods,
    FillValues,
    FloatInt,
    InterpMethodInt,
    InterpMethods,
    RecoverNans,
)
from .gridmapping import GridMapping
from .profiling import GLOBAL_TIMER as TIMER
from .ops import coarsen_ops, gather
from .utils import (
    _can_apply_affine_transform,
    _get_agg_method,
    _get_fill_value,
    _get_interp_method_int,
    _get_recover_nan,
    _select_variables,
    normalize_grid_mapping,
)
from .xrlite import DataArray, Dataset

_HIGH_ORDER_MSG = (
    "interp_methods must be one of 0, 1, 'nearest', 'bilinear'. "
    "Higher order is not supported for 3D arrays in affine transforms, "
    "as it causes unintended blending across the non-spatial (e.g., time) "
    "dimension."
)


def affine_transform_dataset(
    source_ds: Dataset,
    target_gm: GridMapping,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
) -> Dataset:
    """Resample *source_ds* from *source_gm* to *target_gm* via the affine
    image-to-image transform (both regular, equal/compatible CRS).

    Option semantics (per-variable interp/agg/recover-NaN/fill resolution,
    dtype defaults) match the reference (affine.py:52-137)."""
    if source_gm is None:
        source_gm = GridMapping.from_dataset(source_ds)
    if source_gm.is_j_axis_up:
        # The corner-composed pixel matrix (ij_transform_to) is a valid
        # index-space map only when no axis flips: with a flipped j axis it
        # is off by exactly one row (the reference shares this flaw and
        # flips sources only in reproject, reference reproject.py:115-118,
        # never in affine).  Flip rows once — pixel centers are identical —
        # so the engine always sees a j-down source.
        row_dim = source_gm.xy_dim_names[1]
        source_ds = source_ds.isel({row_dim: slice(None, None, -1)})
        source_gm = source_gm.derive(is_j_axis_up=False)
    source_ds = normalize_grid_mapping(source_ds, source_gm)

    assert _can_apply_affine_transform(source_gm, target_gm), (
        f"Affine transformation cannot be applied to source CRS "
        f"{source_gm.crs.name!r} and target CRS {target_gm.crs.name!r}"
    )

    # A j-up *target* flips the composed matrix the same way; compute on
    # its j-down twin (identical pixel centers) and reverse output rows.
    flip_output = target_gm.is_j_axis_up
    compute_gm = (
        target_gm.derive(is_j_axis_up=False) if flip_output else target_gm
    )

    out = resample_dataset(
        _select_variables(source_ds, variables),
        compute_gm.ij_transform_to(source_gm),
        (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0]),
        target_gm.size,
        target_gm.tile_size,
        interp_methods,
        agg_methods,
        recover_nans,
        fill_values,
    )
    if flip_output:
        out = out.isel({source_gm.xy_dim_names[1]: slice(None, None, -1)})
    x_name, y_name = target_gm.xy_var_names
    return out.assign_coords(
        {x_name: target_gm.x_coords, y_name: target_gm.y_coords}
    )


def resample_dataset(
    dataset: Dataset,
    affine_matrix: AffineTransformMatrix,
    yx_dims: tuple[str, str],
    target_size: tuple[int, int],
    target_tile_size: tuple[int, int],
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
) -> Dataset:
    """Resample every variable whose trailing dims are *yx_dims* through
    the affine matrix.  Non-spatial variables are copied; variables that
    use only one of the two spatial dims (1D coords etc.) are dropped —
    same classification as reference affine.py:140-240."""
    out_w, out_h = target_size
    buckets = {"coords": {}, "data_vars": {}}

    for name, var in dataset.variables.items():
        if var.dims[-2:] == tuple(yx_dims):
            shape = var.data.shape[:-2] + (out_h, out_w)
            with TIMER("affine.resample"):
                data = _resample_array(
                    var.data,
                    affine_matrix,
                    shape,
                    _get_interp_method_int(interp_methods, name, var),
                    _get_agg_method(agg_methods, name, var),
                    _get_recover_nan(recover_nans, name, var),
                    _get_fill_value(fill_values, name, var),
                )
            replacement = DataArray(
                data=data,
                dims=var.dims,
                attrs=dict(var.attrs),
                chunks=_output_chunks(var, shape, target_tile_size),
            )
        elif yx_dims[0] in var.dims or yx_dims[1] in var.dims:
            continue  # partial spatial dependence: drop
        else:
            replacement = var

        kind = "coords" if name in dataset.coords else "data_vars"
        if kind == "data_vars" and name not in dataset.data_vars:
            continue
        buckets[kind][name] = replacement

    return Dataset(
        data_vars=buckets["data_vars"],
        coords=buckets["coords"],
        attrs=dict(dataset.attrs),
    )


def _output_chunks(var, output_shape, target_tile_size):
    """Chunk metadata for a resampled variable: leading dims keep their
    first chunk size, spatial dims take the target tile size."""
    if var.chunks is not None:
        lead = tuple(c[0] for c in var.chunks[:-2])
    else:
        lead = tuple(output_shape[:-2])
    return lead + (target_tile_size[1], target_tile_size[0])


def _scale_split(affine_matrix: AffineTransformMatrix):
    """Split a downscaling matrix into integral window divisors and the
    residual (<=1 per axis) matrix (reference affine.py:287-307)."""
    (i_scale, sh_x, i_off), (sh_y, j_scale, j_off) = affine_matrix
    i_div, j_div = math.ceil(abs(i_scale)), math.ceil(abs(j_scale))
    residual = (
        (i_scale / i_div, sh_x, i_off),
        (sh_y, j_scale / j_div, j_off),
    )
    return (j_div, i_div), residual


def _resample_array(
    array,
    affine_matrix: AffineTransformMatrix,
    output_shape: Sequence[int],
    interp_method: InterpMethodInt,
    agg_method: AggFunction,
    recover_nan: bool,
    fill_value: FloatInt,
):
    i_scale, j_scale = affine_matrix[0][0], affine_matrix[1][1]
    # abs(): a flipped axis (negative scale) must still aggregate when it
    # downscales — the signed gate silently skipped the split
    downscaling = (abs(i_scale) > 1 or abs(j_scale) > 1) and interp_method != 0
    if not downscaling:
        return _gather_resample(
            array, affine_matrix, output_shape, interp_method,
            recover_nan, fill_value,
        )

    # downscale = residual gather at an inflated size, then an integral
    # window aggregation back to the requested size
    (j_div, i_div), residual = _scale_split(affine_matrix)
    inflated = tuple(output_shape[:-2]) + (
        output_shape[-2] * j_div,
        output_shape[-1] * i_div,
    )
    stretched = _gather_resample(
        array, residual, inflated, interp_method, recover_nan, fill_value
    )
    return coarsen_ops.coarsen(stretched, j_div, i_div, agg_method)


def _gather_resample(
    array,
    affine_matrix: AffineTransformMatrix,
    output_shape: Sequence[int],
    interp_method: InterpMethodInt,
    recover_nan: bool,
    fill_value: FloatInt,
):
    """One fused gather through the affine map; optionally the two-pass
    NaN-recovery trick (transform a zero-filled image and the valid mask
    separately, then divide — reference affine.py:344-360)."""
    if interp_method > 1:
        raise ValueError(_HIGH_ORDER_MSG)

    (i_scale, _, i_off), (_, j_scale, j_off) = affine_matrix
    out_h, out_w = output_shape[-2], output_shape[-1]
    xp = gather._get_xp(array)
    in_dtype = np.dtype(array.dtype)

    def transform(a):
        return gather.affine_gather(
            a, j_scale, i_scale, j_off, i_off, out_h, out_w,
            interp_method, fill_value, xp=xp,
        )

    result = None
    if recover_nan and interp_method > 0:
        nan_mask = xp.isnan(array)
        host_has_nans = xp is not np or bool(np.any(np.asarray(nan_mask)))
        if host_has_nans:
            numerator = transform(xp.where(nan_mask, 0.0, array))
            weight = transform(1.0 - nan_mask)
            result = xp.where(
                xp.isclose(weight, 0.0), np.nan, numerator / weight
            )
    if result is None:
        result = transform(array)

    # integer inputs round-trip through float interpolation
    if np.dtype(result.dtype) != in_dtype:
        if in_dtype.kind in "ui":
            result = xp.rint(result)
        result = result.astype(in_dtype)
    return result
