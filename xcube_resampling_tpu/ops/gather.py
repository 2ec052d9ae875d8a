"""Gather + interpolation kernels (affine resampling, grid-coordinate
sampling for reproject/rectify phase B).

These replace the reference's per-pixel loops and the external
``dask_image.ndinterp.affine_transform`` spline kernel
(reference affine.py:362, reproject.py:268-335, rectify.py:663-734) with
vectorized gathers that XLA fuses into a single device kernel.  Boundary
semantics match scipy ``map_coordinates(order<=1, mode="constant")``:
out-of-range neighbours contribute the constant fill value, but zero-weight
neighbours never contaminate the result (so an exact-integer coordinate at
the image edge stays finite even with a NaN fill value).
"""

from __future__ import annotations

import functools

import numpy as np


def _get_xp(array):
    if isinstance(array, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def affine_gather(
    array,
    j_scale: float,
    i_scale: float,
    j_off: float,
    i_off: float,
    out_h: int,
    out_w: int,
    order: int,
    fill_value,
    xp=None,
):
    """Affine resampling of the trailing (y, x) dims of *array*.

    output[..., j, i] = input[..., j*j_scale + j_off, i*i_scale + i_off]

    Args:
        array: (..., H, W) array (numpy or jax).
        order: 0 (nearest) or 1 (bilinear).
        fill_value: value for samples outside the source extent.
    """
    xp = xp or _get_xp(array)
    src_h, src_w = array.shape[-2], array.shape[-1]
    cdt = _coord_dtype(array)
    jj = xp.arange(out_h, dtype=cdt) * j_scale + j_off
    ii = xp.arange(out_w, dtype=cdt) * i_scale + i_off
    yy = jj[:, None]
    xx = ii[None, :]
    return grid_gather_separable(array, yy, xx, order, fill_value, xp=xp)


def _coord_dtype(array):
    # float32 data keeps float64 coordinate math on host; on device (jax)
    # the dtype follows the x64 setting
    return np.float64


def grid_gather_separable(array, yy, xx, order: int, fill_value, xp=None):
    """Gather at fractional coordinates; yy is (H, 1) or (H, W), xx is
    (1, W) or (H, W); broadcasting over the trailing dims of *array*.

    scipy map_coordinates(mode="constant") parity: a sample point whose
    *coordinate* falls outside the valid range ([0, n-1] for order 1,
    [-0.5, n-0.5] for order 0) yields the fill value directly — there is no
    fill/edge blending.  Interior points always sum both taps per dimension,
    including zero-weight taps, so a NaN neighbour propagates exactly as in
    the reference pipeline (which fed dask_image/scipy, affine.py:362)."""
    xp = xp or _get_xp(array)
    src_h, src_w = array.shape[-2], array.shape[-1]

    if order == 0:
        valid = (
            (yy >= -0.5) & (yy <= src_h - 0.5) & (xx >= -0.5) & (xx <= src_w - 0.5)
        )
        iy = xp.clip(xp.floor(yy + 0.5).astype(xp.int32), 0, src_h - 1)
        ix = xp.clip(xp.floor(xx + 0.5).astype(xp.int32), 0, src_w - 1)
        if (
            getattr(yy, "ndim", 0) == 2
            and getattr(xx, "ndim", 0) == 2
            and yy.shape[1] == 1
            and xx.shape[0] == 1
            and xp is not np
        ):
            vals = xp.take(
                xp.take(array, iy[:, 0], axis=-2), ix[0, :], axis=-1
            )
            return _where_fill(xp, valid, vals, fill_value, array.dtype)
        iy_b, ix_b, valid_b = xp.broadcast_arrays(iy, ix, valid)
        vals = array[..., iy_b, ix_b]
        return _where_fill(xp, valid_b, vals, fill_value, array.dtype)

    # order == 1: bilinear with constant fill
    valid = (yy >= 0) & (yy <= src_h - 1) & (xx >= 0) & (xx <= src_w - 1)
    y0f = xp.floor(yy)
    x0f = xp.floor(xx)
    fy = yy - y0f
    fx = xx - x0f
    y0 = xp.clip(y0f.astype(xp.int32), 0, src_h - 1)
    x0 = xp.clip(x0f.astype(xp.int32), 0, src_w - 1)
    y1 = xp.clip(y0 + 1, 0, src_h - 1)
    x1 = xp.clip(x0 + 1, 0, src_w - 1)

    out_dtype = _float_dtype(array.dtype)

    separable = (
        getattr(yy, "ndim", 0) == 2
        and getattr(xx, "ndim", 0) == 2
        and yy.shape[1] == 1
        and xx.shape[0] == 1
    )
    if separable:
        # axis-aligned sampling (affine upscale): factorize the four-tap
        # gather into row-takes + row-shared column-takes, which read
        # memory in order (instead of a 2D gather) and save the four
        # full-size broadcast gathers on the host (~3x less work and no
        # (H, W) index temporaries)
        r0 = xp.take(array, y0[:, 0], axis=-2).astype(out_dtype)
        r1 = xp.take(array, y1[:, 0], axis=-2).astype(out_dtype)
        ry0 = r0 * (1 - fy) + r1 * fy
        c0 = xp.take(ry0, x0[0, :], axis=-1)
        c1 = xp.take(ry0, x1[0, :], axis=-1)
        result = c0 * (1 - fx) + c1 * fx
        return _where_fill(xp, valid, result, fill_value, out_dtype)

    y0b, y1b, x0b, x1b, fyb, fxb, validb = xp.broadcast_arrays(
        y0, y1, x0, x1, fy, fx, valid
    )
    v00 = array[..., y0b, x0b].astype(out_dtype)
    v01 = array[..., y0b, x1b].astype(out_dtype)
    v10 = array[..., y1b, x0b].astype(out_dtype)
    v11 = array[..., y1b, x1b].astype(out_dtype)
    vu0 = v00 * (1 - fxb) + v01 * fxb
    vu1 = v10 * (1 - fxb) + v11 * fxb
    result = vu0 * (1 - fyb) + vu1 * fyb
    return _where_fill(xp, validb, result, fill_value, out_dtype)


def _float_dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return dtype
    return np.dtype(np.float64)


def _where_fill(xp, valid, vals, fill_value, dtype):
    fill = xp.asarray(fill_value)
    if np.dtype(dtype).kind in "ui":
        fill = fill.astype(dtype)
    else:
        fill = fill.astype(dtype)
    return xp.where(valid, vals, fill)


def grid_sample(
    data,
    ix,
    iy,
    interp_method: str,
    xp=None,
):
    """Sample *data* (..., H, W) at fractional indices (iy, ix) of shape
    (h, w), with the reference's nearest / triangular / bilinear semantics
    and int16-free clamped neighbours (reference reproject.py:268-335).

    Neighbours are clamped to the source extent (the caller guarantees the
    window covers the target region plus a 1-2 pixel pad, reference
    reproject.py:355-423)."""
    xp = xp or _get_xp(data)
    src_h, src_w = data.shape[-2], data.shape[-1]

    if interp_method == "nearest":
        jy = xp.clip(xp.rint(iy).astype(xp.int32), 0, src_h - 1)
        jx = xp.clip(xp.rint(ix).astype(xp.int32), 0, src_w - 1)
        return data[..., jy, jx]

    ix_floor = xp.floor(ix)
    iy_floor = xp.floor(iy)
    diff_ix = ix - ix_floor
    diff_iy = iy - iy_floor
    x0 = xp.clip(ix_floor.astype(xp.int32), 0, src_w - 1)
    y0 = xp.clip(iy_floor.astype(xp.int32), 0, src_h - 1)
    x1 = xp.clip(xp.ceil(ix).astype(xp.int32), 0, src_w - 1)
    y1 = xp.clip(xp.ceil(iy).astype(xp.int32), 0, src_h - 1)

    value_00 = data[..., y0, x0]
    value_01 = data[..., y0, x1]
    value_10 = data[..., y1, x0]
    value_11 = data[..., y1, x1]

    if interp_method == "triangular":
        mask = diff_ix + diff_iy < 1.0
        near = value_00 + diff_ix * (value_01 - value_00) + diff_iy * (
            value_10 - value_00
        )
        far = (
            value_11
            + (1.0 - diff_ix) * (value_10 - value_11)
            + (1.0 - diff_iy) * (value_01 - value_11)
        )
        return xp.where(mask, near, far)
    elif interp_method == "bilinear":
        value_u0 = value_00 + diff_ix * (value_01 - value_00)
        value_u1 = value_10 + diff_ix * (value_11 - value_10)
        return value_u0 + diff_iy * (value_u1 - value_u0)
    else:
        raise NotImplementedError(
            f"interp_methods must be one of 0, 1, 'nearest', 'bilinear', "
            f"'triangular', was '{interp_method}'."
        )


@functools.lru_cache(maxsize=128)
def _jit_affine_gather(j_scale, i_scale, j_off, i_off, out_h, out_w, order, fill):
    """Jit-compiled affine gather closure for the device fast path."""
    import jax
    import jax.numpy as jnp

    def fn(array):
        return affine_gather(
            array, j_scale, i_scale, j_off, i_off, out_h, out_w, order, fill, xp=jnp
        )

    return jax.jit(fn)


def affine_gather_jax(array, j_scale, i_scale, j_off, i_off, out_h, out_w, order, fill):
    """Device path: compile-once affine gather (static geometry)."""
    fn = _jit_affine_gather(
        float(j_scale),
        float(i_scale),
        float(j_off),
        float(i_off),
        int(out_h),
        int(out_w),
        int(order),
        float(fill) if not np.issubdtype(type(fill), np.integer) else fill,
    )
    return fn(array)
