"""Rectification engine (irregular 2D-coords swath -> regular grid).

Semantics track reference ``rectify.py:54-773`` (see NOTICE), with the
numba scatter kernels redesigned as vectorized candidate-enumeration +
scatter-min (:mod:`.ops.rectify_ops`) — deterministic, parallel,
bit-matching the reference's first-writer-wins semantics.  Phase A
produces a per-tile ``(2, h, w)`` float64 fractional source-index map;
Phase B is a shared gather kernel.  Chunked execution is tile-static (one
target tile = one kernel call / one device tile), and the output is
chunking-invariant by construction (the guarantee the reference asserts
via its dask tests, test_rectify.py:295-388).

Engine tiers, selected in :func:`_inverse_ij_map`:

1. **device walk** — the planner-free Newton quad-walk
   (:func:`.ops.rectify_ops.inverse_ij_map_walk`): pure gathers, no
   host planning, engaged on clean fold-free swaths
   (``XRTPU_PHASEA_WALK=0`` disables);
2. **device stencil** — the host-planned tiled stencil kernel
   (``XRTPU_PHASEA=device`` forces the device tiers, ``auto`` uses
   them when a non-CPU backend is present);
3. **host tiles** — per-destination-tile source windows from the bbox
   scan, each tile through the multithreaded C++ / vectorized numpy
   kernel.
"""

from __future__ import annotations

import math
import os
import time
from collections.abc import Hashable, Iterable

import numpy as np

from .affine import resample_dataset
from .chunk import compute_array_from_func, iter_tiles
from .constants import (
    SCALE_LIMIT,
    UV_DELTA,
    AggMethods,
    FillValues,
    FloatInt,
    InterpMethodStr,
    InterpMethods,
    RecoverNans,
)
from .crs import Transformer
from .gridmapping import GridMapping
from .ops import rectify_ops
from .profiling import GLOBAL_TIMER as TIMER
from .utils import (
    _get_fill_value,
    _get_interp_method_str,
    _is_equal_crs,
    _prep_interp_methods_downscale,
    _select_variables,
    assemble_target_shell,
    normalize_grid_mapping,
)
from .xrlite import DataArray, Dataset


def rectify_dataset(
    source_ds: Dataset,
    target_gm: GridMapping | None = None,
    source_gm: GridMapping | None = None,
    variables: str | Iterable[str] | None = None,
    interp_methods: InterpMethods | None = None,
    agg_methods: AggMethods | None = None,
    recover_nans: RecoverNans = False,
    fill_values: FillValues | None = None,
    tile_size: int | tuple[int, int] | None = None,
) -> Dataset:
    """Rectify a dataset with non-regular (2D) spatial coordinates to a
    regular target grid.  Option semantics follow the reference
    (rectify.py:54-118)."""
    with TIMER("rectify.gm_inference"):
        if source_gm is None:
            source_gm = GridMapping.from_dataset(source_ds)
        source_ds = normalize_grid_mapping(source_ds, source_gm)
        if target_gm is None:
            target_gm = source_gm.to_regular(tile_size=tile_size)

    # swath coordinates must live in the target CRS before inversion
    if not _is_equal_crs(source_gm, target_gm):
        with TIMER("rectify.coord_transform"):
            source_ds = _reproject_swath_coords(source_ds, source_gm, target_gm)
            source_gm = GridMapping.from_dataset(source_ds)

    source_ds = _select_variables(source_ds, variables)

    with TIMER("rectify.pre_downscale"):
        source_ds, source_gm = _maybe_downscale(
            source_ds, source_gm, target_gm,
            interp_methods, agg_methods, recover_nans,
        )

    # how many Phase-B gathers will share this geometry's map: every 2D
    # spatial variable counts once, 3D ones per leading slice
    swath_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    work_bands = 0
    for var in source_ds.data_vars.values():
        if var.dims[-2:] == swath_dims:
            lead = var.data.shape[:-2]
            work_bands += int(np.prod(lead)) if lead else 1

    # PHASE A: per-target-pixel fractional source indices
    with TIMER("rectify.phase_a"):
        ij_map = _inverse_ij_map(
            source_gm, target_gm, UV_DELTA, work_bands=max(work_bands, 1)
        )

    target_ds = assemble_target_shell(
        source_ds, source_gm, target_gm, target_gm.to_coords()
    )
    with TIMER("rectify.phase_b"):
        for name, var in source_ds.data_vars.items():
            if var.dims[-2:] == swath_dims:
                assert len(var.dims) in (2, 3), (
                    f"Data variable {name} has {len(var.dims)} dimensions."
                )
                target_ds[name] = _gather_variable(
                    var, name, target_gm, ij_map, interp_methods, fill_values
                )
            elif not set(swath_dims) & set(var.dims):
                # non-spatial variables ride along unchanged
                target_ds[name] = var

    return target_ds


def _reproject_swath_coords(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
) -> Dataset:
    """Forward-transform the source's 2D coordinate images into the target
    CRS (reference rectify.py:182-231; native transformer instead of a
    per-block pyproj callback)."""
    fwd = Transformer.from_crs(source_gm.crs, target_gm.crs, always_xy=True)
    new_xx, new_yy = fwd.transform(
        np.asarray(source_gm.x_coords.data, dtype=np.float64),
        np.asarray(source_gm.y_coords.data, dtype=np.float64),
    )

    swath_dims = (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0])
    if target_gm.crs.is_geographic:
        new_names = ("lon", "lat")
    else:
        new_names = ("transformed_x", "transformed_y")

    return source_ds.drop_vars(source_gm.xy_var_names).assign_coords(
        {
            "spatial_ref": DataArray(
                np.array(0), dims=(), attrs=target_gm.crs.to_cf()
            ),
            new_names[0]: (swath_dims, np.asarray(new_xx)),
            new_names[1]: (swath_dims, np.asarray(new_yy)),
        }
    )


def _maybe_downscale(
    source_ds: Dataset,
    source_gm: GridMapping,
    target_gm: GridMapping,
    interp_methods: InterpMethods | None,
    agg_methods: AggMethods | None,
    recover_nans: RecoverNans,
) -> tuple[Dataset, GridMapping]:
    """Pre-downscale when source resolution is finer than target
    (reference rectify.py:234-260)."""
    x_scale = source_gm.x_res / target_gm.x_res
    y_scale = source_gm.y_res / target_gm.y_res
    if x_scale >= SCALE_LIMIT and y_scale >= SCALE_LIMIT:
        return source_ds, source_gm

    new_size = tuple(
        max(2, round(scale * extent))
        for scale, extent in (
            (x_scale, source_gm.width),
            (y_scale, source_gm.height),
        )
    )
    source_ds = resample_dataset(
        source_ds,
        ((1 / x_scale, 0, 0), (0, 1 / y_scale, 0)),
        (source_gm.xy_dim_names[1], source_gm.xy_dim_names[0]),
        new_size,
        source_gm.tile_size,
        _prep_interp_methods_downscale(interp_methods),
        agg_methods,
        recover_nans,
    )
    return source_ds, GridMapping.from_dataset(source_ds)


def _tile_search_border(target_gm: GridMapping) -> float:
    """Empirical xy_border growing per-tile search windows: more tiles
    means smaller destination bboxes and a higher risk of missing source
    quads near tile edges (reference rectify.py:329-340)."""
    x1, y1, x2, y2 = target_gm.xy_bbox
    per_axis = min(
        2 * (target_gm.width / target_gm.tile_width) * target_gm.x_res,
        2 * (target_gm.height / target_gm.tile_height) * target_gm.y_res,
    )
    return min(per_axis, min(0.5 * (x2 - x1), 0.5 * (y2 - y1)))


_LINK_PROFILE: list = []

# Engine throughputs for the tier cost model.  The HOST rates are
# calibrated once per process by :func:`_engine_rates` (a faster CPU
# shifts them 1-2 orders of magnitude, which would wrongly favor host
# for mid-size jobs); the host constants below only serve hosts where the
# micro-probes cannot run.  The DEVICE constants were measured by
# chip_smoke.py's rectify phase on the 16-band OLCI-like swath on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit: the resident Phase-B
# gather rate (target pixels x bands per second) and the hybrid device
# Phase A's fixed cost — its warm wall time less the upload and
# round-trip terms that :func:`_phase_a_auto_choice` adds from the link
# profile, so the upload is counted once.  The gather rate is that of
# the NEAREST gather and the model has no interp term: on that card the
# bilinear and triangular device jobs took seconds per call while the
# host tier took under one, so the auto tier's device choice for them is
# known to be the slower one (ROADMAP queue 1).
# ``XRTPU_RATE_*`` env vars override all four.
_HOST_QUAD_RATE = 6e6
_HOST_GATHER_RATE = 25e6
_DEVICE_GATHER_RATE = 6.9273e10
_DEVICE_FIXED_S = 0.0813319

_ENGINE_RATES: dict = {}


def _measure_host_rates() -> tuple[float, float]:
    """(quad rate, gather rate) of the host tier, measured with two
    sub-20 ms micro-probes on synthetic data.  Rates extrapolate well:
    both kernels stream memory linearly, so a small probe is within ~2x
    of the asymptote — far inside the >2x tier gaps the choice spans."""
    from .ops import rectify_ops as _ops

    n = 96
    jj, ii = np.mgrid[0:n, 0:n].astype(np.float64)
    gx = ii * 1.03 + 0.11 * jj
    gy = jj * 0.97 - 0.07 * ii
    # warm once (first call loads the native library / faults pages)
    _ops.inverse_ij_map(gx, gy, 0, 0, (n, n), 0.0, 0.0, 1.0, 1.0, 1e-3)
    t0 = time.perf_counter()
    ij_map = _ops.inverse_ij_map(
        gx, gy, 0, 0, (n, n), 0.0, 0.0, 1.0, 1.0, 1e-3
    )
    quad_rate = (n - 1) * (n - 1) / max(time.perf_counter() - t0, 1e-6)

    src = np.ascontiguousarray(gx, dtype=np.float32)
    _ops.var_image_from_ij_map(src, ij_map, np.nan, "nearest")
    t0 = time.perf_counter()
    _ops.var_image_from_ij_map(src, ij_map, np.nan, "nearest")
    gather_rate = n * n / max(time.perf_counter() - t0, 1e-6)
    return quad_rate, gather_rate


def _engine_rates() -> dict:
    """Tier-model throughputs: measured once per process where possible,
    module fallbacks otherwise, ``XRTPU_RATE_*`` env overrides last."""
    if _ENGINE_RATES:
        return _ENGINE_RATES
    rates = dict(
        host_quad=_HOST_QUAD_RATE,
        host_gather=_HOST_GATHER_RATE,
        device_gather=_DEVICE_GATHER_RATE,
        device_fixed=_DEVICE_FIXED_S,
    )
    try:
        rates["host_quad"], rates["host_gather"] = _measure_host_rates()
    except Exception:  # noqa: BLE001 - fallbacks already in place
        pass
    for key, env in (
        ("host_quad", "XRTPU_RATE_HOST_QUAD"),
        ("host_gather", "XRTPU_RATE_HOST_GATHER"),
        ("device_gather", "XRTPU_RATE_DEVICE_GATHER"),
        ("device_fixed", "XRTPU_RATE_DEVICE_FIXED"),
    ):
        value = os.environ.get(env)
        if value:
            rates[key] = float(value)
    _ENGINE_RATES.update(rates)
    return _ENGINE_RATES


def _device_link_profile() -> tuple[float, float]:
    """(upload bytes/s, fetch round-trip s) to the default device,
    measured once per process with a few small transfers.

    The device Phase-A tier streams the full coordinate images to the
    device, so the tier choice prices that upload over the link the
    process actually has.  The probes run no device computation: indexing
    the uploaded array would compile a program on first use, and that
    compile would read as a slow link."""
    if not _LINK_PROFILE:
        try:
            import jax

            small = np.zeros(4, np.float32)
            rtt = math.inf
            for _ in range(3):
                t0 = time.perf_counter()
                np.asarray(jax.device_put(small))
                rtt = min(rtt, time.perf_counter() - t0)
            buf = np.zeros(4 << 20, np.uint8)
            jax.block_until_ready(jax.device_put(buf))  # first-use setup
            t0 = time.perf_counter()
            jax.block_until_ready(jax.device_put(buf))
            bw = buf.nbytes / max(time.perf_counter() - t0, 1e-4)
            _LINK_PROFILE.append((bw, max(rtt, 1e-4)))
        except Exception:  # noqa: BLE001
            _LINK_PROFILE.append((1e9, 1e-3))
    return _LINK_PROFILE[0]


def _phase_a_tier(
    work_bands: int | None = None,
    swath_px: int = 0,
    target_px: int = 0,
) -> str:
    """'device' or 'host': XRTPU_PHASEA overrides; auto models the whole
    job — Phase A plus *work_bands* Phase-B gathers — on each tier.

    The device tier pays a fixed per-geometry cost (coordinate upload +
    meta round trips) that single-band one-shot jobs may never earn back
    (reference semantics being beaten:
    /root/reference/xcube_resampling/rectify.py:424-576; a laptop run of
    the reference rectifies ~4.4 Mpix/s, BASELINE.md).  Multi-band
    products (OLCI: ~17 bands per geometry) amortize it and the device
    gathers win by an order of magnitude."""
    mode = os.environ.get("XRTPU_PHASEA", "auto")
    if mode != "auto":
        return mode
    try:
        import jax

        if jax.default_backend() in ("cpu",):
            return "host"
    except Exception:  # noqa: BLE001
        return "host"
    if work_bands is None or not swath_px or not target_px:
        return "device"
    bw, rtt = _device_link_profile()
    return _phase_a_auto_choice(work_bands, swath_px, target_px, bw, rtt)


def _phase_a_auto_choice(
    work_bands: int,
    swath_px: int,
    target_px: int,
    bw: float,
    rtt: float,
    rates: dict | None = None,
) -> str:
    """Pure cost comparison behind the auto tier (see :func:`_phase_a_tier`).
    *rates* defaults to the per-process calibration (:func:`_engine_rates`);
    tests inject fixed rate profiles here."""
    if rates is None:
        rates = _engine_rates()
    coord_bytes = 2 * swath_px * 4  # two float32 coordinate images
    device_cost = (
        coord_bytes / bw
        + 6 * rtt
        + rates["device_fixed"]
        + work_bands * target_px / rates["device_gather"]
    )
    host_cost = (
        swath_px / rates["host_quad"]
        + work_bands * target_px / rates["host_gather"]
    )
    return "device" if device_cost <= host_cost else "host"


def _inverse_ij_map(
    source_gm: GridMapping,
    target_gm: GridMapping,
    uv_delta: float,
    work_bands: int | None = None,
):
    """PHASE A: the (2, height, width) fractional source-index map.

    Device tier: one XLA kernel over the full map — the reference's numba
    hot loop (rectify.py:424-576) stays on the device; the host only
    normalizes coordinates and sizes the candidate rectangle.  Host tier:
    tile-by-tile with per-tile source windows discovered by the bbox scan
    (reference rectify.py:312-370).  *work_bands* (the number of Phase-B
    gathers that will consume the map) feeds the amortization-aware tier
    choice; None keeps the backend-only heuristic.
    """
    x1, y1, x2, y2 = target_gm.xy_bbox
    x_res, y_res = target_gm.xy_res
    j_up = target_gm.is_j_axis_up
    shape_hw = (target_gm.height, target_gm.width)

    tier = _phase_a_tier(
        work_bands,
        swath_px=source_gm.width * source_gm.height,
        target_px=shape_hw[0] * shape_hw[1],
    )
    if tier == "device":
        with TIMER("rectify.phase_a_device"):
            swath = np.asarray(source_gm.xy_coords.data, dtype=np.float64)
            on_device = rectify_ops.inverse_ij_map_device(
                swath[0],
                swath[1],
                0,
                0,
                shape_hw,
                x1,
                y1 if j_up else y2,
                x_res,
                y_res if j_up else -y_res,
                uv_delta,
            )
        if on_device is not None:
            return on_device

    # (A single whole-image native call was tried here and rejected: the
    # swath's rotation makes source rows cut diagonally across the full
    # destination map, so claim reads/writes thrash the cache — the
    # 512^2-tile walk below keeps the working set cache-resident and
    # measured ~2.3x faster end-to-end on the OLCI-sized swath.)
    with TIMER("rectify.phase_a_host"):
        with TIMER("rectify.phase_a_bbox_scan"):
            window_bboxes = source_gm.ij_bboxes_from_xy_bboxes(
                target_gm.xy_bboxes,
                xy_border=_tile_search_border(target_gm),
                ij_border=1,
            )

        return compute_array_from_func(
            _inverse_ij_map_tile,
            (2,) + shape_hw,
            (2, target_gm.tile_height, target_gm.tile_width),
            np.float64,
            ctx_arg_names=["dtype", "block_id", "block_shape", "block_slices"],
            args=(
                source_gm.xy_coords,
                window_bboxes,
                x1,
                y1,
                y2,
                x_res,
                y_res,
                j_up,
                uv_delta,
            ),
            name="ij_pixels",
        )


# Established internal entry point for the Phase-A map (bench, sharded
# rectify, parity tests import it under this name).
_compute_target_source_ij = _inverse_ij_map


def _inverse_ij_map_tile(
    dtype: np.dtype,
    block_id: int,
    block_shape: tuple[int, ...],
    block_slices: tuple,
    swath_xy: DataArray,
    window_bboxes: np.ndarray,
    x_min: float,
    y_min: float,
    y_max: float,
    x_res: float,
    y_res: float,
    j_up: bool,
    uv_delta: float,
) -> np.ndarray:
    """One destination tile of the fractional source-index map
    (reference rectify.py:373-419)."""
    _, (row0, _), (col0, _) = block_slices
    i_lo, j_lo, i_hi, j_hi = window_bboxes[block_id]
    if i_lo == -1:
        # no source quad can land in this tile
        return np.full(block_shape, np.nan, dtype=dtype)

    window = np.asarray(
        swath_xy.data[:, j_lo : j_hi + 1, i_lo : i_hi + 1], dtype=np.float64
    )
    x_origin = x_min + col0 * x_res
    y_origin = (y_min + row0 * y_res) if j_up else (y_max - row0 * y_res)
    return rectify_ops.inverse_ij_map(
        window[0],
        window[1],
        int(i_lo),
        int(j_lo),
        (block_shape[1], block_shape[2]),
        x_origin,
        y_origin,
        x_res,
        y_res if j_up else -y_res,
        uv_delta,
    )


def _gather_variable(
    var: DataArray,
    name: Hashable,
    target_gm: GridMapping,
    ij_map,
    interp_methods: InterpMethods | None = None,
    fill_values: FillValues | None = None,
) -> DataArray:
    """PHASE B: gather a data variable through the source-index map
    (reference rectify.py:263-309)."""
    had_band_axis = len(var.dims) == 3
    if not had_band_axis:
        var = var.expand_dims({"dummy": 1})

    fill_value = _get_fill_value(fill_values, name, var)
    interp = _get_interp_method_str(interp_methods, name, var)

    # the phase names record which tier gathered
    if isinstance(ij_map, rectify_ops.DeviceIJMap):
        # fully device-resident pipeline: the Phase-A map stays on the
        # device and every variable (numpy- or JAX-backed) gathers
        # through it there — nothing crosses the host boundary per band
        with TIMER("rectify.phase_b_resident"):
            gather = rectify_ops.make_device_var_image_fn_resident(
                ij_map, fill_value, interp
            )
            image = gather(var.data)
    elif type(var.data).__module__.startswith("jax"):
        # device fast path over a host-materialized map: JAX-backed
        # variables gather through the fractional index map on device
        # (the map is staged once and reused for every variable)
        with TIMER("rectify.phase_b_device"):
            gather = rectify_ops.make_device_var_image_fn(
                ij_map, (var.shape[-2], var.shape[-1]), fill_value, interp
            )
            image = gather(var.data)
    else:
        with TIMER("rectify.phase_b_host"):
            image = _gather_host_tiled(
                np.asarray(var.data), ij_map, fill_value, interp, target_gm
            )

    tile_hw = (target_gm.tile_height, target_gm.tile_width)
    grid_dims = (target_gm.xy_dim_names[1], target_gm.xy_dim_names[0])
    if had_band_axis:
        lead = var.chunks[0][0] if var.chunks is not None else var.shape[0]
        dims = (var.dims[0],) + grid_dims
        chunks = (lead,) + tile_hw
    else:
        image = image[0, :, :]
        dims = grid_dims
        chunks = tile_hw if target_gm.is_tiled else None

    return DataArray(
        data=image, dims=dims, attrs=dict(var.attrs), chunks=chunks
    )


def _gather_host_tiled(
    src_var: np.ndarray,
    ij_map: np.ndarray,
    fill_value: FloatInt,
    interp_method: InterpMethodStr,
    target_gm: GridMapping,
) -> np.ndarray:
    """Gather tile by tile so the per-tile source windows stay small
    (reference rectify.py:579-635).

    The native C++ gather indexes the source directly (no per-tile window
    copies to bound), so when it applies, one whole-map call replaces the
    tile loop — same result, none of the tile-slice copies."""
    from .native import var_image_gather_native

    whole = var_image_gather_native(
        src_var, np.asarray(ij_map), fill_value, interp_method
    )
    if whole is not None:
        return whole
    out_hw = ij_map.shape[-2:]
    out = np.empty(src_var.shape[:-2] + out_hw, dtype=src_var.dtype)
    for tile in iter_tiles(out_hw, (target_gm.tile_height, target_gm.tile_width)):
        rows, cols = tile.slices
        out[..., rows, cols] = rectify_ops.var_image_from_ij_map(
            src_var, ij_map[:, rows, cols], fill_value, interp_method
        )
    return out
