"""Rectify engine goldens (port of reference tests/test_rectify.py):
nearest/triangular/bilinear goldens, chunking invariance across tile
decompositions (the de-facto distributed test), antimeridian handling,
CRS-changing rectification."""

import numpy as np
import pytest

from xcube_resampling_tpu.gridmapping import CRS_WGS84, GridMapping
from xcube_resampling_tpu.rectify import rectify_dataset
from xcube_resampling_tpu.xrlite import DataArray, Dataset

from .sampledata import (
    create_2x2_dataset_with_irregular_coords,
    create_2x2_dataset_with_irregular_coords_antimeridian,
    create_2x2x2_dataset_with_irregular_coords,
    create_4x4_dataset_with_irregular_coords,
)

nan = np.nan


def expected_rad_13x13(dtype):
    return np.array(
        [
            [nan, nan, 1.0, nan, nan, nan, nan, nan, nan, nan, nan, nan, nan],
            [nan, nan, 1.0, 1.0, nan, nan, nan, nan, nan, nan, nan, nan, nan],
            [nan, nan, 1.0, 1.0, 1.0, 1.0, nan, nan, nan, nan, nan, nan, nan],
            [nan, nan, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, nan, nan, nan, nan, nan],
            [nan, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, nan, nan, nan, nan],
            [nan, 3.0, 3.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, nan, nan],
            [nan, 3.0, 3.0, 3.0, 3.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
            [nan, 3.0, 3.0, 3.0, 3.0, 3.0, 1.0, 2.0, 2.0, 2.0, 2.0, nan, nan],
            [3.0, 3.0, 3.0, 3.0, 3.0, 4.0, 4.0, 2.0, 2.0, 2.0, nan, nan, nan],
            [nan, 3.0, 3.0, 3.0, 4.0, 4.0, 4.0, 4.0, 2.0, nan, nan, nan, nan],
            [nan, nan, 3.0, 4.0, 4.0, 4.0, 4.0, nan, nan, nan, nan, nan, nan],
            [nan, nan, nan, 4.0, 4.0, 4.0, nan, nan, nan, nan, nan, nan, nan],
            [nan, nan, nan, nan, 4.0, nan, nan, nan, nan, nan, nan, nan, nan],
        ],
        dtype=dtype,
    )


def _assert_shape_and_dim(target_ds, size, chunks=None, var_names=("rad",)):
    w, h = size

    assert "lon" in target_ds
    lon = target_ds["lon"]
    assert (w,) == lon.shape
    assert ("lon",) == lon.dims

    assert "lat" in target_ds
    lat = target_ds["lat"]
    assert (h,) == lat.shape
    assert ("lat",) == lat.dims

    out_vars = []
    for var_name in var_names:
        assert var_name in target_ds
        var = target_ds[var_name]
        assert (h, w) == var.shape
        assert ("lat", "lon") == var.dims
        assert chunks == var.chunks
        out_vars.append(var)

    return (lon, lat, *out_vars)


def test_rectify_2x2_to_default():
    source_ds = create_2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(4, 4), xy_min=(-1, 49), xy_res=2, crs=CRS_WGS84
    )
    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    np.testing.assert_almost_equal(
        target_ds.rad.values,
        np.array(
            [
                [nan, nan, nan, nan],
                [nan, 1.0, 2.0, nan],
                [3.0, 3.0, 2.0, nan],
                [nan, 4.0, nan, nan],
            ],
            dtype=target_ds.rad.dtype,
        ),
    )


def test_rectify_2x2_to_regular():
    source_ds = create_2x2_dataset_with_irregular_coords()
    target_ds = rectify_dataset(source_ds, interp_methods=0)

    np.testing.assert_almost_equal(
        target_ds.rad.values,
        np.array(
            [
                [nan, nan, nan, nan],
                [nan, nan, nan, nan],
                [nan, 2.0, nan, nan],
                [nan, nan, nan, nan],
            ],
            dtype=target_ds.rad.dtype,
        ),
    )


def test_rectify_2x2x2_to_default():
    source_ds = create_2x2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(4, 4), xy_min=(-1, 49), xy_res=2, crs=CRS_WGS84
    )
    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)
    assert set(source_ds.variables).union(["spatial_ref"]) == set(target_ds.variables)
    expected = np.array(
        [
            [nan, nan, nan, nan],
            [nan, 1.0, 2.0, nan],
            [3.0, 3.0, 2.0, nan],
            [nan, 4.0, nan, nan],
        ],
        dtype=target_ds.rad.dtype,
    )
    np.testing.assert_almost_equal(
        target_ds.rad.values, np.stack([expected, expected])
    )


def test_rectify_2x2_to_7x7():
    source_ds = create_2x2_dataset_with_irregular_coords()
    # Offset "rad" so its values do not lie on a plane
    source_ds["rad"] = source_ds.rad + DataArray(
        np.array([[0.0, 0.0], [0.0, 1.0]]), dims=("y", "x")
    )

    target_gm = GridMapping.regular(
        size=(7, 7), xy_min=(-0.5, 49.5), xy_res=1.0, crs=CRS_WGS84
    )

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    lon, lat, rad = _assert_shape_and_dim(target_ds, (7, 7))
    np.testing.assert_almost_equal(lon.values, np.arange(0, 6.1, dtype=lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(56, 49.9, -1, dtype=lat.dtype))
    np.testing.assert_almost_equal(
        rad.values,
        np.array(
            [
                [nan, 1.0, nan, nan, nan, nan, nan],
                [nan, 1.0, 1.0, nan, nan, nan, nan],
                [nan, 1.0, 1.0, 1.0, 2.0, nan, nan],
                [nan, 3.0, 3.0, 1.0, 2.0, 2.0, 2.0],
                [3.0, 3.0, 3.0, 5.0, 2.0, nan, nan],
                [nan, 3.0, 5.0, 5.0, nan, nan, nan],
                [nan, nan, 5.0, nan, nan, nan, nan],
            ],
            dtype=rad.dtype,
        ),
    )


def test_rectify_2x2_to_7x7_triangular():
    source_ds = create_2x2_dataset_with_irregular_coords()
    source_ds["rad"] = source_ds.rad + DataArray(
        np.array([[0.0, 0.0], [0.0, 1.0]]), dims=("y", "x")
    )

    target_gm = GridMapping.regular(
        size=(7, 7), xy_min=(-0.5, 49.5), xy_res=1.0, crs=CRS_WGS84
    )

    target_ds = rectify_dataset(
        source_ds, target_gm=target_gm, interp_methods="triangular"
    )

    lon, lat, rad = _assert_shape_and_dim(target_ds, (7, 7))
    np.testing.assert_almost_equal(lon.values, np.arange(0, 6.1, dtype=lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(56, 49.9, -1, dtype=lat.dtype))
    np.testing.assert_almost_equal(
        rad.values,
        np.array(
            [
                [nan, 1.000, nan, nan, nan, nan, nan],
                [nan, 1.478, 1.391, nan, nan, nan, nan],
                [nan, 1.957, 1.870, 1.784, 1.697, nan, nan],
                [nan, 2.435, 2.348, 2.261, 2.174, 2.087, 2.000],
                [3.000, 3.000, 3.000, 3.000, 3.000, nan, nan],
                [nan, 4.000, 4.000, 4.000, nan, nan, nan],
                [nan, nan, 5.000, nan, nan, nan, nan],
            ],
            dtype=rad.dtype,
        ),
        decimal=3,
    )


def test_rectify_2x2_to_7x7_bilinear():
    source_ds = create_2x2_dataset_with_irregular_coords()
    source_ds["rad"] = source_ds.rad + DataArray(
        np.array([[0.0, 0.0], [0.0, 1.0]]), dims=("y", "x")
    )

    target_gm = GridMapping.regular(
        size=(7, 7), xy_min=(-0.5, 49.5), xy_res=1.0, crs=CRS_WGS84
    )

    target_ds = rectify_dataset(
        source_ds, target_gm=target_gm, interp_methods="bilinear"
    )

    lon, lat, rad = _assert_shape_and_dim(target_ds, (7, 7))
    np.testing.assert_almost_equal(
        rad.values,
        np.array(
            [
                [nan, 1.000, nan, nan, nan, nan, nan],
                [nan, 1.488, 1.410, nan, nan, nan, nan],
                [nan, 1.994, 1.949, 1.858, 1.722, nan, nan],
                [nan, 2.520, 2.506, 2.448, 2.344, 2.195, 2.000],
                [3.000, 3.112, 3.163, 3.153, 3.082, nan, nan],
                [nan, 4.000, 4.041, 4.020, nan, nan, nan],
                [nan, nan, 5.000, nan, nan, nan, nan],
            ],
            dtype=rad.dtype,
        ),
        decimal=3,
    )


def test_rectify_2x2_to_7x7_invalid_interp():
    source_ds = create_2x2_dataset_with_irregular_coords()
    target_gm = GridMapping.regular(
        size=(7, 7), xy_min=(-0.5, 49.5), xy_res=1.0, crs=CRS_WGS84
    )
    with pytest.raises(NotImplementedError):
        rectify_dataset(source_ds, target_gm=target_gm, interp_methods="cubic")


def test_rectify_2x2_to_7x7_subset():
    source_ds = create_2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(7, 7), xy_min=(1.5, 50.5), xy_res=1.0, crs=CRS_WGS84
    )

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods="nearest")
    lon, lat, rad = _assert_shape_and_dim(target_ds, (7, 7))
    np.testing.assert_almost_equal(lon.values, np.arange(2, 8.1, dtype=lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(57, 50.9, -1, dtype=lat.dtype))
    np.testing.assert_almost_equal(
        rad.values,
        np.array(
            [
                [nan, nan, nan, nan, nan, nan, nan],
                [nan, nan, nan, nan, nan, nan, nan],
                [1.0, nan, nan, nan, nan, nan, nan],
                [1.0, 1.0, 2.0, nan, nan, nan, nan],
                [3.0, 1.0, 2.0, 2.0, 2.0, nan, nan],
                [3.0, 4.0, 2.0, nan, nan, nan, nan],
                [4.0, 4.0, nan, nan, nan, nan, nan],
            ],
            dtype=rad.dtype,
        ),
    )


def test_rectify_2x2_to_13x13():
    source_ds = create_2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(13, 13), xy_min=(-0.25, 49.75), xy_res=0.5, crs=CRS_WGS84
    )

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    lon, lat, rad = _assert_shape_and_dim(target_ds, (13, 13))
    np.testing.assert_almost_equal(lon.values, np.arange(0, 6.1, 0.5, lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(56, 49.9, -0.5, lat.dtype))
    np.testing.assert_almost_equal(rad.values, expected_rad_13x13(rad.dtype))


def test_rectify_2x2_to_13x13_j_axis_up():
    source_ds = create_2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(13, 13),
        xy_min=(-0.25, 49.75),
        xy_res=0.5,
        crs=CRS_WGS84,
        is_j_axis_up=True,
    )

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    lon, lat, rad = _assert_shape_and_dim(target_ds, (13, 13))
    np.testing.assert_almost_equal(lon.values, np.arange(0, 6.1, 0.5, lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(50, 56.1, 0.5, lat.dtype))
    np.testing.assert_almost_equal(rad.values, expected_rad_13x13(rad.dtype)[::-1])


def test_rectify_2x2_to_13x13_j_axis_up_tiles_5x5():
    source_ds = create_2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(13, 13),
        xy_min=(-0.25, 49.75),
        xy_res=0.5,
        crs=CRS_WGS84,
        tile_size=5,
        is_j_axis_up=True,
    )

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    lon, lat, rad = _assert_shape_and_dim(
        target_ds, (13, 13), chunks=((5, 5, 3), (5, 5, 3))
    )
    np.testing.assert_almost_equal(lon.values, np.arange(0, 6.1, 0.5, lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(50, 56.1, 0.5, lat.dtype))
    np.testing.assert_almost_equal(rad.values, expected_rad_13x13(rad.dtype)[::-1])


@pytest.mark.parametrize(
    "tile_size,expected_chunks",
    [
        (7, ((7, 6), (7, 6))),
        (5, ((5, 5, 3), (5, 5, 3))),
        ((3, 13), ((13,), (3, 3, 3, 3, 1))),
        ((13, 3), ((3, 3, 3, 3, 1), (13,))),
    ],
)
def test_rectify_2x2_to_13x13_chunking_invariance(tile_size, expected_chunks):
    """Output must be identical for every tile decomposition — the de-facto
    distributed-execution test (reference test_rectify.py:295-388)."""
    source_ds = create_2x2_dataset_with_irregular_coords()

    target_gm = GridMapping.regular(
        size=(13, 13),
        xy_min=(-0.25, 49.75),
        xy_res=0.5,
        crs=CRS_WGS84,
        tile_size=tile_size,
    )

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    lon, lat, rad = _assert_shape_and_dim(target_ds, (13, 13), chunks=expected_chunks)
    np.testing.assert_almost_equal(lon.values, np.arange(0, 6.1, 0.5, lon.dtype))
    np.testing.assert_almost_equal(lat.values, np.arange(56, 49.9, -0.5, lat.dtype))
    np.testing.assert_almost_equal(rad.values, expected_rad_13x13(rad.dtype))


def test_rectify_2x2_to_13x13_antimeridian():
    source_ds = create_2x2_dataset_with_irregular_coords_antimeridian()

    target_gm = GridMapping.regular(
        size=(13, 13), xy_min=(177.75, 49.75), xy_res=0.5, crs=CRS_WGS84
    )

    assert target_gm.is_lon_360 is True

    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)

    assert target_ds is not None
    lon, lat, rad = _assert_shape_and_dim(target_ds, (13, 13))
    np.testing.assert_almost_equal(
        lon.values,
        np.array(
            [
                178.0, 178.5, 179.0, 179.5, 180.0, -179.5, -179.0,
                -178.5, -178.0, -177.5, -177.0, -176.5, -176.0,
            ],
            dtype=lon.dtype,
        ),
    )
    np.testing.assert_almost_equal(lat.values, np.arange(56, 49.9, -0.5, lat.dtype))
    np.testing.assert_almost_equal(rad.values, expected_rad_13x13(rad.dtype))


def test_rectify_2x2_to_13x13_none():
    source_ds = create_2x2_dataset_with_irregular_coords()

    for xy_min in [(10.0, 50.0), (-10.0, 50.0), (0.0, 58.0), (0.0, 42.0)]:
        target_gm = GridMapping.regular(
            size=(13, 13), xy_min=xy_min, xy_res=0.5, crs=CRS_WGS84
        )
        target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)
        np.testing.assert_array_equal(
            np.isnan(target_ds.rad.values),
            np.ones(target_ds.rad.shape, dtype=bool),
        )


def test_rectify_different_crs():
    source_ds = create_4x4_dataset_with_irregular_coords()
    target_gm = GridMapping.regular(
        size=(3, 3), xy_min=(3600000, 3200000), xy_res=100000, crs="epsg:3035"
    )
    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)
    np.testing.assert_almost_equal(
        target_ds.x.values, np.array([3650000.0, 3750000.0, 3850000.0])
    )
    np.testing.assert_almost_equal(
        target_ds.y.values, np.array([3450000.0, 3350000.0, 3250000.0])
    )
    np.testing.assert_almost_equal(
        target_ds.rad.values,
        np.array(
            [[10.0, 6.0, 3.0], [10.0, 7.0, 3.0], [11.0, 11.0, 8.0]],
            dtype=target_ds.rad.dtype,
        ),
    )


def test_rectify_different_crs_chunked():
    source_ds = create_4x4_dataset_with_irregular_coords()
    source_ds = source_ds.chunk(dict(y=2, x=2))
    target_gm = GridMapping.regular(
        size=(3, 3), xy_min=(3600000, 3200000), xy_res=100000, crs="epsg:3035"
    )
    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)
    np.testing.assert_almost_equal(
        target_ds.x.values, np.array([3650000.0, 3750000.0, 3850000.0])
    )
    np.testing.assert_almost_equal(
        target_ds.y.values, np.array([3450000.0, 3350000.0, 3250000.0])
    )
    np.testing.assert_almost_equal(
        target_ds.rad.values,
        np.array(
            [[10.0, 6.0, 3.0], [10.0, 7.0, 3.0], [11.0, 11.0, 8.0]],
            dtype=target_ds.rad.dtype,
        ),
    )


def test_rectify_device_phase_a_matches_goldens(monkeypatch):
    """Forcing the device Phase A tier (XRTPU_PHASEA=device) on the CPU
    backend must reproduce the 13x13 nearest golden bit-for-bit — the
    whole-image scatter-min kernel picks the same first-writer-wins quad
    per pixel as the tiled host path."""
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    source_ds = create_2x2_dataset_with_irregular_coords()
    target_gm = GridMapping.regular(
        size=(13, 13), xy_min=(-0.25, 49.75), xy_res=0.5, crs=CRS_WGS84
    )
    target_ds = rectify_dataset(source_ds, target_gm=target_gm, interp_methods=0)
    lon, lat, rad = _assert_shape_and_dim(target_ds, (13, 13))
    np.testing.assert_almost_equal(rad.values, expected_rad_13x13(rad.dtype))

    # j-axis-up flips the offset/scale handed to the device kernel
    target_gm_up = GridMapping.regular(
        size=(13, 13), xy_min=(-0.25, 49.75), xy_res=0.5, crs=CRS_WGS84,
        is_j_axis_up=True,
    )
    target_up = rectify_dataset(
        source_ds, target_gm=target_gm_up, interp_methods=0
    )
    np.testing.assert_almost_equal(
        target_up.rad.values, expected_rad_13x13(target_up.rad.dtype)[::-1]
    )


def test_rectify_device_phase_a_matches_host_map_olci(monkeypatch):
    """Device vs host Phase A on a realistic irregular swath: identical
    winners and fractional coordinates (both tiers run float64 on CPU)."""
    from tests.sampledata import create_olci_like_swath

    from xcube_resampling_tpu.constants import UV_DELTA
    from xcube_resampling_tpu.ops import rectify_ops
    from xcube_resampling_tpu.rectify import _compute_target_source_ij

    ds = create_olci_like_swath(width=160, height=200, tile_size=64)
    source_gm = GridMapping.from_dataset(ds)
    target_gm = source_gm.to_regular(tile_size=64)

    monkeypatch.setenv("XRTPU_PHASEA", "host")
    host_map = _compute_target_source_ij(source_gm, target_gm, UV_DELTA)
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    dev_map = _compute_target_source_ij(source_gm, target_gm, UV_DELTA)
    # the device tier keeps the map device-resident; fetch for comparison
    assert isinstance(dev_map, rectify_ops.DeviceIJMap)
    assert dev_map.shape == host_map.shape
    dev_map = dev_map.as_numpy()

    assert np.array_equal(np.isnan(host_map), np.isnan(dev_map))
    # atol covers pure rounding noise of the grid-unit solve near u/v = 0
    np.testing.assert_allclose(
        dev_map, host_map, rtol=1e-9, atol=1e-9, equal_nan=True
    )


def test_phase_a_tier_cost_model():
    """Amortization-aware tier choice: a slow link keeps one-shot
    single-band jobs on the host tier; band reuse or a fast (PCIe-class)
    link sends the work to the device."""
    from xcube_resampling_tpu.rectify import _phase_a_auto_choice

    olci_swath = 1189 * 1890
    olci_target = 2926 * 2177
    # injected rate profile; the production path uses the per-process
    # calibration instead
    rates = dict(
        host_quad=6e6, host_gather=25e6, device_gather=4e8,
        device_fixed=0.1,
    )
    slow_link = dict(bw=35e6, rtt=0.05, rates=rates)  # a remote device
    pcie = dict(bw=8e9, rtt=2e-4, rates=rates)        # a local card

    assert _phase_a_auto_choice(1, olci_swath, olci_target, **slow_link) == "host"
    assert _phase_a_auto_choice(16, olci_swath, olci_target, **slow_link) == "device"
    assert _phase_a_auto_choice(1, olci_swath, olci_target, **pcie) == "device"
    assert _phase_a_auto_choice(16, olci_swath, olci_target, **pcie) == "device"


def test_engine_rate_calibration(monkeypatch):
    """The tier model measures host rates once per process (fallback
    constants only when the probes cannot run) and honours XRTPU_RATE_*
    overrides."""
    from xcube_resampling_tpu import rectify as r

    monkeypatch.setattr(r, "_ENGINE_RATES", {})
    rates = r._engine_rates()
    assert rates["host_quad"] > 0 and rates["host_gather"] > 0
    assert rates["device_gather"] == r._DEVICE_GATHER_RATE

    monkeypatch.setattr(r, "_ENGINE_RATES", {})
    monkeypatch.setenv("XRTPU_RATE_HOST_QUAD", "123.0")
    monkeypatch.setenv("XRTPU_RATE_DEVICE_FIXED", "0.5")
    rates = r._engine_rates()
    assert rates["host_quad"] == 123.0
    assert rates["device_fixed"] == 0.5


def test_phase_a_tier_env_override(monkeypatch):
    from xcube_resampling_tpu.rectify import _phase_a_tier

    monkeypatch.setenv("XRTPU_PHASEA", "host")
    assert _phase_a_tier(16, swath_px=100, target_px=100) == "host"
    monkeypatch.setenv("XRTPU_PHASEA", "device")
    assert _phase_a_tier(1, swath_px=100, target_px=100) == "device"
    # auto on the CPU test backend always stays on host
    monkeypatch.delenv("XRTPU_PHASEA")
    assert _phase_a_tier(16, swath_px=100, target_px=100) == "host"


def test_rectify_nan_edge_swath_end_to_end():
    # Real OLCI/SLSTR L2 swaths carry non-finite edge coordinates; both
    # grid-mapping inference AND rectification must survive them
    # (reference handles this via NaN-skipping scans, reference
    # gridmapping/bboxes.py:143-166).
    from tests.sampledata import create_olci_like_swath

    ds = create_olci_like_swath(width=64, height=48, tile_size=32)
    lon = np.asarray(ds.lon.data).copy()
    lat = np.asarray(ds.lat.data).copy()
    for jj, ii in ((0, 0), (0, 1), (1, 0), (-1, -1), (0, -1)):
        lon[jj, ii] = np.nan
        lat[jj, ii] = np.nan
    ds = ds.assign_coords(
        lon=DataArray(lon, dims=ds.lon.dims, attrs=ds.lon.attrs),
        lat=DataArray(lat, dims=ds.lat.dims, attrs=ds.lat.attrs),
    )
    gm = GridMapping.from_dataset(ds)
    assert np.isfinite(np.asarray(gm.xy_bbox, dtype=float)).all()

    out = rectify_dataset(ds)
    vals = np.asarray(out.rad.values)
    assert vals.ndim == 2
    # most of the grid rectifies; NaN-cornered pixels only thin the edges
    assert np.isfinite(vals).mean() > 0.5


def test_compressed_coord_upload_roundtrip():
    """Predictor + f16-residual coordinate staging reconstructs within
    the hybrid tier's f32 error class; unsuitable fields decline."""
    import jax.numpy as jnp

    from xcube_resampling_tpu.ops import rectify_ops as ops

    h, w = 190, 123
    j = np.arange(h, dtype=np.float64)[:, None]
    i = np.arange(w, dtype=np.float64)[None, :]
    gx = ((i + 0.12 * j + 2e-5 * j * i) * 1.02 + 7.3).astype(np.float32)
    packed = ops._compress_coords(gx, "test_resid")
    assert packed is not None
    coarse, resid = packed
    assert resid.dtype == np.float16
    assert coarse.nbytes + resid.nbytes < 0.6 * gx.nbytes
    recon = ops._coord_recon(gx.shape)
    rec = np.asarray(recon(jnp.asarray(coarse), jnp.asarray(resid)))
    assert np.abs(rec.astype(np.float64) - gx).max() < 5e-4

    # non-finite coordinates decline (NaN-edged swaths keep plain f32)
    gnan = gx.copy()
    gnan[0, 0] = np.nan
    assert ops._compress_coords(gnan, "test_resid2") is None

    # a field too rough for f16 residuals declines
    rough = np.random.default_rng(0).random((h, w)).astype(np.float32) * 99
    assert ops._compress_coords(rough, "test_resid3") is None
