"""Reproject engine goldens (port of reference tests/test_reproject.py:
UTM <-> LAEA <-> geographic at equal/finer/coarser resolutions, j-axis-up
on both sides, chunked 3D case, NotImplementedError for cubic)."""

import numpy as np
import pytest

from xcube_resampling_tpu.crs import CRS, CRS_WGS84
from xcube_resampling_tpu.gridmapping import GridMapping
from xcube_resampling_tpu.reproject import reproject_dataset

from .sampledata import (
    create_2x5x5_dataset_regular_utm,
    create_5x5_dataset_regular_utm,
    create_large_dataset_for_reproject,
)


def test_reproject_target_gm():
    source_ds = create_5x5_dataset_regular_utm()

    # projected CRS, similar resolution
    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(4320080, 3382480), xy_res=80, crs="epsg:3035"
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [1, 1, 2, 3, 4],
                [6, 6, 7, 8, 9],
                [11, 12, 12, 13, 14],
                [16, 17, 17, 18, 19],
                [21, 17, 17, 18, 19],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_target_gm_3d():
    source_ds = create_2x5x5_dataset_regular_utm()

    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(4320080, 3382480), xy_res=80, crs="epsg:3035"
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    assert set(source_ds.variables) == set(target_ds.variables)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [
                    [1, 1, 2, 3, 4],
                    [6, 6, 7, 8, 9],
                    [11, 12, 12, 13, 14],
                    [16, 17, 17, 18, 19],
                    [21, 17, 17, 18, 19],
                ],
                [
                    [1, 1, 2, 3, 4],
                    [6, 6, 7, 8, 9],
                    [11, 12, 12, 13, 14],
                    [16, 17, 17, 18, 19],
                    [21, 17, 17, 18, 19],
                ],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_target_gm_j_axis_up():
    source_ds = create_5x5_dataset_regular_utm()
    target_gm = GridMapping.regular(
        size=(5, 5),
        xy_min=(4320080, 3382480),
        xy_res=80,
        crs="epsg:3035",
        is_j_axis_up=True,
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [21, 17, 17, 18, 19],
                [16, 17, 17, 18, 19],
                [11, 12, 12, 13, 14],
                [6, 6, 7, 8, 9],
                [1, 1, 2, 3, 4],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_source_gm_j_axis_up():
    source_ds = create_5x5_dataset_regular_utm()
    source_ds = source_ds.isel(y=slice(None, None, -1))
    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(4320080, 3382480), xy_res=80, crs="epsg:3035"
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [1, 1, 2, 3, 4],
                [6, 6, 7, 8, 9],
                [11, 12, 12, 13, 14],
                [16, 17, 17, 18, 19],
                [21, 17, 17, 18, 19],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_target_gm_finer_res():
    source_ds = create_5x5_dataset_regular_utm()
    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(4320080, 3382480), xy_res=20, crs="epsg:3035"
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [15, 16, 16, 16, 16],
                [15, 16, 16, 16, 16],
                [15, 16, 16, 16, 16],
                [20, 21, 21, 21, 21],
                [20, 21, 21, 21, 21],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_target_gm_coarser_res():
    source_ds = create_5x5_dataset_regular_utm()
    target_gm = GridMapping.regular(
        size=(3, 3), xy_min=(4320050, 3382500), xy_res=120, crs="epsg:3035"
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [0, 1, 2],
                [5, 6, 7],
                [15, 16, 17],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_target_gm_geographic_crs():
    source_ds = create_5x5_dataset_regular_utm()
    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(9.9886, 53.5499), xy_res=0.0006, crs=CRS_WGS84
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [7, 8, 8, 8, 9],
                [12, 13, 13, 13, 14],
                [12, 13, 13, 13, 14],
                [17, 18, 18, 18, 19],
                [22, 23, 23, 23, 24],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_target_gm_geographic_crs_fine_res():
    source_ds = create_5x5_dataset_regular_utm()

    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(9.9886, 53.5499), xy_res=0.0003, crs=CRS_WGS84
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    np.testing.assert_almost_equal(
        target_ds.band_1.values,
        np.array(
            [
                [12, 12, 12, 13, 13],
                [17, 17, 17, 18, 18],
                [17, 17, 17, 18, 18],
                [22, 17, 17, 18, 18],
                [22, 22, 22, 23, 23],
            ],
            dtype=target_ds.band_1.dtype,
        ),
    )


def test_reproject_complex_chunked_array():
    source_ds = create_large_dataset_for_reproject()
    target_gm = GridMapping.regular(
        size=(10, 10),
        xy_min=(6.0, 48.0),
        xy_res=0.2,
        crs=CRS_WGS84,
        tile_size=(5, 5),
    )

    target_ds = reproject_dataset(source_ds, target_gm, interp_methods="triangular")
    assert sorted(["temperature", "onedim_data"]) == sorted(target_ds.data_vars)
    assert target_ds.temperature.values[0, 0, 0] == pytest.approx(6353.582, abs=5e-4)
    assert target_ds.temperature.values[0, -1, -1] == pytest.approx(
        3007.1228, abs=5e-4
    )
    assert [2, 5, 5] == [
        target_ds.temperature.chunksizes["time"][0],
        target_ds.temperature.chunksizes["lat"][0],
        target_ds.temperature.chunksizes["lon"][0],
    ]

    target_ds = reproject_dataset(source_ds, target_gm, interp_methods=1)
    assert sorted(["temperature", "onedim_data"]) == sorted(target_ds.data_vars)
    assert target_ds.temperature.values[0, 0, 0] == pytest.approx(6353.5823, abs=5e-4)
    assert target_ds.temperature.values[0, -1, -1] == pytest.approx(
        3007.1228, abs=5e-4
    )
    assert [2, 5, 5] == [
        target_ds.temperature.chunksizes["time"][0],
        target_ds.temperature.chunksizes["lat"][0],
        target_ds.temperature.chunksizes["lon"][0],
    ]


def test_reproject_raise_not_implemented():
    source_ds = create_5x5_dataset_regular_utm()
    target_gm = GridMapping.regular(
        size=(5, 5), xy_min=(4320080, 3382480), xy_res=20, crs="epsg:3035"
    )
    with pytest.raises(NotImplementedError) as excinfo:
        reproject_dataset(source_ds, target_gm, interp_methods="cubic")
    assert (
        "interp_methods must be one of 0, 1, 'nearest', 'bilinear', 'triangular'"
        in str(excinfo.value)
    )


@pytest.mark.slow
def test_engine_fast_extreme_warp_env(monkeypatch):
    """XRTPU_FAST_EXTREME_WARP=1 routes device-backed extreme warps through
    the region-decomposed SRW path inside the engine."""
    import jax.numpy as jnp

    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.reproject import _device_reproject_fn

    src_gm = GridMapping.regular(
        size=(360, 180), xy_min=(-180, -90), xy_res=1.0, crs="EPSG:4326"
    )
    tgt_gm = GridMapping.regular(
        size=(128, 128), xy_min=(900000.0, 900000.0), xy_res=40000.0,
        crs="EPSG:3035",
    )
    data = jnp.asarray(
        np.linspace(0, 1, 360 * 180, dtype=np.float32).reshape(180, 360)
    )
    _, base_fn = _device_reproject_fn(src_gm, tgt_gm, "bilinear", np.nan)
    base = np.asarray(base_fn(data))
    monkeypatch.setenv("XRTPU_FAST_EXTREME_WARP", "1")
    tier, fast_fn = _device_reproject_fn(src_gm, tgt_gm, "bilinear", np.nan)
    assert tier == "region-srw"
    fast = np.asarray(fast_fn(data))
    both = ~np.isnan(base) & ~np.isnan(fast)
    assert both.mean() > 0.9
    # smooth input: the two paths agree to the documented tolerance
    np.testing.assert_allclose(fast[both], base[both], atol=2e-2)


def test_reproject_no_overlap_raises_early():
    # A disjoint target grid must fail with a clear message, not the
    # downstream "cannot find any grid mapping in dataset" (the reference
    # fails the confusing way, reference utils.py:119-124 -> downstream)
    source_ds = create_5x5_dataset_regular_utm()
    target_gm = GridMapping.regular(
        size=(4, 4), xy_min=(900000, 900000), xy_res=10, crs="epsg:3035"
    )
    with pytest.raises(ValueError, match="does not overlap the source extent"):
        reproject_dataset(source_ds, target_gm)


def test_reproject_downscale_with_2d_aux_coords():
    # Downscale path over a dataset carrying 2D lat/lon aux coords (the
    # reference's flagship CF fixture shape): the resampled 2D coord
    # images must not take down the grid-mapping re-inference inside
    # _maybe_downscale (reproject.py), however NaN-edged they come out.
    from .sampledata import create_s2plus_dataset

    source_ds = create_s2plus_dataset()
    source_gm = GridMapping.from_dataset(source_ds)
    from xcube_resampling_tpu.crs import Transformer

    fwd = Transformer.from_crs(source_gm.crs, "epsg:3035", always_xy=True)
    b = fwd.transform_bounds(*source_gm.xy_bbox)
    # coarser-than-source target slightly larger than the source extent
    target_gm = GridMapping.regular(
        size=(6, 6), xy_min=(b[0] - 40, b[1] - 40), xy_res=25.0,
        crs="epsg:3035",
    )
    target_ds = reproject_dataset(source_ds, target_gm)
    assert "rrs_443" in target_ds
    assert target_ds.rrs_443.shape == (6, 6)
    vals = np.asarray(target_ds.rrs_443.values)
    assert np.isfinite(vals).any()
