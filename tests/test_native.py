"""Native C++ host kernels: availability and parity with the numpy
semantics-reference implementation."""

import os

import numpy as np
import pytest

from xcube_resampling_tpu.constants import UV_DELTA
from xcube_resampling_tpu.native import inverse_ij_map_native, native_available
from xcube_resampling_tpu.ops import rectify_ops


def _swath(h, w, seed=0):
    r = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    lon = 1.0 * ii - 0.4 * jj + 0.05 * r.random((h, w))
    lat = 56.0 - 1.0 * jj - 0.2 * ii + 0.05 * r.random((h, w))
    return lon.astype(np.float64), lat.astype(np.float64)


pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable (no g++?)"
)


def _numpy_reference(*args):
    """Run the vectorized numpy Phase A with the native path disabled."""
    os.environ["XRTPU_NO_NATIVE"] = "1"
    try:
        import xcube_resampling_tpu.native as nat

        lib, tried = nat._lib, nat._tried
        nat._lib, nat._tried = None, True
        try:
            return rectify_ops.inverse_ij_map(*args)
        finally:
            nat._lib, nat._tried = lib, tried
    finally:
        os.environ.pop("XRTPU_NO_NATIVE", None)


def test_native_phase_a_parity_random_swath():
    src_x, src_y = _swath(7, 9)
    args = (src_x, src_y, 3, 5, (25, 30), -4.0, 57.0, 0.5, -0.5, UV_DELTA)
    ref = _numpy_reference(*args)
    nat = inverse_ij_map_native(*args)
    np.testing.assert_array_equal(nat, ref)


def test_native_phase_a_parity_2x2():
    lon = np.array([[1.0, 6.0], [0.0, 2.0]])
    lat = np.array([[56.0, 53.0], [52.0, 50.0]])
    args = (lon, lat, 0, 0, (13, 13), -0.25, 56.25, 0.5, -0.5, UV_DELTA)
    ref = _numpy_reference(*args)
    nat = inverse_ij_map_native(*args)
    np.testing.assert_array_equal(nat, ref)


def test_native_phase_a_strided_view_matches_contiguous():
    """Row-sliced swath windows pass to the kernel without a copy (row
    stride parameter); the result must equal the contiguous-copy call."""
    src_x, src_y = _swath(12, 14)
    vx = src_x[3:9, 2:11]
    vy = src_y[3:9, 2:11]
    assert not vx.flags.c_contiguous
    args_tail = (2, 3, (25, 30), -4.0, 57.0, 0.5, -0.5, UV_DELTA)
    nat_view = inverse_ij_map_native(vx, vy, *args_tail)
    nat_copy = inverse_ij_map_native(
        np.ascontiguousarray(vx), np.ascontiguousarray(vy), *args_tail
    )
    np.testing.assert_array_equal(nat_view, nat_copy)


def test_native_phase_b_parity_swath_gather():
    """C++ Phase B gather equals the vectorized numpy gather bit-for-bit
    on float32/float64 sources for every interpolation."""
    from xcube_resampling_tpu import native as nat

    rng = np.random.default_rng(3)
    ij = np.empty((2, 21, 17))
    ij[0] = rng.random((21, 17)) * 13
    ij[1] = rng.random((21, 17)) * 9
    ij[0, 4, 4] = np.nan
    ij[1, 2, 9] = np.nan
    for dt in (np.float32, np.float64):
        src = rng.random((2, 10, 14)).astype(dt)
        src[0, 3, 3] = np.nan
        for interp in ("nearest", "triangular", "bilinear"):
            got = nat.var_image_gather_native(src, ij, np.nan, interp, dt)
            assert got is not None
            lib, tried = nat._lib, nat._tried
            nat._lib, nat._tried = None, True
            try:
                ref = rectify_ops.var_image_from_ij_map(
                    src, ij, np.nan, interp, dt
                )
            finally:
                nat._lib, nat._tried = lib, tried
            np.testing.assert_array_equal(got, ref)


def test_native_phase_a_handles_nans():
    src_x, src_y = _swath(6, 6)
    src_x[2, 3] = np.nan
    src_y[4, 1] = np.nan
    args = (src_x, src_y, 0, 0, (20, 20), -2.0, 57.0, 0.5, -0.5, UV_DELTA)
    ref = _numpy_reference(*args)
    nat = inverse_ij_map_native(*args)
    np.testing.assert_array_equal(nat, ref)


def test_native_mt_bit_identical_across_thread_counts():
    """The multi-threaded Phase A (min-quad-rank merge of per-thread row
    blocks) must be bit-identical to the sequential kernel for any thread
    count — the determinism contract of the native tier."""
    import ctypes

    from xcube_resampling_tpu.constants import UV_DELTA
    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.native import get_lib

    from .sampledata import create_olci_like_swath

    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")

    ds = create_olci_like_swath(width=160, height=240, tile_size=512)
    source_gm = GridMapping.from_dataset(ds)
    target_gm = source_gm.to_regular(tile_size=512)
    src_xy = np.asarray(source_gm.xy_coords.data, dtype=np.float64)
    dst_h, dst_w = target_gm.height, target_gm.width
    x_min, _, _, y_max = target_gm.xy_bbox
    dbl_p = ctypes.POINTER(ctypes.c_double)
    sx = np.ascontiguousarray(src_xy[0])
    sy = np.ascontiguousarray(src_xy[1])
    args = (
        sx.ctypes.data_as(dbl_p), sy.ctypes.data_as(dbl_p),
        sx.shape[0], sx.shape[1], sx.shape[1], 0, 0, dst_h, dst_w,
        float(x_min), float(y_max), float(target_gm.x_res),
        float(-target_gm.y_res), UV_DELTA,
    )

    ref = np.full((2, dst_h, dst_w), np.nan, np.float64)
    lib.inverse_ij_map_f64(*args, ref.ctypes.data_as(dbl_p))
    for n_threads in (1, 3, 7):
        out = np.full((2, dst_h, dst_w), np.nan, np.float64)
        lib.inverse_ij_map_f64_mt(
            *args, out.ctypes.data_as(dbl_p), n_threads
        )
        np.testing.assert_array_equal(
            np.nan_to_num(out, nan=-9e9), np.nan_to_num(ref, nan=-9e9)
        )


def test_native_phase_b_fuzz_matches_numpy():
    """Fuzz the C++ Phase B gather against the numpy path: random maps
    (with NaN cells and exact-integer/edge indices), f32/f64 sources with
    NaN taps, finite and NaN fills, all interpolations."""
    from xcube_resampling_tpu import native as nat

    rng = np.random.default_rng(11)
    for trial in range(12):
        sh, sw = int(rng.integers(2, 40)), int(rng.integers(2, 40))
        dh, dw = int(rng.integers(1, 35)), int(rng.integers(1, 35))
        dt = np.float32 if trial % 2 else np.float64
        interp = ("nearest", "triangular", "bilinear")[trial % 3]
        fill = np.nan if trial % 4 else -9.0
        bands = () if trial % 5 else (3,)
        src = rng.random(bands + (sh, sw)).astype(dt)
        src[(np.s_[...],) + tuple(rng.integers(0, d) for d in (sh, sw))] = np.nan
        ij = np.empty((2, dh, dw))
        ij[0] = rng.random((dh, dw)) * (sw - 1)
        ij[1] = rng.random((dh, dw)) * (sh - 1)
        ij[:, rng.random((dh, dw)) < 0.1] = np.nan
        ij[0].flat[0] = float(sw - 1)  # exact max index
        ij[1].flat[0] = float(sh - 1)
        got = nat.var_image_gather_native(src, ij, fill, interp, dt)
        assert got is not None
        lib, tried = nat._lib, nat._tried
        nat._lib, nat._tried = None, True
        try:
            ref = rectify_ops.var_image_from_ij_map(src, ij, fill, interp, dt)
        finally:
            nat._lib, nat._tried = lib, tried
        np.testing.assert_array_equal(got, ref, err_msg=f"trial {trial}")


def test_library_built_on_another_host_is_rebuilt(monkeypatch, tmp_path):
    """The library's file name is keyed on the build host's CPU: a copy
    built elsewhere sits under a foreign key and is never loaded — this
    host builds and loads its own."""
    import xcube_resampling_tpu.native as nat

    monkeypatch.setattr(nat, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_host_cpu_id", lambda: "another host's cpu")
    foreign = nat._library_path()
    foreign.write_bytes(b"not a library for this host")
    monkeypatch.undo()

    monkeypatch.setattr(nat, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", False)
    local = nat._library_path()
    assert local != foreign and not local.exists()
    assert nat.get_lib() is not None
    assert local.is_file()
    assert foreign.read_bytes() == b"not a library for this host"
