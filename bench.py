"""Benchmark harness (BASELINE.json configs) on one GPU.

Prints one JSON line per run:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Headline metric: *sustained* bilinear reprojection throughput in Mpix/s on
one card — the 20480x20480 UTM->LAEA warp (419 Mpix in one dispatch,
BASELINE config #5's single-card analogue).  The reference publishes no
benchmark numbers (BASELINE.md); the only measured figures are its
example-notebook wall times, whose best sustained throughput is ~4.9
Mpix/s (6.4 Mpix rectified band in ~1.3 s,
examples/rectify_sentinel3.ipynb).  ``vs_baseline`` is computed against
that 4.9 Mpix/s figure.

The first line of standard output names the card and its power limit;
the headline JSON is the last.  Diagnostic lines (affine, coarsen,
rectify, the global mosaic) go to stderr.  A section that fails makes the
exit code non-zero.

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REFERENCE_MPIX_S = 4.9  # best sustained reference throughput (see docstring)


def _time_fn(fn, *args, warmup=2, iters=10, windows=3):
    """Seconds per call: *warmup* calls first (compiles included), then
    the best of *windows* windows of *iters* calls, each window ending in
    ``block_until_ready`` on the last output."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def bench_reproject_utm(log):
    """Headline (BASELINE metric): bilinear reproject EPSG:4326 -> UTM.

    Global 0.05 deg source grid, 4096x4096 @150 m UTM zone 32N target
    (central Europe).  Mild in-zone rotation keeps the separable-residual
    warp kernel in its fast regime."""
    import jax.numpy as jnp

    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.ops.reproject_ops import make_fused_reproject_fn
    from xcube_resampling_tpu.ops.srw import make_srw_reproject_fn

    src_w, src_h = 7200, 3600
    source_gm = GridMapping.regular(
        size=(src_w, src_h), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"
    )
    out_w = out_h = 4096
    target_gm = GridMapping.regular(
        size=(out_w, out_h),
        xy_min=(250000.0, 5200000.0),
        xy_res=150.0,
        crs="epsg:32632",
    )
    src = jnp.asarray(
        np.random.default_rng(0).random((src_h, src_w), dtype=np.float32)
    )
    results = {}
    for interp in ("bilinear", "nearest"):
        fn = make_srw_reproject_fn(source_gm, target_gm, interp, np.nan)
        kind = "srw"
        if fn is None:
            fn = make_fused_reproject_fn(source_gm, target_gm, interp, np.nan)
            kind = "gather"
        dt = _time_fn(fn, src)
        mpix_s = out_w * out_h / dt / 1e6
        results[interp] = mpix_s
        log(
            f"reproject 4326->UTM32N {interp} [{kind}]: "
            f"{mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)"
        )

    # 4-band batch through the same plan
    fn = make_srw_reproject_fn(source_gm, target_gm, "bilinear", np.nan)
    if fn is not None:
        batch = jnp.stack([src, src * 2, src * 3, src * 4])
        dt = _time_fn(fn, batch)
        mpix_s = 4 * out_w * out_h / dt / 1e6
        results["bilinear_batch4"] = mpix_s
        log(
            f"reproject 4326->UTM32N bilinear [srw, 4-band]: "
            f"{mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)"
        )

    # the exact tier (direct-gather semantics, XRTPU_EXACT=1 path)
    from xcube_resampling_tpu.ops.esw import make_esw_reproject_fn

    fn = make_esw_reproject_fn(source_gm, target_gm, "bilinear", np.nan)
    if fn is not None:
        dt = _time_fn(fn, src)
        mpix_s = out_w * out_h / dt / 1e6
        results["bilinear_exact"] = mpix_s
        log(
            f"reproject 4326->UTM32N bilinear [esw, exact]: "
            f"{mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)"
        )

    # severe rotation (45 deg warp past the two-pass gate): the exact
    # separable warp replaces the 20 Mpix/s gather fallback of round 1
    severe_gm = GridMapping.regular(
        size=(4096, 2048),
        xy_min=(900000.0, 900000.0),
        xy_res=875.0,
        crs="epsg:3035",
    )
    fn = make_esw_reproject_fn(source_gm, severe_gm, "bilinear", np.nan)
    if fn is not None:
        dt = _time_fn(fn, src)
        mpix_s = 4096 * 2048 / dt / 1e6
        results["bilinear_severe_exact"] = mpix_s
        log(
            f"reproject 4326->3035 severe-rotation bilinear [esw, exact]: "
            f"{mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)"
        )
    return results


def bench_reproject_global(log):
    """Config #3: global 0.05 deg EPSG:4326 grid -> EPSG:3035, bilinear."""
    import jax.numpy as jnp

    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.ops.reproject_ops import make_fused_reproject_fn

    src_w, src_h = 7200, 3600
    source_gm = GridMapping.regular(
        size=(src_w, src_h), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"
    )
    out_w = out_h = 4096
    target_gm = GridMapping.regular(
        size=(out_w, out_h),
        xy_min=(2000000.0, 1000000.0),
        xy_res=1500.0,
        crs="epsg:3035",
    )
    from xcube_resampling_tpu.ops.srw import make_srw_reproject_fn

    src = jnp.asarray(
        np.random.default_rng(0).random((src_h, src_w), dtype=np.float32)
    )
    results = {}
    for interp in ("bilinear", "nearest"):
        fn = make_srw_reproject_fn(source_gm, target_gm, interp, np.nan)
        kind = "srw"
        if fn is None:
            # the production dispatch routes this singular-warp config to
            # the exact ESW mosaic (measured in the mosaic section below);
            # the serialized gather here is a diagnostic floor, NOT the
            # engine's default path for this config
            fn = make_fused_reproject_fn(source_gm, target_gm, interp, np.nan)
            kind = "gather diagnostic — default dispatch is the esw-mosaic line"
        dt = _time_fn(fn, src)
        mpix_s = out_w * out_h / dt / 1e6
        results[interp] = mpix_s
        log(
            f"reproject 4326->3035 {interp} [{kind}]: "
            f"{mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)"
        )
    return results


def bench_global_mosaics(log):
    """Config #3 through the exact region mosaic (direct-gather semantics,
    ESW pieces + gather at the singular pieces): the tier the dispatch
    picks for this geometry.  Its one-time compile of a dozen group
    programs is set-up time, paid in the warm-up calls."""
    import jax.numpy as jnp

    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.ops.srw import make_region_reproject_fn

    src_w, src_h = 7200, 3600
    source_gm = GridMapping.regular(
        size=(src_w, src_h), xy_min=(-180.0, -90.0), xy_res=0.05, crs="epsg:4326"
    )
    out_w = out_h = 4096
    target_gm = GridMapping.regular(
        size=(out_w, out_h),
        xy_min=(2000000.0, 1000000.0),
        xy_res=1500.0,
        crs="epsg:3035",
    )
    src = jnp.asarray(
        np.random.default_rng(0).random((src_h, src_w), dtype=np.float32)
    )
    fn = make_region_reproject_fn(
        source_gm, target_gm, "bilinear", np.nan, exact=True
    )
    if fn is None:
        raise RuntimeError("the exact region mosaic did not plan")
    dt = _time_fn(fn, src, warmup=1, iters=5)
    mpix_s = out_w * out_h / dt / 1e6
    log(
        f"reproject 4326->3035 bilinear [esw-mosaic, exact]: "
        f"{mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)"
    )
    return mpix_s


def bench_affine(log):
    """Config #1: affine bilinear 2x downscale of a 1024x1024 float32."""
    import jax
    import jax.numpy as jnp

    from xcube_resampling_tpu.ops import coarsen_ops, gather

    # 16-band batch
    src = jnp.asarray(
        np.random.default_rng(0).random((16, 1024, 1024), dtype=np.float32)
    )

    def downscale(a):
        up = gather.affine_gather(
            a, 1.0, 1.0, 0.0, 0.0, 1024, 1024, 1, np.nan, xp=jnp
        )
        return coarsen_ops.coarsen_jax(up, 2, 2, "mean")

    fn = jax.jit(downscale)
    dt = _time_fn(fn, src)
    mpix_s = 16 * 1024 * 1024 / dt / 1e6
    log(f"affine 2x downscale 16x1024^2: {mpix_s:.1f} Mpix/s ({dt*1e3:.3f} ms)")
    return mpix_s


def bench_coarsen(log):
    """Config #2: coarsen aggregation of a 4-band 4096x4096 raster, 4x."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from xcube_resampling_tpu.ops import coarsen_ops

    src = jnp.asarray(
        np.random.default_rng(0).random((4, 4096, 4096), dtype=np.float32)
    )
    src_int = jnp.asarray(
        np.random.default_rng(0).integers(0, 16, (4, 4096, 4096), dtype=np.int32)
    )
    out = {}
    for agg, data in (("mean", src), ("first", src), ("mode", src_int)):
        fn = jax.jit(partial(coarsen_ops.coarsen_jax, j_div=4, i_div=4, agg_name=agg))
        dt = _time_fn(fn, data)
        mpix_s = 4 * 4096 * 4096 / dt / 1e6
        out[agg] = mpix_s
        log(f"coarsen 4x {agg} 4-band 4096^2: {mpix_s:.1f} Mpix/s ({dt*1e3:.2f} ms)")
    return out


def bench_rectify(log):
    """Config #4: rectify a synthetic OLCI-like swath to a regular grid.

    Phase A (inverse pixel lookup) runs once per geometry — on the
    device via the hybrid stencil kernel (ops/rectify_ops.py) with the map
    kept device-resident; per-band Phase B gathers stream through it on
    the device.  OLCI products have ~17 bands sharing one geometry, so both
    the single-geometry amortized number and the per-band throughput
    matter (reference workflow: rectify_sentinel3 notebook)."""
    import jax
    import jax.numpy as jnp

    from tests.sampledata import create_olci_like_swath

    from xcube_resampling_tpu.constants import UV_DELTA
    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.ops import rectify_ops
    from xcube_resampling_tpu.rectify import (
        _compute_target_source_ij,
        rectify_dataset,
    )

    ds = create_olci_like_swath(width=1189, height=1890, tile_size=512)

    # end-to-end single-band path (device tiers picked automatically),
    # with warm re-runs (the first call pays one-time import/JIT/native-
    # load costs that a multi-product pipeline amortizes away); the
    # full-image host fetch is timed separately
    def _sync(arr):
        jax.block_until_ready(getattr(arr, "data", arr))

    t0 = time.perf_counter()
    out = rectify_dataset(ds, interp_methods=0)
    _sync(out.rad)
    dt_cold = time.perf_counter() - t0
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = rectify_dataset(ds, interp_methods=0)
        _sync(out.rad)
        dt = min(dt, time.perf_counter() - t0)
    t0 = time.perf_counter()
    _ = out.rad.values
    dt_fetch = time.perf_counter() - t0
    npix = out.rad.shape[-2] * out.rad.shape[-1]
    log(
        f"rectify e2e single-band -> {out.rad.shape}: "
        f"{npix / dt / 1e6:.1f} Mpix/s ({dt:.2f} s warm, {dt_cold:.2f} s "
        f"cold, +{dt_fetch:.2f} s fetch)"
    )

    # host tier for comparison: single-band products amortize nothing, so
    # the C++ Phase A + host gather can win where a device round trip is
    # expensive; multi-band (the OLCI norm) belongs to the device tier
    # below
    os.environ["XRTPU_PHASEA"] = "host"
    try:
        rectify_dataset(ds, interp_methods=0)  # warm native load + pages
        dt_h = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out_h = rectify_dataset(ds, interp_methods=0)
            _sync(out_h.rad)
            dt_h = min(dt_h, time.perf_counter() - t0)
        log(
            f"rectify e2e single-band [host tier]: "
            f"{npix / dt_h / 1e6:.1f} Mpix/s ({dt_h:.2f} s warm)"
        )
    finally:
        del os.environ["XRTPU_PHASEA"]

    source_gm = GridMapping.from_dataset(ds)
    target_gm = source_gm.to_regular(tile_size=512)

    # Phase A alone, warm (best of 3)
    dt_a = float("inf")
    for _i in range(3):
        t0 = time.perf_counter()
        ij_map = _compute_target_source_ij(source_gm, target_gm, UV_DELTA)
        if isinstance(ij_map, rectify_ops.DeviceIJMap):
            jax.block_until_ready(ij_map.device_map())
        dt_a = min(dt_a, time.perf_counter() - t0)
    tier = (
        "device" if isinstance(ij_map, rectify_ops.DeviceIJMap) else "host"
    )

    bands = jnp.asarray(
        np.broadcast_to(
            ds.rad.values[np.newaxis], (16,) + ds.rad.values.shape
        ).copy()
    )
    total_pix = 16 * npix
    rates = {}
    for interp in ("nearest", "bilinear", "triangular"):
        if isinstance(ij_map, rectify_ops.DeviceIJMap):
            fn = rectify_ops.make_device_var_image_fn_resident(
                ij_map, np.nan, interp
            )
        else:
            fn = rectify_ops.make_device_var_image_fn(
                ij_map, ds.rad.values.shape, np.nan, interp
            )
        dt_b = _time_fn(fn, bands)
        rates[interp] = dt_b
        log(
            f"rectify device phase B 16 bands {interp}: "
            f"{total_pix / dt_b / 1e6:.1f} Mpix/s"
        )
    dt_b = rates["nearest"]
    amortized_16 = total_pix / (dt_a + dt_b) / 1e6
    amortized_1 = npix / (dt_a + dt_b / 16) / 1e6
    log(
        f"rectify phase A ({tier}, once): {dt_a:.2f} s; amortized "
        f"nearest: {amortized_1:.1f} Mpix/s single-band, "
        f"{amortized_16:.1f} Mpix/s 16-band"
    )

    # Phase A with the coordinate arrays already device-resident — the
    # multi-product streaming case, without the coordinate upload
    if isinstance(ij_map, rectify_ops.DeviceIJMap):
        x1, y1, x2, y2 = target_gm.xy_bbox
        swath = np.asarray(source_gm.xy_coords.data, dtype=np.float64)
        gx = jnp.asarray(
            (swath[0] - x1) / target_gm.x_res, dtype=jnp.float32
        )
        gy = jnp.asarray(
            (swath[1] - y2) / -target_gm.y_res, dtype=jnp.float32
        )
        jax.block_until_ready((gx, gy))  # coords resident
        seeds = list(rectify_ops._HYBRID_SEED_JIT.values())
        denses = list(rectify_ops._HYBRID_DENSE_JIT.values())
        if seeds and denses:
            seed, dense = seeds[-1], denses[-1]

            def _resident_phase_a(gx, gy):
                cqj, cqi, meta = seed(gx, gy)
                return dense(gx, gy, cqj, cqi)

            dt_ar = _time_fn(_resident_phase_a, gx, gy, warmup=1, iters=3)
            amortized_16r = total_pix / (dt_ar + dt_b) / 1e6
            log(
                f"rectify phase A (device, coords resident): "
                f"{dt_ar*1e3:.0f} ms; amortized 16-band nearest: "
                f"{amortized_16r:.1f} Mpix/s"
            )
    return amortized_16


def bench_reproject_20k(log):
    """Config #5 analogue on one card: 20k x 20k single-band reproject
    (UTM zone 32N -> EPSG:3035), memory-resident (~5 GB working set).
    The multi-card version of this config is the sharded halo path
    (parallel/halo.py, ``chip_smoke.py --multi``)."""
    import jax.numpy as jnp

    from xcube_resampling_tpu.gridmapping import GridMapping
    from xcube_resampling_tpu.ops.reproject_ops import make_fused_reproject_fn
    from xcube_resampling_tpu.ops.srw import make_srw_reproject_fn

    n = 20480
    source_gm = GridMapping.regular(
        size=(n, n), xy_min=(300000.0, 5200000.0), xy_res=30.0,
        crs="epsg:32632",
    )
    target_gm = GridMapping.regular(
        size=(n, n), xy_min=(4050000.0, 2650000.0), xy_res=30.0,
        crs="epsg:3035",
    )
    fn = make_srw_reproject_fn(source_gm, target_gm, "bilinear", np.nan)
    kind = "srw"
    if fn is None:
        fn = make_fused_reproject_fn(source_gm, target_gm, "bilinear", np.nan)
        kind = "gather"
    src = jnp.asarray(
        np.random.default_rng(0).random((n, n), dtype=np.float32)
    )
    dt = _time_fn(fn, src, warmup=1, iters=3)
    mpix_s = n * n / dt / 1e6
    log(
        f"reproject 20k x 20k UTM32N->3035 bilinear [{kind}]: "
        f"{mpix_s:.1f} Mpix/s ({dt*1e3:.1f} ms, {n*n/1e6:.0f} Mpix)"
    )
    return mpix_s


def main() -> int:
    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from chip_smoke import nvidia_smi

    print(f"card: {nvidia_smi()}", flush=True)  # before JAX takes the card
    import jax

    from xcube_resampling_tpu.compile_cache import use_compile_cache

    log(f"compile cache: {use_compile_cache(root)}")
    log(f"devices: {jax.devices()}")
    if jax.default_backend() != "gpu":
        log(f"no GPU: JAX's default backend is {jax.default_backend()!r}")
        return 2

    failed = []

    def section(name, fn):
        try:
            return fn(log)
        except Exception as e:  # noqa: BLE001 - reported, and fails the run
            log(f"{name} bench failed: {e!r}")
            failed.append(name)
            return None

    section("utm reproject", bench_reproject_utm)
    value = section("20k reproject", bench_reproject_20k)
    section("affine", bench_affine)
    section("coarsen", bench_coarsen)
    section("global reproject", bench_reproject_global)
    section("rectify", bench_rectify)
    log("global mosaic: the exact region mosaic's compile did not finish "
        "within 1230 s on an H100; this section runs last and may not end")
    section("global mosaic", bench_global_mosaics)

    # per-phase breakdown of everything the engines did during this run
    # (rectify/reproject/affine phases; see profiling.py)
    from xcube_resampling_tpu.profiling import GLOBAL_TIMER

    if GLOBAL_TIMER.totals:
        log("engine phase breakdown:")
        for line in GLOBAL_TIMER.report().splitlines():
            log("  " + line)
    if value is not None:
        print(json.dumps({
            "metric": "reproject_bilinear_sustained_mpix_per_s_per_chip",
            "value": round(float(value), 1),
            "unit": "Mpix/s",
            "vs_baseline": round(float(value) / REFERENCE_MPIX_S, 1),
        }), flush=True)
    if failed:
        log(f"failed sections: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
