#!/usr/bin/env python3
"""Smoke test of the regridding main path on one GPU.

Drives ``resample_in_space`` through every engine at the sizes of the
repository's benchmark configurations (bench.py), with inputs that are
``xrlite.Dataset``s of device arrays, and holds every result to a stated
tolerance against the float64 host path or the plain gather kernel on the
card.  Each phase prints one line: the tier the dispatch chose, the cold
(first-call, compiles included) and warm seconds, the compiles it caused,
the largest error against its tolerance and the reason for that
tolerance, and the platform of the output's device.

    python chip_smoke.py [--seed N]     # one GPU, every phase
    python chip_smoke.py --multi        # four GPUs: the sharded paths only

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script exits non-zero, without that line, when JAX finds no GPU, when
a phase raises, when a comparison fails, or when a phase ran on the host
where it should have run on the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the one bench geometry per engine (bench.py), as (size, xy_min, res, crs)
MILD_SOURCE = ((300000.0, 5200000.0), 30.0, "epsg:32632")
MILD_TARGET = ((4050000.0, 2650000.0), 30.0, "epsg:3035")
GLOBAL_SOURCE = ((7200, 3600), (-180.0, -90.0), 0.05, "epsg:4326")
ROTATED_TARGET = ((4096, 2048), (900000.0, 900000.0), 875.0, "epsg:3035")
GLOBAL_TARGET = ((4096, 4096), (2000000.0, 1000000.0), 1500.0, "epsg:3035")

# position tolerances (px) behind the value tolerances below
SRW_POS_TOL = 0.1  # SRW ~0.05 px of a direct gather + <1e-2 px coordinate
#                    field + the host path's float32 window origins
EXACT_POS_TOL = 0.05  # <1e-2 px coordinate field + float32 window origins


class SmokeFailure(AssertionError):
    """A phase ran on the wrong device or missed its tolerance."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- environment ------------------------------------------------------------


@contextlib.contextmanager
def env_vars(**values):
    """Set environment variables for the enclosed block, then restore."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def nvidia_smi() -> str:
    """``name, power.limit`` of each card, read before JAX starts."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if res.returncode != 0:
        return f"nvidia-smi failed (rc {res.returncode})"
    return "; ".join(line.strip() for line in res.stdout.splitlines())


def import_package():
    """The package next to this script, never an installed copy."""
    sys.path.insert(0, str(ROOT))
    import xcube_resampling_tpu as pkg

    here = Path(pkg.__file__).resolve().parent.parent
    if here != ROOT:
        raise SystemExit(f"xcube_resampling_tpu found at {here}, not {ROOT}")
    return pkg


class CompileCounter:
    """Counts XLA backend compiles (and their seconds) through JAX's
    monitoring events; :meth:`take` returns and resets the tally."""

    _EVENT = "/jax/core/compile/backend_compile_duration"
    _instance = None

    def __init__(self):
        self.count, self.seconds = 0, 0.0

    @classmethod
    def get(cls) -> "CompileCounter":
        if cls._instance is None:
            import jax

            cls._instance = cls()
            jax.monitoring.register_event_duration_secs_listener(
                cls._instance._on_event
            )
        return cls._instance

    def _on_event(self, event, duration, **_kw):
        if event == self._EVENT:
            self.count += 1
            self.seconds += duration

    def take(self) -> tuple[int, float]:
        out = (self.count, self.seconds)
        self.count, self.seconds = 0, 0.0
        return out


# -- data -------------------------------------------------------------------


def smooth_field(rng, shape, min_wavelength=40.0):
    """A smooth float32 field of *shape* (..., h, w) — a sum of three
    separable sinusoids per leading slice — and a bound on how much it
    changes per pixel step (the sum over terms of amplitude times the two
    angular wavenumbers), from which the value tolerances follow."""
    *lead, h, w = shape
    n_lead = int(np.prod(lead)) if lead else 1
    out = np.empty((n_lead, h, w), np.float32)
    jj = np.arange(h, dtype=np.float64)
    ii = np.arange(w, dtype=np.float64)
    grad = 0.0
    for b in range(n_lead):
        out[b] = rng.uniform(0.0, 1.0)
        bound = 0.0
        for _ in range(3):
            amp = rng.uniform(0.1, 0.3)
            kw, kj = 2 * np.pi / rng.uniform(min_wavelength, 8 * min_wavelength, 2)
            row = np.sin(kw * ii + rng.uniform(0, 2 * np.pi)).astype(np.float32)
            col = np.cos(kj * jj + rng.uniform(0, 2 * np.pi)).astype(np.float32)
            out[b] += np.float32(amp) * np.outer(col, row)
            bound += amp * (kw + kj)
        grad = max(grad, bound)
    return out.reshape(shape), grad


def regular_gm(size, xy_min, res, crs, scale=1):
    """A bench grid, or the same extent at *scale* times coarser pixels."""
    from xcube_resampling_tpu import GridMapping

    w, h = (size, size) if np.isscalar(size) else size
    return GridMapping.regular(
        size=(w // scale, h // scale), xy_min=xy_min, xy_res=res * scale,
        crs=crs, tile_size=512,
    )


def window_gm(gm, r0, c0, h, w):
    """Rows r0:r0+h, columns c0:c0+w of the regular (j-down) *gm*."""
    from xcube_resampling_tpu import GridMapping

    x_res, y_res = gm.xy_res
    x_min, y_min = gm.xy_bbox[0], gm.xy_bbox[1]
    return GridMapping.regular(
        size=(w, h),
        xy_min=(x_min + c0 * x_res, y_min + (gm.height - r0 - h) * y_res),
        xy_res=(x_res, y_res), crs=gm.crs,
    )


def dataset(gm, arrays):
    """An ``xrlite.Dataset`` on the grid of *gm* holding *arrays*
    (name -> (..., h, w) array, numpy or device)."""
    from xcube_resampling_tpu import DataArray, Dataset

    yx = (gm.xy_dim_names[1], gm.xy_dim_names[0])
    data_vars = {
        name: DataArray(a, dims=(("band",) if a.ndim == 3 else ()) + yx)
        for name, a in arrays.items()
    }
    return Dataset(data_vars, coords=gm.to_coords())


# -- measurement ------------------------------------------------------------


def block(result):
    import jax

    if hasattr(result, "data_vars"):
        for var in result.data_vars.values():
            jax.block_until_ready(var.data)
    else:
        jax.block_until_ready(result)
    return result


def timed(call, warm_runs=2):
    """``(result, cold_s, warm_s, n_compiles, compile_s)``: cold is the
    first call, compiles included; warm the best of *warm_runs* more."""
    counter = CompileCounter.get()
    counter.take()
    t0 = time.perf_counter()
    result = block(call())
    cold = time.perf_counter() - t0
    n_compiles, compile_s = counter.take()
    warm = math.inf
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        result = block(call())
        warm = min(warm, time.perf_counter() - t0)
    return result, cold, warm, n_compiles, compile_s


def device_array(data, platform: str):
    """*data* as numpy after checking it is a device array on *platform*."""
    import jax

    check(
        isinstance(data, jax.Array),
        f"result is a host {type(data).__name__}, not a device array",
    )
    where = sorted({d.platform for d in data.devices()})
    check(where == [platform], f"result lives on {where}, not {platform}")
    return np.asarray(data)


def peak_memory_gb() -> float | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return None if peak is None else peak / 2**30


def report(phase: str, **fields) -> None:
    parts = [f"phase={phase}"]
    for key, value in fields.items():
        if isinstance(value, float):
            value = f"{value:.6g}"
        parts.append(f"{key}={value}")
    print(" ".join(parts), flush=True)


def tier_of(prefix: str) -> str:
    """The tier named by the engine's phase timer since the last reset."""
    from xcube_resampling_tpu.profiling import GLOBAL_TIMER

    tiers = sorted(
        name[len(prefix):] for name in GLOBAL_TIMER.counts
        if name.startswith(prefix)
    )
    check(len(tiers) == 1, f"expected one {prefix}* tier, found {tiers}")
    return tiers[0]


def max_abs_diff(a, b):
    """(largest |a-b| where both are finite, share of pixels whose NaN
    masks differ)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    err = float(np.max(np.abs(a[both].astype(np.float64) - b[both]))) if both.any() else 0.0
    return err, float(np.mean(fa != fb))


def ulp_diff(a, b):
    """Largest difference in float32 ulps where both are finite, and
    whether the NaN masks agree exactly."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    if not both.any():
        return 0.0, bool((fa == fb).all())
    x, y = a[both].astype(np.float32), b[both].astype(np.float32)
    spacing = np.spacing(np.maximum(np.abs(x), np.abs(y)))
    return float(np.max(np.abs(x.astype(np.float64) - y) / spacing)), bool(
        (fa == fb).all()
    )


# -- phases -----------------------------------------------------------------


def phase_reproject_mild(seed, platform, n=20480, scale=1, window=1024,
                         expect_tier="srw"):
    """UTM 32N -> EPSG:3035, n^2 float32 single band, bilinear (bench.py's
    20k cell; n=4096 is the same geometry cut to 4096^2).  Reference: the
    float64 host path over a centred window of the target."""
    import jax

    from xcube_resampling_tpu import resample_in_space, reproject
    from xcube_resampling_tpu.profiling import GLOBAL_TIMER

    source_gm = regular_gm(n, *MILD_SOURCE, scale=scale)
    target_gm = regular_gm(n, *MILD_TARGET, scale=scale)
    rng = np.random.default_rng(seed)
    src, grad = smooth_field(rng, (source_gm.height, source_gm.width))
    src_dev = jax.device_put(src)
    ds_dev = dataset(source_gm, {"band": src_dev})

    GLOBAL_TIMER.reset()
    out, cold, warm, n_comp, comp_s = timed(
        lambda: resample_in_space(ds_dev, target_gm=target_gm, source_gm=source_gm),
        warm_runs=1,
    )
    tier = tier_of("reproject.device.")
    got = device_array(out["band"].data, platform)
    del out

    # the tier alone, on the card (device time of the kernel)
    _, fn = reproject._device_reproject_fn(source_gm, target_gm, "bilinear", np.nan)
    _, _, kernel_s, _, _ = timed(lambda: fn(src_dev), warm_runs=3)

    win = min(window, target_gm.height, target_gm.width)
    r0, c0 = (target_gm.height - win) // 2, (target_gm.width - win) // 2
    sub_gm = window_gm(target_gm, r0, c0, win, win)
    ref = resample_in_space(
        dataset(source_gm, {"band": src}), target_gm=sub_gm, source_gm=source_gm
    )["band"].values
    err, mask_share = max_abs_diff(got[r0:r0 + win, c0:c0 + win], ref)
    tol = SRW_POS_TOL * grad + 1e-5
    report(
        "reproject-mild", size=f"{target_gm.width}x{target_gm.height}",
        interp="bilinear", tier=tier, cold_s=cold, warm_s=warm,
        tier_device_s=kernel_s, compiles=n_comp, compile_s=comp_s,
        ref=f"host-f64-window-{win}", max_err=err, tol=tol,
        tol_reason=f"{SRW_POS_TOL}px*max_grad({grad:.4g}/px)",
        nan_mask_diff=mask_share, platform=platform, peak_gb=peak_memory_gb(),
    )
    check(expect_tier is None or tier == expect_tier,
          f"mild warp ran tier {tier}, expected {expect_tier}")
    check(err <= tol, f"mild warp error {err} > {tol}")
    check(mask_share <= 1e-3, f"mild warp NaN masks differ on {mask_share:.3%}")
    return tier


def _exact_tier_phase(name, target, seed, platform, scale, window,
                      interps, expect_tier):
    """A tier with exact semantics against the plain fused gather on the
    card (nearest bit-exact, bilinear within 2 float32 ulp) and against
    the host path over a window."""
    import jax

    from xcube_resampling_tpu import resample_in_space
    from xcube_resampling_tpu.ops.reproject_ops import make_fused_reproject_fn
    from xcube_resampling_tpu.profiling import GLOBAL_TIMER

    (sw, sh), s_min, s_res, s_crs = GLOBAL_SOURCE
    source_gm = regular_gm((sw, sh), s_min, s_res, s_crs, scale=scale)
    target_gm = regular_gm(*target, scale=scale)
    rng = np.random.default_rng(seed)
    src, grad = smooth_field(rng, (source_gm.height, source_gm.width))
    src_dev = jax.device_put(src)
    ds_dev = dataset(source_gm, {"band": src_dev})
    win_h = min(window, target_gm.height)
    win_w = min(window, target_gm.width)
    r0, c0 = (target_gm.height - win_h) // 2, (target_gm.width - win_w) // 2
    sub_gm = window_gm(target_gm, r0, c0, win_h, win_w)

    tiers = []
    for interp in interps:
        GLOBAL_TIMER.reset()
        out, cold, warm, n_comp, comp_s = timed(
            lambda: resample_in_space(
                ds_dev, target_gm=target_gm, source_gm=source_gm,
                interp_methods=interp,
            ),
            warm_runs=2,
        )
        tier = tier_of("reproject.device.")
        got = device_array(out["band"].data, platform)
        del out

        gather = make_fused_reproject_fn(source_gm, target_gm, interp, np.nan)
        plain = device_array(block(gather(src_dev)), platform)
        ulps, same_mask = ulp_diff(got, plain)
        ulp_tol = 0.0 if interp == "nearest" else 2.0

        ref = resample_in_space(
            dataset(source_gm, {"band": src}), target_gm=sub_gm,
            source_gm=source_gm, interp_methods=interp,
        )["band"].values
        err, mask_share = max_abs_diff(got[r0:r0 + win_h, c0:c0 + win_w], ref)
        if interp == "nearest":
            # a position within tolerance of a pixel edge may pick the
            # neighbour: at most one pixel step of the field
            tol, reason = 1.5 * grad + 1e-6, f"1.5px*max_grad({grad:.4g}/px)"
        else:
            tol = EXACT_POS_TOL * grad + 1e-5
            reason = f"{EXACT_POS_TOL}px*max_grad({grad:.4g}/px)"
        report(
            name, size=f"{target_gm.width}x{target_gm.height}",
            interp=interp, tier=tier, cold_s=cold, warm_s=warm,
            compiles=n_comp, compile_s=comp_s, ref="fused-gather-on-card",
            max_ulp=ulps, ulp_tol=ulp_tol, nan_mask_equal=same_mask,
            ref2=f"host-f64-window-{win_w}x{win_h}", max_err=err, tol=tol,
            tol_reason=reason, nan_mask_diff=mask_share, platform=platform,
            peak_gb=peak_memory_gb(),
        )
        check(expect_tier is None or tier == expect_tier,
              f"{name} {interp} ran tier {tier}, expected {expect_tier}")
        check(same_mask, f"{name} {interp}: NaN mask differs from the gather")
        check(ulps <= ulp_tol, f"{name} {interp}: {ulps} ulp > {ulp_tol}")
        check(err <= tol, f"{name} {interp}: host error {err} > {tol}")
        check(mask_share <= 1e-3,
              f"{name} {interp}: host NaN masks differ on {mask_share:.3%}")
        tiers.append(tier)
    return tiers


def phase_reproject_rotated(seed, platform, scale=1, window=1024,
                            interps=("bilinear", "nearest"), expect_tier="esw"):
    """0.05 deg EPSG:4326 -> the 4096x2048 EPSG:3035 severe-rotation
    target (bench.py)."""
    return _exact_tier_phase(
        "reproject-rotated", ROTATED_TARGET, seed, platform, scale, window,
        interps, expect_tier,
    )


def phase_reproject_global(seed, platform, scale=1, window=1024,
                           interps=("bilinear",), mosaic=True):
    """0.05 deg EPSG:4326 -> the 4096^2 EPSG:3035 target whose warp holds
    a projection singularity (bench.py's global cell).  The dispatch
    picks the exact region mosaic; ``mosaic=False`` skips that tier
    (``XRTPU_NO_EXACT_MOSAIC=1``) for the plain gather."""
    if mosaic:
        return _exact_tier_phase(
            "reproject-global", GLOBAL_TARGET, seed, platform, scale,
            window, interps, "esw-mosaic",
        )
    with env_vars(XRTPU_NO_EXACT_MOSAIC="1"):
        return _exact_tier_phase(
            "reproject-global", GLOBAL_TARGET, seed, platform, scale,
            window, interps, "gather",
        )


def phase_affine(seed, platform, n=1024, bands=16):
    """bands x n^2 float32, 2x bilinear downscale (bench.py's affine
    cell), against the host numpy path."""
    import jax

    from xcube_resampling_tpu import GridMapping, resample_in_space

    source_gm = GridMapping.regular(
        size=(n, n), xy_min=(4000000.0, 3000000.0), xy_res=20.0,
        crs="epsg:3035", tile_size=512,
    )
    target_gm = GridMapping.regular(
        size=(n // 2, n // 2), xy_min=(4000000.0, 3000000.0), xy_res=40.0,
        crs="epsg:3035", tile_size=512,
    )
    rng = np.random.default_rng(seed)
    src = rng.random((bands, n, n), dtype=np.float32)
    ds_dev = dataset(source_gm, {"band": jax.device_put(src)})
    out, cold, warm, n_comp, comp_s = timed(
        lambda: resample_in_space(ds_dev, target_gm=target_gm, source_gm=source_gm)
    )
    got = device_array(out["band"].data, platform)
    ref = resample_in_space(
        dataset(source_gm, {"band": src}), target_gm=target_gm, source_gm=source_gm
    )["band"].values
    err, mask_share = max_abs_diff(got, ref)
    tol = 2e-6  # 4-tap float32 means of values in [0, 1), summed in another order
    report(
        "affine", size=f"{bands}x{n}^2->{n // 2}^2", interp="bilinear",
        agg="mean", tier="device-jnp", cold_s=cold, warm_s=warm,
        compiles=n_comp, compile_s=comp_s, ref="host-numpy", max_err=err,
        tol=tol, tol_reason="f32-summation-order", nan_mask_diff=mask_share,
        platform=platform, peak_gb=peak_memory_gb(),
    )
    check(err <= tol and mask_share == 0.0, f"affine error {err} > {tol}")


def phase_coarsen(seed, platform, n=4096, bands=4, factor=4):
    """mean / first / mode 4x over bands x n^2 (bench.py's coarsen cell)
    through the affine downscale route, against the host numpy path
    (exact for first and mode)."""
    import jax

    from xcube_resampling_tpu import GridMapping, resample_in_space

    source_gm = GridMapping.regular(
        size=(n, n), xy_min=(4000000.0, 3000000.0), xy_res=10.0,
        crs="epsg:3035", tile_size=512,
    )
    target_gm = GridMapping.regular(
        size=(n // factor, n // factor), xy_min=(4000000.0, 3000000.0),
        xy_res=10.0 * factor, crs="epsg:3035", tile_size=512,
    )
    rng = np.random.default_rng(seed)
    host = {
        "mean": rng.random((bands, n, n), dtype=np.float32),
        "first": rng.random((bands, n, n), dtype=np.float32),
        "mode": rng.integers(0, 16, (bands, n, n), dtype=np.int32),
    }
    ds_dev = dataset(
        source_gm, {k: jax.device_put(v) for k, v in host.items()}
    )
    kwargs = dict(
        target_gm=target_gm, source_gm=source_gm, interp_methods=1,
        agg_methods={k: k for k in host},
    )
    out, cold, warm, n_comp, comp_s = timed(
        lambda: resample_in_space(ds_dev, **kwargs)
    )
    ref = resample_in_space(dataset(source_gm, host), **kwargs)
    for agg, tol, reason in (
        ("mean", 2e-6, "f32-summation-order"),
        ("first", 0.0, "exact"),
        ("mode", 0.0, "exact"),
    ):
        got = device_array(out[agg].data, platform)
        want = ref[agg].values
        err, mask_share = max_abs_diff(got, want)
        report(
            "coarsen", size=f"{bands}x{n}^2/{factor}", agg=agg,
            tier="device-jnp", cold_s=cold, warm_s=warm, compiles=n_comp,
            compile_s=comp_s, ref="host-numpy", max_err=err, tol=tol,
            tol_reason=reason, nan_mask_diff=mask_share, platform=platform,
            peak_gb=peak_memory_gb(),
        )
        check(err <= tol and mask_share == 0.0, f"coarsen {agg} error {err} > {tol}")


def olci_swath(seed, width=1189, height=1890, bands=16):
    """bench.py's OLCI-like swath with *bands* smooth float32 bands."""
    sys.path.insert(0, str(ROOT))
    from tests.sampledata import create_olci_like_swath

    swath = create_olci_like_swath(width=width, height=height, tile_size=512)
    data, grad = smooth_field(np.random.default_rng(seed), (bands, height, width))
    coords = {k: swath.coords[k] for k in ("lon", "lat")}
    return coords, data, grad


def rectify_dataset_of(coords, data):
    from xcube_resampling_tpu import DataArray, Dataset

    return Dataset(
        {"bands": DataArray(data, dims=("band", "y", "x"))}, coords=coords
    )


def phase_rectify(seed, platform, width=1189, height=1890, bands=16,
                  nearest_flip_share=1e-3):
    """OLCI-like swath, 16 bands, through the public path: Phase A must
    run on the device tier and Phase B gather through the resident map.
    Reference: the host tier (XRTPU_PHASEA=host) on numpy bands.  Also
    measures the two device constants of the rectify tier model."""
    import jax

    from xcube_resampling_tpu import GridMapping, resample_in_space
    from xcube_resampling_tpu import rectify
    from xcube_resampling_tpu.constants import UV_DELTA
    from xcube_resampling_tpu.ops import rectify_ops
    from xcube_resampling_tpu.profiling import GLOBAL_TIMER

    coords, data, grad = olci_swath(seed, width, height, bands)
    ds_dev = rectify_dataset_of(coords, jax.device_put(data))
    ds_host = rectify_dataset_of(coords, data)

    for interp in ("nearest", "bilinear", "triangular"):
        GLOBAL_TIMER.reset()
        out, cold, warm, n_comp, comp_s = timed(
            lambda: resample_in_space(ds_dev, interp_methods=interp, tile_size=512)
        )
        warm_compiles, _ = CompileCounter.get().take()
        counts = dict(GLOBAL_TIMER.counts)
        got = device_array(out["bands"].data, platform)
        check(counts.get("rectify.phase_a_device", 0) > 0
              and counts.get("rectify.phase_a_host", 0) == 0,
              f"rectify Phase A did not run on the device tier: {counts}")
        check(counts.get("rectify.phase_b_resident", 0) > 0,
              f"rectify Phase B did not gather through the resident map: {counts}")

        with env_vars(XRTPU_PHASEA="host"):
            # one call: the host tier's wall time for the same job
            t0 = time.perf_counter()
            want = resample_in_space(
                ds_host, interp_methods=interp, tile_size=512
            )["bands"].values
            host_s = time.perf_counter() - t0
        check(got.shape == want.shape, f"rectify shape {got.shape} != {want.shape}")

        if interp == "nearest":
            # the float32 device map and the float64 host map may fall on
            # opposite sides of a pixel edge; everywhere else the winner
            # is the same source pixel
            differ = ~((got == want) | (np.isnan(got) & np.isnan(want)))
            share = float(differ.mean())
            err, mask_share = max_abs_diff(got, want)
            tol, reason = 1.5 * grad + 1e-5, f"edge-flip:1.5px*max_grad({grad:.4g}/px)"
            extra = dict(flip_share=share, flip_share_tol=nearest_flip_share)
            ok = share <= nearest_flip_share and err <= tol
        else:
            # float32 map positions (grid units in the thousands) against
            # float64: 1e-2 px times the field's slope, plus f32 rounding
            err, mask_share = max_abs_diff(got, want)
            tol = 1e-2 * grad + 1e-5
            reason = f"1e-2px*max_grad({grad:.4g}/px)"
            extra = {}
            ok = err <= tol
        report(
            "rectify", size=f"{bands}x{height}x{width}->{got.shape[-1]}x{got.shape[-2]}",
            interp=interp, tier="phase_a_device+phase_b_resident",
            cold_s=cold, warm_s=warm, compiles=n_comp, compile_s=comp_s,
            warm_compiles=warm_compiles, host_tier_s=host_s,
            ref="host-tier-f64", max_err=err, tol=tol, tol_reason=reason,
            nan_mask_diff=mask_share, **extra, platform=platform,
            peak_gb=peak_memory_gb(),
        )
        check(ok, f"rectify {interp}: error {err} > {tol} or flips over bound")
        check(mask_share <= 1e-3,
              f"rectify {interp}: NaN masks differ on {mask_share:.3%}")

    # the rectify tier model's device constants: the hybrid Phase A's
    # fixed cost per geometry, and the resident Phase-B nearest gather
    # rate.  The model prices the coordinate upload and the round trips
    # from the link profile, so the fixed cost is the warm Phase-A wall
    # time less those two terms.
    source_gm = GridMapping.from_dataset(ds_host)
    target_gm = source_gm.to_regular(tile_size=512)

    def phase_a():
        ij_map = rectify._inverse_ij_map(source_gm, target_gm, UV_DELTA, bands)
        check(isinstance(ij_map, rectify_ops.DeviceIJMap),
              f"Phase A returned {type(ij_map).__name__}, not DeviceIJMap")
        block(ij_map.device_map())
        return ij_map

    ij_map, _, phase_a_s, _, _ = timed(phase_a, warm_runs=3)
    bw, rtt = rectify._device_link_profile()
    link_s = 2 * width * height * 4 / bw + 6 * rtt
    gather = rectify_ops.make_device_var_image_fn_resident(ij_map, np.nan, "nearest")
    bands_dev = ds_dev["bands"].data
    _, _, gather_s, _, _ = timed(lambda: gather(bands_dev), warm_runs=3)
    report(
        "rectify-tier-model", phase_a_wall_s=phase_a_s, link_s=link_s,
        device_fixed_s=phase_a_s - link_s,
        device_gather_rate=bands * target_gm.width * target_gm.height / gather_s,
        platform=platform,
    )


# -- four cards -------------------------------------------------------------


def _shard_devices(arr) -> list:
    return sorted(
        {s.device.id for s in arr.addressable_shards if s.data.size}
    )


def _compare_sharded(name, sharded, single, n_devices, ulp_tol=2.0):
    import jax

    holders = _shard_devices(sharded)
    check(len(holders) == n_devices,
          f"{name}: output shards on devices {holders}, expected {n_devices}")
    a, b = np.asarray(jax.device_get(sharded)), np.asarray(jax.device_get(single))
    check(a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}")
    ulps, same_mask = ulp_diff(a, b)
    report(
        name, shape="x".join(map(str, a.shape)), shard_devices=holders,
        ref="same-call-one-card", max_ulp=ulps, ulp_tol=ulp_tol,
        nan_mask_equal=same_mask,
    )
    check(same_mask and ulps <= ulp_tol,
          f"{name}: {ulps} ulp from one card (mask equal: {same_mask})")


def run_multi(seed, devices, n=20480, esw_n=4096, scale=1, swath=(1189, 1890),
              bands=16):
    """The sharded paths over a ("bands",) mesh of *devices*, each
    compared with the same call on a one-device mesh of devices[0]:
    the n^2 mild warp (SRW), the exact separable warp on the same
    geometry cut to esw_n^2, and rectify of the OLCI-like swath."""
    import jax
    import jax.numpy as jnp

    from xcube_resampling_tpu import GridMapping
    from xcube_resampling_tpu.parallel import (
        make_mesh, make_sharded_esw_step, sharded_phase_a, sharded_rectify,
        sharded_reproject,
    )

    mesh = make_mesh(("bands",), devices=devices)
    one = make_mesh(("bands",), devices=devices[:1])
    n_dev = len(devices)

    source_gm = regular_gm(n, *MILD_SOURCE, scale=scale)
    target_gm = regular_gm(n, *MILD_TARGET, scale=scale)
    src, _ = smooth_field(np.random.default_rng(seed), (source_gm.height, source_gm.width))

    def both(call, m):
        # one call each: the sharded steps plan on every call, so a warm
        # time would mostly time the host planner
        with jax.default_device(m.devices.flat[0]):
            return timed(lambda: call(m), warm_runs=0)

    def report_times(name, runs):
        for label, (_, cold, _, n_comp, comp_s) in zip(("mesh", "one"), runs):
            report(name, on=label, cold_s=cold, compiles=n_comp,
                   compile_s=comp_s)

    runs = [both(lambda m: sharded_reproject(src, source_gm, target_gm, m), m)
            for m in (mesh, one)]
    report_times("sharded-reproject", runs)
    _compare_sharded("sharded-reproject", runs[0][0], runs[1][0], n_dev)

    esw_source = regular_gm(esw_n, *MILD_SOURCE, scale=scale)
    esw_target = regular_gm(esw_n, *MILD_TARGET, scale=scale)
    esw_src, _ = smooth_field(
        np.random.default_rng(seed), (esw_source.height, esw_source.width)
    )

    def esw(m):
        built = make_sharded_esw_step(m, esw_source, esw_target)
        check(built is not None, "sharded ESW plan rejected")
        step_fn, (src_pad_h, out_h) = built
        padded = jnp.pad(jnp.asarray(esw_src), ((0, src_pad_h), (0, 0)),
                         constant_values=np.nan)
        return step_fn(padded)[:out_h]

    runs = [both(esw, m) for m in (mesh, one)]
    report_times("sharded-esw", runs)
    _compare_sharded("sharded-esw", runs[0][0], runs[1][0], n_dev)

    coords, data, _ = olci_swath(seed, *swath, bands)
    swath_ds = rectify_dataset_of(coords, data)
    swath_gm = GridMapping.from_dataset(swath_ds)
    swath_target = swath_gm.to_regular(tile_size=512)

    def rectify(m):
        ij_map = sharded_phase_a(m, swath_gm, swath_target)
        check(ij_map is not None, "sharded Phase A rejected the swath")
        return sharded_rectify(data, swath_gm, swath_target, m,
                               interp_method="bilinear", ij_map=ij_map)

    runs = [both(rectify, m) for m in (mesh, one)]
    report_times("sharded-rectify", runs)
    _compare_sharded("sharded-rectify", runs[0][0], runs[1][0], n_dev)


# -- main -------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--multi", action="store_true",
        help="run only the sharded paths, on a mesh of four GPUs",
    )
    args = parser.parse_args(argv)

    smi = nvidia_smi()  # before JAX takes the card
    import_package()
    from xcube_resampling_tpu.compile_cache import use_compile_cache
    from xcube_resampling_tpu.native import native_available

    cache_dir = use_compile_cache(ROOT)
    import jax

    devices = jax.devices()
    print(
        f"gpu: {smi} | jax {jax.__version__} | devices {devices} | "
        f"compile cache {cache_dir} | native library "
        f"{'loaded' if native_available() else 'unavailable'}",
        flush=True,
    )
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    CompileCounter.get()

    t0 = time.perf_counter()
    if args.multi:
        check(len(devices) >= 4, f"--multi needs four GPUs, found {len(devices)}")
        devices = devices[:4]
        run_multi(args.seed, devices)
    else:
        devices = devices[:1]
        phase_reproject_mild(args.seed, "gpu", n=4096)
        phase_reproject_mild(args.seed, "gpu", n=20480)
        phase_reproject_rotated(args.seed, "gpu")
        phase_affine(args.seed, "gpu")
        phase_coarsen(args.seed, "gpu")
        phase_rectify(args.seed, "gpu")
        # the exact region mosaic did not finish compiling within 1230 s
        # on an H100 (ROADMAP, queue 1, item 4): the smoke takes the
        # global cell through the plain gather tier
        phase_reproject_global(args.seed, "gpu", mosaic=False)
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    dev = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
