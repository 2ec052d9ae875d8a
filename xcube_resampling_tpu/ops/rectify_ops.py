"""Rectification kernels: inverse source-pixel lookup over irregular swaths.

This replaces the reference's numba scatter loops
(/root/reference/xcube_resampling/rectify.py:424-576), which are hostile to
parallel execution (sequential first-writer-wins writes).  The redesign:

* Every source quad (2x2 cell of the swath coordinate images) claims a
  bounded rectangle of target pixels (after the pre-downscale step a quad
  covers only a few pixels).  Candidates are enumerated as
  (quad, pixel-offset) pairs — a dense, vectorizable set.
* Containment is decided by the same two barycentric triangle solves with
  ``uv_delta`` tolerance as the reference (rectify.py:530-573).
* The reference's first-writer-wins race resolution (rectify.py:547-552) is
  made deterministic and parallel: each accepted candidate carries its
  quad's row-major rank; a scatter-min per target pixel picks exactly the
  quad the reference's sequential loop would have written first, so results
  match the reference bit-for-bit while every candidate evaluates in
  parallel.

The numpy implementation below is the float64 semantics reference; the same
algorithm runs under jax.jit via scatter-min (``.at[].min``) for the device
path (see `inverse_ij_map_jax`).
"""

from __future__ import annotations

import os

import numpy as np


def _fdet(px0, py0, px1, py1, px2, py2):
    return (px0 - px1) * (py0 - py2) - (px0 - px2) * (py0 - py1)


def _fu(px, py, px0, py0, px2, py2):
    return (px0 - px) * (py0 - py2) - (py0 - py) * (px0 - px2)


def _fv(px, py, px0, py0, px1, py1):
    return (py0 - py) * (px0 - px1) - (px0 - px) * (py0 - py1)


def inverse_ij_map(
    src_x: np.ndarray,
    src_y: np.ndarray,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
) -> np.ndarray:
    """Compute the (2, dst_h, dst_w) float64 fractional source (i, j) map
    for a destination block, from 2D source coordinate images.

    Equivalent to reference `_compute_target_source_ij_sequential`
    (rectify.py:424-576) under its sequential write order.
    """
    dst_h, dst_w = dst_shape

    from ..native import inverse_ij_map_native

    native = inverse_ij_map_native(
        src_x,
        src_y,
        src_i_min,
        src_j_min,
        dst_shape,
        dst_x_offset,
        dst_y_offset,
        dst_x_scale,
        dst_y_scale,
        uv_delta,
    )
    if native is not None:
        return native

    out = np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    src_h, src_w = src_x.shape
    if src_h < 2 or src_w < 2:
        return out

    # quad corners; quad (j0, i0) has corners (j0,i0),(j0,i1),(j1,i0),(j1,i1)
    p0x = src_x[:-1, :-1]
    p1x = src_x[:-1, 1:]
    p2x = src_x[1:, :-1]
    p3x = src_x[1:, 1:]
    p0y = src_y[:-1, :-1]
    p1y = src_y[:-1, 1:]
    p2y = src_y[1:, :-1]
    p3y = src_y[1:, 1:]

    # destination pixel rect per quad: floor((corner - offset)/scale) over
    # the 4 corners; elementwise min/max avoids materializing corner stacks
    with np.errstate(invalid="ignore"):
        cx_min = np.minimum(np.minimum(p0x, p1x), np.minimum(p2x, p3x))
        cx_max = np.maximum(np.maximum(p0x, p1x), np.maximum(p2x, p3x))
        cy_min = np.minimum(np.minimum(p0y, p1y), np.minimum(p2y, p3y))
        cy_max = np.maximum(np.maximum(p0y, p1y), np.maximum(p2y, p3y))
        if dst_x_scale >= 0:
            i_lo = np.floor((cx_min - dst_x_offset) / dst_x_scale)
            i_hi = np.floor((cx_max - dst_x_offset) / dst_x_scale)
        else:
            i_lo = np.floor((cx_max - dst_x_offset) / dst_x_scale)
            i_hi = np.floor((cx_min - dst_x_offset) / dst_x_scale)
        if dst_y_scale >= 0:
            j_lo = np.floor((cy_min - dst_y_offset) / dst_y_scale)
            j_hi = np.floor((cy_max - dst_y_offset) / dst_y_scale)
        else:
            j_lo = np.floor((cy_max - dst_y_offset) / dst_y_scale)
            j_hi = np.floor((cy_min - dst_y_offset) / dst_y_scale)
        nan_rect = np.isnan(i_lo) | np.isnan(j_lo)
        i_lo = np.nan_to_num(i_lo, nan=-(10.0**9))
        i_hi = np.nan_to_num(i_hi, nan=-(10.0**9))
        j_lo = np.nan_to_num(j_lo, nan=-(10.0**9))
        j_hi = np.nan_to_num(j_hi, nan=-(10.0**9))

    alive = (
        ~nan_rect
        & (i_hi >= 0)
        & (j_hi >= 0)
        & (i_lo < dst_w)
        & (j_lo < dst_h)
    )

    # triangle determinants (NaN -> 0, both-zero quads dropped,
    # rectify.py:530-541)
    det_a = _fdet(p0x, p0y, p1x, p1y, p2x, p2y)
    det_b = _fdet(p3x, p3y, p2x, p2y, p1x, p1y)
    det_a = np.nan_to_num(det_a, nan=0.0)
    det_b = np.nan_to_num(det_b, nan=0.0)
    alive &= (det_a != 0.0) | (det_b != 0.0)

    if not alive.any():
        return out

    # flat dense per-quad arrays (no up-front compression: the dominant
    # cost is the triangle solves, which run on per-offset subsets below)
    nqj, nqi = src_h - 1, src_w - 1
    alive_f = alive.reshape(-1)
    corners = {
        "p0x": p0x.reshape(-1),
        "p0y": p0y.reshape(-1),
        "p1x": p1x.reshape(-1),
        "p1y": p1y.reshape(-1),
        "p2x": p2x.reshape(-1),
        "p2y": p2y.reshape(-1),
        "p3x": p3x.reshape(-1),
        "p3y": p3y.reshape(-1),
        "det_a": det_a.reshape(-1),
        "det_b": det_b.reshape(-1),
    }
    qi_f = np.tile(np.arange(nqi, dtype=np.int64), nqj)
    qj_f = np.repeat(np.arange(nqj, dtype=np.int64), nqi)

    i_lo_q = np.clip(i_lo.reshape(-1), 0, dst_w - 1).astype(np.int64)
    i_hi_q = np.clip(i_hi.reshape(-1), 0, dst_w - 1).astype(np.int64)
    j_lo_q = np.clip(j_lo.reshape(-1), 0, dst_h - 1).astype(np.int64)
    j_hi_q = np.clip(j_hi.reshape(-1), 0, dst_h - 1).astype(np.int64)

    r_i = int((i_hi_q[alive_f] - i_lo_q[alive_f]).max()) + 1
    r_j = int((j_hi_q[alive_f] - j_lo_q[alive_f]).max()) + 1

    u_min = v_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta

    # winner-rank map: quad row-major rank == the reference's write order
    rank = qj_f * nqi + qi_f
    inf_rank = np.iinfo(np.int64).max
    claim = np.full(dst_h * dst_w, inf_rank, dtype=np.int64)

    # pass 1: scatter-min the rank of each accepting candidate per pixel.
    # Candidates are compressed to the in-rect subset before the triangle
    # solves.
    accept_cache = []
    for dj in range(r_j):
        for di in range(r_i):
            pixel_j = j_lo_q + dj
            pixel_i = i_lo_q + di
            mask = alive_f & (pixel_j <= j_hi_q) & (pixel_i <= i_hi_q)
            sel = np.nonzero(mask)[0]
            if sel.size == 0:
                continue
            q_sel = {k: v[sel] for k, v in corners.items()}
            accept, src_if, src_jf = _accept_quad(
                q_sel,
                qi_f[sel],
                qj_f[sel],
                pixel_i[sel],
                pixel_j[sel],
                dst_x_offset,
                dst_y_offset,
                dst_x_scale,
                dst_y_scale,
                u_min,
                v_min,
                uv_max,
            )
            if not accept.any():
                continue
            acc_sel = sel[accept]
            flat = pixel_j[acc_sel] * dst_w + pixel_i[acc_sel]
            accept_cache.append((acc_sel, flat, src_if[accept], src_jf[accept]))
            np.minimum.at(claim, flat, rank[acc_sel])

    # pass 2: write the winning candidates' fractional source coordinates
    out_i = out[0].reshape(-1)
    out_j = out[1].reshape(-1)
    for acc_sel, flat, src_if, src_jf in accept_cache:
        win = claim[flat] == rank[acc_sel]
        if win.any():
            out_i[flat[win]] = src_i_min + src_if[win]
            out_j[flat[win]] = src_j_min + src_jf[win]

    return out


def _accept_quad(
    q,
    qi,
    qj,
    pixel_i,
    pixel_j,
    dst_x_offset,
    dst_y_offset,
    dst_x_scale,
    dst_y_scale,
    u_min,
    v_min,
    uv_max,
    xp=np,
):
    """Evaluate the reference's two-triangle containment test for candidate
    (quad, pixel) pairs; returns (accept, fractional src_i, src_j) relative
    to the source window."""
    dst_x = dst_x_offset + (pixel_i + 0.5) * dst_x_scale
    dst_y = dst_y_offset + (pixel_j + 0.5) * dst_y_scale

    det_a = q["det_a"]
    det_b = q["det_b"]
    p0x, p0y = q["p0x"], q["p0y"]
    p1x, p1y = q["p1x"], q["p1y"]
    p2x, p2y = q["p2x"], q["p2y"]
    p3x, p3y = q["p3x"], q["p3y"]

    clamp = lambda x: xp.clip(x, 0.0, 1.0)  # noqa: E731

    safe_a = xp.where(det_a == 0.0, 1.0, det_a)
    ua = _fu(dst_x, dst_y, p0x, p0y, p2x, p2y) / safe_a
    va = _fv(dst_x, dst_y, p0x, p0y, p1x, p1y) / safe_a
    ok_a = (
        (det_a != 0.0)
        & (ua >= u_min)
        & (va >= v_min)
        & (ua + va <= uv_max)
    )

    if xp is np:
        # numpy host path: evaluate the second triangle only where the
        # first rejected (the reference's short-circuit, rectify.py:566)
        src_if = qi + clamp(ua)
        src_jf = qj + clamp(va)
        accept = ok_a.copy()
        nb = np.nonzero(~ok_a & (det_b != 0.0))[0]
        if nb.size:
            dxb = dst_x[nb]
            dyb = dst_y[nb]
            ub = _fu(dxb, dyb, p3x[nb], p3y[nb], p1x[nb], p1y[nb]) / det_b[nb]
            vb = _fv(dxb, dyb, p3x[nb], p3y[nb], p2x[nb], p2y[nb]) / det_b[nb]
            ok_b = (ub >= u_min) & (vb >= v_min) & (ub + vb <= uv_max)
            hit = nb[ok_b]
            accept[hit] = True
            src_if[hit] = (qi[hit] + 1) - clamp(ub[ok_b])
            src_jf[hit] = (qj[hit] + 1) - clamp(vb[ok_b])
        return accept, src_if, src_jf

    safe_b = xp.where(det_b == 0.0, 1.0, det_b)
    ub = _fu(dst_x, dst_y, p3x, p3y, p1x, p1y) / safe_b
    vb = _fv(dst_x, dst_y, p3x, p3y, p2x, p2y) / safe_b
    ok_b = (
        (det_b != 0.0)
        & (ub >= u_min)
        & (vb >= v_min)
        & (ub + vb <= uv_max)
    )

    src_i_a = qi + clamp(ua)
    src_j_a = qj + clamp(va)
    src_i_b = (qi + 1) - clamp(ub)
    src_j_b = (qj + 1) - clamp(vb)

    use_b = ~ok_a & ok_b
    accept = ok_a | ok_b
    src_if = xp.where(use_b, src_i_b, src_i_a)
    src_jf = xp.where(use_b, src_j_b, src_j_a)
    return accept, src_if, src_jf


def _phase_a_scan(gx, gy, uv_delta, dst_h, dst_w, r_i, n_off):
    """Device Phase A over coordinates already normalized to destination
    grid units (pixel center of dst pixel (j, i) is at (i+0.5, j+0.5)).

    Two `lax.fori_loop` passes over the (r_j, r_i) candidate-offset
    rectangle keep the HLO small (an unrolled form compiles for minutes):
    pass 1 scatter-mins each
    accepting quad's row-major rank per destination pixel — exactly the
    quad the reference's sequential first-writer-wins loop
    (/root/reference/xcube_resampling/rectify.py:544-576) would have
    written first — pass 2 rewrites the winners' fractional coordinates.
    The barycentric (u, v) of the two triangle solves are affine-invariant,
    so working in grid units changes no acceptance decision in exact
    arithmetic while keeping all magnitudes small enough for float32 on
    the device."""
    import jax.numpy as jnp
    from jax import lax

    src_h, src_w = gx.shape
    nqi = src_w - 1
    size = dst_h * dst_w
    ftype = gx.dtype

    p0x = gx[:-1, :-1].reshape(-1)
    p1x = gx[:-1, 1:].reshape(-1)
    p2x = gx[1:, :-1].reshape(-1)
    p3x = gx[1:, 1:].reshape(-1)
    p0y = gy[:-1, :-1].reshape(-1)
    p1y = gy[:-1, 1:].reshape(-1)
    p2y = gy[1:, :-1].reshape(-1)
    p3y = gy[1:, 1:].reshape(-1)

    fi = jnp.floor(jnp.stack([p0x, p1x, p2x, p3x]))
    fj = jnp.floor(jnp.stack([p0y, p1y, p2y, p3y]))
    nan_rect = jnp.isnan(fi).any(axis=0) | jnp.isnan(fj).any(axis=0)
    fi = jnp.nan_to_num(fi, nan=-(10.0**9))
    fj = jnp.nan_to_num(fj, nan=-(10.0**9))
    i_lo = fi.min(axis=0)
    i_hi = fi.max(axis=0)
    j_lo = fj.min(axis=0)
    j_hi = fj.max(axis=0)

    det_a = jnp.nan_to_num(_fdet(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
    det_b = jnp.nan_to_num(_fdet(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)

    alive = (
        ~nan_rect
        & (i_hi >= 0)
        & (j_hi >= 0)
        & (i_lo < dst_w)
        & (j_lo < dst_h)
        & ((det_a != 0.0) | (det_b != 0.0))
    )

    i_lo_q = jnp.clip(i_lo, 0, dst_w - 1).astype(jnp.int32)
    i_hi_q = jnp.clip(i_hi, 0, dst_w - 1).astype(jnp.int32)
    j_lo_q = jnp.clip(j_lo, 0, dst_h - 1).astype(jnp.int32)
    j_hi_q = jnp.clip(j_hi, 0, dst_h - 1).astype(jnp.int32)

    nq = nqi * (src_h - 1)
    qj = (jnp.arange(nq, dtype=jnp.int32) // nqi).astype(jnp.int32)
    qi = (jnp.arange(nq, dtype=jnp.int32) % nqi).astype(jnp.int32)
    inf_rank = jnp.iinfo(jnp.int32).max
    rank = jnp.where(alive, qj * nqi + qi, inf_rank)

    u_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta
    qif = qi.astype(ftype)
    qjf = qj.astype(ftype)

    def candidates(k):
        dj = (k // r_i).astype(jnp.int32)
        di = (k % r_i).astype(jnp.int32)
        pixel_j = j_lo_q + dj
        pixel_i = i_lo_q + di
        in_rect = (pixel_j <= j_hi_q) & (pixel_i <= i_hi_q)
        dst_x = pixel_i.astype(ftype) + ftype.type(0.5)
        dst_y = pixel_j.astype(ftype) + ftype.type(0.5)

        safe_a = jnp.where(det_a == 0.0, 1.0, det_a)
        ua = _fu(dst_x, dst_y, p0x, p0y, p2x, p2y) / safe_a
        va = _fv(dst_x, dst_y, p0x, p0y, p1x, p1y) / safe_a
        ok_a = (
            (det_a != 0.0) & (ua >= u_min) & (va >= u_min)
            & (ua + va <= uv_max)
        )
        safe_b = jnp.where(det_b == 0.0, 1.0, det_b)
        ub = _fu(dst_x, dst_y, p3x, p3y, p1x, p1y) / safe_b
        vb = _fv(dst_x, dst_y, p3x, p3y, p2x, p2y) / safe_b
        ok_b = (
            (det_b != 0.0) & (ub >= u_min) & (vb >= u_min)
            & (ub + vb <= uv_max)
        )

        use_b = ~ok_a & ok_b
        src_if = jnp.where(
            use_b,
            (qif + 1) - jnp.clip(ub, 0.0, 1.0),
            qif + jnp.clip(ua, 0.0, 1.0),
        )
        src_jf = jnp.where(
            use_b,
            (qjf + 1) - jnp.clip(vb, 0.0, 1.0),
            qjf + jnp.clip(va, 0.0, 1.0),
        )
        ok = (ok_a | ok_b) & in_rect & alive
        flat = jnp.where(ok, pixel_j * dst_w + pixel_i, size)
        return ok, flat, src_if, src_jf

    def claim_body(k, c):
        ok, flat, _, _ = candidates(k)
        return c.at[flat].min(jnp.where(ok, rank, inf_rank))

    claim = lax.fori_loop(
        0, n_off, claim_body,
        jnp.full((size + 1,), inf_rank, dtype=jnp.int32),
    )

    def write_body(k, outs):
        out_i, out_j = outs
        ok, flat, src_if, src_jf = candidates(k)
        win = ok & (claim[flat] == rank)
        slot = jnp.where(win, flat, size)
        # each real pixel has exactly one winner (ranks are unique), so
        # scatter order cannot matter; losers land in the crop slot
        out_i = out_i.at[slot].set(jnp.where(win, src_if, jnp.nan))
        out_j = out_j.at[slot].set(jnp.where(win, src_jf, jnp.nan))
        return out_i, out_j

    out_i, out_j = lax.fori_loop(
        0, n_off, write_body,
        (
            jnp.full((size + 1,), jnp.nan, dtype=ftype),
            jnp.full((size + 1,), jnp.nan, dtype=ftype),
        ),
    )
    return jnp.stack(
        [out_i[:size].reshape(dst_h, dst_w), out_j[:size].reshape(dst_h, dst_w)]
    )


_PHASE_A_JIT = None


def _phase_a_jit():
    global _PHASE_A_JIT
    if _PHASE_A_JIT is None:
        import jax

        _PHASE_A_JIT = jax.jit(
            _phase_a_scan,
            static_argnames=("dst_h", "dst_w", "r_i", "n_off"),
        )
    return _PHASE_A_JIT


def inverse_ij_map_jax(
    src_x,
    src_y,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    r_i: int = 4,
    r_j: int = 4,
):
    """XLA/device variant of :func:`inverse_ij_map` (jit-compatible, static
    shapes).  Candidate-enumeration + scatter-min with the candidate
    rectangle bounded by the static (r_j, r_i) — callers size it from host
    metadata (after pre-downscaling a quad covers only a few target pixels,
    reference rectify.py:136-143 guarantees this).  Coordinates are
    normalized to destination grid units before the solve."""
    import jax.numpy as jnp

    gx = (src_x - dst_x_offset) / dst_x_scale
    gy = (src_y - dst_y_offset) / dst_y_scale
    out = _phase_a_jit()(
        gx, gy, uv_delta,
        dst_h=dst_shape[0], dst_w=dst_shape[1],
        r_i=r_i, n_off=r_i * r_j,
    )
    if src_i_min or src_j_min:
        out = out + jnp.asarray(
            [[[float(src_i_min)]], [[float(src_j_min)]]], dtype=out.dtype
        )
    return out


def _ceil_pow2(n: int, cap: int) -> int:
    r = 1
    while r < n and r < cap:
        r *= 2
    return r


def _inverse_ij_map_device_scatter(
    src_x: np.ndarray,
    src_y: np.ndarray,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    max_span: int = 16,
    pad_multiple: int = 128,
) -> np.ndarray | None:
    """Whole-image device Phase A (scatter-min formulation) of
    :func:`inverse_ij_map`.

    Host work is limited to a single float64 normalization of the swath
    coordinates into destination grid units plus a corner min/max sweep
    that sizes the static candidate rectangle; everything O(quads x
    candidates) — the reference's numba hot loop
    (/root/reference/xcube_resampling/rectify.py:424-576) — runs on the
    device.  Shapes are padded to ``pad_multiple`` buckets (NaN coords =
    dead quads) so repeated geometries of similar size reuse one compile.

    Returns None when the geometry is outside the kernel's envelope (a
    quad spans more than ``max_span`` destination pixels — e.g. an
    antimeridian-wrapping swath — or the problem exceeds device memory
    guards); callers then fall back to the tiled host path."""
    import jax.numpy as jnp

    dst_h, dst_w = dst_shape
    gx = (np.asarray(src_x, dtype=np.float64) - dst_x_offset) / dst_x_scale
    gy = (np.asarray(src_y, dtype=np.float64) - dst_y_offset) / dst_y_scale
    src_h, src_w = gx.shape
    if src_h < 2 or src_w < 2:
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    pad = pad_multiple
    dst_h_p = -(-dst_h // pad) * pad
    dst_w_p = -(-dst_w // pad) * pad

    # corner min/max sweep (cheap, vectorized) sizes the candidate rect
    with np.errstate(invalid="ignore"):
        ci = np.floor(gx)
        cj = np.floor(gy)
        i_lo = np.minimum(
            np.minimum(ci[:-1, :-1], ci[:-1, 1:]),
            np.minimum(ci[1:, :-1], ci[1:, 1:]),
        )
        i_hi = np.maximum(
            np.maximum(ci[:-1, :-1], ci[:-1, 1:]),
            np.maximum(ci[1:, :-1], ci[1:, 1:]),
        )
        j_lo = np.minimum(
            np.minimum(cj[:-1, :-1], cj[:-1, 1:]),
            np.minimum(cj[1:, :-1], cj[1:, 1:]),
        )
        j_hi = np.maximum(
            np.maximum(cj[:-1, :-1], cj[:-1, 1:]),
            np.maximum(cj[1:, :-1], cj[1:, 1:]),
        )
        alive = (
            np.isfinite(i_lo) & np.isfinite(j_lo)
            & (i_hi >= 0) & (j_hi >= 0)
            & (i_lo < dst_w_p) & (j_lo < dst_h_p)
        )
    if not alive.any():
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)
    span_i = (
        np.clip(i_hi[alive], 0, dst_w_p - 1)
        - np.clip(i_lo[alive], 0, dst_w_p - 1)
    )
    span_j = (
        np.clip(j_hi[alive], 0, dst_h_p - 1)
        - np.clip(j_lo[alive], 0, dst_h_p - 1)
    )
    r_i = int(span_i.max()) + 1
    r_j = int(span_j.max()) + 1
    if r_i > max_span or r_j > max_span:
        return None
    r_i = _ceil_pow2(r_i, max_span)
    r_j = _ceil_pow2(r_j, max_span)

    # memory guards (f32 working set ~ tens of bytes per quad/pixel)
    src_h_p = -(-src_h // pad) * pad
    src_w_p = -(-src_w // pad) * pad
    if (src_h_p - 1) * (src_w_p - 1) > 32_000_000 or dst_h_p * dst_w_p > 64_000_000:
        return None

    gx_p = np.full((src_h_p, src_w_p), np.nan, dtype=np.float64)
    gy_p = np.full((src_h_p, src_w_p), np.nan, dtype=np.float64)
    gx_p[:src_h, :src_w] = gx
    gy_p[:src_h, :src_w] = gy

    import jax

    # float64 on CPU double-precision backends (bit-comparable to the host
    # tier under tests), float32 on accelerators (magnitudes are grid
    # units)
    if jax.config.read("jax_enable_x64") and jax.default_backend() == "cpu":
        dt = jnp.float64
    else:
        dt = jnp.float32
    out = _phase_a_jit()(
        jnp.asarray(gx_p, dtype=dt),
        jnp.asarray(gy_p, dtype=dt),
        dt(uv_delta),
        dst_h=dst_h_p,
        dst_w=dst_w_p,
        r_i=r_i,
        n_off=r_i * r_j,
    )
    out_np = np.asarray(out, dtype=np.float64)[:, :dst_h, :dst_w]
    if src_i_min or src_j_min:
        out_np[0] += src_i_min
        out_np[1] += src_j_min
    return out_np


def _phase_a_tiled(gx, gy, tjs, tis, base_j, base_i, uv_delta, tile, win, nqi):
    """Tiled-window device Phase A: each (tile x tile) destination tile
    tests all quads of one statically-sized source window against its
    pixels — a dense broadcast + min-rank reduction, no scatter (the
    scatter-min formulation, :func:`_inverse_ij_map_device_scatter`,
    has colliding scatters).

    ``base_j``/``base_i`` are per-tile window origins (host-planned from an
    exact coarse solve).  Winner selection re-derives the reference's
    first-writer-wins order (/root/reference/xcube_resampling/rectify.py:
    544-576) as a min over global row-major quad rank; the payload is
    recovered by a second fused pass (rank == best).

    Layout note: corner values come from flat gathers of the full
    coordinate image at computed quad-node indices — NOT from per-tile
    ``dynamic_slice`` windows.  The window formulation forced eight
    (win-1, win-1) -> (nq,) reshapes per tile under vmap, each a
    relayout; the flat-gather form keeps every
    intermediate in the natural (T, nq) / (T, P, nq) layout and runs the
    whole pass as gathers + one fused broadcast/reduce chain."""
    import jax.numpy as jnp

    ftype = gx.dtype
    src_h, src_w = gx.shape
    w_row = src_w  # flat row stride of the padded coordinate image
    inf = jnp.iinfo(jnp.int32).max
    gxf = gx.reshape(-1)
    gyf = gy.reshape(-1)

    iota_t = jnp.arange(tile, dtype=jnp.int32)
    q_dj = jnp.repeat(jnp.arange(win - 1, dtype=jnp.int32), win - 1)
    q_di = jnp.tile(jnp.arange(win - 1, dtype=jnp.int32), win - 1)
    u_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta

    # global quad-node coordinates of every window quad: (T, nq)
    qj = base_j[:, None] + q_dj[None, :]
    qi = base_i[:, None] + q_di[None, :]
    idx0 = qj * w_row + qi
    p0x = jnp.take(gxf, idx0)
    p1x = jnp.take(gxf, idx0 + 1)
    p2x = jnp.take(gxf, idx0 + w_row)
    p3x = jnp.take(gxf, idx0 + w_row + 1)
    p0y = jnp.take(gyf, idx0)
    p1y = jnp.take(gyf, idx0 + 1)
    p2y = jnp.take(gyf, idx0 + w_row)
    p3y = jnp.take(gyf, idx0 + w_row + 1)

    det_a = jnp.nan_to_num(_fdet(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
    det_b = jnp.nan_to_num(_fdet(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)
    safe_a = jnp.where(det_a == 0.0, 1.0, det_a)
    safe_b = jnp.where(det_b == 0.0, 1.0, det_b)

    # pixel centers in grid units: (T, P, 1) against quads (T, 1, nq)
    px = (tis[:, None] * tile + iota_t[None, :]).astype(ftype) + ftype.type(
        0.5
    )
    py = (tjs[:, None] * tile + iota_t[None, :]).astype(ftype) + ftype.type(
        0.5
    )
    n_t = tjs.shape[0]
    p_n = tile * tile
    dst_x = jnp.broadcast_to(px[:, None, :], (n_t, tile, tile)).reshape(
        n_t, p_n, 1
    )
    dst_y = jnp.broadcast_to(py[:, :, None], (n_t, tile, tile)).reshape(
        n_t, p_n, 1
    )

    # pass 1 (O(P*Q)): acceptance + min global rank only
    e0x = p0x[:, None, :]
    e0y = p0y[:, None, :]
    ua = _fu(dst_x, dst_y, e0x, e0y, p2x[:, None, :], p2y[:, None, :]) / (
        safe_a[:, None, :]
    )
    va = _fv(dst_x, dst_y, e0x, e0y, p1x[:, None, :], p1y[:, None, :]) / (
        safe_a[:, None, :]
    )
    ok_a = (
        (det_a[:, None, :] != 0.0) & (ua >= u_min) & (va >= u_min)
        & (ua + va <= uv_max)
    )
    e3x = p3x[:, None, :]
    e3y = p3y[:, None, :]
    ub = _fu(dst_x, dst_y, e3x, e3y, p1x[:, None, :], p1y[:, None, :]) / (
        safe_b[:, None, :]
    )
    vb = _fv(dst_x, dst_y, e3x, e3y, p2x[:, None, :], p2y[:, None, :]) / (
        safe_b[:, None, :]
    )
    ok_b = (
        (det_b[:, None, :] != 0.0) & (ub >= u_min) & (vb >= u_min)
        & (ub + vb <= uv_max)
    )
    accept = ok_a | ok_b
    rank = (qj * nqi + qi)[:, None, :]
    best = jnp.min(jnp.where(accept, rank, inf), axis=2)  # (T, P)

    # pass 2 (O(P)): re-solve the winner quad only.  `best` IS the global
    # row-major quad id; gather its corners straight from the flat image
    found = best < inf
    b = jnp.where(found, best, 0)
    wqj = b // nqi
    wqi = b % nqi
    wf = wqj * w_row + wqi
    w0x = jnp.take(gxf, wf)
    w1x = jnp.take(gxf, wf + 1)
    w2x = jnp.take(gxf, wf + w_row)
    w3x = jnp.take(gxf, wf + w_row + 1)
    w0y = jnp.take(gyf, wf)
    w1y = jnp.take(gyf, wf + 1)
    w2y = jnp.take(gyf, wf + w_row)
    w3y = jnp.take(gyf, wf + w_row + 1)
    dx = dst_x[:, :, 0]
    dy = dst_y[:, :, 0]
    wdet_a = jnp.nan_to_num(_fdet(w0x, w0y, w1x, w1y, w2x, w2y), nan=0.0)
    wdet_b = jnp.nan_to_num(_fdet(w3x, w3y, w2x, w2y, w1x, w1y), nan=0.0)
    wsafe_a = jnp.where(wdet_a == 0.0, 1.0, wdet_a)
    wsafe_b = jnp.where(wdet_b == 0.0, 1.0, wdet_b)
    wua = _fu(dx, dy, w0x, w0y, w2x, w2y) / wsafe_a
    wva = _fv(dx, dy, w0x, w0y, w1x, w1y) / wsafe_a
    wok_a = (
        (wdet_a != 0.0) & (wua >= u_min) & (wva >= u_min)
        & (wua + wva <= uv_max)
    )
    wub = _fu(dx, dy, w3x, w3y, w1x, w1y) / wsafe_b
    wvb = _fv(dx, dy, w3x, w3y, w2x, w2y) / wsafe_b
    gi = wqi.astype(ftype)
    gj = wqj.astype(ftype)
    src_if = jnp.where(
        wok_a,
        gi + jnp.clip(wua, 0.0, 1.0),
        (gi + 1) - jnp.clip(wub, 0.0, 1.0),
    )
    src_jf = jnp.where(
        wok_a,
        gj + jnp.clip(wva, 0.0, 1.0),
        (gj + 1) - jnp.clip(wvb, 0.0, 1.0),
    )
    out_i = jnp.where(found, src_if, jnp.nan)
    out_j = jnp.where(found, src_jf, jnp.nan)
    return out_i.reshape(n_t, tile, tile), out_j.reshape(n_t, tile, tile)


_PHASE_A_TILED_JIT = None


def _phase_a_tiled_jit():
    global _PHASE_A_TILED_JIT
    if _PHASE_A_TILED_JIT is None:
        import jax

        _PHASE_A_TILED_JIT = jax.jit(
            _phase_a_tiled,
            static_argnames=("tile", "win", "nqi"),
        )
    return _PHASE_A_TILED_JIT


_PHASE_A_APPLY_JITS = {}


def _build_phase_a_apply(
    *, tile, nqi, n_tj, n_ti, dst_h, dst_w, win_all, win_band, has_host
):
    """One fused jitted program for the whole device Phase A: the
    interior-window pass over every tile, the larger-window band pass
    scattered over its tile ids, host-exception block injection, and the
    (T, t, t) -> (2, Hp, Wp) assembly.  Per-geometry arrays arrive as
    arguments so the compiled executable is shared across geometries with
    equal bucket shapes — and the jit itself is cached at module level on
    the static config, so a new plan for the same geometry class reuses
    the traced/compiled program instead of retracing per call.

    Scatter note: band/host tile lists are padded by repeating their last
    entry; duplicate ``.at[].set`` indices then write identical values, so
    the result is deterministic."""
    import jax
    import jax.numpy as jnp

    key = (tile, nqi, n_tj, n_ti, dst_h, dst_w, win_all, win_band, has_host)
    cached = _PHASE_A_APPLY_JITS.get(key)
    if cached is not None:
        return cached

    def full(gx, gy, uvd, a_tjs, a_tis, a_bjs, a_bis, *rest):
        pos = 0
        o_i, o_j = _phase_a_tiled(
            gx, gy, a_tjs, a_tis, a_bjs, a_bis, uvd,
            tile=tile, win=win_all, nqi=nqi,
        )
        if win_band:
            sel, b_tjs, b_tis, b_bjs, b_bis = rest[pos : pos + 5]
            pos += 5
            b_i, b_j = _phase_a_tiled(
                gx, gy, b_tjs, b_tis, b_bjs, b_bis, uvd,
                tile=tile, win=win_band, nqi=nqi,
            )
            o_i = o_i.at[sel].set(b_i)
            o_j = o_j.at[sel].set(b_j)
        if has_host:
            h_sel, h_i, h_j = rest[pos : pos + 3]
            o_i = o_i.at[h_sel].set(h_i)
            o_j = o_j.at[h_sel].set(h_j)
        o_i = o_i.reshape(n_tj, n_ti, tile, tile).transpose(0, 2, 1, 3)
        o_j = o_j.reshape(n_tj, n_ti, tile, tile).transpose(0, 2, 1, 3)
        hp, wp = n_tj * tile, n_ti * tile
        full_map = jnp.stack([o_i.reshape(hp, wp), o_j.reshape(hp, wp)])
        return full_map[:, :dst_h, :dst_w]

    jitted = jax.jit(full)
    _PHASE_A_APPLY_JITS[key] = jitted
    return jitted


_SCRATCH: dict = {}


def _scratch(key: str, shape: tuple, dtype) -> np.ndarray:
    """Reused host scratch buffers for the Phase-A planner.

    Planning repeatedly allocates a handful of swath-sized temporaries;
    on hosts where freshly-faulted pages are expensive (VM snapshots with
    lazy page restore) malloc/free cycles re-pay that cost every call.
    The pool keeps one buffer per (key, shape, dtype) — planning is
    host-single-threaded, and the retained footprint is a few times the
    largest swath seen."""
    k = (key, shape, np.dtype(dtype).str)
    buf = _SCRATCH.get(k)
    if buf is None:
        buf = _SCRATCH[k] = np.empty(shape, dtype)
    return buf


def _dilate1(m: np.ndarray) -> np.ndarray:
    """8-connected binary dilation by one cell."""
    out = m.copy()
    out[1:, :] |= m[:-1, :]
    out[:-1, :] |= m[1:, :]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    out[1:, 1:] |= m[:-1, :-1]
    out[1:, :-1] |= m[:-1, 1:]
    out[:-1, 1:] |= m[1:, :-1]
    out[:-1, :-1] |= m[1:, 1:]
    return out


def _fill_nan_extrapolate(a: np.ndarray, max_iters: int = 8) -> np.ndarray:
    """Fill NaN cells of a (2, h, w) field by linear extrapolation from
    valid neighbours (2*v1 - v2 along each axis direction, averaged over
    available directions), falling back to nearest-copy when only one
    neighbour exists.  Used to extend the coarse seed field past the swath
    footprint so edge tiles get usable window origins.  Cells farther than
    ``max_iters`` from the footprint are filled with the nearest valid
    value in one vectorized pass — they can hold no coverage, their seeds
    only need to be in-bounds."""
    a = a.copy()
    for _ in range(max_iters):
        nan = np.isnan(a[0])
        if not nan.any():
            break
        est = np.zeros_like(a)
        cnt = np.zeros(a.shape[1:], dtype=np.int32)
        for axis, sign in ((1, 1), (1, -1), (2, 1), (2, -1)):
            v1 = np.roll(a, sign, axis=axis)
            v2 = np.roll(a, 2 * sign, axis=axis)
            # roll wraps: kill the wrapped border band
            ax = axis - 1
            v1_ok = ~np.isnan(v1[0])
            v2_ok = ~np.isnan(v2[0])
            border = np.zeros_like(v1_ok)
            idx = [slice(None)] * 2
            idx[ax] = slice(0, sign) if sign > 0 else slice(sign, None)
            border[tuple(idx)] = True
            v1_ok &= ~border
            idx[ax] = slice(0, 2 * sign) if sign > 0 else slice(2 * sign, None)
            border2 = np.zeros_like(v1_ok)
            border2[tuple(idx)] = True
            v2_ok &= ~border2
            take = nan & v1_ok
            lin = take & v2_ok
            contrib = np.where(lin, 2 * v1 - v2, v1)
            est[:, take] += contrib[:, take]
            cnt[take] += 1
        filled = nan & (cnt > 0)
        a[:, filled] = est[:, filled] / cnt[filled]
    nan = np.isnan(a[0])
    if nan.any():
        from scipy.ndimage import distance_transform_edt

        _, (jj, ii) = distance_transform_edt(nan, return_indices=True)
        a[:, nan] = a[:, jj[nan], ii[nan]]
    return a


class PhaseAPlan:
    """Host-side plan for the device Phase A (see
    :func:`plan_phase_a_device`).  Holds the padded grid-unit coordinate
    arrays, per-class tile lists / window origins, and any host-computed
    exception blocks.  ``apply`` runs entirely on the device and returns
    the (2, Hp, Wp) fractional source-index map as a device array (crop to
    ``dst_shape`` at consumption) — nothing crosses the host boundary, so
    Phase B can gather straight through it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def device_args(self):
        """The padded grid-unit coordinate arrays as device arrays (staged
        once per geometry; callers may keep them resident)."""
        import jax.numpy as jnp

        from ..profiling import GLOBAL_TIMER as _T

        with _T("phase_a.stage"):
            return (
                jnp.asarray(self.gx_p, dtype=self.dtype),
                jnp.asarray(self.gy_p, dtype=self.dtype),
            )

    def apply(self, gx_d, gy_d):
        """Device Phase A: all tile classes, scatter of exception tiles,
        and final assembly run as ONE jitted program (eager assembly ops
        would each be a separate device dispatch).  All per-geometry
        arrays are arguments,
        not closure constants, so geometries sharing bucket sizes reuse
        the compiled executable (and the persistent compile cache)."""
        from ..profiling import GLOBAL_TIMER as _T

        if getattr(self, "_apply_jit", None) is None:
            self._apply_jit = _build_phase_a_apply(
                tile=self.tile,
                nqi=self.nqi,
                n_tj=self.n_tj,
                n_ti=self.n_ti,
                dst_h=self.dst_h,
                dst_w=self.dst_w,
                win_all=self.cls_all["win"],
                win_band=(
                    self.cls_band["win"] if self.cls_band is not None else 0
                ),
                has_host=self.host_blocks is not None,
            )
        args = [
            gx_d, gy_d, self.dtype(self.uv_delta),
            self.cls_all["tjs"], self.cls_all["tis"],
            self.cls_all["bjs"], self.cls_all["bis"],
        ]
        if self.cls_band is not None:
            args += [
                self.cls_band["sel"],
                self.cls_band["tjs"], self.cls_band["tis"],
                self.cls_band["bjs"], self.cls_band["bis"],
            ]
        if self.host_blocks is not None:
            sel, blocks = self.host_blocks
            args += [sel, blocks[0], blocks[1]]
        with _T("phase_a.apply_dispatch"):
            return self._apply_jit(*args)

    def as_numpy(self, out_d) -> np.ndarray:
        """Fetch + restore absolute indices (float64); ``apply`` already
        crops to (2, dst_h, dst_w) on device."""
        out_np = np.array(out_d, dtype=np.float64)
        if self.src_i_min or self.src_j_min:
            out_np[0] += self.src_i_min
            out_np[1] += self.src_j_min
        return out_np


def plan_phase_a_device(
    src_x: np.ndarray,
    src_y: np.ndarray,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    tile: int = 8,
    max_win: int = 48,
):
    """Host planning for the device Phase A tier.

    Normalizes the swath coordinates to destination grid units (float64),
    solves Phase A exactly on a coarse grid whose samples sit on the
    destination tile corners (1/tile^2 of the pixels, through the
    multithreaded C++ / numpy host kernel), extends the seed field past
    the footprint, and derives per-tile source-window origins in three
    classes: interior (all 4 corner seeds exact, tight windows), boundary
    band (mixed/extrapolated seeds or node presence without seeds, larger
    windows scaled by the seed-field roughness and the extrapolation
    distance), and host-exception tiles (window requirement beyond the
    device cap — solved exactly by the host kernel and injected).  Tiles
    provably beyond the footprint (no source node within the dilation
    radius) are emitted as NaN without any work.

    Returns a :class:`PhaseAPlan`, a ready (2, dst_h, dst_w) float64 map
    (degenerate cases solved entirely on the host), or None when the
    geometry is outside the device envelope (callers fall back to the
    tiled host path).  Plan quality contract: the device map equals the
    host map bit-for-bit in float64 and to ~2e-3 px in float32, with the
    same NaN coverage (tests/test_rectify.py)."""
    import jax
    import jax.numpy as jnp

    from ..profiling import GLOBAL_TIMER as _T

    dst_h, dst_w = dst_shape
    with _T("phase_a.plan.normalize"):
        sx = np.asarray(src_x, dtype=np.float64)
        sy = np.asarray(src_y, dtype=np.float64)
        gx = _scratch("gx", sx.shape, np.float64)
        gy = _scratch("gy", sy.shape, np.float64)
        np.subtract(sx, dst_x_offset, out=gx)
        gx /= dst_x_scale
        np.subtract(sy, dst_y_offset, out=gy)
        gy /= dst_y_scale
    src_h, src_w = gx.shape
    if src_h < 2 or src_w < 2:
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    n_tj = -(-dst_h // tile)
    n_ti = -(-dst_w // tile)
    # coarse samples on tile corners: sample (cj, ci) at fine pixel
    # (tile*cj, tile*ci), i.e. grid-unit position tile*cj + 0.5
    ch, cw = n_tj + 1, n_ti + 1
    off = 0.5 - 0.5 * tile
    with _T("phase_a.plan.coarse_solve"):
        seed = inverse_ij_map(
            gx, gy, 0, 0, (ch, cw),
            off, off, float(tile), float(tile), uv_delta,
        )
    valid = np.isfinite(seed[0])

    # forward node presence (exactness guard): every destination tile
    # that any source grid node lands in — dilated by the largest quad
    # edge length — might contain covered pixels.  The coarse sampling
    # can miss coverage slivers thinner than a tile; presence-flagged
    # tiles without solved seeds join the boundary band (or the host
    # exception list when their windows blow up).
    n_t = n_tj * n_ti
    _presence_t = _T("phase_a.plan.presence")
    _presence_t.__enter__()
    # float32 is ample for the presence scan: the tile attribution below
    # is dilated by at least one tile and the dilation radius rounds
    # edge_len UP, so sub-pixel f32 rounding cannot change the outcome.
    # Diffs run through two reused buffers instead of four fresh float64
    # temporaries (this is a hot host path on single-core rigs).
    gx32 = _scratch("gx32", gx.shape, np.float32)
    gy32 = _scratch("gy32", gy.shape, np.float32)
    gx32[:] = gx
    gy32[:] = gy
    d_row = _scratch("d_row", (src_h - 1, src_w), np.float32)
    d_col = _scratch("d_col", (src_h, src_w - 1), np.float32)
    with np.errstate(invalid="ignore"):
        edge_len = 0.0
        for arr in (gx32, gy32):
            for buf, a, b in (
                (d_row, arr[1:], arr[:-1]),
                (d_col, arr[:, 1:], arr[:, :-1]),
            ):
                np.subtract(a, b, out=buf)
                np.abs(buf, out=buf)
                if np.isfinite(buf).any():
                    edge_len = max(edge_len, float(np.nanmax(buf)))
        # NaN coordinates compare False everywhere, dropping those nodes
        # (the predecessor mapped them to tile -1 with the same effect)
        node_i = np.floor(gx32, out=_scratch("node_i", gx32.shape, np.float32))
        node_j = np.floor(gy32, out=_scratch("node_j", gy32.shape, np.float32))
        inb = (
            (node_i >= 0) & (node_i < n_ti * tile)
            & (node_j >= 0) & (node_j < n_tj * tile)
        )
    presence = np.zeros(n_t, dtype=bool)
    if inb.any():
        t_ids = (
            (node_j[inb].astype(np.int64) // tile) * n_ti
            + node_i[inb].astype(np.int64) // tile
        )
        presence[:] = np.bincount(t_ids, minlength=n_t) > 0
    presence = presence.reshape(n_tj, n_ti)
    dil = int(np.ceil(edge_len / tile)) + 1
    if dil > 8:
        return None
    needed = presence
    for _ in range(dil):
        needed = _dilate1(needed)
    _presence_t.__exit__(None, None, None)

    if not valid.any():
        if presence.any():
            return None
        return np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)

    # seed-field roughness: max |difference| between adjacent coarse
    # samples (quads per tile step) decides the extrapolation margins
    with np.errstate(invalid="ignore"):
        dji = np.abs(np.diff(seed, axis=2))
        djj = np.abs(np.diff(seed, axis=1))
    rough = max(
        float(np.nanmax(dji)) if np.isfinite(dji).any() else 1.0,
        float(np.nanmax(djj)) if np.isfinite(djj).any() else 1.0,
    )
    margin = 2
    with _T("phase_a.plan.fill"):
        seed_f = _fill_nan_extrapolate(seed)
    if np.isnan(seed_f[0]).any():
        return None

    # per-tile window: origin = floor(min corner seed) - margins,
    # extent = corner-seed spread + margins
    c_i = seed_f[0]
    c_j = seed_f[1]
    t_i_min = np.minimum(
        np.minimum(c_i[:-1, :-1], c_i[:-1, 1:]),
        np.minimum(c_i[1:, :-1], c_i[1:, 1:]),
    )
    t_i_max = np.maximum(
        np.maximum(c_i[:-1, :-1], c_i[:-1, 1:]),
        np.maximum(c_i[1:, :-1], c_i[1:, 1:]),
    )
    t_j_min = np.minimum(
        np.minimum(c_j[:-1, :-1], c_j[:-1, 1:]),
        np.minimum(c_j[1:, :-1], c_j[1:, 1:]),
    )
    t_j_max = np.maximum(
        np.maximum(c_j[:-1, :-1], c_j[:-1, 1:]),
        np.maximum(c_j[1:, :-1], c_j[1:, 1:]),
    )
    v4 = (
        valid[:-1, :-1] & valid[:-1, 1:] & valid[1:, :-1] & valid[1:, 1:]
    )
    # extrapolated seeds carry error that grows with the distance to the
    # nearest solved sample (in coarse cells, via EDT).  The linear
    # extrapolation in _fill_nan_extrapolate captures the field's first
    # order exactly, so its error is second order: ~ curvature * d^2.
    # Cells beyond the extrapolation range carry nearest-copy values with
    # first-order error (roughness * d) instead.
    from scipy.ndimage import distance_transform_edt

    with np.errstate(invalid="ignore"):
        curv = 1e-3
        for dd in (np.diff(seed, 2, axis=2), np.diff(seed, 2, axis=1)):
            if np.isfinite(dd).any():
                curv = max(curv, float(np.nanmax(np.abs(dd))))
    dist_c = distance_transform_edt(~valid)
    d4 = np.maximum(
        np.maximum(dist_c[:-1, :-1], dist_c[:-1, 1:]),
        np.maximum(dist_c[1:, :-1], dist_c[1:, 1:]),
    )
    extrapolated = d4 <= 8.0  # _fill_nan_extrapolate max_iters
    err = np.where(
        extrapolated,
        curv * (d4 + 1.0) ** 2,
        max(rough, 1.0) * (d4 + 1.0),
    )
    extra = np.where(v4, 0.0, np.ceil(err) + 3.0)
    spread = np.maximum(t_i_max - t_i_min, t_j_max - t_j_min) + 2 * extra

    band = (_dilate1(mixed := (valid[:-1, :-1] | valid[:-1, 1:]
                               | valid[1:, :-1] | valid[1:, 1:]) & ~v4)
            | mixed | (needed & ~v4))

    base_i_all = (np.floor(t_i_min - extra) - margin).reshape(-1)
    base_j_all = (np.floor(t_j_min - extra) - margin).reshape(-1)
    req = np.ceil(spread).astype(np.int64).reshape(-1) + 2 * margin + 3

    def _win_of(req_max: int) -> int:
        return -(-max(int(req_max), 4) // 4) * 4

    flat_v4 = v4.reshape(-1)
    flat_band = (band & ~v4).reshape(-1)
    win_int = _win_of(req[flat_v4].max()) if flat_v4.any() else 4
    if win_int > max_win:
        return None

    # pad source so every window slice is in-bounds after clipping
    pad = 64
    src_h_p = -(-max(src_h, 2 * max_win) // pad) * pad
    src_w_p = -(-max(src_w, 2 * max_win) // pad) * pad

    if jax.config.read("jax_enable_x64") and jax.default_backend() == "cpu":
        dt = jnp.float64
        np_dt = np.float64
    else:
        dt = jnp.float32
        np_dt = np.float32
    with _T("phase_a.plan.pad"):
        gx_p = np.full((src_h_p, src_w_p), np.nan, dtype=np_dt)
        gy_p = np.full((src_h_p, src_w_p), np.nan, dtype=np_dt)
        gx_p[:src_h, :src_w] = gx
        gy_p[:src_h, :src_w] = gy

    tj_grid = np.repeat(np.arange(n_tj, dtype=np.int32), n_ti)
    ti_grid = np.tile(np.arange(n_ti, dtype=np.int32), n_tj)

    def make_class(sel, win, bucket=256):
        n_s = len(sel)
        n_p = -(-n_s // bucket) * bucket
        sel_p = np.concatenate(
            [sel, np.full(n_p - n_s, sel[-1], dtype=sel.dtype)]
        )
        return dict(
            sel=jnp.asarray(sel_p.astype(np.int32)),
            n_real=n_s,
            win=win,
            tjs=jnp.asarray(tj_grid[sel_p]),
            tis=jnp.asarray(ti_grid[sel_p]),
            bjs=jnp.asarray(
                np.clip(base_j_all[sel_p], 0, src_h_p - win).astype(np.int32)
            ),
            bis=jnp.asarray(
                np.clip(base_i_all[sel_p], 0, src_w_p - win).astype(np.int32)
            ),
        )

    # class 1 runs every tile at the interior window (far-outside tiles
    # produce NaN cheaply and assembly stays a pure reshape)
    cls_all = dict(
        sel=None,
        n_real=n_t,
        win=win_int,
        tjs=jnp.asarray(tj_grid),
        tis=jnp.asarray(ti_grid),
        bjs=jnp.asarray(
            np.clip(base_j_all, 0, src_h_p - win_int).astype(np.int32)
        ),
        bis=jnp.asarray(
            np.clip(base_i_all, 0, src_w_p - win_int).astype(np.int32)
        ),
    )

    cls_band = None
    host_blocks = None
    sel_band = np.nonzero(flat_band)[0]
    if len(sel_band):
        win_band = _win_of(req[sel_band].max())
        host_tiles = np.array([], dtype=np.int64)
        if win_band > 2 * max_win:
            over = req[sel_band] > 2 * max_win
            host_tiles = sel_band[over]
            sel_band = sel_band[~over]
            win_band = (
                _win_of(req[sel_band].max()) if len(sel_band) else 0
            )
        if len(sel_band) and win_band > win_int:
            cls_band = make_class(sel_band, win_band)
        if len(host_tiles) > 1024:
            return None
        if len(host_tiles):
            hb_i = np.empty((len(host_tiles), tile, tile), dtype=np.float64)
            hb_j = np.empty_like(hb_i)
            for k, t in enumerate(host_tiles):
                tj, ti = divmod(int(t), n_ti)
                w = int(min(req[t], 8 * max_win))
                bj = int(np.clip(base_j_all[t], 0, max(src_h - 2, 0)))
                bi = int(np.clip(base_i_all[t], 0, max(src_w - 2, 0)))
                j1 = min(bj + w, src_h)
                i1 = min(bi + w, src_w)
                blk = inverse_ij_map(
                    gx[bj:j1, bi:i1], gy[bj:j1, bi:i1], bi, bj,
                    (tile, tile),
                    float(ti * tile), float(tj * tile), 1.0, 1.0,
                    uv_delta,
                )
                hb_i[k] = blk[0]
                hb_j[k] = blk[1]
            host_blocks = (
                jnp.asarray(host_tiles.astype(np.int32)),
                (
                    jnp.asarray(hb_i, dtype=dt),
                    jnp.asarray(hb_j, dtype=dt),
                ),
            )

    return PhaseAPlan(
        gx_p=gx_p,
        gy_p=gy_p,
        dtype=dt,
        uv_delta=uv_delta,
        tile=tile,
        nqi=src_w_p - 1,
        n_tj=n_tj,
        n_ti=n_ti,
        dst_h=dst_h,
        dst_w=dst_w,
        src_i_min=src_i_min,
        src_j_min=src_j_min,
        cls_all=cls_all,
        cls_band=cls_band,
        host_blocks=host_blocks,
    )


class DeviceIJMap:
    """A Phase-A result that lives on the device.

    Holds the padded (2, Hp, Wp) fractional source-index map produced by
    :meth:`PhaseAPlan.apply` so Phase B can gather straight through it
    without the map ever crossing the host boundary.  Host consumers call
    :meth:`as_numpy`, which fetches once and caches."""

    def __init__(self, plan: PhaseAPlan, out_d):
        self._plan = plan
        self._out_d = out_d
        self._np = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return 2, self._plan.dst_h, self._plan.dst_w

    def device_map(self):
        """The (2, dst_h, dst_w) map as a device array with absolute
        source indices (``apply`` crops on device; usually a zero-op)."""
        import jax.numpy as jnp

        p = self._plan
        m = self._out_d
        if p.src_i_min or p.src_j_min:
            off = jnp.asarray(
                [p.src_i_min, p.src_j_min], dtype=m.dtype
            )[:, None, None]
            m = m + off
        return m

    def as_numpy(self) -> np.ndarray:
        if self._np is None:
            self._np = self._plan.as_numpy(self._out_d)
        return self._np


def _walk_gate(gx32: np.ndarray, gy32: np.ndarray, max_edge: float) -> bool:
    """Host gate for the Newton-walk Phase A: the walk is exact only on
    clean fold-free swaths — every coordinate finite, every quad's two
    triangle determinants nonzero with a uniform orientation sign across
    the image (a sign flip means the swath folds over itself, where the
    reference's min-rank winner may sit arbitrarily far from the walk's
    converged quad), and no quad edge longer than ``max_edge`` grid units
    (antimeridian wraps / degenerate geometries would unbound the walk's
    step size).  One vectorized float32 pass, ~10 ms on OLCI swaths."""
    if not (np.isfinite(gx32).all() and np.isfinite(gy32).all()):
        return False
    p0x = gx32[:-1, :-1]
    p1x = gx32[:-1, 1:]
    p2x = gx32[1:, :-1]
    p3x = gx32[1:, 1:]
    p0y = gy32[:-1, :-1]
    p1y = gy32[:-1, 1:]
    p2y = gy32[1:, :-1]
    p3y = gy32[1:, 1:]
    det_a = (p1x - p0x) * (p2y - p0y) - (p2x - p0x) * (p1y - p0y)
    if det_a.max() >= 0 and det_a.min() <= 0:
        return False
    det_b = (p2x - p3x) * (p1y - p3y) - (p1x - p3x) * (p2y - p3y)
    if det_b.max() >= 0 and det_b.min() <= 0:
        return False
    edge = max(
        float(np.abs(p1x - p0x).max()),
        float(np.abs(p2x - p0x).max()),
        float(np.abs(p1y - p0y).max()),
        float(np.abs(p2y - p0y).max()),
    )
    return edge <= max_edge


_WALK_JIT: dict = {}


def _tri_solve_flat(gxf, gyf, w_row, qj, qi, px, py):
    """Both triangle systems of quad (qj, qi), corners gathered from the
    flat coordinate images — the exact formulas of the tiled kernel /
    host loop (reference rectify.py:530-573)."""
    import jax.numpy as jnp

    idx0 = qj * w_row + qi
    p0x = jnp.take(gxf, idx0)
    p1x = jnp.take(gxf, idx0 + 1)
    p2x = jnp.take(gxf, idx0 + w_row)
    p3x = jnp.take(gxf, idx0 + w_row + 1)
    p0y = jnp.take(gyf, idx0)
    p1y = jnp.take(gyf, idx0 + 1)
    p2y = jnp.take(gyf, idx0 + w_row)
    p3y = jnp.take(gyf, idx0 + w_row + 1)
    det_a = jnp.nan_to_num(_fdet(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
    det_b = jnp.nan_to_num(_fdet(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)
    safe_a = jnp.where(det_a == 0.0, 1.0, det_a)
    safe_b = jnp.where(det_b == 0.0, 1.0, det_b)
    ua = _fu(px, py, p0x, p0y, p2x, p2y) / safe_a
    va = _fv(px, py, p0x, p0y, p1x, p1y) / safe_a
    ub = _fu(px, py, p3x, p3y, p1x, p1y) / safe_b
    vb = _fv(px, py, p3x, p3y, p2x, p2y) / safe_b
    return det_a, ua, va, det_b, ub, vb


def _walk_steps_flat(gxf, gyf, w_row, nqj, nqi, qj, qi, px, py, n_iters):
    """Fixed-count quad walk: each step solves the current quad's
    triangle-A affine extension and jumps floor(u), floor(v) quads —
    Newton's method on the piecewise-affine inverse, converging
    geometrically on fold-free swaths."""
    import jax.numpy as jnp
    from jax import lax

    def body(_, carry):
        qj, qi = carry
        det_a, ua, va, det_b, ub, vb = _tri_solve_flat(
            gxf, gyf, w_row, qj, qi, px, py
        )
        di_a = jnp.floor(ua)
        dj_a = jnp.floor(va)
        # triangle A degenerate: the B system spans the same quad
        # from the far corner (offsets flip)
        di = jnp.where(det_a != 0.0, di_a, jnp.floor(1.0 - ub))
        dj = jnp.where(det_a != 0.0, dj_a, jnp.floor(1.0 - vb))
        di = jnp.nan_to_num(di, nan=0.0, posinf=0.0, neginf=0.0)
        dj = jnp.nan_to_num(dj, nan=0.0, posinf=0.0, neginf=0.0)
        qi = jnp.clip(qi + di.astype(jnp.int32), 0, nqi - 1)
        qj = jnp.clip(qj + dj.astype(jnp.int32), 0, nqj - 1)
        return qj, qi

    return lax.fori_loop(0, n_iters, body, (qj, qi))


def _affine_seed(gxf, gyf, src_h, src_w, ft):
    """Global affine seed: least-squares fit (i, j) ~ linear(gx, gy) over
    the swath nodes, centered for conditioning.  2x2 closed form per
    component; degenerate fits fall back to the centre.  Returns
    (xm, ym, im, jm, ai, bi, aj, bj) such that
    i ~ im + ai*(x-xm) + bi*(y-ym), j ~ jm + aj*(x-xm) + bj*(y-ym)."""
    import jax.numpy as jnp
    from jax import lax

    n = src_h * src_w
    ii = jnp.tile(jnp.arange(src_w, dtype=ft), src_h)
    jj = jnp.repeat(jnp.arange(src_h, dtype=ft), src_w)
    xm = jnp.mean(gxf)
    ym = jnp.mean(gyf)
    im = (src_w - 1) / 2.0
    jm = (src_h - 1) / 2.0
    xc = gxf - xm
    yc = gyf - ym

    def dot(a, b):
        # full float32 products: the GPU may otherwise run them in TF32
        return jnp.dot(a, b, precision=lax.Precision.HIGHEST)

    sxx = dot(xc, xc) / n
    sxy = dot(xc, yc) / n
    syy = dot(yc, yc) / n
    det_m = sxx * syy - sxy * sxy
    det_m = jnp.where(jnp.abs(det_m) < 1e-30, 1e-30, det_m)
    rix = dot(xc, ii - im) / n
    riy = dot(yc, ii - im) / n
    rjx = dot(xc, jj - jm) / n
    rjy = dot(yc, jj - jm) / n
    ai = (rix * syy - riy * sxy) / det_m
    bi = (riy * sxx - rix * sxy) / det_m
    aj = (rjx * syy - rjy * sxy) / det_m
    bj = (rjy * sxx - rjx * sxy) / det_m
    return xm, ym, im, jm, ai, bi, aj, bj


def _build_walk_kernel(
    src_shape, dst_shape, dtype, uv_delta,
    coarse_stride, coarse_iters, fine_iters,
):
    """Compile the multigrid Newton-walk Phase A (see
    :func:`inverse_ij_map_walk`)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    src_h, src_w = src_shape
    dst_h, dst_w = dst_shape
    nqj, nqi = src_h - 1, src_w - 1
    w_row = src_w
    ft = dtype
    u_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta
    inf = jnp.iinfo(jnp.int32).max

    @jax.jit
    def walk(gx, gy):
        gxf = gx.reshape(-1)
        gyf = gy.reshape(-1)

        def tri_solve(gxf, gyf, qj, qi, px, py):
            return _tri_solve_flat(gxf, gyf, w_row, qj, qi, px, py)

        def walk_steps(gxf, gyf, qj, qi, px, py, n_iters):
            return _walk_steps_flat(
                gxf, gyf, w_row, nqj, nqi, qj, qi, px, py, n_iters
            )

        xm, ym, im, jm, ai, bi, aj, bj = _affine_seed(
            gxf, gyf, src_h, src_w, ft
        )

        # coarse level: one sample per (stride x stride) destination block
        ch = -(-dst_h // coarse_stride)
        cw = -(-dst_w // coarse_stride)
        pxc = (
            jnp.arange(cw, dtype=ft)[None, :] * coarse_stride
            + ft(0.5)
        )
        pyc = (
            jnp.arange(ch, dtype=ft)[:, None] * coarse_stride
            + ft(0.5)
        )
        pxc = jnp.broadcast_to(pxc, (ch, cw))
        pyc = jnp.broadcast_to(pyc, (ch, cw))
        qi0 = jnp.clip(
            jnp.nan_to_num(
                im + ai * (pxc - xm) + bi * (pyc - ym), nan=im
            ).astype(jnp.int32),
            0,
            nqi - 1,
        )
        qj0 = jnp.clip(
            jnp.nan_to_num(
                jm + aj * (pxc - xm) + bj * (pyc - ym), nan=jm
            ).astype(jnp.int32),
            0,
            nqj - 1,
        )
        qj_c, qi_c = walk_steps(gxf, gyf, qj0, qi0, pxc, pyc, coarse_iters)

        # fine level: nearest upsample of the coarse quad guesses
        qj_f = jnp.repeat(
            jnp.repeat(qj_c, coarse_stride, axis=0), coarse_stride, axis=1
        )[:dst_h, :dst_w]
        qi_f = jnp.repeat(
            jnp.repeat(qi_c, coarse_stride, axis=0), coarse_stride, axis=1
        )[:dst_h, :dst_w]
        px = jnp.broadcast_to(
            jnp.arange(dst_w, dtype=ft)[None, :] + ft(0.5),
            (dst_h, dst_w),
        )
        py = jnp.broadcast_to(
            jnp.arange(dst_h, dtype=ft)[:, None] + ft(0.5),
            (dst_h, dst_w),
        )
        qj, qi = walk_steps(gxf, gyf, qj_f, qi_f, px, py, fine_iters)

        # acceptance + payload: min-rank select over the 3x3 quad
        # neighbourhood of the converged guess — reproduces the host
        # kernel's first-writer-wins (row-major quad rank) order, since a
        # fold-free point is contained (within uv_delta) only by quads
        # adjacent to its true quad.  fori_loop keeps the trace one
        # candidate body instead of nine (a smaller program to compile).
        offsets = jnp.asarray(
            [(dj, di) for dj in (-1, 0, 1) for di in (-1, 0, 1)],
            dtype=jnp.int32,
        )

        def cand_body(k, state):
            best_rank, out_i, out_j = state
            cj = jnp.clip(qj + offsets[k, 0], 0, nqj - 1)
            ci = jnp.clip(qi + offsets[k, 1], 0, nqi - 1)
            det_a, ua, va, det_b, ub, vb = tri_solve(
                gxf, gyf, cj, ci, px, py
            )
            ok_a = (
                (det_a != 0.0) & (ua >= u_min) & (va >= u_min)
                & (ua + va <= uv_max)
            )
            ok_b = (
                (det_b != 0.0) & (ub >= u_min) & (vb >= u_min)
                & (ub + vb <= uv_max)
            )
            ok = ok_a | ok_b
            rank = cj * nqi + ci
            gi = ci.astype(ft)
            gj = cj.astype(ft)
            src_if = jnp.where(
                ok_a,
                gi + jnp.clip(ua, 0.0, 1.0),
                (gi + 1) - jnp.clip(ub, 0.0, 1.0),
            )
            src_jf = jnp.where(
                ok_a,
                gj + jnp.clip(va, 0.0, 1.0),
                (gj + 1) - jnp.clip(vb, 0.0, 1.0),
            )
            better = ok & (rank < best_rank)
            return (
                jnp.where(better, rank, best_rank),
                jnp.where(better, src_if, out_i),
                jnp.where(better, src_jf, out_j),
            )

        best_rank = jnp.full((dst_h, dst_w), inf, dtype=jnp.int32)
        out_i = jnp.full((dst_h, dst_w), jnp.nan, dtype=ft)
        out_j = jnp.full((dst_h, dst_w), jnp.nan, dtype=ft)
        _, out_i, out_j = lax.fori_loop(
            0, 9, cand_body, (best_rank, out_i, out_j)
        )
        return jnp.stack([out_i, out_j])

    return walk


def inverse_ij_map_walk(
    src_x: np.ndarray,
    src_y: np.ndarray,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    coarse_stride: int = 8,
    coarse_iters: int = 24,
    fine_iters: int = 4,
) -> "DeviceIJMap | None":
    """Newton-walk device Phase A: a planner-free inverse map.

    Instead of host-planned per-tile candidate windows (the tiled stencil
    kernel's O(pixels x window-quads) broadcast), every destination pixel
    *walks* the source quad lattice: a global affine seed, a strided
    coarse walk, a full-resolution refinement, then an exact 3x3 min-rank
    acceptance — pure gathers + element-wise math, no scatter, no host
    planning beyond coordinate normalization and the fold-free gate.
    Matches the host kernel bit-for-bit in float64 (same triangle
    formulas, same row-major-rank winner; reference
    /root/reference/xcube_resampling/rectify.py:458-576) on swaths that
    pass :func:`_walk_gate`; returns None otherwise so callers fall back
    to the tiled-stencil or host tiers.  The compiled kernel depends only
    on the array shapes, so repeated geometries of one product family
    reuse both the jit cache and the persistent compile cache."""
    import jax
    import jax.numpy as jnp

    from ..profiling import GLOBAL_TIMER as _T

    dst_h, dst_w = dst_shape
    src_h, src_w = src_x.shape
    if src_h < 2 or src_w < 2 or dst_h < 1 or dst_w < 1:
        return None
    if src_h * src_w > 2**30:
        # the walk gathers through int32 flat indices; swaths beyond
        # ~1 Gpix (none exist in practice) take the stencil tiers
        return None

    with _T("phase_a.walk.normalize"):
        sx = np.asarray(src_x, dtype=np.float64)
        sy = np.asarray(src_y, dtype=np.float64)
        gx = _scratch("gx", sx.shape, np.float64)
        gy = _scratch("gy", sy.shape, np.float64)
        np.subtract(sx, dst_x_offset, out=gx)
        gx /= dst_x_scale
        np.subtract(sy, dst_y_offset, out=gy)
        gy /= dst_y_scale

    with _T("phase_a.walk.gate"):
        gx32 = _scratch("gx32", gx.shape, np.float32)
        gy32 = _scratch("gy32", gy.shape, np.float32)
        gx32[:] = gx
        gy32[:] = gy
        if not _walk_gate(
            gx32, gy32, max_edge=float(max(dst_h, dst_w))
        ):
            return None

    if jax.config.read("jax_enable_x64") and jax.default_backend() == "cpu":
        dt = jnp.float64
        np_dt = np.float64
    else:
        dt = jnp.float32
        np_dt = np.float32

    key = (
        (src_h, src_w), (dst_h, dst_w), np.dtype(np_dt).str,
        float(uv_delta), coarse_stride, coarse_iters, fine_iters,
    )
    walk = _WALK_JIT.get(key)
    if walk is None:
        walk = _build_walk_kernel(
            (src_h, src_w), (dst_h, dst_w), dt, float(uv_delta),
            coarse_stride, coarse_iters, fine_iters,
        )
        _WALK_JIT[key] = walk

    with _T("phase_a.walk.stage"):
        gx_d = jnp.asarray(gx, dtype=dt)
        gy_d = jnp.asarray(gy, dtype=dt)
    with _T("phase_a.walk.dispatch"):
        out_d = walk(gx_d, gy_d)

    shim = PhaseAPlan(
        dst_h=dst_h,
        dst_w=dst_w,
        src_i_min=src_i_min,
        src_j_min=src_j_min,
        dtype=dt,
    )
    return DeviceIJMap(shim, out_d)


_HYBRID_SEED_JIT: dict = {}
_HYBRID_DENSE_JIT: dict = {}
#: (shape/dtype/params family) -> (tile, win_j, win_i) used by the last
#: call, for the optimistic overlap of dense dispatch with the meta fetch
_HYBRID_LAST_WIN: dict = {}

#: static window-node buckets for the hybrid dense kernel — few buckets
#: keep the compile-cache small; the exact bucket is chosen from spans
#: measured on device, so no bucket is ever compiled speculatively
_HYBRID_WINS = (8, 12, 16, 20, 24, 28, 32, 36, 40, 48)


def _hybrid_corner_walk(
    gx, gy, src_shape, dst_shape, dtype, tile, coarse_iters, refine_iters
):
    """Affine seed + multigrid walk on the tile-corner lattice: quad
    guesses for every corner of the (tile x tile) destination tiling,
    computed with ~1/tile^2 of the per-pixel walk's gather traffic."""
    import jax.numpy as jnp

    src_h, src_w = src_shape
    dst_h, dst_w = dst_shape
    nqj, nqi = src_h - 1, src_w - 1
    w_row = src_w
    ft = dtype
    n_tj = -(-dst_h // tile)
    n_ti = -(-dst_w // tile)
    cs = 8  # coarse lattice: every 8th tile corner
    n_cj = (n_tj // cs) + 2
    n_ci = (n_ti // cs) + 2

    gxf = gx.reshape(-1)
    gyf = gy.reshape(-1)
    xm, ym, im, jm, ai, bi, aj, bj = _affine_seed(
        gxf, gyf, src_h, src_w, ft
    )
    pxc = jnp.broadcast_to(
        (jnp.arange(n_ci, dtype=ft) * (cs * tile))[None, :], (n_cj, n_ci)
    )
    pyc = jnp.broadcast_to(
        (jnp.arange(n_cj, dtype=ft) * (cs * tile))[:, None], (n_cj, n_ci)
    )
    qi0 = jnp.clip(
        jnp.nan_to_num(im + ai * (pxc - xm) + bi * (pyc - ym), nan=im)
        .astype(jnp.int32),
        0,
        nqi - 1,
    )
    qj0 = jnp.clip(
        jnp.nan_to_num(jm + aj * (pxc - xm) + bj * (pyc - ym), nan=jm)
        .astype(jnp.int32),
        0,
        nqj - 1,
    )
    qj_c, qi_c = _walk_steps_flat(
        gxf, gyf, w_row, nqj, nqi, qj0, qi0, pxc, pyc, coarse_iters
    )
    qj_f = jnp.repeat(jnp.repeat(qj_c, cs, axis=0), cs, axis=1)[
        : n_tj + 1, : n_ti + 1
    ]
    qi_f = jnp.repeat(jnp.repeat(qi_c, cs, axis=0), cs, axis=1)[
        : n_tj + 1, : n_ti + 1
    ]
    pxf = jnp.broadcast_to(
        (jnp.arange(n_ti + 1, dtype=ft) * tile)[None, :],
        (n_tj + 1, n_ti + 1),
    )
    pyf = jnp.broadcast_to(
        (jnp.arange(n_tj + 1, dtype=ft) * tile)[:, None],
        (n_tj + 1, n_ti + 1),
    )
    return _walk_steps_flat(
        gxf, gyf, w_row, nqj, nqi, qj_f, qi_f, pxf, pyf, refine_iters
    )


def _hybrid_corner_minmax(c):
    """Per-tile min/max of the four surrounding corner-lattice values."""
    import jax.numpy as jnp

    lo = jnp.minimum(
        jnp.minimum(c[:-1, :-1], c[:-1, 1:]),
        jnp.minimum(c[1:, :-1], c[1:, 1:]),
    )
    hi = jnp.maximum(
        jnp.maximum(c[:-1, :-1], c[:-1, 1:]),
        jnp.maximum(c[1:, :-1], c[1:, 1:]),
    )
    return lo, hi


def _build_hybrid_seed_kernel(
    src_shape, dst_shape, dtype, tile, coarse_iters, refine_iters,
    max_edge, margin,
):
    """Stage 1 of the hybrid Phase A: device gate + corner walk + exact
    window needs, independent of the dense kernel's window size.

    The gate re-derives :func:`_walk_gate` on device (finite coords,
    uniform triangle orientation across the swath, bounded quad edge) so
    the host never touches the coordinate arrays beyond normalization.
    Returns the corner-lattice quad guesses (kept device-resident for
    stage 2) and one tiny int32 vector [gate_ok, need_j, need_i] — the
    per-axis window-node count that covers every tile's quad range plus
    the acceptance margins, clamped at the swath bounds — which the host
    fetches to pick the dense window buckets exactly."""
    import jax
    import jax.numpy as jnp

    src_h, src_w = src_shape
    ft = dtype

    @jax.jit
    def seed(gx, gy):
        # --- device gate (the host _walk_gate's checks) ---
        p0x = gx[:-1, :-1]
        p1x = gx[:-1, 1:]
        p2x = gx[1:, :-1]
        p3x = gx[1:, 1:]
        p0y = gy[:-1, :-1]
        p1y = gy[:-1, 1:]
        p2y = gy[1:, :-1]
        p3y = gy[1:, 1:]
        det_a = _fdet(p0x, p0y, p1x, p1y, p2x, p2y)
        det_b = _fdet(p3x, p3y, p2x, p2y, p1x, p1y)
        finite_ok = jnp.all(jnp.isfinite(gx)) & jnp.all(jnp.isfinite(gy))
        orient_a = (jnp.max(det_a) < 0) | (jnp.min(det_a) > 0)
        orient_b = (jnp.max(det_b) < 0) | (jnp.min(det_b) > 0)
        edge = jnp.maximum(
            jnp.maximum(
                jnp.max(jnp.abs(p1x - p0x)), jnp.max(jnp.abs(p2x - p0x))
            ),
            jnp.maximum(
                jnp.max(jnp.abs(p1y - p0y)), jnp.max(jnp.abs(p2y - p0y))
            ),
        )
        gate_ok = finite_ok & orient_a & orient_b & (edge <= ft(max_edge))

        # --- corner walk + per-axis window needs ---
        cqj, cqi = _hybrid_corner_walk(
            gx, gy, src_shape, dst_shape, ft, tile,
            coarse_iters, refine_iters,
        )
        qj_lo, qj_hi = _hybrid_corner_minmax(cqj)
        qi_lo, qi_hi = _hybrid_corner_minmax(cqi)
        # window nodes needed on each axis: the margin-padded quad range
        # clamped at the swath bounds (quads outside don't exist), plus
        # the closing node — so need <= src dim always holds and tiny
        # swaths are served by a whole-axis window
        nqj, nqi = src_h - 1, src_w - 1
        need_j = jnp.max(
            jnp.minimum(qj_hi + margin, nqj - 1)
            - jnp.maximum(qj_lo - margin, 0)
        ) + 2
        need_i = jnp.max(
            jnp.minimum(qi_hi + margin, nqi - 1)
            - jnp.maximum(qi_lo - margin, 0)
        ) + 2
        meta = jnp.stack(
            [gate_ok.astype(jnp.int32), need_j, need_i]
        )
        return cqj, cqi, meta

    return seed


def _build_hybrid_dense_kernel(
    src_shape, dst_shape, dtype, uv_delta, tile, win_j, win_i, margin
):
    """Stage 2 of the hybrid Phase A: per-tile static source windows +
    dense min-rank acceptance.

    Each tile loads one (win_j x win_i) coordinate window as contiguous
    ``dynamic_slice`` rows (no per-pixel random gathers, which the pure
    Newton walk is made of), then every pixel tests all window quads with the exact triangle
    acceptance and first-writer-wins rank order of the host kernel
    (reference /root/reference/xcube_resampling/rectify.py:544-576).
    Window cover is guaranteed by construction: the wins are picked from
    stage 1's exact bound-clamped per-axis needs."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    src_h, src_w = src_shape
    dst_h, dst_w = dst_shape
    nqj, nqi = src_h - 1, src_w - 1
    ft = dtype
    u_min = -uv_delta
    uv_max = 1.0 + 2 * uv_delta
    inf = jnp.iinfo(jnp.int32).max
    n_tj = -(-dst_h // tile)
    n_ti = -(-dst_w // tile)

    @jax.jit
    def dense(gx, gy, cqj, cqi):
        qj_lo, _ = _hybrid_corner_minmax(cqj)
        qi_lo, _ = _hybrid_corner_minmax(cqi)
        base_j = jnp.clip(qj_lo - margin, 0, src_h - win_j).reshape(-1)
        base_i = jnp.clip(qi_lo - margin, 0, src_w - win_i).reshape(-1)

        # window node loads: batched contiguous slices
        def load(b_j, b_i):
            return (
                lax.dynamic_slice(gx, (b_j, b_i), (win_j, win_i)),
                lax.dynamic_slice(gy, (b_j, b_i), (win_j, win_i)),
            )

        wx, wy = jax.vmap(load)(base_j, base_i)  # (T, win_j, win_i)

        # quad corners as 4D window views: (T, win-1, win-1)
        p0x = wx[:, :-1, :-1]
        p1x = wx[:, :-1, 1:]
        p2x = wx[:, 1:, :-1]
        p3x = wx[:, 1:, 1:]
        p0y = wy[:, :-1, :-1]
        p1y = wy[:, :-1, 1:]
        p2y = wy[:, 1:, :-1]
        p3y = wy[:, 1:, 1:]
        det_a = jnp.nan_to_num(_fdet(p0x, p0y, p1x, p1y, p2x, p2y), nan=0.0)
        det_b = jnp.nan_to_num(_fdet(p3x, p3y, p2x, p2y, p1x, p1y), nan=0.0)
        # per-quad reciprocals: the uv solves below run per (pixel, quad),
        # so dividing there would cost billions of divides — divide
        # once per quad and multiply in the broadcast instead
        inv_a = 1.0 / jnp.where(det_a == 0.0, 1.0, det_a)
        inv_b = 1.0 / jnp.where(det_b == 0.0, 1.0, det_b)

        # global row-major quad rank of every window quad:
        # (T, win_j-1, win_i-1)
        dj = jnp.arange(win_j - 1, dtype=jnp.int32)
        di = jnp.arange(win_i - 1, dtype=jnp.int32)
        qj_g = base_j[:, None, None] + dj[None, :, None]
        qi_g = base_i[:, None, None] + di[None, None, :]
        rank = qj_g * nqi + qi_g

        # pixel centers of every tile: (T, P) with T row-major (tj, ti)
        iota_t = jnp.arange(tile, dtype=jnp.int32)
        tjs = jnp.repeat(jnp.arange(n_tj, dtype=jnp.int32), n_ti)
        tis = jnp.tile(jnp.arange(n_ti, dtype=jnp.int32), n_tj)
        pxr = (tis[:, None] * tile + iota_t[None, :]).astype(ft) + ft(0.5)
        pyr = (tjs[:, None] * tile + iota_t[None, :]).astype(ft) + ft(0.5)
        n_t = n_tj * n_ti
        p_n = tile * tile
        dst_x = jnp.broadcast_to(
            pxr[:, None, :], (n_t, tile, tile)
        ).reshape(n_t, p_n, 1, 1)
        dst_y = jnp.broadcast_to(
            pyr[:, :, None], (n_t, tile, tile)
        ).reshape(n_t, p_n, 1, 1)

        # the pixels-x-quads broadcast chain ((T, P, wq, wq) fused
        # terms): acceptance masks + both triangle solutions
        e0x = p0x[:, None]
        e0y = p0y[:, None]
        ua = _fu(
            dst_x, dst_y, e0x, e0y, p2x[:, None], p2y[:, None]
        ) * inv_a[:, None]
        va = _fv(
            dst_x, dst_y, e0x, e0y, p1x[:, None], p1y[:, None]
        ) * inv_a[:, None]
        ok_a = (
            (det_a[:, None] != 0.0) & (ua >= u_min) & (va >= u_min)
            & (ua + va <= uv_max)
        )
        e3x = p3x[:, None]
        e3y = p3y[:, None]
        ub = _fu(
            dst_x, dst_y, e3x, e3y, p1x[:, None], p1y[:, None]
        ) * inv_b[:, None]
        vb = _fv(
            dst_x, dst_y, e3x, e3y, p2x[:, None], p2y[:, None]
        ) * inv_b[:, None]
        ok_b = (
            (det_b[:, None] != 0.0) & (ub >= u_min) & (vb >= u_min)
            & (ub + vb <= uv_max)
        )
        accept = ok_a | ok_b
        gi = qi_g.astype(ft)[:, None]
        gj = qj_g.astype(ft)[:, None]
        src_if = jnp.where(
            ok_a,
            gi + jnp.clip(ua, 0.0, 1.0),
            (gi + 1) - jnp.clip(ub, 0.0, 1.0),
        )
        src_jf = jnp.where(
            ok_a,
            gj + jnp.clip(va, 0.0, 1.0),
            (gj + 1) - jnp.clip(vb, 0.0, 1.0),
        )
        rank_pq = jnp.where(accept, rank[:, None], inf)

        # ONE variadic min-by-rank reduce carries the winner's payload
        # out with its rank — a (best, then rank==best re-select) pair of
        # reductions would traverse the fused broadcast twice
        def min_by_rank(acc, val):
            ar, ai_, aj_ = acc
            br, bi_, bj_ = val
            take_b = br < ar
            return (
                jnp.where(take_b, br, ar),
                jnp.where(take_b, bi_, ai_),
                jnp.where(take_b, bj_, aj_),
            )

        best, out_i, out_j = lax.reduce(
            (rank_pq, src_if, src_jf),
            (np.int32(inf), np.dtype(ft).type(np.nan),
             np.dtype(ft).type(np.nan)),
            min_by_rank,
            (2, 3),
        )
        found = best < inf
        out_i = jnp.where(found, out_i, jnp.nan)
        out_j = jnp.where(found, out_j, jnp.nan)

        # assembly: (T, t, t) -> (2, dst_h, dst_w)
        o_i = out_i.reshape(n_tj, n_ti, tile, tile).transpose(0, 2, 1, 3)
        o_j = out_j.reshape(n_tj, n_ti, tile, tile).transpose(0, 2, 1, 3)
        hp, wp = n_tj * tile, n_ti * tile
        full_map = jnp.stack([o_i.reshape(hp, wp), o_j.reshape(hp, wp)])
        return full_map[:, :dst_h, :dst_w]

    return dense


def _normalize_chunked(sx, offset, scale, out):
    """(sx - offset) / scale in float64 math, written chunk-by-chunk into
    ``out`` (float32 on accelerators) — cache-sized chunks cost ~one
    memory pass instead of four."""
    h = sx.shape[0]
    step = max(1, (1 << 21) // max(sx.shape[1], 1))  # ~16 MB f64 chunks
    for r0 in range(0, h, step):
        r1 = min(r0 + step, h)
        out[r0:r1] = (sx[r0:r1] - offset) / scale


#: per-(H, W, step) jitted device reconstruction for the compressed
#: coordinate upload (see _stage_compressed)
_COORD_RECON_JIT: dict = {}
_COORD_STEP = 16
#: residuals beyond this magnitude [px] would quantize coarser than the
#: hybrid tier's own f32 error class (f16 ulp at 2.0 = 0.002 px)
_COORD_RESID_CAP = 2.0


def _coord_nodes(n: int) -> np.ndarray:
    k = np.arange(0, n - 1, _COORD_STEP, dtype=np.int64)
    return np.append(k, n - 1)


def _coord_recon(shape: tuple[int, int]):
    """Device-side f32 bilinear predictor + f16 residual add, jitted per
    swath shape.  The weight/index lines are trace-time constants."""
    import jax
    import jax.numpy as jnp

    fn = _COORD_RECON_JIT.get(shape)
    if fn is not None:
        return fn
    h, w = shape
    ch, cw = _coord_nodes(h), _coord_nodes(w)
    kh, kw = len(ch) - 1, len(cw) - 1
    jj = np.arange(h, dtype=np.float32)
    ii = np.arange(w, dtype=np.float32)
    rj = np.clip(np.searchsorted(ch, jj, side="right") - 1, 0, kh - 1)
    ri = np.clip(np.searchsorted(cw, ii, side="right") - 1, 0, kw - 1)
    wj = ((jj - ch[rj]) / (ch[rj + 1] - ch[rj])).astype(np.float32)
    wi = ((ii - cw[ri]) / (cw[ri + 1] - cw[ri])).astype(np.float32)
    rj_d, ri_d = jnp.asarray(rj), jnp.asarray(ri)
    wj_d = jnp.asarray(wj[:, None])
    wi_d = jnp.asarray(wi[None, :])

    @jax.jit
    def recon(coarse, resid):
        c00 = coarse[rj_d][:, ri_d]
        c01 = coarse[rj_d][:, ri_d + 1]
        c10 = coarse[rj_d + 1][:, ri_d]
        c11 = coarse[rj_d + 1][:, ri_d + 1]
        # lerp form must match the host predictor in _compress_coords
        top = c00 * (1 - wi_d) + c01 * wi_d
        bot = c10 * (1 - wi_d) + c11 * wi_d
        pred = top * (1 - wj_d) + bot * wj_d
        return pred + resid.astype(jnp.float32)

    _COORD_RECON_JIT[shape] = recon
    return recon


def _compress_coords(a32: np.ndarray, key: str):
    """(coarse f32, resid f16) halving the coordinate upload bytes, or
    None when the field is not representable (non-finite values, or a
    residual the f16 quantization would round coarser than the tier's
    f32 error class).

    The full-resolution residual rides against a bilinear prediction
    from a 16x-subsampled grid; reconstruction error = prediction f32
    ulp + f16 residual quantization — the same class as the plain f32
    upload this replaces.  Interior cells use block-broadcast prediction
    (no full-image gathers); ragged edge strips go through the small
    generic path.
    """
    h, w = a32.shape
    ch, cw = _coord_nodes(h), _coord_nodes(w)
    kh, kw = len(ch) - 1, len(cw) - 1
    if kh < 2 or kw < 2:
        return None
    step = _COORD_STEP
    fh, fw = (kh - 1) * step, (kw - 1) * step
    coarse = a32[np.ix_(ch, cw)]
    if not np.isfinite(coarse).all():
        return None
    resid = _scratch(key, (h, w), np.float16)

    wf = (np.arange(step, dtype=np.float32) / step)[None, :]
    wj = wf.reshape(1, step, 1, 1)
    wi = wf.reshape(1, 1, 1, step)
    c00 = coarse[: kh - 1, : kw - 1][:, None, :, None]
    c01 = coarse[: kh - 1, 1:kw][:, None, :, None]
    c10 = coarse[1:kh, : kw - 1][:, None, :, None]
    c11 = coarse[1:kh, 1:kw][:, None, :, None]
    top = c00 * (1 - wi) + c01 * wi
    bot = c10 * (1 - wi) + c11 * wi
    pred = top * (1 - wj) + bot * wj
    block = a32[:fh, :fw].reshape(kh - 1, step, kw - 1, step)
    res_int = (block - pred).reshape(fh, fw)
    if not np.isfinite(res_int).all():
        return None
    if float(np.abs(res_int).max()) > _COORD_RESID_CAP:
        return None
    resid[:fh, :fw] = res_int

    def strip(r0, r1, c0, c1):
        if r0 >= r1 or c0 >= c1:
            return True
        jj = np.arange(r0, r1, dtype=np.float32)
        ii = np.arange(c0, c1, dtype=np.float32)
        rj = np.clip(np.searchsorted(ch, jj, side="right") - 1, 0, kh - 1)
        ri = np.clip(np.searchsorted(cw, ii, side="right") - 1, 0, kw - 1)
        wjs = ((jj - ch[rj]) / (ch[rj + 1] - ch[rj])).astype(np.float32)
        wis = ((ii - cw[ri]) / (cw[ri + 1] - cw[ri])).astype(np.float32)
        s00 = coarse[np.ix_(rj, ri)]
        s01 = coarse[np.ix_(rj, ri + 1)]
        s10 = coarse[np.ix_(rj + 1, ri)]
        s11 = coarse[np.ix_(rj + 1, ri + 1)]
        tops = s00 + wis[None, :] * (s01 - s00)
        bots = s10 + wis[None, :] * (s11 - s10)
        preds = tops + wjs[:, None] * (bots - tops)
        res = a32[r0:r1, c0:c1] - preds
        if not np.isfinite(res).all() or float(np.abs(res).max()) > _COORD_RESID_CAP:
            return False
        resid[r0:r1, c0:c1] = res
        return True

    if not (strip(0, fh, fw, w) and strip(fh, h, 0, w)):
        return None
    return coarse, resid


def _stage_compressed(a32: np.ndarray, key: str):
    """Stage a normalized f32 coordinate image through the halved-byte
    compressed upload; None -> caller stages the plain f32 array.  The
    device_put calls are async, so the caller's next host compression
    overlaps these transfers."""
    import jax

    if os.environ.get("XRTPU_PHASEA_COMPRESS", "1") == "0":
        return None
    packed = _compress_coords(a32, key + "_resid")
    if packed is None:
        return None
    coarse, resid = packed
    recon = _coord_recon(a32.shape)
    return recon(jax.device_put(coarse), jax.device_put(resid))


def inverse_ij_map_hybrid(
    src_x: np.ndarray,
    src_y: np.ndarray,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    tile: int = 16,
    margin: int = 2,
    coarse_iters: int = 24,
    refine_iters: int = 6,
) -> "DeviceIJMap | None":
    """Hybrid device Phase A: coarse walk seeds, dense tiled acceptance.

    The pure Newton walk (:func:`inverse_ij_map_walk`) is exact but pays
    ~70 random flat gathers per destination pixel (fine walk + 3x3
    acceptance).  Here the per-pixel work is gather-free, in two
    device stages:

    1. :func:`_build_hybrid_seed_kernel` — device gate (finite coords,
       uniform orientation, bounded edge), corner-lattice walk, and the
       exact per-axis quad spans of every tile; the host fetches three
       int32 scalars and picks the dense window bucket exactly (no
       estimator, no speculative compiles, no wasted dense dispatch).
    2. :func:`_build_hybrid_dense_kernel` — per-tile static (win x win)
       coordinate windows loaded as contiguous slices + the dense
       min-rank acceptance broadcast.

    Winner selection and NaN coverage match the host kernel (reference
    /root/reference/xcube_resampling/rectify.py:458-576) on every swath
    the gate accepts; geometries it cannot serve return None and fall to
    the walk / host-planned stencil tiers."""
    import jax
    import jax.numpy as jnp

    from ..profiling import GLOBAL_TIMER as _T

    dst_h, dst_w = dst_shape
    src_h, src_w = src_x.shape
    if src_h < 2 or src_w < 2 or dst_h < 4 or dst_w < 4:
        return None
    if src_h * src_w > 2**30:
        return None

    if jax.config.read("jax_enable_x64") and jax.default_backend() == "cpu":
        dt = jnp.float64
        np_dt = np.float64
    else:
        dt = jnp.float32
        np_dt = np.float32

    # normalize/upload interleaved per array: gy's host pass overlaps
    # gx's async device transfer.  On the f32 (accelerator) path each
    # array first tries the compressed upload (coarse f32 + f16
    # residual — halves the bytes of the transfer, same error class as
    # plain f32; see _stage_compressed); non-finite or
    # rough fields fall back to the plain f32 transfer.
    compress_ok = np_dt is np.float32
    with _T("phase_a.hybrid.normalize"):
        sx = np.asarray(src_x, dtype=np.float64)
        sy = np.asarray(src_y, dtype=np.float64)
        gx_n = _scratch("hyb_gx", sx.shape, np_dt)
        gy_n = _scratch("hyb_gy", sy.shape, np_dt)
        _normalize_chunked(sx, dst_x_offset, dst_x_scale, gx_n)
    with _T("phase_a.hybrid.stage"):
        gx_d = _stage_compressed(gx_n, "hyb_gx") if compress_ok else None
        if gx_d is None:
            gx_d = jnp.asarray(gx_n, dtype=dt)
    with _T("phase_a.hybrid.normalize"):
        _normalize_chunked(sy, dst_y_offset, dst_y_scale, gy_n)
    with _T("phase_a.hybrid.stage"):
        gy_d = _stage_compressed(gy_n, "hyb_gy") if compress_ok else None
        if gy_d is None:
            gy_d = jnp.asarray(gy_n, dtype=dt)

    max_edge = float(max(dst_h, dst_w))
    cap = _HYBRID_WINS[-1]

    # smallest static window bucket covering stage 1's exact need
    # (need <= src dim by construction, so only a >cap need — a very
    # wide tile-to-quad ratio — forces a smaller tile or a fallback)
    def pick(need, src_dim):
        for bucket in _HYBRID_WINS:
            if min(bucket, src_dim) >= need:
                return min(bucket, src_dim)
        return None

    def get_dense(t, win_j, win_i):
        dense_key = (
            (src_h, src_w), (dst_h, dst_w), np.dtype(np_dt).str,
            float(uv_delta), t, win_j, win_i, margin,
        )
        dense = _HYBRID_DENSE_JIT.get(dense_key)
        if dense is None:
            dense = _build_hybrid_dense_kernel(
                (src_h, src_w), (dst_h, dst_w), dt, float(uv_delta),
                t, win_j, win_i, margin,
            )
            _HYBRID_DENSE_JIT[dense_key] = dense
        return dense

    # product families reuse one geometry class: remember the window the
    # last same-shaped call used and dispatch the dense kernel with it
    # optimistically, so its execution overlaps the meta fetch instead of
    # serializing on it (validated against the fetched needs before use)
    family_key = (
        (src_h, src_w), (dst_h, dst_w), np.dtype(np_dt).str,
        float(uv_delta), tile, margin, coarse_iters, refine_iters,
    )
    guess = _HYBRID_LAST_WIN.get(family_key)

    # coarse destination resolutions span many quads per pixel: cascade
    # to smaller tiles until the window need fits the bucket cap, using
    # the measured per-pixel quad rate to skip hopeless tiles (and the
    # last same-family call's tile as the first candidate)
    tiles = [16, 12, 8, 4]
    if guess is not None and guess[0] in tiles:
        tiles.remove(guess[0])
        tiles.insert(0, guess[0])
    rate = None
    chosen = None
    out_d = None
    for t in tiles:
        if t > tile or dst_h < t or dst_w < t:
            continue
        if rate is not None and t != 4:
            if rate * t + 2 * margin + 4 > cap:
                continue
        seed_key = (
            (src_h, src_w), (dst_h, dst_w), np.dtype(np_dt).str,
            t, coarse_iters, refine_iters, max_edge, margin,
        )
        seed = _HYBRID_SEED_JIT.get(seed_key)
        if seed is None:
            seed = _build_hybrid_seed_kernel(
                (src_h, src_w), (dst_h, dst_w), dt, t,
                coarse_iters, refine_iters, max_edge, margin,
            )
            _HYBRID_SEED_JIT[seed_key] = seed
        with _T("phase_a.hybrid.seed"):
            cqj, cqi, meta = seed(gx_d, gy_d)
        optimistic = None
        if guess is not None and guess[0] == t:
            with _T("phase_a.hybrid.dense"):
                optimistic = get_dense(t, guess[1], guess[2])(
                    gx_d, gy_d, cqj, cqi
                )
        with _T("phase_a.hybrid.meta_fetch"):
            gate_ok, need_j, need_i = (int(v) for v in np.asarray(meta))
        if os.environ.get("XRTPU_HYBRID_DEBUG", ""):
            print(
                f"[hybrid] tile={t} gate={bool(gate_ok)} "
                f"need=({need_j},{need_i})",
                flush=True,
            )
        if not gate_ok:
            return None
        if optimistic is not None:
            g_wj, g_wi = guess[1], guess[2]
            if (g_wj >= need_j or g_wj >= src_h) and (
                g_wi >= need_i or g_wi >= src_w
            ):
                chosen = (t, g_wj, g_wi)
                out_d = optimistic
                break
        win_j = pick(need_j, src_h)
        win_i = pick(need_i, src_w)
        if win_j is not None and win_i is not None:
            chosen = (t, win_j, win_i, cqj, cqi)
            break
        rate = max(need_j, need_i, 2 * margin + 5) / t

    if chosen is None:
        return None
    if out_d is None:
        t, win_j, win_i, cqj, cqi = chosen
        with _T("phase_a.hybrid.dense"):
            out_d = get_dense(t, win_j, win_i)(gx_d, gy_d, cqj, cqi)
        _HYBRID_LAST_WIN[family_key] = (t, win_j, win_i)
    else:
        _HYBRID_LAST_WIN[family_key] = chosen

    shim = PhaseAPlan(
        dst_h=dst_h,
        dst_w=dst_w,
        src_i_min=src_i_min,
        src_j_min=src_j_min,
        dtype=dt,
    )
    return DeviceIJMap(shim, out_d)

def inverse_ij_map_device(
    src_x: np.ndarray,
    src_y: np.ndarray,
    src_i_min: int,
    src_j_min: int,
    dst_shape: tuple[int, int],
    dst_x_offset: float,
    dst_y_offset: float,
    dst_x_scale: float,
    dst_y_scale: float,
    uv_delta: float,
    tile: int = 8,
    max_win: int = 48,
) -> "DeviceIJMap | np.ndarray | None":
    """Whole-image device Phase A: the production device tier of
    :func:`inverse_ij_map`.

    Tier order: the hybrid walk-seeded stencil
    (:func:`inverse_ij_map_hybrid`, gather-free per-pixel work —
    ``XRTPU_PHASEA_HYBRID=0`` disables), the planner-free Newton walk
    (:func:`inverse_ij_map_walk`) on clean fold-free swaths
    (``XRTPU_PHASEA_WALK=0`` disables), then the host-planned tiled
    stencil kernel (:func:`plan_phase_a_device`).  Returns a
    :class:`DeviceIJMap` (or a ready numpy map for degenerate
    geometries), or None when the geometry is outside the device
    envelope; callers fall back to the tiled host path."""
    if os.environ.get("XRTPU_PHASEA_HYBRID", "") != "0":
        hybrid = inverse_ij_map_hybrid(
            src_x, src_y, src_i_min, src_j_min, dst_shape,
            dst_x_offset, dst_y_offset, dst_x_scale, dst_y_scale,
            uv_delta,
        )
        if hybrid is not None:
            return hybrid
    if os.environ.get("XRTPU_PHASEA_WALK", "") != "0":
        walked = inverse_ij_map_walk(
            src_x, src_y, src_i_min, src_j_min, dst_shape,
            dst_x_offset, dst_y_offset, dst_x_scale, dst_y_scale,
            uv_delta,
        )
        if walked is not None:
            return walked
    plan = plan_phase_a_device(
        src_x, src_y, src_i_min, src_j_min, dst_shape,
        dst_x_offset, dst_y_offset, dst_x_scale, dst_y_scale,
        uv_delta, tile=tile, max_win=max_win,
    )
    if plan is None or isinstance(plan, np.ndarray):
        return plan
    gx_d, gy_d = plan.device_args()
    return DeviceIJMap(plan, plan.apply(gx_d, gy_d))


_VAR_IMAGE_DEV_JIT = {}


def make_device_var_image_fn_resident(ij_map: DeviceIJMap, fill_value, interp_method):
    """Device Phase B over a device-resident Phase-A map: one fused jitted
    gather per (interp, fill) — the map never leaves the device, source
    bands are staged on first use (reference semantics of
    `_compute_var_image_for_dest_line`, rectify.py:663-734; NaN map cells
    produce the fill value).

    For bilinear the gather-free SRW tap kernel resolves the coverage
    interior when the map is smooth enough; planning fetches only a step
    lattice + bit-packed validity (~0.5 MB) instead of the full map, so
    the resident contract survives even on hosts where a full-map fetch
    is expensive.  The coverage-edge band and any non-smooth geometry
    stay on the exact per-pixel gather."""
    import jax
    import jax.numpy as jnp

    # repr() so a NaN fill (the default) still hits the cache: float('nan')
    # never equals itself, which would defeat the dict and retrace per band
    key = (interp_method, repr(float(fill_value)))
    fn_cache = getattr(ij_map, "_phase_b_fns", None)
    if fn_cache is None:
        fn_cache = ij_map._phase_b_fns = {}
    if key in fn_cache:
        return fn_cache[key]

    kernel = _VAR_IMAGE_DEV_JIT.get(key)
    if kernel is None:

        @jax.jit
        def kernel(src, m):  # noqa: ANN001
            from .reproject_ops import gather_interp

            valid = jnp.isfinite(m[0]) & jnp.isfinite(m[1])
            ix = jnp.nan_to_num(m[0], nan=0.0).astype(jnp.float32)
            iy = jnp.nan_to_num(m[1], nan=0.0).astype(jnp.float32)
            return gather_interp(
                src, ix, iy, interp_method, fill_value, jnp, valid=valid
            )

        _VAR_IMAGE_DEV_JIT[key] = kernel

    m_dev = ij_map.device_map()

    def gather_fn(src):
        if not type(src).__module__.startswith("jax"):
            src = jnp.asarray(src)
        return kernel(src, m_dev)

    srw_env = os.environ.get("XRTPU_PHASEB_SRW", "")
    want_srw = (
        interp_method in ("bilinear", "triangular")
        if srw_env == ""
        else srw_env == "1"
    )
    if not want_srw:
        fn_cache[key] = gather_fn
        return gather_fn

    # SRW planning needs the source extent, which arrives with the first
    # band — build lazily and fall back to the gather kernel when the
    # geometry rejects the separable plan
    state: dict = {}

    def fn(src):
        if not type(src).__module__.startswith("jax"):
            src = jnp.asarray(src)
        impl = state.get("impl")
        if impl is None:
            impl = (
                _build_resident_srw_phase_b(
                    m_dev, (src.shape[-2], src.shape[-1]),
                    fill_value, interp_method,
                )
                or gather_fn
            )
            state["impl"] = impl
        return impl(src)

    fn_cache[key] = fn
    return fn


def _build_resident_srw_phase_b(m_dev, src_hw, fill_value, interp_method):
    """Plan the SRW interior + gathered-edge composition for a device-
    resident Phase-A map.  Fetches only step-lattice map samples, the
    half-offset probe lattice (accuracy gate), and bit-packed validity.
    Returns a callable or None when the geometry rejects the plan."""
    import jax
    import jax.numpy as jnp

    from .srw import (
        fields_from_lattice,
        make_srw_fn,
        make_srw_fn_batched,
        plan_srw,
    )

    step = 16
    out_h, out_w = int(m_dev.shape[-2]), int(m_dev.shape[-1])
    if out_h < 2 * step or out_w < 2 * step:
        return None
    src_h, src_w = src_hw

    ncj = (out_h - 1) // step + 2
    nci = (out_w - 1) // step + 2
    rsel = np.minimum(np.arange(ncj) * step, out_h - 1)
    csel = np.minimum(np.arange(nci) * step, out_w - 1)
    prow = np.minimum(rsel + step // 2, out_h - 1)
    pcol = np.minimum(csel + step // 2, out_w - 1)

    @jax.jit
    def sample_kernel(m, rs, cs, pr, pc):
        lat = m[:, rs[:, None], cs[None, :]]
        prb = m[:, pr[:, None], pc[None, :]]
        valid = jnp.isfinite(m[0]) & jnp.isfinite(m[1])
        return jnp.packbits(valid.reshape(-1)), lat, prb

    packed, lat, prb = jax.device_get(
        sample_kernel(
            m_dev,
            jnp.asarray(rsel), jnp.asarray(csel),
            jnp.asarray(prow), jnp.asarray(pcol),
        )
    )
    valid = (
        np.unpackbits(np.asarray(packed), count=out_h * out_w)
        .astype(bool)
        .reshape(out_h, out_w)
    )
    if not valid.any():
        return None

    lat = np.asarray(lat, dtype=np.float64)
    prb = np.asarray(prb, dtype=np.float64)
    fields = fields_from_lattice(
        lat[0], lat[1], prb[0], prb[1],
        valid[prow[:, None], pcol[None, :]], (prow, pcol),
        step, src_h, src_w, out_h, out_w,
    )
    if fields is None:
        return None
    plan = plan_srw(None, None, fields=fields)
    if plan is None:
        return None

    # interior = square erosion by (step + 2): strictly inside the
    # coverage at the scale of the coarse lattice; everything else valid
    # resolves through the exact per-pixel gather
    from scipy.ndimage import minimum_filter

    interior = (
        minimum_filter(
            valid.astype(np.uint8), size=2 * (step + 2) + 1,
            mode="constant", cval=0,
        )
        > 0
    )
    if not interior.any():
        return None

    n_ops = plan.base_v.shape[1] * plan.d_v + plan.base_h.shape[0] * plan.d_h
    n_elems = plan.src_h * plan.src_w + plan.out_h * plan.out_w
    make = (
        make_srw_fn_batched
        if n_ops > 128 and n_elems < 64_000_000
        else make_srw_fn
    )
    srw_fn = make(plan, interp_method, fill_value)

    edge_rows, edge_cols = np.nonzero(valid & ~interior)
    er_d = jnp.asarray(edge_rows.astype(np.int32))
    ec_d = jnp.asarray(edge_cols.astype(np.int32))
    interior_d = jnp.asarray(interior)
    fill = jnp.float32(fill_value)

    @jax.jit
    def run(src, m, erd, ecd, inter):
        from .reproject_ops import gather_interp

        out = srw_fn(src)
        out = jnp.where(inter, out, fill)
        if erd.shape[0]:
            ixe = m[0][erd, ecd].astype(jnp.float32)
            iye = m[1][erd, ecd].astype(jnp.float32)
            vals = gather_interp(
                src, ixe, iye, interp_method, fill_value, jnp
            )
            out = out.at[..., erd, ecd].set(vals)
        return out

    def impl(src):
        return run(src, m_dev, er_d, ec_d, interior_d)

    return impl


def make_device_var_image_fn(
    ij_map: np.ndarray,
    src_shape: tuple[int, int],
    fill_value,
    interp_method: str,
):
    """Compile a device Phase-B kernel: resample a batch of source bands
    through a fixed fractional (i, j) map (the map is built once per
    geometry by Phase A; every band/time-step then streams through this
    jitted kernel on the device — the multi-band fast path of rectify).

    When the map is smooth enough (measured against the true per-pixel
    field), the gather-free SRW tap kernel is used instead of the XLA
    gather — Phase A's output is just another coordinate field to SRW."""
    import jax
    import jax.numpy as jnp

    src_h, src_w = src_shape
    valid_np = ~np.isnan(ij_map[0]) & ~np.isnan(ij_map[1])
    valid = jnp.asarray(valid_np)
    fill = jnp.float32(fill_value)

    import os

    # SRW engages for the 4-tap interps (bilinear, and triangular via
    # the bilinear - s*Delta correction); nearest keeps the single-tap
    # gather.  A tuned choice, to be re-tuned on the GPU;
    # XRTPU_PHASEB_SRW=0/1 forces it for experiments.
    srw_env = os.environ.get("XRTPU_PHASEB_SRW", "")
    use_srw = (
        interp_method in ("bilinear", "triangular")
        if srw_env == ""
        else srw_env == "1"
    )
    if use_srw and interp_method in ("nearest", "bilinear", "triangular"):
        from scipy.ndimage import binary_erosion

        from .srw import fields_from_ij_map, make_srw_fn, plan_srw

        # SRW needs a smooth field: the interior of the coverage is (the
        # swath geometry itself), but the NaN-filled band at the coverage
        # edge is extrapolation.  Resolve the interior gather-free and the
        # thin edge band by a compacted per-pixel gather (a few % of the
        # pixels at the serialized-gather rate is negligible).
        step = 16
        interior = binary_erosion(valid_np, iterations=step + 2)
        edge = valid_np & ~interior
        fields = fields_from_ij_map(
            ij_map, src_h, src_w, step=step, gate_mask=interior
        )
        plan = (
            plan_srw(None, None, fields=fields)
            if fields is not None
            else None
        )
        if plan is not None and interior.any():
            from .srw import make_srw_fn_batched

            n_ops = (
                plan.base_v.shape[1] * plan.d_v
                + plan.base_h.shape[0] * plan.d_h
            )
            n_elems = (
                plan.src_h * plan.src_w + plan.out_h * plan.out_w
            )
            make = (
                make_srw_fn_batched
                if n_ops > 128 and n_elems < 64_000_000
                else make_srw_fn
            )
            srw_fn = make(plan, interp_method, fill_value)
            interior_j = jnp.asarray(interior)
            edge_rows, edge_cols = np.nonzero(edge)
            e_rows = jnp.asarray(edge_rows)
            e_cols = jnp.asarray(edge_cols)
            ix_e = jnp.asarray(
                ij_map[0][edge_rows, edge_cols], dtype=jnp.float32
            )
            iy_e = jnp.asarray(
                ij_map[1][edge_rows, edge_cols], dtype=jnp.float32
            )

            @jax.jit
            def fn_srw(src, ixe, iye, er, ec, inter):
                from .reproject_ops import gather_interp

                out = srw_fn(src)
                out = jnp.where(inter, out, fill)
                if er.shape[0]:
                    vals = gather_interp(
                        src, ixe, iye, interp_method, fill_value, jnp
                    )
                    out = out.at[..., er, ec].set(vals)
                return out

            def fn(src):
                return fn_srw(src, ix_e, iy_e, e_rows, e_cols, interior_j)

            return fn

    ix = jnp.asarray(np.nan_to_num(ij_map[0], nan=0.0), dtype=jnp.float32)
    iy = jnp.asarray(np.nan_to_num(ij_map[1], nan=0.0), dtype=jnp.float32)

    @jax.jit
    def kernel(src, ixd, iyd, validd):
        from .reproject_ops import gather_interp

        vals = gather_interp(
            src, ixd, iyd, interp_method, fill_value, jnp, valid=validd
        )
        return vals

    def fn(src):
        return kernel(src, ix, iy, valid)

    return fn


def var_image_from_ij_map(
    src_var: np.ndarray,
    ij_map: np.ndarray,
    fill_value,
    interp_method: str,
    out_dtype=None,
) -> np.ndarray:
    """Phase B: gather source pixels through the fractional (i, j) map with
    nearest / triangular / bilinear interpolation — vectorized port of
    reference `_compute_var_image_block` / `_compute_var_image_for_dest_line`
    (rectify.py:605-734), including the float64 upcast and the window
    min/max slicing with +2 pad."""
    out_dtype = np.dtype(out_dtype or src_var.dtype)
    from ..native import var_image_gather_native

    native = var_image_gather_native(
        src_var, np.asarray(ij_map), fill_value, interp_method, out_dtype
    )
    if native is not None:
        return native
    dst_h, dst_w = ij_map.shape[-2], ij_map.shape[-1]
    dst_shape = src_var.shape[:-2] + (dst_h, dst_w)
    dst_out = np.full(dst_shape, fill_value, dtype=out_dtype)
    if np.all(np.isnan(ij_map[0])):
        return dst_out

    src_bbox = (
        int(np.nanmin(ij_map[0])),
        int(np.nanmin(ij_map[1])),
        min(int(np.nanmax(ij_map[0])) + 2, src_var.shape[-1]),
        min(int(np.nanmax(ij_map[1])) + 2, src_var.shape[-2]),
    )
    # no float64 copy of the window: the gathered taps promote to float64
    # in the arithmetic below (u/v are float64), which is value-identical
    # to upcasting the window first and halves the staging traffic
    window = src_var[..., src_bbox[1] : src_bbox[3], src_bbox[0] : src_bbox[2]]
    if window.dtype.kind not in "fc":
        window = window.astype(np.float64)
    src_h, src_w = window.shape[-2], window.shape[-1]

    src_i_f = ij_map[0] - src_bbox[0]
    src_j_f = ij_map[1] - src_bbox[1]
    valid = ~(np.isnan(src_i_f) | np.isnan(src_j_f))
    src_i_f = np.nan_to_num(src_i_f, nan=0.0)
    src_j_f = np.nan_to_num(src_j_f, nan=0.0)

    # truncation (int()) matches the reference's positive-index floor
    i0 = src_i_f.astype(np.int64)
    j0 = src_j_f.astype(np.int64)
    u = src_i_f - i0
    v = src_j_f - j0

    if interp_method == "nearest":
        i_sel = np.where(u > 0.5, np.clip(i0 + 1, 0, src_w - 1), i0)
        j_sel = np.where(v > 0.5, np.clip(j0 + 1, 0, src_h - 1), j0)
        i_sel = np.clip(i_sel, 0, src_w - 1)
        j_sel = np.clip(j_sel, 0, src_h - 1)
        values = window[..., j_sel, i_sel]
    elif interp_method in ("triangular", "bilinear"):
        i0c = np.clip(i0, 0, src_w - 1)
        j0c = np.clip(j0, 0, src_h - 1)
        i1 = np.clip(i0c + 1, 0, src_w - 1)
        j1 = np.clip(j0c + 1, 0, src_h - 1)
        # promote the gathered taps (not the whole window) to float64:
        # tap DIFFERENCES must be taken in float64 to match the
        # reference's upcast-then-interpolate semantics (rectify.py:630)
        # bit-for-bit — f32 differences deviate by 1 ulp
        v00 = window[..., j0c, i0c].astype(np.float64, copy=False)
        v01 = window[..., j0c, i1].astype(np.float64, copy=False)
        v10 = window[..., j1, i0c].astype(np.float64, copy=False)
        v11 = window[..., j1, i1].astype(np.float64, copy=False)
        if interp_method == "triangular":
            near = v00 + u * (v01 - v00) + v * (v10 - v00)
            far = v11 + (1.0 - u) * (v10 - v11) + (1.0 - v) * (v01 - v11)
            values = np.where(u + v < 1.0, near, far)
        else:
            vu0 = v00 + u * (v01 - v00)
            vu1 = v10 + u * (v11 - v10)
            values = vu0 + v * (vu1 - vu0)
    else:
        raise NotImplementedError(
            f"interp_methods must be one of 0, 1, 'nearest', 'bilinear', "
            f"'triangular', was '{interp_method}'."
        )

    if out_dtype.kind in "ui":
        values = np.rint(values)
    dst_out = np.where(valid, values.astype(out_dtype), dst_out)
    return dst_out.astype(out_dtype)
