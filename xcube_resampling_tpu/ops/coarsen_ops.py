"""Window-reduction (coarsening) kernels.

The host path reshapes into windows and applies the numpy reducers from
:mod:`xcube_resampling_tpu.coarsen` (semantics-defining, NaN-aware, int
round-trip).  The device path maps the same window reshape onto XLA — a
reshape + reduce that XLA fuses into one reduction; ``mode`` becomes a
pairwise running-best or a sort (replacing the reference's numba
histogram loop, coarsen.py:138-155).
"""

from __future__ import annotations

import numpy as np

from ..constants import AGG_METHODS


def window_reshape(array, j_div: int, i_div: int):
    """Reshape the trailing (H, W) dims into (H/j_div, j_div, W/i_div, i_div)
    windows; H, W must be exact multiples."""
    *batch, h, w = array.shape
    assert h % j_div == 0 and w % i_div == 0, "coarsen requires exact multiples"
    return array.reshape(*batch, h // j_div, j_div, w // i_div, i_div)


def coarsen_numpy(array: np.ndarray, j_div: int, i_div: int, agg_fn) -> np.ndarray:
    """Host window reduction using an AGG_METHODS reducer callable."""
    if j_div == 1 and i_div == 1:
        return array
    block = window_reshape(np.asarray(array), j_div, i_div)
    ndim = block.ndim
    axis = (ndim - 3, ndim - 1)
    return np.asarray(agg_fn(block, axis))


def coarsen_jax(array, j_div: int, i_div: int, agg_name: str):
    """Device window reduction by aggregation-method name."""
    import jax.numpy as jnp

    if j_div == 1 and i_div == 1:
        return array
    block = window_reshape(array, j_div, i_div)
    ndim = block.ndim
    axis = (ndim - 3, ndim - 1)
    is_float = jnp.issubdtype(block.dtype, jnp.floating)

    def int_roundtrip(x):
        if not is_float and jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.rint(x).astype(block.dtype)
        return x

    if agg_name == "mean":
        return int_roundtrip(
            jnp.nanmean(block, axis) if is_float else jnp.mean(block, axis)
        )
    if agg_name == "sum":
        return jnp.nansum(block, axis) if is_float else jnp.sum(block, axis)
    if agg_name == "std":
        return int_roundtrip(
            jnp.nanstd(block, axis) if is_float else jnp.std(block, axis)
        )
    if agg_name == "var":
        return int_roundtrip(
            jnp.nanvar(block, axis) if is_float else jnp.var(block, axis)
        )
    if agg_name == "median":
        return int_roundtrip(
            jnp.nanmedian(block, axis) if is_float else jnp.median(block, axis)
        )
    if agg_name == "min":
        return jnp.nanmin(block, axis)
    if agg_name == "max":
        return jnp.nanmax(block, axis)
    if agg_name == "prod":
        return jnp.nanprod(block, axis)
    if agg_name == "count":
        return jnp.count_nonzero(block, axis)
    if agg_name in ("first", "last", "center"):
        j = {"first": 0, "last": j_div - 1, "center": j_div // 2}[agg_name]
        i = {"first": 0, "last": i_div - 1, "center": i_div // 2}[agg_name]
        idx = [slice(None)] * block.ndim
        idx[axis[0]] = j
        idx[axis[1]] = i
        return block[tuple(idx)]
    if agg_name == "mode":
        return _mode_jax(block, axis)
    raise ValueError(f"unsupported aggregation {agg_name!r}")


#: window size above which the O(w^2) pairwise mode yields to the
#: O(w log w) sort-based mode
_MODE_PAIRWISE_MAX_W = 64


def _mode_jax(block, axis):
    """Categorical mode — ties resolve to the smallest value, matching
    the host reducer's histogram scan (reference
    `_mode_from_normalized`, coarsen.py:138-155).

    Small windows (the common 2x2..8x8 coarsenings) use a pairwise
    running-best: counts[i] = sum_j (x_i == x_j) accumulated tap by tap
    (never the (N, w, w) equality tensor), then best = max count with
    min value.  No sort, pure fused elementwise+select.  NaN taps never
    self-match, so a
    NaN only wins an all-NaN window — identical to the sort path.

    Larger windows fall back to sort + longest-run detection:
    value-range independent and O(w log w) per pixel with tiny memory
    (the one-hot/histogram alternative is O(range) memory, which blows
    up on device for wide-ranged categorical data); the run lengths of
    an ascending sort peak at each group's end, and argmax returns the
    first maximum."""
    import jax.lax
    import jax.numpy as jnp

    ndim = block.ndim
    keep = [d for d in range(ndim) if d not in axis]
    perm = keep + list(axis)
    moved = jnp.transpose(block, perm)
    lead_shape = moved.shape[: len(keep)]
    w = int(np.prod(moved.shape[len(keep):]))
    flat = moved.reshape((-1, w))

    if 1 < w <= _MODE_PAIRWISE_MAX_W:
        counts = jnp.zeros(flat.shape, dtype=jnp.int32)
        for j in range(w):
            counts = counts + (flat == flat[:, j : j + 1]).astype(jnp.int32)
        best_c = counts[:, 0]
        best_v = flat[:, 0]
        for i in range(1, w):
            ci = counts[:, i]
            vi = flat[:, i]
            better = (ci > best_c) | ((ci == best_c) & (vi < best_v))
            best_c = jnp.where(better, ci, best_c)
            best_v = jnp.where(better, vi, best_v)
        return best_v.reshape(lead_shape)

    s = jnp.sort(flat, axis=1)
    idx = jnp.arange(w)
    new_group = jnp.concatenate(
        [jnp.ones((s.shape[0], 1), bool), s[:, 1:] != s[:, :-1]], axis=1
    )
    start = jax.lax.cummax(jnp.where(new_group, idx, 0), axis=1)
    run_len = idx - start + 1
    best = jnp.argmax(run_len, axis=1)
    modes = jnp.take_along_axis(s, best[:, None], axis=1)[:, 0]
    return modes.reshape(lead_shape)


def coarsen(array, j_div: int, i_div: int, agg):
    """Window-reduce dispatching on array type: numpy arrays use the host
    reducers (``agg`` may be a name or an AGG_METHODS callable), jax arrays
    use the XLA kernels (``agg`` must be a name)."""
    if isinstance(array, np.ndarray):
        agg_fn = AGG_METHODS[agg] if isinstance(agg, str) else agg
        return coarsen_numpy(array, j_div, i_div, agg_fn)
    if not isinstance(agg, str):
        for name, fn in AGG_METHODS.items():
            if fn is agg:
                agg = name
                break
        else:
            raise ValueError("jax path needs an aggregation name")
    return coarsen_jax(array, j_div, i_div, agg)
