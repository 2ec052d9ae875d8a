"""Chunk-lazy zarr-backed arrays.

The reference gets out-of-core *reading* from dask-backed xarray: slicing
a variable only loads the chunks the slice touches (SURVEY.md §2.3).  This
rebuild has no task graph; instead :class:`LazyArray` is a tiny
ndarray-duck that resolves basic slicing directly against the store.  A
:class:`~..xrlite.DataArray` accepts it as data (anything carrying
shape/dtype), so ``open_dataset(..., lazy=True)`` gives datasets whose
pixel payload stays on disk until a kernel (or the streaming executor's
per-tile source windowing) slices it.
"""

from __future__ import annotations

import numpy as np

from .core import Array


class LazyArray:
    """Read-only, chunk-lazy view of a zarr array.

    Supports basic indexing (ints, unit-stride slices, Ellipsis) — each
    ``__getitem__`` reads only the chunks the request overlaps.  Anything
    fancier (masks, fancy indices, strides) materializes first via
    ``np.asarray``.
    """

    def __init__(self, array: Array):
        self._array = array
        self.shape = array.shape
        self.dtype = array.dtype
        self.chunks = array.chunks

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def _normalize_key(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is None for k in key):
            return None  # np.newaxis: let numpy handle it
        n_given = sum(1 for k in key if k is not Ellipsis)
        if Ellipsis in key:
            i = key.index(Ellipsis)
            key = (
                key[:i]
                + (slice(None),) * (self.ndim - n_given)
                + key[i + 1 :]
            )
        key = key + (slice(None),) * (self.ndim - len(key))
        slices, squeeze = [], []
        for ax, k in enumerate(key):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += self.shape[ax]
                if not 0 <= k < self.shape[ax]:
                    raise IndexError(
                        f"index {k} out of bounds for axis {ax} "
                        f"(size {self.shape[ax]})"
                    )
                slices.append(slice(k, k + 1))
                squeeze.append(ax)
            elif isinstance(k, slice):
                if k.step not in (None, 1):
                    return None
                slices.append(k)
            else:
                return None  # fancy indexing -> materialize
        return tuple(slices), tuple(squeeze)

    def __getitem__(self, key):
        norm = self._normalize_key(key)
        if norm is None:
            return np.asarray(self)[key]
        slices, squeeze = norm
        out = self._array.read_window(slices)
        if squeeze:
            out = out.reshape(
                tuple(
                    s for ax, s in enumerate(out.shape) if ax not in squeeze
                )
            )
        return out

    def __array__(self, dtype=None, copy=None):
        out = self._array.read()
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out

    def __repr__(self):
        return (
            f"LazyArray(shape={self.shape}, dtype={self.dtype}, "
            f"chunks={self.chunks})"
        )
