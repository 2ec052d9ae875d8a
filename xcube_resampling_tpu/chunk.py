"""Tile decomposition for eager chunked execution.

The reference delegates chunked execution to dask: it assembles a custom
task graph block-by-block with injected block context
(reference: /root/reference/xcube_resampling/dask.py:41-135).  This
rebuild has no task scheduler — tiles are *static shapes* executed eagerly
(typically through jit-compiled kernels; see
:mod:`xcube_resampling_tpu.parallel.tiling`) — so this module only supplies
the tile geometry: per-axis boundary arithmetic done once with numpy, a
:class:`Tile` record per block, and a driver that assembles an output array
tile by tile.  The reference's ``_NestedList`` (``dask.py:183-232``, a
scaffold for ``da.block``) has no equivalent here: eager assembly writes
straight into the output array.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator, Mapping, Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np

IntTuple = tuple[int, ...]


def axis_tile_edges(extent: int, tile: int) -> np.ndarray:
    """Tile boundary positions along one axis.

    ``axis_tile_edges(13, 5)`` -> ``[0, 5, 10, 13]``: full tiles of size
    *tile* plus a final ragged remainder.
    """
    return np.append(np.arange(0, extent, tile, dtype=np.int64), extent)


def get_chunk_sizes(shape: IntTuple, chunks: IntTuple) -> Iterator[IntTuple]:
    """Per-axis tile sizes in dask ``chunks`` notation.

    ``get_chunk_sizes((13, 13), (5, 7))`` -> ``(5, 5, 3), (7, 6)``.
    """
    for extent, tile in zip(shape, chunks):
        yield tuple(np.diff(axis_tile_edges(extent, tile)).tolist())


def get_chunk_counts(shape: IntTuple, chunks: IntTuple) -> Iterator[int]:
    """Number of tiles along each axis (ceil division)."""
    for extent, tile in zip(shape, chunks):
        yield -(-extent // tile)


@dataclass(frozen=True)
class Tile:
    """One block of a tiled array: its grid position and array slices."""

    index: IntTuple
    slices: tuple[slice, ...]

    @property
    def shape(self) -> IntTuple:
        return tuple(s.stop - s.start for s in self.slices)

    @property
    def bounds(self) -> tuple[tuple[int, int], ...]:
        return tuple((s.start, s.stop) for s in self.slices)


def iter_tiles(shape: IntTuple, tile_shape: IntTuple) -> Iterator[Tile]:
    """Row-major iteration over the tile grid of *shape* cut by *tile_shape*."""
    edges = [axis_tile_edges(n, t) for n, t in zip(shape, tile_shape)]
    counts = tuple(len(e) - 1 for e in edges)
    for index in np.ndindex(*counts):
        yield Tile(
            index=tuple(int(k) for k in index),
            slices=tuple(
                slice(int(e[k]), int(e[k + 1])) for e, k in zip(edges, index)
            ),
        )


def compute_array_from_func(
    func: Callable[..., np.ndarray],
    shape: IntTuple,
    chunks: IntTuple,
    dtype: Any,
    name: str | None = None,
    ctx_arg_names: Sequence[str] | None = None,
    args: Sequence[Any] = (),
    kwargs: Mapping[str, Any] | None = None,
) -> np.ndarray:
    """Assemble an array eagerly by invoking *func* once per tile.

    Eager analogue of the reference's dask-graph builder
    (``dask.py:41-135``): the block function may request context arguments
    by name — ``shape``, ``chunks``, ``dtype``, ``name`` (whole-array), and
    ``block_id``, ``block_index``, ``block_shape``, ``block_slices``
    (per-tile; ``block_slices`` is ``((start, stop), ...)`` pairs).
    """
    out = np.empty(shape, dtype=dtype)
    ctx: dict[str, Any] = {
        "shape": tuple(shape),
        "chunks": tuple(get_chunk_sizes(shape, chunks)),
        "dtype": dtype,
        "name": name,
    }
    for block_id, tile in enumerate(iter_tiles(tuple(shape), tuple(chunks))):
        ctx["block_id"] = block_id
        ctx["block_index"] = tile.index
        ctx["block_shape"] = tile.shape
        ctx["block_slices"] = tile.bounds
        ctx_args = [ctx[arg_name] for arg_name in ctx_arg_names or ()]
        out[tile.slices] = np.asarray(func(*ctx_args, *args, **(kwargs or {})))
    return out
