"""Static-shape tile batching: the dask-graph replacement.

The reference expresses tiled work as a dask task graph with one task per
block (reference dask.py:41-135).  Here the same decomposition becomes a
*batch of identically-shaped tiles*: stack the tiles along a leading axis,
``vmap`` the tile kernel over it, and (optionally) shard that axis over the
device mesh — every tile is one program instance, compiled once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np



@dataclass
class TileBatch:
    """A batch of uniformly-shaped tiles cut from a 2D (+batch) array."""

    tiles: object  # (T, ..., th, tw)
    grid: tuple[int, int]  # (n_tiles_y, n_tiles_x)
    tile_shape: tuple[int, int]
    out_shape: tuple[int, int]


def batch_tiles(array, tile_h: int, tile_w: int, fill=0) -> TileBatch:
    """Cut the trailing (H, W) dims into a (T, ..., th, tw) batch, padding
    edge tiles with *fill* to keep shapes static."""
    *batch, h, w = array.shape
    nty = -(-h // tile_h)
    ntx = -(-w // tile_w)
    pad_h = nty * tile_h - h
    pad_w = ntx * tile_w - w
    xp = np if isinstance(array, np.ndarray) else _jnp()
    if pad_h or pad_w:
        pad = [(0, 0)] * len(batch) + [(0, pad_h), (0, pad_w)]
        array = xp.pad(array, pad, mode="constant", constant_values=fill)
    # (..., nty, th, ntx, tw) -> (nty*ntx, ..., th, tw)
    array = array.reshape(*batch, nty, tile_h, ntx, tile_w)
    nb = len(batch)
    perm = [nb, nb + 2] + list(range(nb)) + [nb + 1, nb + 3]
    array = array.transpose(perm).reshape(
        nty * ntx, *batch, tile_h, tile_w
    )
    return TileBatch(array, (nty, ntx), (tile_h, tile_w), (h, w))


def untile(batch: TileBatch):
    """Reassemble a TileBatch into the full (…, H, W) array, trimming the
    edge padding."""
    tiles = batch.tiles
    nty, ntx = batch.grid
    th, tw = batch.tile_shape
    h, w = batch.out_shape
    t, *inner, _, _ = tiles.shape
    nb = len(inner)
    arr = tiles.reshape(nty, ntx, *inner, th, tw)
    perm = list(range(2, 2 + nb)) + [0, 2 + nb, 1, 3 + nb]
    arr = arr.transpose(perm).reshape(*inner, nty * th, ntx * tw)
    return arr[..., :h, :w]


def shard_tile_axis(tiles, mesh, axis_name: str = "tiles"):
    """Place a tile batch with its leading axis sharded over *mesh*."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis_name))
    return jax.device_put(tiles, sharding)


def _jnp():
    import jax.numpy as jnp

    return jnp
