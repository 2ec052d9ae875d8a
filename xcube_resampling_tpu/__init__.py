"""xcube_resampling_tpu — geospatial raster resampling on accelerators.

A from-scratch JAX rebuild of the capabilities of
xcube-dev/xcube-resampling (reference mounted at /root/reference) with its
hot paths on the device (a GPU):

* compute path: JAX / XLA kernels (gathers, stencils, reductions)
* chunk orchestration: static-shape tile batching + ``jax.sharding`` meshes
  (replaces dask task graphs)
* CRS engine: native jittable projection math (replaces pyproj) — the
  reprojection pipeline runs fused on device
* data model: :mod:`xcube_resampling_tpu.xrlite` (replaces xarray)
* storage: :mod:`xcube_resampling_tpu.zarrlite` minimal zarr v2 IO
"""

from .version import version

__version__ = version

from .affine import affine_transform_dataset, resample_dataset
from .crs import CRS, CRS_CRS84, CRS_WGS84, Transformer
from .gridmapping import GridMapping
from .rectify import rectify_dataset
from .reproject import reproject_dataset
from .spatial import resample_in_space
from .xrlite import DataArray, Dataset

__all__ = [
    "CRS",
    "CRS_CRS84",
    "CRS_WGS84",
    "DataArray",
    "Dataset",
    "GridMapping",
    "Transformer",
    "affine_transform_dataset",
    "rectify_dataset",
    "reproject_dataset",
    "resample_dataset",
    "resample_in_space",
    "version",
]
