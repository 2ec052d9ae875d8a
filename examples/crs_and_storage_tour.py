"""Round-2 surface tour: universal CRS input, datum transforms, and
real-world zarr stores (blosc chunks, zip archives).

Runs on CPU; no GPU required."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _bootstrap  # noqa: F401  (path setup + JAX_PLATFORMS handling)

import json
import struct
import tempfile
import zipfile
import zlib
from pathlib import Path

import numpy as np

from xcube_resampling_tpu.crs import CRS, Transformer
from xcube_resampling_tpu import zarrlite


def crs_tour():
    # WKT2 with datum ensemble + USAGE noise (as pyproj prints it)
    wkt = CRS.from_epsg(32632).to_wkt()
    assert CRS.from_wkt(wkt) == CRS.from_epsg(32632)

    # proj4 strings, including +towgs84
    bng = CRS.from_proj4(
        "+proj=tmerc +lat_0=49 +lon_0=-2 +k=0.9996012717 "
        "+x_0=400000 +y_0=-100000 +ellps=airy +datum=OSGB36"
    )
    assert bng == CRS.from_epsg(27700)

    # cross-datum transform: ED50 -> WGS84 shifts ~100-150 m in Europe
    t = Transformer.from_crs("EPSG:4230", "EPSG:4326")
    lon, lat = t.transform(10.0, 52.0)
    print(f"ED50 (10E, 52N) -> WGS84 ({lon:.6f}, {lat:.6f})")

    # Greenwich to British National Grid via the OSGB36 Helmert
    e, n = Transformer.from_crs("EPSG:4326", "EPSG:27700").transform(
        -0.0014, 51.4779
    )
    print(f"Greenwich -> BNG ({e:.0f}, {n:.0f})")


def storage_tour():
    # write a plain store, wrap it in a zip, read it back lazily
    arr = (np.arange(20000, dtype="<f4") / 7.0).reshape(100, 200)
    store = zarrlite.MemoryStore()
    store[".zgroup"] = json.dumps({"zarr_format": 2}).encode()
    store["v/.zarray"] = json.dumps(
        {
            "zarr_format": 2,
            "shape": [100, 200],
            "chunks": [50, 200],
            "dtype": "<f4",
            "compressor": {"id": "zlib", "level": 1},
            "fill_value": "NaN",
            "filters": None,
            "order": "C",
        }
    ).encode()
    store["v/.zattrs"] = json.dumps({"_ARRAY_DIMENSIONS": ["y", "x"]}).encode()
    for ci, chunk in enumerate((arr[:50], arr[50:])):
        store[f"v/{ci}.0"] = zlib.compress(chunk.tobytes(), 1)

    with tempfile.TemporaryDirectory() as tmp:
        zpath = Path(tmp) / "tour.zarr.zip"
        with zipfile.ZipFile(zpath, "w") as zf:
            for key, value in store.items():
                zf.writestr(f"tour.zarr/{key}", value)
        ds = zarrlite.open_dataset(str(zpath), lazy=True)
        window = np.asarray(ds.v[60:70, 10:20].values)
        assert np.allclose(window, arr[60:70, 10:20])
        print(f"zip store window mean: {window.mean():.3f}")

    # blosc frames decode without any C codec library
    from xcube_resampling_tpu.zarrlite.codecs import blosc_decompress

    payload = arr[:8].tobytes()
    frame = struct.pack(
        "<BBBBIII", 2, 1, 0x2, 4, len(payload), len(payload), len(payload) + 16
    ) + payload  # memcpy frame, simplest of the format's layouts
    assert blosc_decompress(frame) == payload
    print("blosc memcpy frame decoded")


if __name__ == "__main__":
    crs_tour()
    storage_tour()
    print("tour complete")
