"""Native host runtime: C++ kernels bound via ctypes.

The reference's host-side native tier is numba JIT (LLVM-compiled loops);
this package supplies the equivalent as ahead-of-time-compiled C++ shared
libraries.  The library builds itself on first use (g++, no pybind11) and
everything falls back transparently to the vectorized numpy implementations
when no compiler is available.  Set ``XRTPU_NO_NATIVE=1`` to disable.

The library is built with ``-march=native``, so a copy built on one CPU
can crash another with an illegal instruction.  Its file name therefore
carries a hash of the sources, the build recipe and the build host's CPU
(``build/libxrtpu_native-<key>.so``, git-ignored): a tree copied to
another host finds no library under its own key and builds one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_BUILD_DIR = _HERE / "build"
_SOURCES = [_HERE / "phase_a.cpp", _HERE / "phase_b.cpp", _HERE / "bbox.cpp"]

# -ffp-contract=off: FMA contraction would perturb the float64
# interpolation/solve math away from the numpy reference semantics; with
# it off, -march=native only vectorizes (bit-identical results)
_BASE_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")
# native-arch + OpenMP first; progressively portable fallbacks
_FLAG_LADDER = (("-march=native", "-fopenmp"), ("-fopenmp",), ())

_lock = threading.Lock()
_lib = None
_tried = False


def _host_cpu_id() -> str:
    """The build host's CPU: machine, model name and feature flags."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    lines.append(line.strip())
                elif not line.strip() and lines:
                    break  # the first processor's block is enough
    except OSError:
        lines.append(platform.processor())
    return "\n".join([platform.machine(), *lines])


def _library_key() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr((_BASE_FLAGS, _FLAG_LADDER)).encode())
    h.update(_host_cpu_id().encode())
    return h.hexdigest()[:20]


def _library_path() -> Path:
    return _BUILD_DIR / f"libxrtpu_native-{_library_key()}.so"


def _build(lib_path: Path) -> bool:
    """Compile into a private temporary file, then rename it into place,
    so concurrent builders (test workers) never load a half-written
    library."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=lib_path.stem + ".", suffix=".tmp", dir=lib_path.parent
    )
    os.close(fd)
    try:
        for flags in _FLAG_LADDER:
            cmd = ["g++", *_BASE_FLAGS, *flags, "-o", tmp, *map(str, _SOURCES)]
            try:
                res = subprocess.run(
                    cmd, capture_output=True, timeout=120, cwd=str(_HERE)
                )
            except (OSError, subprocess.SubprocessError):
                return False
            if res.returncode == 0 and os.path.getsize(tmp) > 0:
                os.replace(tmp, lib_path)
                return True
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("XRTPU_NO_NATIVE"):
            return None
        lib_path = _library_path()
        if not lib_path.is_file() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        lib.inverse_ij_map_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.inverse_ij_map_f64.restype = None
        lib.inverse_ij_map_f64_mt.argtypes = (
            lib.inverse_ij_map_f64.argtypes + [ctypes.c_int32]
        )
        lib.inverse_ij_map_f64_mt.restype = None
        lib.var_image_gather.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.var_image_gather.restype = None
        lib.compute_ij_bboxes_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.compute_ij_bboxes_f64.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def inverse_ij_map_native(
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
) -> np.ndarray | None:
    """C++ Phase A; returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None

    # row-sliced views of the swath pass through without a copy: the
    # kernel takes a row stride, requiring only unit column stride
    def _as_strided_f64(a):
        a = np.asarray(a)
        if (
            a.dtype == np.float64
            and a.ndim == 2
            and a.strides[1] == a.itemsize
            and a.strides[0] % a.itemsize == 0
            and a.strides[0] >= a.shape[1] * a.itemsize
        ):
            return a, a.strides[0] // a.itemsize
        a = np.ascontiguousarray(a, dtype=np.float64)
        return a, a.shape[1]

    src_x, x_stride = _as_strided_f64(src_x)
    src_y, y_stride = _as_strided_f64(src_y)
    if x_stride != y_stride:
        src_x = np.ascontiguousarray(src_x)
        src_y = np.ascontiguousarray(src_y)
        x_stride = y_stride = src_x.shape[1]
    dst_h, dst_w = dst_shape
    out = np.full((2, dst_h, dst_w), np.nan, dtype=np.float64)
    dbl_p = ctypes.POINTER(ctypes.c_double)
    # thread count: XRTPU_NATIVE_THREADS wins, else all cores; the
    # multi-threaded kernel is bit-identical to the sequential one
    # (min-quad-rank merge of contiguous row-block claims)
    try:
        n_threads = int(os.environ.get("XRTPU_NATIVE_THREADS", "0"))
    except ValueError:
        n_threads = 0
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.inverse_ij_map_f64_mt(
        src_x.ctypes.data_as(dbl_p),
        src_y.ctypes.data_as(dbl_p),
        src_x.shape[0],
        src_x.shape[1],
        int(x_stride),
        int(src_i_min),
        int(src_j_min),
        dst_h,
        dst_w,
        float(dst_x_offset),
        float(dst_y_offset),
        float(dst_x_scale),
        float(dst_y_scale),
        float(uv_delta),
        out.ctypes.data_as(dbl_p),
        int(n_threads),
    )
    return out


_INTERP_CODES = {"nearest": 0, "triangular": 1, "bilinear": 2}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


def var_image_gather_native(
    src_var: np.ndarray,
    ij_map: np.ndarray,
    fill_value,
    interp_method: str,
    out_dtype=None,
) -> np.ndarray | None:
    """C++ Phase B gather (float32/float64 variables only); returns None
    when the library or the dtype/interp combination is unavailable —
    callers fall back to the vectorized numpy path, whose semantics this
    kernel matches bit-for-bit (see phase_b.cpp)."""
    lib = get_lib()
    if lib is None:
        return None
    interp = _INTERP_CODES.get(interp_method)
    if interp is None:
        return None
    src_dtype = np.dtype(src_var.dtype)
    out_dtype = np.dtype(out_dtype or src_dtype)
    code = _DTYPE_CODES.get(src_dtype)
    if code is None or out_dtype != src_dtype:
        return None
    if ij_map.dtype != np.float64 or ij_map.ndim != 3 or ij_map.shape[0] != 2:
        return None
    try:
        fill = float(fill_value)
    except (TypeError, ValueError):
        return None
    src = np.ascontiguousarray(src_var)
    ij = np.ascontiguousarray(ij_map)
    src_h, src_w = src.shape[-2], src.shape[-1]
    dst_h, dst_w = ij.shape[-2], ij.shape[-1]
    lead = src.shape[:-2]
    n_bands = int(np.prod(lead)) if lead else 1
    out = np.empty(lead + (dst_h, dst_w), dtype=src_dtype)
    lib.var_image_gather(
        src.ctypes.data_as(ctypes.c_void_p),
        code,
        n_bands,
        src_h,
        src_w,
        ij.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst_h,
        dst_w,
        fill,
        interp,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def compute_ij_bboxes_native(
    x_image: np.ndarray,
    y_image: np.ndarray,
    xy_boxes: np.ndarray,
    xy_border: float,
    ij_border: int,
    ij_boxes: np.ndarray,
) -> np.ndarray | None:
    """C++ pixel-bbox scan (float64 coordinate images, int64 output);
    returns None when unavailable — callers fall back to the vectorized
    numpy scan, whose semantics this kernel matches exactly."""
    lib = get_lib()
    if lib is None:
        return None
    if x_image.dtype != np.float64 or y_image.dtype != np.float64:
        return None
    if ij_boxes.dtype != np.int64 or not ij_boxes.flags.c_contiguous:
        return None
    x = np.ascontiguousarray(x_image)
    y = np.ascontiguousarray(y_image)
    boxes = np.ascontiguousarray(xy_boxes, dtype=np.float64)
    dbl_p = ctypes.POINTER(ctypes.c_double)
    lib.compute_ij_bboxes_f64(
        x.ctypes.data_as(dbl_p),
        y.ctypes.data_as(dbl_p),
        x.shape[0],
        x.shape[1],
        boxes.ctypes.data_as(dbl_p),
        boxes.shape[0],
        float(xy_border),
        int(ij_border),
        ij_boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return ij_boxes
